"""The group world (`dml_tpu_torch.parallel.group_world`) with the image
group backends, against the JAX package on the CPU and the same trees
(JAX's seeded init, carried across by `params_io.from_flax_variables`).

One module-scoped session of two gloo ranks, each a real process, with a
`file://` rendezvous under the test's temporary directory: rank 0 is a
group primary script, rank 1 a follower started through the operator's
entry point (`node --follow 1`, by `tests/_torch_group_follower.py`,
which registers the port's TinyNet first). The primary:

- opens the world, builds a tp-2 mesh and `param_gather`
  `ShardedInference`s through it, and serves TinyNet and MobileNetV2
  through `sharded_backend` (float32, JAX's trees: rows within atol
  1e-4 of JAX's tp-2 `ShardedInference` on the 8 virtual devices, bit
  for bit the port's one-rank engine's) and through the production
  `group_engine_backend` (bfloat16, `set_variables` with JAX's trees:
  bit for bit the one-rank engine's);
- idles past the world's collective timeout and serves again (a follower
  waits for the next call on the control channel, which has none);
- runs a TinyNet job through a 4-node port `LocalCluster` whose group is
  the whole pool, kills the follower, runs a second job: the group
  backend raises `GroupDegraded` within the world's collective timeout,
  refuses later batches at once, and the job completes exactly once with
  the one-device rows;
- with the world closed, starts a `NodeApp` whose group mesh takes two
  ranks with no follower running: `FollowersMissing` at start, within
  its join timeout, before its node joins.

Every wait has its own limit: a fork between the ranks fails in seconds.
"""

from __future__ import annotations

import asyncio
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _tinynet import ensure_tinynet
from dml_tpu.config import MeshSpec as JaxMeshSpec
from dml_tpu.jobs import groups as jg
from dml_tpu.parallel.mesh import make_mesh as jax_make_mesh
from dml_tpu_torch.parallel import group_world
from test_torch_cluster import free_port_block, release_ports

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")
MODELS = ("TinyNet", "MobileNetV2")
#: the world's collective timeout in the session (a dead follower's
#: GroupDegraded must come within it)
COLLECTIVE_S = 5.0
SESSION_S = 150.0  # the primary script's own limit

PRIMARY = r'''
import asyncio, json, os, pickle, signal, subprocess, sys, time
import numpy as np
import torch

torch.set_num_threads(1)
out_dir, tests = sys.argv[1], sys.argv[2]
sys.path.insert(0, tests)
from _torch_group_follower import register_tinynet

register_tinynet()
from dml_tpu_torch.cli import NodeApp
from dml_tpu_torch.cluster.chaos import LocalCluster
from dml_tpu_torch.config import ClusterSpec, MeshSpec, StoreConfig, Timing, WorkerGroupSpec
from dml_tpu_torch.jobs import groups as tg
from dml_tpu_torch.jobs.service import JobService
from dml_tpu_torch.observability import METRICS
from dml_tpu_torch.parallel import group_world as gw
from dml_tpu_torch.parallel.inference import ShardedInference
from dml_tpu_torch.parallel.mesh import make_mesh

cfg = json.load(open(os.path.join(out_dir, "inputs.json")))
with open(os.path.join(out_dir, "trees.pkl"), "rb") as f:
    trees = pickle.load(f)
jpegs, base = cfg["jpegs"], cfg["base"]
R = {}
group = WorkerGroupSpec("img0", ("H3", "H4"), MeshSpec(dp=1, tp=2))
spec = ClusterSpec.localhost(4, base_port=base, introducer_port=base - 1, worker_groups=[group],
                             store=StoreConfig(root=os.path.join(out_dir, "roots"),
                                               download_dir=os.path.join(out_dir, "dl")))

# ---- the world: this process rank 0, the follower a `node --follow` process
spec_path = os.path.join(out_dir, "spec.json")
with open(spec_path, "w") as f:
    f.write(spec.to_json())
rdv = "file://" + os.path.join(out_dir, "rendezvous")
flog = open(os.path.join(out_dir, "follower.log"), "w")
follower = subprocess.Popen(
    [sys.executable, os.path.join(tests, "_torch_group_follower.py"), "node", "--spec",
     spec_path, "--name", "H3", "--follow", "1", "--rendezvous", rdv, "--device", "cpu"],
    stdout=flog, stderr=subprocess.STDOUT)
world = gw.open_primary(rdv, 2, device="cpu", join_timeout_s=60, timeout_s=cfg["collective_s"])
R["backend"] = world.backend
mesh = gw.build(make_mesh, MeshSpec(dp=1, tp=2), ranks=range(2))
R["mesh"] = {"shape": dict(mesh.shape), "rank": mesh.rank}
members = ("a:1", "a:2")
for model in cfg["models"]:
    si = gw.build(ShardedInference, model, mesh, batch_size=4, variables=trees[model],
                  dtype=torch.float32, param_gather=True, device="cpu")
    gb = tg.sharded_backend(si, group_name="g", members=members, alive_fn=lambda: set(members))
    one = tg.sharded_backend(ShardedInference(model, None, batch_size=4, variables=trees[model],
                                              dtype=torch.float32, device="cpu"))
    R[model] = {"group": asyncio.run(gb(model, jpegs))[0], "one": asyncio.run(one(model, jpegs))[0],
                "capacity": gb.capacity}
# the production group engine: lazy, bf16, the operator's weights by set_variables
ge = tg.group_engine_backend("img0", members, lambda: set(members), MeshSpec(dp=1, tp=2),
                             batch_size=4, device="cpu")
for model in cfg["models"]:
    ge.set_variables(model, trees[model])
    one = tg.sharded_backend(ShardedInference(model, None, batch_size=4, variables=trees[model],
                                              device="cpu"))
    R[model]["engine"] = asyncio.run(ge(model, jpegs))[0]
    R[model]["engine_one"] = asyncio.run(one(model, jpegs))[0]
R["engines"] = sorted(f"{m} {s}" for m, s in ge.engines)
R["engine_capacity"] = ge.capacity
# idle past the collective timeout: the follower waits for the next call
# on the control channel, which has none
time.sleep(cfg["collective_s"] + 2)
R["after_idle"] = asyncio.run(ge("TinyNet", jpegs))[0]
R["stats_before_kill"] = world.stats()

# ---- a TinyNet job through a 4-node cluster (H1 leads, H2 stands by: the
# group H3 + H4 is the whole pool), then the follower dies and a second job runs
si_group = gw.build(ShardedInference, "TinyNet", mesh, batch_size=4, variables=trees["TinyNet"],
                    dtype=torch.float32, param_gather=True, device="cpu")
si_one = ShardedInference("TinyNet", None, batch_size=4, variables=trees["TinyNet"],
                          dtype=torch.float32, device="cpu")


class Recorder:
    """The primary's group backend, recording what it raised and when."""

    def __init__(self, gb):
        self.gb, self.errors, self.served = gb, [], 0

    def __getattr__(self, k):
        return getattr(self.gb, k)

    async def __call__(self, model, paths):
        try:
            out = await self.gb(model, paths)
        except Exception as e:
            self.errors.append([type(e).__name__, str(e)[:300], time.monotonic()])
            raise
        self.served += 1
        return out


recs = {}


def make_jobs(node, store):
    alive = lambda: {n.unique_name for n in node.membership.alive_nodes()}
    mem = node.spec.group_members_unique("img0")
    gb = None
    if node.me.unique_name == mem[0]:
        gb = recs["H3"] = Recorder(tg.sharded_backend(si_group, group_name="img0", members=mem,
                                                      alive_fn=alive))
    js = JobService(node, store, infer_backend=tg.sharded_backend(si_one), group_backend=gb)
    js.scheduler.set_batch_size("TinyNet", 4)
    return js


async def cluster_run():
    c = LocalCluster(4, os.path.join(out_dir, "cluster"), base + 10,
                     timing=Timing(**cfg["timing"]), worker_groups=[group], make_jobs=make_jobs)
    await c.start()
    try:
        await c.wait_for(c.converged, 30.0, "cluster convergence")
        client = c.client()
        for p in jpegs:
            await client.store.put(p, os.path.basename(p))

        async def job(n):
            jid = await client.jobs.submit_job("TinyNet", n)
            done = await client.jobs.wait_job(jid, timeout=60.0)
            merged = await client.jobs.get_output(jid, os.path.join(out_dir, f"final_{jid}.json"))
            return done, merged

        key = "jobs_group_batches_total{group=img0}"
        b0 = METRICS.snapshot()["counters"].get(key, 0.0)
        done1, merged1 = await asyncio.wait_for(job(8), 60)
        b1 = METRICS.snapshot()["counters"].get(key, 0.0)
        follower.kill()
        follower.wait(timeout=30)
        t_kill = time.monotonic()
        done2, merged2 = await asyncio.wait_for(job(8), 90)
        rec = recs["H3"]
        t_refuse = time.monotonic()
        try:
            await rec.gb("TinyNet", jpegs)
            refused = None
        except tg.GroupDegraded as e:
            refused = {"error": str(e)[:300], "s": time.monotonic() - t_refuse}
        return {"done1": done1, "merged1": merged1, "group_batches1": b1 - b0,
                "done2": done2, "merged2": merged2,
                "errors": [[n, m, t - t_kill] for n, m, t in rec.errors],
                "served": rec.served, "refused": refused, "lost_after": getattr(rec.gb, "lost", False)}
    finally:
        await c.stop()


R["cluster"] = asyncio.run(asyncio.wait_for(cluster_run(), 150))
R["stats"] = world.stats()
world.close()
R["rows_one"] = asyncio.run(tg.sharded_backend(si_one)("TinyNet", jpegs))[0]

# ---- a second world whose follower stops answering (SIGSTOP) while the
# primary sends a call larger than a socket holds: MobileNetV2's tree
# travels in the call's buffer
rdv2 = "file://" + os.path.join(out_dir, "rendezvous2")
flog2 = open(os.path.join(out_dir, "follower2.log"), "w")
follower2 = subprocess.Popen(
    [sys.executable, os.path.join(tests, "_torch_group_follower.py"), "node", "--spec",
     spec_path, "--name", "H3", "--follow", "1", "--rendezvous", rdv2, "--device", "cpu"],
    stdout=flog2, stderr=subprocess.STDOUT)
world2 = gw.open_primary(rdv2, 2, device="cpu", join_timeout_s=60, timeout_s=cfg["collective_s"])
try:
    mesh2 = gw.build(make_mesh, MeshSpec(dp=1, tp=2), ranks=range(2))
    follower2.send_signal(signal.SIGSTOP)
    t0 = time.monotonic()
    try:
        gw.build(ShardedInference, "MobileNetV2", mesh2, batch_size=4,
                 variables=trees["MobileNetV2"], dtype=torch.float32, param_gather=True,
                 device="cpu")
        R["stopped"] = {"error": None}
    except Exception as e:
        R["stopped"] = {"error": type(e).__name__, "msg": str(e)[:300],
                        "s": time.monotonic() - t0}
    t0 = time.monotonic()
    try:
        gw.build(make_mesh, MeshSpec(dp=1, tp=2), ranks=range(2))
        R["stopped"]["refused"] = None
    except Exception as e:
        R["stopped"]["refused"] = {"error": type(e).__name__, "s": time.monotonic() - t0}
finally:
    follower2.kill()
    follower2.wait(timeout=30)
    world2.close()

# ---- with the world closed: a primary with no follower refuses to start
app = NodeApp(spec, "H3", device="cpu", world_join_s=cfg["no_follower_join_s"])
t0 = time.monotonic()
try:
    asyncio.run(app.start())
    R["no_follower"] = {"error": None}
except gw.FollowersMissing as e:
    R["no_follower"] = {"error": str(e), "s": time.monotonic() - t0,
                        "joined": app.node.joined, "world": gw.current() is None}
with open(os.path.join(out_dir, "primary.pkl"), "wb") as f:
    pickle.dump(R, f)
print("PRIMARY_OK", flush=True)
'''


def _plain(tree):
    return ({k: _plain(v) for k, v in tree.items()} if hasattr(tree, "items")
            else np.asarray(tree))


def _jax_tree(model):
    from dml_tpu.models.params_io import init_variables
    from dml_tpu.models.registry import get_model

    return _plain(init_variables(get_model(model), seed=0, dtype=jnp.float32))


def _jax_rows(model, tree, jpegs):
    """JAX's tp-2 param_gather rows through its `sharded_backend`."""
    from dml_tpu.parallel.inference import ShardedInference as JaxSI

    mesh = jax_make_mesh(JaxMeshSpec(dp=1, tp=2), devices=jax.devices()[:2])
    si = JaxSI(model, mesh, batch_size=4, variables=tree, dtype=jnp.float32, param_gather=True)
    members = ("a:1", "a:2")
    gb = jg.sharded_backend(si, group_name="g", members=members, alive_fn=lambda: set(members))
    return asyncio.run(gb(model, jpegs))[0], gb.capacity


class Session:
    """The two ranks' results, and the JAX package's rows beside them."""

    def __init__(self, out_dir):
        import json

        from PIL import Image

        ensure_tinynet()
        rng = np.random.RandomState(0)
        self.jpegs = []
        for i in range(3):
            p = str(out_dir / f"gw_{i}.jpeg")
            Image.fromarray(rng.randint(0, 255, (40, 40, 3)).astype(np.uint8)).save(p)
            self.jpegs.append(p)
        trees = {m: _jax_tree(m) for m in MODELS}
        with open(out_dir / "trees.pkl", "wb") as f:
            pickle.dump(trees, f)
        self.base = free_port_block(24)
        (out_dir / "inputs.json").write_text(json.dumps({
            "jpegs": self.jpegs, "base": self.base, "models": list(MODELS),
            "collective_s": COLLECTIVE_S, "no_follower_join_s": 2.0,
            "timing": dict(ping_interval=0.2, ack_timeout=0.5, cleanup_time=1.5,
                           leader_rpc_timeout=10.0)}))
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
        (out_dir / "primary.py").write_text(PRIMARY)
        proc = subprocess.Popen([sys.executable, str(out_dir / "primary.py"), str(out_dir), TESTS],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
                                text=True)
        try:
            # JAX's rows while the ranks run
            self.jax = {m: _jax_rows(m, trees[m], self.jpegs) for m in MODELS}
            out, _ = proc.communicate(timeout=SESSION_S)
        except BaseException:
            proc.kill()
            proc.communicate()
            raise
        finally:
            release_ports(self.base, 24)
        follower_log = (out_dir / "follower.log").read_text() if (
            out_dir / "follower.log").exists() else ""
        assert proc.returncode == 0 and "PRIMARY_OK" in out, (
            f"primary rc {proc.returncode}:\n{out[-4000:]}\nfollower:\n{follower_log[-2000:]}")
        with open(out_dir / "primary.pkl", "rb") as f:
            self.r = pickle.load(f)


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield Session(tmp_path_factory.mktemp("group_world"))
    finally:
        torch.set_num_threads(n)


def _assert_close_rows(got, want):
    assert set(got) == set(want)
    for k in want:
        assert [r["wnid"] for r in got[k]] == [r["wnid"] for r in want[k]], k
        np.testing.assert_allclose([r["score"] for r in got[k]], [r["score"] for r in want[k]],
                                   atol=1e-4, rtol=0, err_msg=k)


def _files(rows):
    return {os.path.basename(k): v for k, v in rows.items()}


@pytest.mark.sharded
@pytest.mark.parametrize("model", MODELS)
def test_two_rank_group_rows_equal_one_rank_and_jax_tp2(session, model):
    """A param_gather engine over the two-rank world serves the one-rank
    rows bit for bit (float32, JAX's tree), and JAX's tp-2 rows within
    atol 1e-4; the backend's capacity is the mesh's, as JAX's."""
    r = session.r[model]
    assert r["group"] == r["one"]
    jrows, jcap = session.jax[model]
    _assert_close_rows(r["group"], jrows)
    assert r["capacity"] == jcap == 2.0
    assert session.r["mesh"] == {"shape": {"dp": 1, "tp": 2, "sp": 1, "pp": 1, "ep": 1},
                                 "rank": 0}
    assert session.r["backend"] == "gloo"


@pytest.mark.sharded
@pytest.mark.parametrize("model", MODELS)
def test_group_engine_backend_on_two_ranks_equals_one_rank(session, model):
    """The production group engine (lazy, bfloat16) on the two-rank world,
    after `set_variables` with JAX's tree, serves the one-rank bf16
    engine's rows bit for bit; one engine per (model, mesh), capacity 2."""
    r = session.r[model]
    assert r["engine"] == r["engine_one"]
    assert [row[0]["wnid"] for row in r["engine"].values()] == [
        row[0]["wnid"] for row in r["one"].values()]
    assert session.r["engines"] == ["MobileNetV2 (1, 2, 1)", "TinyNet (1, 2, 1)"]
    assert session.r["engine_capacity"] == 2.0
    assert session.r["after_idle"] == session.r["TinyNet"]["engine"]


@pytest.mark.sharded
def test_primary_without_its_follower_refuses_to_start(session):
    """A group primary whose mesh takes two ranks raises FollowersMissing
    at start, within its join timeout, before its node joins."""
    r = session.r["no_follower"]
    assert r["error"] is not None and "did not join within 2 s" in r["error"]
    assert 1.5 < r["s"] < 30
    assert r["joined"] is False and r["world"] is True


@pytest.mark.sharded
def test_killed_follower_degrades_and_the_job_completes_once(session):
    """A follower killed between two jobs: the primary's next batch raises
    GroupDegraded within the collective timeout, every later call is
    refused at once, and the job still completes exactly once with the
    one-rank rows."""
    c = session.r["cluster"]
    one = _files(session.r["rows_one"])
    assert c["done1"]["total_queries"] == 8 and c["merged1"] == one
    assert c["group_batches1"] >= 1 and c["served"] >= 1
    assert c["done2"]["total_queries"] == 8 and c["merged2"] == one
    assert c["errors"], "the group backend never saw the lost rank"
    name, msg, after = c["errors"][0]
    assert name == "GroupDegraded" and "lost a rank" in msg
    assert 0 <= after < COLLECTIVE_S
    assert all(e[0] == "GroupDegraded" for e in c["errors"])
    assert c["refused"] is not None and c["refused"]["s"] < 1.0
    assert c["lost_after"] is True
    assert session.r["stats"]["broken"] and session.r["stats_before_kill"]["broken"] is None
    # one call a batch of each of the four backends, and one after the idle;
    # a mesh and an engine built for each of them but the first two, which
    # share a mesh
    assert session.r["stats_before_kill"]["calls"] == 5
    assert session.r["stats_before_kill"]["builds"] == 7


@pytest.mark.sharded
def test_stopped_follower_degrades_within_the_collective_timeout(session):
    """A follower that stops answering (SIGSTOP) while the primary sends it
    a call larger than a socket holds: the primary's send raises
    GroupDegraded within the world's collective timeout instead of
    waiting for the follower, and the next call is refused at once."""
    r = session.r["stopped"]
    assert r["error"] == "GroupDegraded" and "lost a rank" in r["msg"], r
    assert r["s"] < COLLECTIVE_S + 3, r
    assert r["refused"] is not None and r["refused"]["error"] == "GroupDegraded"
    assert r["refused"]["s"] < 1.0


def test_follower_needs_its_device_before_it_joins(tmp_path, monkeypatch):
    """The `node --follow` entry on cuda (the default) with no card raises
    "no CUDA device" before it joins; a node that is no group's primary,
    or whose group takes one rank, has no world to follow."""
    from dml_tpu_torch.config import ClusterSpec, MeshSpec, WorkerGroupSpec

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = ClusterSpec.localhost(4, base_port=40101, worker_groups=[
        WorkerGroupSpec("g", ("H3", "H4"), MeshSpec(dp=1, tp=2)),
        WorkerGroupSpec("one", ("H1", "H2"), MeshSpec(dp=1, tp=1))])
    rdv = "file://" + str(tmp_path / "never")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        group_world.follow_from_spec(spec, "H3", 1, init_method=rdv)
    assert not (tmp_path / "never").exists() and group_world.current() is None
    with pytest.raises(SystemExit, match="not a worker group's primary"):
        group_world.follow_from_spec(spec, "H4", 1, device="cpu", init_method=rdv)
    with pytest.raises(SystemExit, match="takes one rank"):
        group_world.follow_from_spec(spec, "H1", 1, device="cpu", init_method=rdv)
    with pytest.raises(ValueError, match="not in 1..1"):
        group_world.follow(rdv, 2, 2, device="cpu")
    assert group_world.mesh_ranks(MeshSpec(dp=1, tp=2)) == 2
    assert group_world.mesh_ranks(MeshSpec(dp=-1, tp=2)) == 1


def test_world_wire_round_trips_arrays_and_handles():
    """The world's wire: every tensor and numpy array of a call's
    arguments travels in one aligned byte buffer (bf16, bool, empty and
    0-d included) and comes back bit for bit; built objects travel by
    handle; a device tensor is refused before anything is sent."""
    from dml_tpu_torch.parallel.group_world import _decode, _encode

    obj = object()
    args = {"rows": {"k": torch.randn(2, 3).to(torch.bfloat16), "s": torch.ones(3, dtype=torch.bool)},
            "ids": np.arange(5, dtype=np.int32), "empty": np.zeros((0, 4), np.float32),
            "scalar": torch.tensor(7.5), "obj": obj, "plain": [1, ("a", 2.0)]}
    parts, size = [], [0]
    enc = _encode(args, {id(obj): 3}, parts, size)
    buf = torch.cat(parts)
    assert buf.numel() == size[0]
    dec = _decode(enc, {3: "mine"}, buf)
    assert dec["obj"] == "mine" and dec["plain"] == [1, ("a", 2.0)]
    assert torch.equal(dec["rows"]["k"].view(torch.int16), args["rows"]["k"].view(torch.int16))
    assert torch.equal(dec["rows"]["s"], args["rows"]["s"]) and dec["scalar"].item() == 7.5
    assert isinstance(dec["ids"], np.ndarray) and (dec["ids"] == args["ids"]).all()
    assert dec["empty"].shape == (0, 4)
    meta = torch.empty(2, device="meta")
    with pytest.raises(TypeError, match="host arguments"):
        _encode({"t": meta}, {}, [], [0])
