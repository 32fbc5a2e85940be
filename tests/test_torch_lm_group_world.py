"""The LM group forms over a group world (`dml_tpu_torch.parallel.
group_world`) against the JAX package's `generate` on the CPU, on the
same weights (JAX's seeded tree written with the flax-msgpack codec and
named in the port's spec, `"weights"`), float32 greedy: tokens exact.

One module-scoped session of two gloo ranks, each a real process, with a
`file://` rendezvous under the test's temporary directory: rank 0 is a
group primary script, rank 1 a follower started through the operator's
entry point (`node --follow 1`, by `tests/_torch_group_follower.py`).
The primary serves, every engine built through the world:

- the weight-resident tp-2 form (`wire_lm_group` on the primary of a
  tp-2 group) and the param-gather form (`sharded_lm_backend`);
- the pp-2 form (`wire_lm_group` on the primary of a pp-2 group);
- the LMDriver overlap form (``{"overlap": true}``), two batches at once
  beside two image calls on a TinyNet engine of the same world (one
  ordered channel: the rows stay the one-rank engine's, bit for bit);
- the disaggregated decode primary (`DisaggLMBackend` over the resident
  form) in a 4-node port `LocalCluster` with a prefill-role member: the
  streamed and whole-slab handoffs adopt every slab on both ranks, and
  a job through the cluster.

Every wait has its own limit: a fork between the ranks fails in seconds.
"""

from __future__ import annotations

import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from dml_tpu_torch.inference.lm_backend import write_prompt_file
from test_torch_cluster import free_port_block, release_ports
from test_torch_lm_sharded import PP_SPEC, SPEC, _expect, _prompts, _weights_spec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")
SESSION_S = 150.0  # the primary script's own limit
N_PROMPTS = 3

PRIMARY = r'''
import asyncio, json, os, pickle, subprocess, sys, time
import numpy as np
import torch

torch.set_num_threads(1)
out_dir, tests = sys.argv[1], sys.argv[2]
sys.path.insert(0, tests)
from _torch_group_follower import register_tinynet

register_tinynet()
from dml_tpu_torch.cluster.chaos import LocalCluster
from dml_tpu_torch.cluster.node import Node
from dml_tpu_torch.cluster.store_service import StoreService
from dml_tpu_torch.config import ClusterSpec, MeshSpec, StoreConfig, Timing, WorkerGroupSpec
from dml_tpu_torch.inference import lm_sharded as ls
from dml_tpu_torch.inference.lm_backend import LMBackend
from dml_tpu_torch.jobs.service import JobService
from dml_tpu_torch.parallel import group_world as gw
from dml_tpu_torch.parallel.inference import ShardedInference
from dml_tpu_torch.parallel.mesh import make_mesh

cfg = json.load(open(os.path.join(out_dir, "inputs.json")))
spec_lm, pp_spec, paths, base = cfg["spec"], cfg["pp_spec"], cfg["paths"], cfg["base"]
model = spec_lm["name"]
R = {}
store_cfg = StoreConfig(root=os.path.join(out_dir, "roots"), download_dir=os.path.join(out_dir, "dl"))
rdv = "file://" + os.path.join(out_dir, "rendezvous")
spec0 = ClusterSpec.localhost(4, base_port=base, introducer_port=base - 1, store=store_cfg,
                              worker_groups=[WorkerGroupSpec("w", ("H3", "H4"),
                                                             MeshSpec(dp=1, tp=2))])
spec_path = os.path.join(out_dir, "spec.json")
with open(spec_path, "w") as f:
    f.write(spec0.to_json())
flog = open(os.path.join(out_dir, "follower.log"), "w")
follower = subprocess.Popen(
    [sys.executable, os.path.join(tests, "_torch_group_follower.py"), "node", "--spec",
     spec_path, "--name", "H3", "--follow", "1", "--rendezvous", rdv, "--device", "cpu"],
    stdout=flog, stderr=subprocess.STDOUT)
world = gw.open_primary(rdv, 2, device="cpu", join_timeout_s=60, timeout_s=30)


def wired(group, name, lm):
    """`wire_lm_group` on an unstarted node of a 4-node spec (nothing binds)."""
    spec = ClusterSpec.localhost(4, base_port=base, introducer_port=base - 1,
                                 worker_groups=[group], store=store_cfg)
    node = Node(spec, spec.node_by_name(name))
    store = StoreService(node, root=os.path.join(out_dir, f"st_{group.name}_{name}"))
    return ls.wire_lm_group(node, store, lm, device="cpu")


def live(gb, mode):
    """The wired engine under a group backend whose members are alive (an
    unstarted node sees none of its peers)."""
    members = ("a", "b")
    return ls.sharded_lm_group_backend(gb.lm_backend, model_name=gb.model, group_name="g",
                                       members=members, alive_fn=lambda: set(members),
                                       capacity=gb.capacity, mode=mode)


def tokens(results):
    return {os.path.basename(k): v["tokens"] for k, v in results.items()}


# ---- the resident form, wired; the gather form, built through the world
tp_group = WorkerGroupSpec("tp0", ("H3", "H4"), MeshSpec(dp=1, tp=2), lm_models=(model,))
gb, pf = wired(tp_group, "H3", spec_lm)
R["resident"] = {"tokens": tokens(asyncio.run(live(gb, "resident")(model, paths))[0]),
                 "engine": type(gb.lm_backend).__name__, "capacity": gb.capacity,
                 "replicate": gb.lm_backend.server._gather_shardings.replicate,
                 "prefill": pf, "lender": wired(tp_group, "H4", spec_lm) == (None, None)}
mesh = gw.build(make_mesh, MeshSpec(dp=1, tp=2), ranks=range(2))
be = gw.build(ls.sharded_lm_backend, spec_lm, mesh, form="gather", device="cpu")
R["gather"] = {"tokens": tokens(be.serve_files(paths)[0]),
               "replicate": be.server._gather_shardings.replicate}

# ---- the pp form, wired
pp_group = WorkerGroupSpec("pp0", ("H3", "H4"), MeshSpec(dp=1, tp=1, pp=2),
                           lm_models=(pp_spec["name"],))
gb, pf = wired(pp_group, "H3", pp_spec)
R["pp"] = {"tokens": tokens(asyncio.run(live(gb, "pp")(pp_spec["name"], paths))[0]),
           "engine": type(gb.lm_backend).__name__, "stage": gb.lm_backend.stage,
           "held": gb.lm_backend.held_bytes(), "capacity": gb.capacity}

# ---- the overlap form: two LM batches at once, beside two image calls on
# a TinyNet engine of the same world (one ordered channel for all four)
gb, _ = wired(tp_group, "H3", dict(spec_lm, overlap=True))
si = gw.build(ShardedInference, "TinyNet", mesh, batch_size=4, seed=0, dtype=torch.float32,
              param_gather=True, device="cpu")
imgs = np.random.RandomState(3).randint(0, 256, (6, 32, 32, 3)).astype(np.uint8)
lgb = live(gb, "resident")


async def overlap():
    return await asyncio.wait_for(asyncio.gather(
        lgb(model, paths[:2]), lgb(model, paths[1:]),
        asyncio.to_thread(si, imgs[:3]), asyncio.to_thread(si, imgs[3:])), 60)


a, b, p1, p2 = asyncio.run(overlap())
one = ShardedInference("TinyNet", None, batch_size=4, seed=0, dtype=torch.float32, device="cpu")
R["overlap"] = {"tokens": [tokens(a[0]), tokens(b[0])], "overlap": gb.lm_backend.overlap,
                "driver_tickets": gb.lm_backend.driver.tickets_served,
                "images_equal": bool(np.array_equal(np.concatenate([p1, p2]), one(imgs)))}
gb.lm_backend.close()

# ---- the disaggregated decode primary in a 4-node cluster: H1 leads, H2
# stands by, H3 decodes (rank 0 and its follower), H4 prefills
roles = WorkerGroupSpec("pd0", ("H3", "H4"), MeshSpec(dp=1, tp=2), lm_models=(model,),
                        roles={"H3": "decode", "H4": "prefill"})
single = LMBackend.from_spec(spec_lm, device="cpu")
wiring = {}


def make_jobs(node, store):
    gb, pf = ls.wire_lm_group(node, store, spec_lm, device="cpu")
    wiring[node.me.name] = (gb, pf)
    js = JobService(node, store)
    js.register_lm(model, backend=single.backend, cost=single.cost(), group_backend=gb,
                   prefill=pf)
    return js


async def disagg():
    c = LocalCluster(4, os.path.join(out_dir, "cluster"), base + 10,
                     timing=Timing(**cfg["timing"]), worker_groups=[roles], make_jobs=make_jobs)
    await c.start()
    try:
        await c.wait_for(c.converged, 30.0, "cluster convergence")
        gb = wiring["H3"][0]
        out = {"wiring": {k: (type(g).__name__ if g else None, type(p).__name__ if p else None)
                          for k, (g, p) in wiring.items()}}
        for form in ("stream", "slab"):
            gb.handoff = form
            h0, f0 = gb.handoffs, gb.fallbacks
            res, _, _ = await asyncio.wait_for(gb(model, paths), 60)
            out[form] = {"tokens": tokens(res), "handoffs": gb.handoffs - h0,
                         "fallbacks": gb.fallbacks - f0}
        gb.handoff = "stream"
        client = c.client(avoid=tuple(c.spec.group_members_unique("pd0")))
        for p in paths:
            await client.store.put(p, os.path.basename(p))
        h0 = gb.handoffs
        jid = await client.jobs.submit_job(model, len(paths))
        done = await asyncio.wait_for(client.jobs.wait_job(jid, timeout=60.0), 70)
        merged = await client.jobs.get_output(jid, os.path.join(out_dir, f"final_{jid}.json"))
        out["job"] = {"queries": done["total_queries"], "tokens": tokens(merged),
                      "handoffs": gb.handoffs - h0}
        return out
    finally:
        await c.stop()


R["disagg"] = asyncio.run(asyncio.wait_for(disagg(), 120))
single.close()
R["stats"] = world.stats()
world.close()
follower.wait(timeout=60)
R["follower_rc"] = follower.returncode
with open(os.path.join(out_dir, "primary.pkl"), "wb") as f:
    pickle.dump(R, f)
print("PRIMARY_OK", flush=True)
'''


class Session:
    """The two ranks' results, and JAX's `generate` beside them."""

    def __init__(self, out_dir):
        self.prompts = _prompts(N_PROMPTS)
        paths = []
        for i, p in enumerate(self.prompts):
            fp = str(out_dir / f"p{i}.tokens.txt")
            write_prompt_file(fp, p)
            paths.append(fp)
        self.base = free_port_block(24)
        spec = _weights_spec(SPEC, out_dir / "spec.msgpack")
        pp_spec = _weights_spec(PP_SPEC, out_dir / "pp.msgpack")
        (out_dir / "inputs.json").write_text(json.dumps({
            "spec": spec, "pp_spec": pp_spec, "paths": paths, "base": self.base,
            "timing": dict(ping_interval=0.2, ack_timeout=0.5, cleanup_time=1.5,
                           leader_rpc_timeout=10.0)}))
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
        (out_dir / "primary.py").write_text(PRIMARY)
        proc = subprocess.Popen([sys.executable, str(out_dir / "primary.py"), str(out_dir), TESTS],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
                                text=True)
        try:
            # JAX's tokens while the ranks run
            budget = SPEC["max_new_tokens"]
            self.want = {f"p{i}.tokens.txt": [int(t) for t in _expect(SPEC, p, budget)]
                         for i, p in enumerate(self.prompts)}
            self.want_pp = {f"p{i}.tokens.txt": [int(t) for t in _expect(PP_SPEC, p, budget)]
                            for i, p in enumerate(self.prompts)}
            out, _ = proc.communicate(timeout=SESSION_S)
        except BaseException:
            proc.kill()
            proc.communicate()
            raise
        finally:
            release_ports(self.base, 24)
        log = out_dir / "follower.log"
        follower_log = log.read_text() if log.exists() else ""
        assert proc.returncode == 0 and "PRIMARY_OK" in out, (
            f"primary rc {proc.returncode}:\n{out[-4000:]}\nfollower:\n{follower_log[-2000:]}")
        with open(out_dir / "primary.pkl", "rb") as f:
            self.r = pickle.load(f)
        self.follower_log = follower_log


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield Session(tmp_path_factory.mktemp("lm_group_world"))
    finally:
        torch.set_num_threads(n)


@pytest.mark.sharded
@pytest.mark.parametrize("form", ["resident", "gather"])
def test_tp2_forms_on_two_ranks_equal_jax_generate(session, form):
    """The weight-resident (wired) and param-gather tp-2 forms, built
    through the world and served on both ranks, give JAX's `generate`
    tokens exactly (float32 greedy)."""
    r = session.r[form]
    assert r["tokens"] == session.want
    assert r["replicate"] is (form == "gather")
    if form == "resident":
        assert r["engine"] == "LMBackend" and r["capacity"] == 2.0
        assert r["prefill"] is None and r["lender"]


@pytest.mark.sharded
def test_pp2_form_on_two_ranks_equals_jax_generate(session):
    """The wired pp-2 primary's pipeline over the world (stage 0 here,
    stage 1 on the follower) gives JAX's `generate` tokens; the primary
    holds its half of the blocks."""
    r = session.r["pp"]
    assert r["tokens"] == session.want_pp
    assert r["engine"] == "PipelinedLMBackend" and r["stage"] == 0 and r["capacity"] == 2.0
    assert 0 < r["held"]


@pytest.mark.sharded
def test_overlap_form_beside_image_calls_keeps_every_answer(session):
    """The LMDriver overlap form serves two batches at once while two image
    calls of another engine share the world's one ordered channel: the
    tokens are JAX's, the image rows the one-rank engine's bit for bit."""
    r = session.r["overlap"]
    names = sorted(session.want)
    assert r["overlap"] is True and r["driver_tickets"] >= 2
    assert r["tokens"][0] == {k: session.want[k] for k in names[:2]}
    assert r["tokens"][1] == {k: session.want[k] for k in names[1:]}
    assert r["images_equal"]


@pytest.mark.sharded
def test_disaggregated_primary_adopts_every_slab_on_both_ranks(session):
    """The disaggregated decode primary over the world, in a 4-node
    cluster with a prefill-role member: the streamed and the whole-slab
    handoffs adopt every request's slab (the adoption broadcast to the
    follower), tokens equal JAX's `generate`; a job through the cluster
    likewise."""
    d = session.r["disagg"]
    assert d["wiring"] == {"H1": (None, None), "H2": (None, None),
                           "H3": ("DisaggLMBackend", None), "H4": (None, "LMPrefillBackend")}
    for form in ("stream", "slab"):
        assert d[form]["tokens"] == session.want, form
        assert (d[form]["handoffs"], d[form]["fallbacks"]) == (N_PROMPTS, 0), form
    assert d["job"]["queries"] == N_PROMPTS and d["job"]["tokens"] == session.want
    assert d["job"]["handoffs"] == N_PROMPTS


@pytest.mark.sharded
def test_follower_ran_every_call_and_left_with_the_world(session):
    """The follower ran the primary's calls until the world closed, then
    exited 0; the world stayed whole throughout."""
    st = session.r["stats"]
    assert st["broken"] is None and st["backend"] == "gloo" and st["size"] == 2
    assert st["calls"] > 20 and st["builds"] >= 8 and st["array_bytes"] > 0
    assert session.r["follower_rc"] == 0
    assert f"world closed after {st['calls']} calls" in session.follower_log
