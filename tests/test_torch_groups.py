"""The port's worker-group backends against the JAX package's, on the CPU
and the same seeded weights:

- image groups (`jobs/groups.py`): `sharded_backend` over a
  ``param_gather`` `ShardedInference` on a world-1 mesh gives the port's
  one-device rows bit for bit, and the JAX `sharded_backend` at tp 2 the
  same wnids with scores within atol 1e-4 (float32 TinyNet, the JAX test
  model, `tests/_tinynet.py`, and its port counterpart from
  `test_torch_train`); `GroupDegraded` before and after the device
  call; `group_engine_backend` (the counterpart of `test_groups.py`'s
  two excluded cases): lazy builds of two models, one engine per
  (model, mesh), `set_variables` dropping that model's engines, the
  reform-ladder rung at reduced membership, `GroupDegraded` with no
  rung, and the typed RuntimeError of a mesh that needs more ranks than
  the world has; a grouped TinyNet job through a port `LocalCluster`
  equal to the one-device rows (the counterpart of
  `test_jobs_sim.py`'s excluded case);
- LM groups (the cluster half of `inference/lm_sharded.py`):
  `sharded_lm_group_backend` tokens equal to JAX's at tp 2 (float32,
  exact) and its degrade case; `DisaggLMBackend`'s adoption-failure
  fallback; `wire_lm_group`'s roles in both packages, and the port's
  refusal of a tp-2 or pp-2 group at world 1; the disaggregated path
  through a 4-node cluster of each package (both handoff forms, a
  failing tunnel, a crashed prefill member), tokens and handoff
  counters equal between the packages; and the stitched cross-node
  trace of a disaggregated request (the counterpart of
  `test_tracing.py`'s excluded case).

The port resolves a group mesh over the ranks of its own world (1 here:
torch.distributed is not initialized), so its groups run at dp 1 x tp 1
where JAX's run at tp 2; the JAX package's own tests hold its tp-2 runs
equal to one device. The two-rank forms are in `test_torch_lm_sharded.py`.
"""

from __future__ import annotations

import asyncio
import errno
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _tinynet import ensure_tinynet, ensure_tinynet2
from dml_tpu.config import MeshSpec as JaxMeshSpec
from dml_tpu.inference import lm_sharded as jls
from dml_tpu.jobs import groups as jg
from dml_tpu.parallel.mesh import make_mesh as jax_make_mesh
from dml_tpu_torch.config import MeshSpec, WorkerGroupSpec
from dml_tpu_torch.inference import lm_sharded as tls
from dml_tpu_torch.inference.lm_backend import LMBackend, lm_spec_parts, write_prompt_file
from dml_tpu_torch.jobs import groups as tg
from dml_tpu_torch.models.registry import MODEL_REGISTRY, CostDefaults, ModelSpec, register
from dml_tpu_torch.parallel.inference import ShardedInference
from dml_tpu_torch.parallel.mesh import make_mesh
from test_torch_cluster import free_port_block
from test_torch_lm_sharded import NEW_TOKENS, SPEC, _expect, _jax_parts, _prompts, _weights_spec
from test_torch_train import TinyNet as PortTinyNet

TIMING = dict(ping_interval=0.2, ack_timeout=0.3, cleanup_time=1.0, leader_rpc_timeout=10.0)


@pytest.fixture(autouse=True, scope="module")
def _tiny_models():
    """TinyNet and TinyNet2 in both registries (the port's counterpart
    class, as test_torch_train registers it); torch on 2 threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    ensure_tinynet()
    ensure_tinynet2()
    added = []
    for name, size in (("TinyNet", (32, 32)), ("TinyNet2", (24, 24))):
        if name.lower() not in MODEL_REGISTRY:
            register(ModelSpec(name=name, builder=PortTinyNet, input_size=size, preprocess="unit",
                               cost=CostDefaults(load_time=0.1, first_query=0.1, per_query=0.01,
                                                 default_batch_size=4)))
            added.append(name.lower())
    yield
    for k in added:
        MODEL_REGISTRY.pop(k, None)
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny_weights():
    """The JAX package's seeded TinyNet tree (float32, on the host)."""
    from dml_tpu.models.params_io import init_variables
    from dml_tpu.models.registry import get_model

    tree = init_variables(get_model("TinyNet"), seed=0, dtype=jnp.float32)
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    from PIL import Image

    d = tmp_path_factory.mktemp("group_jpegs")
    rng = np.random.RandomState(0)
    paths = []
    for i in range(3):
        p = str(d / f"ge_{i}.jpeg")
        Image.fromarray(rng.randint(0, 255, (40, 40, 3)).astype(np.uint8)).save(p)
        paths.append(p)
    return paths


def _world1():
    """The group mesh a world-1 process resolves (dp 1 x tp 1)."""
    return make_mesh(MeshSpec(dp=1, tp=1))


def _port_si(model, mesh, variables=None, param_gather=False, dtype=torch.float32, seed=0):
    return ShardedInference(model, mesh, batch_size=4, variables=variables, dtype=dtype,
                            seed=seed, param_gather=param_gather, device="cpu")


def _jax_si(mesh_spec, variables, param_gather=False):
    from dml_tpu.parallel.inference import ShardedInference as JaxSI

    n = mesh_spec.dp * mesh_spec.tp
    mesh = jax_make_mesh(mesh_spec, devices=jax.devices()[:n])
    return JaxSI("TinyNet", mesh, batch_size=4, variables=variables, dtype=jnp.float32,
                 param_gather=param_gather)


def _assert_close_rows(got, want):
    assert set(got) == set(want)
    for k in want:
        assert [r["wnid"] for r in got[k]] == [r["wnid"] for r in want[k]], k
        np.testing.assert_allclose([r["score"] for r in got[k]], [r["score"] for r in want[k]],
                                   atol=1e-4, rtol=0, err_msg=k)


class _Counting:
    """A ShardedInference that counts its forward calls."""

    def __init__(self, si):
        self.si, self.mesh, self.spec, self.calls = si, si.mesh, si.spec, 0

    def __call__(self, imgs):
        self.calls += 1
        return self.si(imgs)


# ----------------------------------------------------------------------
# image groups: sharded_backend
# ----------------------------------------------------------------------


@pytest.mark.sharded
def test_sharded_backend_rows_equal_one_device_and_jax(tiny_weights, jpegs):
    """The group backend over a param_gather engine on the world-1 group
    mesh serves the one-device rows bit for bit, and JAX's tp-2
    param_gather backend's wnids with scores within 1e-4; `model` and
    `capacity` are JAX's at the same mesh size."""
    members = ("a:1", "a:2")
    gb = tg.sharded_backend(_port_si("TinyNet", _world1(), tiny_weights, param_gather=True),
                            group_name="g", members=members, alive_fn=lambda: set(members))
    one = tg.sharded_backend(_port_si("TinyNet", None, tiny_weights))
    got, t, cost = asyncio.run(gb("TinyNet", jpegs))
    want, _, _ = asyncio.run(one("TinyNet", jpegs))
    assert got == want and t > 0 and cost is None
    jgb = jg.sharded_backend(_jax_si(JaxMeshSpec(dp=1, tp=2), tiny_weights, param_gather=True),
                             group_name="g", members=members, alive_fn=lambda: set(members))
    jone = jg.sharded_backend(_jax_si(JaxMeshSpec(dp=1, tp=1), tiny_weights))
    jgot, _, _ = asyncio.run(jgb("TinyNet", jpegs))
    _assert_close_rows(got, jgot)
    assert gb.model == one.model == jgb.model == "TinyNet"
    assert gb.capacity == one.capacity == jone.capacity == 1.0 and jgb.capacity == 2.0
    assert gb.group_name == jgb.group_name == "g" and one.group_name is None


@pytest.mark.sharded
def test_sharded_backend_degrades_before_and_after_the_call(tiny_weights, jpegs):
    """A member dead before the batch raises GroupDegraded before any
    forward; one that dies during the forward raises after it (the
    result of a broken mesh is never acked)."""
    si = _Counting(_port_si("TinyNet", _world1(), tiny_weights, param_gather=True))
    members = ("a:1", "a:2")
    dead = tg.sharded_backend(si, group_name="g", members=members, alive_fn=lambda: {"a:1"})
    with pytest.raises(tg.GroupDegraded, match=r"lost member\(s\) \['a:2'\]"):
        asyncio.run(dead("TinyNet", jpegs))
    assert si.calls == 0
    views = iter([set(members), {"a:2"}])
    dying = tg.sharded_backend(si, group_name="g", members=members, alive_fn=lambda: next(views))
    with pytest.raises(tg.GroupDegraded, match=r"\['a:1'\]"):
        asyncio.run(dying("TinyNet", jpegs))
    assert si.calls == 1


# ----------------------------------------------------------------------
# image groups: group_engine_backend
# ----------------------------------------------------------------------


@pytest.mark.sharded
def test_group_engine_backend_lazy_models_and_set_variables(tiny_weights, jpegs):
    """Lazy per-model param_gather engines, one per (model, mesh), built
    at the first batch and reused; capacity from the chip-count prior to
    the resolved mesh; rows bit-equal to the one-device engine on the
    same seed; `set_variables` drops that model's engines only, and the
    rebuilt engine serves the given tree: the one-device rows on it,
    and JAX's tp-2 group engine's wnids on the same tree."""
    members = ("a:1", "a:2")
    be = tg.group_engine_backend("g", members, lambda: set(members), MeshSpec(dp=1, tp=1),
                                 batch_size=4, device="cpu")
    assert be.model is None and be.capacity == 2.0 and be.engines == {}
    seeded, t, _ = asyncio.run(be("TinyNet", jpegs))
    assert t > 0 and be.capacity == 1.0  # dp 1 x tp 1, resolved
    key = ("TinyNet", (1, 1, 1))
    assert list(be.engines) == [key]
    si = be.engines[key]
    assert si.param_gather and si.device.type == "cpu" and si.dtype == torch.bfloat16
    one = tg.sharded_backend(_port_si("TinyNet", None, dtype=torch.bfloat16))
    assert seeded == asyncio.run(one("TinyNet", jpegs))[0]
    asyncio.run(be("TinyNet", jpegs))
    assert be.engines[key] is si  # cached, not rebuilt
    asyncio.run(be("TinyNet2", jpegs))
    assert set(be.engines) == {key, ("TinyNet2", (1, 1, 1))}
    be.set_variables("TinyNet", tiny_weights)
    assert set(be.engines) == {("TinyNet2", (1, 1, 1))}
    loaded, _, _ = asyncio.run(be("TinyNet", jpegs))
    assert be.engines[key] is not si and loaded != seeded
    one_w = tg.sharded_backend(_port_si("TinyNet", None, tiny_weights, dtype=torch.bfloat16))
    assert loaded == asyncio.run(one_w("TinyNet", jpegs))[0]
    jbe = jg.group_engine_backend("g", members, lambda: set(members), JaxMeshSpec(dp=1, tp=2),
                                  batch_size=4)
    jbe.set_variables("TinyNet", tiny_weights)
    jgot, _, _ = asyncio.run(jbe("TinyNet", jpegs))
    assert jbe.capacity == 2.0 and jbe.model is None
    for k in jgot:  # bf16 on both sides: the top-1 class
        assert loaded[k][0]["wnid"] == jgot[k][0]["wnid"], k


@pytest.mark.sharded
def test_group_engine_backend_reform_rung_and_degraded(tiny_weights, jpegs):
    """At full membership a -1 axis fills the world; with 2 of 3 members
    the batch asks for the reform ladder's rung (dp 2, JAX's rung too),
    which a world of 1 cannot hold: the typed RuntimeError at the batch;
    with 1 of 3 there is no rung: GroupDegraded."""
    members = ("a:1", "a:2", "a:3")
    alive = set(members)
    spec = MeshSpec(dp=-1, tp=1)
    be = tg.group_engine_backend("g", members, lambda: set(alive), spec, batch_size=4,
                                 device="cpu")
    be.set_variables("TinyNet", tiny_weights)
    asyncio.run(be("TinyNet", jpegs))
    assert list(be.engines) == [("TinyNet", (-1, 1, 1))] and be.capacity == 1.0
    alive.discard("a:3")
    rung = {"dp": 2, "tp": 1, "pp": 1}
    assert tg.reform_ladder(spec, 3, 2) == rung == jg.reform_ladder(JaxMeshSpec(dp=-1, tp=1), 3, 2)
    with pytest.raises(RuntimeError, match=r"^group g mesh needs 2 ranks, host sees 1$"):
        asyncio.run(be("TinyNet", jpegs))
    assert list(be.engines) == [("TinyNet", (-1, 1, 1))]
    alive.discard("a:2")
    with pytest.raises(tg.GroupDegraded, match="1 live member"):
        asyncio.run(be("TinyNet", jpegs))


@pytest.mark.sharded
def test_group_mesh_larger_than_the_world_raises_at_the_first_batch(jpegs):
    """A tp-2 group engine at world 1 is built (the spec may be wired on
    any node) but refuses its first batch with JAX's RuntimeError, "ranks"
    for devices; it never serves on one device in silence."""
    members = ("a:1", "a:2")
    be = tg.group_engine_backend("g", members, lambda: set(members), MeshSpec(dp=1, tp=2),
                                 device="cpu")
    assert be.capacity == 2.0
    with pytest.raises(RuntimeError, match=r"^group g mesh needs 2 ranks, host sees 1$"):
        asyncio.run(be("TinyNet", jpegs))
    assert be.engines == {}
    with pytest.raises(RuntimeError, match="needs 4 ranks"):
        tg.group_ranks("g", MeshSpec(dp=2, tp=2))
    assert tg.group_ranks("g", MeshSpec(dp=1, tp=1)) == range(1)
    assert tg.group_ranks("g", MeshSpec(dp=-1, tp=1)) is None


# ----------------------------------------------------------------------
# clusters
# ----------------------------------------------------------------------


async def _start(make_cluster):
    """A started cluster on a probed port block (retried when another
    process took a port between the probe and the bind)."""
    for attempt in range(3):
        cluster = make_cluster(free_port_block(8))
        try:
            await cluster.start()
            await cluster.wait_for(cluster.converged, 30.0, "cluster convergence")
            return cluster
        except OSError as e:
            await cluster.stop()
            if e.errno != errno.EADDRINUSE or attempt == 2:
                raise


@pytest.mark.sharded
def test_group_sharded_serving_outputs_equal_single_chip(tmp_path, tiny_weights):
    """A TinyNet job served by the worker group through a port cluster
    (store fetch -> the group primary's param_gather engine -> output PUT
    -> get_output merge) equals the one-device rows, row for row. Four
    nodes: H1 leads and H2 is the standby, so the pool is exactly the
    collapsed group {H3}: every batch runs on the group engine."""
    from PIL import Image

    from dml_tpu_torch.cluster.chaos import LocalCluster
    from dml_tpu_torch.config import Timing
    from dml_tpu_torch.jobs.service import JobService
    from dml_tpu_torch.observability import METRICS

    si_g = _port_si("TinyNet", _world1(), tiny_weights, param_gather=True)
    si_1 = _port_si("TinyNet", None, tiny_weights)
    group = WorkerGroupSpec("tp0", ("H3", "H4"), MeshSpec(dp=1, tp=1))
    root = str(tmp_path / "sharded_sim")
    os.makedirs(root)

    def make(base):
        return LocalCluster(
            4, root, base, timing=Timing(**TIMING), worker_groups=[group],
            make_jobs=lambda node, store: tg._make_sharded_jobs(
                node, store, JobService, si_g, si_1, group, (32, 32), "TinyNet", 4))

    async def run():
        c = await _start(make)
        try:
            client = c.client()
            rng = np.random.RandomState(0)
            files = []
            for i in range(3):
                p = str(tmp_path / f"real_{i}.jpeg")
                Image.fromarray(rng.randint(0, 255, (40, 40, 3)).astype(np.uint8)).save(p)
                await client.store.put(p, f"real_{i}.jpeg")
                files.append((f"real_{i}.jpeg", p))
            key = "jobs_group_batches_total{group=tp0}"
            before = METRICS.snapshot()["counters"].get(key, 0.0)
            job_id = await client.jobs.submit_job("TinyNet", 6)
            done = await client.jobs.wait_job(job_id, timeout=60.0)
            assert done["total_queries"] == 6
            merged = await client.jobs.get_output(job_id, str(tmp_path / "final_sharded.json"))
            gstats = c.nodes[c.leader_uname()].jobs.group_stats()["tp0"]
            assert gstats["formed"], gstats
            assert METRICS.snapshot()["counters"].get(key, 0.0) - before == 2  # 6 queries, b4
            single = tg.sharded_backend(si_1, input_size=(32, 32))
            for sdfs, local in files:
                exp, _, _ = await single("TinyNet", [local])
                assert merged[sdfs] == exp[local], sdfs
        finally:
            await c.stop()

    asyncio.run(asyncio.wait_for(run(), timeout=120.0))


# ----------------------------------------------------------------------
# LM groups
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def lm_spec(tmp_path_factory):
    """SPEC with the JAX package's seeded tree as its weights file."""
    return _weights_spec(SPEC, tmp_path_factory.mktemp("group_lm") / "spec.msgpack")


def _prompt_files(d, prompts):
    paths = []
    for i, p in enumerate(prompts):
        fp = str(d / f"p{i}.tokens.txt")
        write_prompt_file(fp, p)
        paths.append(fp)
    return paths


@pytest.mark.sharded
def test_sharded_lm_group_backend_tokens_and_degrade(tmp_path, lm_spec):
    """The LM group backend over the resident form at world 1 serves
    JAX's tp-2 group backend's tokens (float32, exact, and JAX's
    generate's); a dead member raises GroupDegraded."""
    paths = _prompt_files(tmp_path, _prompts())
    alive = {"a", "b"}
    be = tls.sharded_lm_backend(lm_spec, _world1(), form="resident", device="cpu")
    gb = tls.sharded_lm_group_backend(be, model_name="ShardLM", group_name="g0",
                                      members=("a", "b"), alive_fn=lambda: set(alive),
                                      capacity=2.0)
    jmesh = jax_make_mesh(JaxMeshSpec(dp=1, tp=2), devices=jax.devices()[:2])
    jbe = jls.sharded_lm_backend(SPEC, jmesh, form="resident")
    jgb = jls.sharded_lm_group_backend(jbe, model_name="ShardLM", group_name="g0",
                                       members=("a", "b"), alive_fn=lambda: {"a", "b"},
                                       capacity=2.0)
    try:
        assert (gb.model, gb.capacity, gb.group_name) == (jgb.model, jgb.capacity, "g0")
        assert gb.lm_backend is be
        got, t, cost = asyncio.run(gb("ShardLM", paths))
        want, _, _ = asyncio.run(jgb("ShardLM", paths))
        assert t > 0 and cost["per_query"] > 0
        for fp, p in zip(paths, _prompts()):
            assert got[fp]["tokens"] == want[fp]["tokens"], fp
            np.testing.assert_array_equal(got[fp]["tokens"], _expect(SPEC, p, NEW_TOKENS))
        alive.discard("b")
        with pytest.raises(tg.GroupDegraded):
            asyncio.run(gb("ShardLM", paths))
    finally:
        be.close()
        jbe.close()


def _bare_disagg(mod, be):
    """A DisaggLMBackend without a node (the JAX test's construction)."""
    gb = mod.DisaggLMBackend.__new__(mod.DisaggLMBackend)
    gb.be = be
    gb.model, gb.group_name, gb.members, gb.alive_fn = "ShardLM", "g0", (), None
    gb.handoff, gb.fanout, gb.prefill_timeout, gb.last_ttft_s = "slab", 0, 5.0, None
    gb.handoffs = gb.fallbacks = gb.handoff_bytes = gb.warm_locals = 0
    return gb


@pytest.mark.disagg
def test_disagg_adoption_failure_falls_back(tmp_path, lm_spec, monkeypatch):
    """A slab that arrives but cannot be adopted (its first layer's rows
    have the wrong length) demotes exactly that request to a local
    prefill while its siblings adopt; tokens are JAX's generate's, and
    the counters and tokens are the JAX backend's for the same case."""
    paths = _prompt_files(tmp_path, _prompts())
    out = {}
    for name, mod in (("port", tls), ("jax", jls)):
        if name == "port":
            params, cfg = lm_spec_parts(lm_spec, device="cpu")
            from dml_tpu_torch.inference.lm_backend import LMBackend as B

            def bad_rows(k):
                return torch.zeros((cfg.kv_heads, 1, cfg.head_dim), dtype=k.dtype)
        else:
            from dml_tpu.inference.lm_backend import LMBackend as B

            params, cfg = _jax_parts(SPEC)

            def bad_rows(k):
                return np.zeros((cfg.kv_heads, 1, cfg.head_dim), k.dtype)
        be = B(params, cfg, max_new_tokens=NEW_TOKENS, max_slots=2, max_len=64, chunk=4)
        be.overlap = False
        gb = _bare_disagg(mod, be)
        pf = mod.LMPrefillBackend(params, cfg, max_len=64)

        async def bad_share(peer, model, idxs, ps, budgets, arrivals, ctxs=None, pf=pf,
                            bad_rows=bad_rows):
            slabs = [pf.prefill_one(ps[i], budgets[i]) for i in idxs]
            slabs[0]["rows"]["block_0"]["k"] = bad_rows(slabs[0]["rows"]["block_0"]["k"])
            for i, entry in zip(idxs, slabs):
                arrivals.put_nowait((i, entry))

        monkeypatch.setattr(gb, "_prefill_peers", lambda: ["peer0"])
        monkeypatch.setattr(gb, "_pull_share_slab", bad_share)
        results, _, _ = asyncio.run(gb("ShardLM", paths))
        out[name] = (results, gb.fallbacks, gb.handoffs)
        be.close()
    results, fallbacks, handoffs = out["port"]
    assert (fallbacks, handoffs) == (1, len(paths) - 1) == out["jax"][1:]
    for fp, p in zip(paths, _prompts()):
        assert results[fp]["tokens"] == out["jax"][0][fp]["tokens"], fp
        np.testing.assert_array_equal(results[fp]["tokens"], _expect(SPEC, p, NEW_TOKENS))


def _roles_view(pkg, tmp, spec_lm, mesh, **kw):
    """{node name: (group backend, prefill backend)} of `wire_lm_group`
    for H3-H5 of a 5-node spec whose group tp0 = H4 (decode) + H5
    (prefill) declares ShardLM, in one package."""
    if pkg == "jax":
        from dml_tpu.cluster.node import Node
        from dml_tpu.cluster.store_service import StoreService
        from dml_tpu.config import ClusterSpec, StoreConfig
        from dml_tpu.config import WorkerGroupSpec as W

        wire = jls.wire_lm_group
    else:
        from dml_tpu_torch.cluster.node import Node
        from dml_tpu_torch.cluster.store_service import StoreService
        from dml_tpu_torch.config import ClusterSpec, StoreConfig
        from dml_tpu_torch.config import WorkerGroupSpec as W

        def wire(node, store, s):
            return tls.wire_lm_group(node, store, s, device="cpu")

    base = free_port_block(5)
    spec = ClusterSpec.localhost(
        5, base_port=base, introducer_port=base - 1,
        store=StoreConfig(root=os.path.join(tmp, "roots"), download_dir=os.path.join(tmp, "dl")),
        worker_groups=[W("tp0", ("H4", "H5"), mesh, lm_models=("ShardLM",),
                         roles={"H4": "decode", "H5": "prefill"}, **kw)])
    out = {}
    for name in ("H3", "H4", "H5"):
        nid = spec.node_by_name(name)
        node = Node(spec, nid)
        out[name] = wire(node, StoreService(node, root=os.path.join(tmp, f"st_{name}")), spec_lm)
    node = Node(spec, spec.node_by_name("H4"))
    out["other"] = wire(node, StoreService(node, root=os.path.join(tmp, "st_x")),
                        {**spec_lm, "name": "OtherLM"})
    return out


@pytest.mark.sharded
def test_wire_lm_group_roles(tmp_path, lm_spec):
    """The decode primary of a role-split group gets the disaggregated
    backend over the resident engine, the prefill member the prefill
    backend, the others neither, and a model the group does not declare
    wires nothing; both packages alike on one spec (dp 1 x tp 1)."""
    views = {}
    for pkg, mesh, spec_lm in (("port", MeshSpec(dp=1, tp=1), lm_spec),
                               ("jax", JaxMeshSpec(dp=1, tp=1), SPEC)):
        views[pkg] = _roles_view(pkg, str(tmp_path / pkg), spec_lm, mesh)
    for pkg, mod in (("port", tls), ("jax", jls)):
        v = views[pkg]
        gb4, pf4 = v["H4"]
        assert isinstance(gb4, mod.DisaggLMBackend) and pf4 is None, pkg
        assert (gb4.model, gb4.capacity, gb4.group_name, gb4.handoff) == (
            "ShardLM", 1.0, "tp0", "stream")
        assert gb4.lm_backend.server.max_slots == SPEC["max_slots"]
        gb5, pf5 = v["H5"]
        assert gb5 is None and isinstance(pf5, mod.LMPrefillBackend), pkg
        assert pf5.max_len == SPEC["max_len"] and pf5.draft is None
        assert v["H3"] == v["other"] == (None, None), pkg
    port = views["port"]
    assert port["H4"][0].lm_backend.server.device.type == "cpu"
    assert port["H5"][1].params["embed"]["embedding"].device.type == "cpu"
    port["H4"][0].be.close()


@pytest.mark.sharded
def test_wire_lm_group_refuses_a_mesh_larger_than_the_world(tmp_path, lm_spec):
    """A tp-2 or pp-2 group at world 1 refuses to wire its primary with
    JAX's RuntimeError ("ranks" for devices); the prefill member, which
    holds no mesh, still wires."""
    with pytest.raises(RuntimeError, match=r"^group tp0 mesh needs 2 ranks, host sees 1$"):
        _roles_view("port", str(tmp_path / "tp2"), lm_spec, MeshSpec(dp=1, tp=2))
    with pytest.raises(RuntimeError, match="needs 2 ranks"):
        _roles_view("port", str(tmp_path / "pp2"), lm_spec, MeshSpec(dp=1, tp=1, pp=2))


# ----------------------------------------------------------------------
# the disaggregated path through a cluster of each package
# ----------------------------------------------------------------------


async def _disagg_cluster(pkg, tmp, tspec):
    """One package's disaggregated LM path through a 4-node LocalCluster:
    group tp0 = H3 (decode primary) + H4 (prefill), so the pool is
    exactly {H3} and every batch runs on the DisaggLMBackend. The plan:
    a job of 8 queries over 4 prompts (stream form); the 4 prompts in
    the slab form; both forms under a failing data plane on the decode
    side; a slow data plane; H4 crashed. Returns the tokens and the
    counters after each step."""
    if pkg == "jax":
        from dml_tpu.cluster.chaos import LocalCluster
        from dml_tpu.cluster.store.data_plane import TunnelFault
        from dml_tpu.config import MeshSpec as M
        from dml_tpu.config import Timing
        from dml_tpu.config import WorkerGroupSpec as W
        from dml_tpu.inference.lm_backend import LMBackend as B
        from dml_tpu.jobs.groups import GroupDegraded
        from dml_tpu.jobs.service import JobService
        from dml_tpu.observability import METRICS

        mod = jls
        params, cfg = _jax_parts(SPEC)
        be_dis = jls.sharded_lm_backend(
            SPEC, jax_make_mesh(JaxMeshSpec(dp=1, tp=2), devices=jax.devices()[:2]))
        mesh = M(dp=1, tp=2)
    else:
        from dml_tpu_torch.cluster.chaos import LocalCluster
        from dml_tpu_torch.cluster.store.data_plane import TunnelFault
        from dml_tpu_torch.config import MeshSpec as M
        from dml_tpu_torch.config import Timing
        from dml_tpu_torch.config import WorkerGroupSpec as W
        from dml_tpu_torch.inference.lm_backend import LMBackend as B
        from dml_tpu_torch.jobs.groups import GroupDegraded
        from dml_tpu_torch.jobs.service import JobService
        from dml_tpu_torch.observability import METRICS

        mod = tls
        params, cfg = lm_spec_parts(tspec, device="cpu")
        be_dis = tls.sharded_lm_backend(tspec, _world1(), device="cpu")
        mesh = M(dp=1, tp=1)
    be_single = B(params, cfg, max_new_tokens=NEW_TOKENS, max_slots=2, max_len=64, chunk=4)
    prefill_be = mod.LMPrefillBackend(params, cfg, max_len=64)
    group = W("tp0", ("H3", "H4"), mesh, lm_models=("ShardLM",),
              roles={"H3": "decode", "H4": "prefill"})
    holder = {}

    def make_jobs(node, store):
        js = JobService(node, store)
        members = node.spec.group_members_unique(group.name)
        gb = None
        if members and node.me.unique_name == members[0]:
            gb = mod.DisaggLMBackend(
                be_dis, model_name="ShardLM", group_name=group.name, node=node, store=store,
                members=members, capacity=2.0,
                alive_fn=lambda: {n.unique_name for n in node.membership.alive_nodes()})
            holder.update(gb=gb, store=store, node=node)
        js.register_lm("ShardLM", backend=be_single.backend, cost=be_single.cost(),
                       prefill=prefill_be, group_backend=gb)
        return js

    def make(base):
        return LocalCluster(4, tmp, base, timing=Timing(**TIMING), worker_groups=[group],
                            make_jobs=make_jobs)

    out = {"steps": []}
    cluster = await _start(make)
    try:
        gb = holder["gb"]
        members = cluster.spec.group_members_unique(group.name)
        client = cluster.client(avoid=tuple(members))
        rng = np.random.RandomState(1)
        paths, names = [], []
        for i in range(4):
            prompt = rng.randint(0, SPEC["vocab_size"], int(rng.randint(4, 20)))
            fname = f"p{i}.tokens.txt"
            p = os.path.join(tmp, fname)
            write_prompt_file(p, prompt)
            await client.store.put(p, fname)
            paths.append(p)
            names.append(fname)
        c_handoff = METRICS.counter("jobs_kv_handoff_total")
        fb0 = c_handoff.value(result="fallback")

        def note(step, results):
            out["steps"].append({"step": step, "handoffs": gb.handoffs,
                                 "fallbacks": gb.fallbacks, "warm": gb.warm_locals,
                                 "bytes": gb.handoff_bytes > 0})
            out[step] = {os.path.basename(k): list(v["tokens"]) for k, v in results.items()}

        job_id = await client.jobs.submit_job("ShardLM", 8)
        done = await client.jobs.wait_job(job_id, timeout=120.0)
        assert done["total_queries"] == 8
        note("job", await client.jobs.get_output(job_id, os.path.join(tmp, "out.json")))
        gb.handoff = "slab"
        note("slab", (await gb("ShardLM", paths))[0])
        holder["store"].data_plane.fault = TunnelFault(seed=3, fail_pct=100.0)
        for form in ("slab", "stream"):
            gb.handoff = form
            note(f"tunnel_fail_{form}", (await gb("ShardLM", paths))[0])
        holder["store"].data_plane.fault = TunnelFault(seed=4, delay_s=0.05)
        note("tunnel_slow", (await gb("ShardLM", paths))[0])
        holder["store"].data_plane.fault = None
        assert gb.last_ttft_s is not None and gb.last_ttft_s > 0
        out["fallback_metric"] = c_handoff.value(result="fallback") - fb0
        await cluster.crash_node(members[1])
        await cluster.wait_for(
            lambda: members[1] not in {n.unique_name
                                       for n in holder["node"].membership.alive_nodes()},
            30.0, "prefill member seen dead")
        with pytest.raises(GroupDegraded):
            await gb("ShardLM", paths)
        out["names"] = names
    finally:
        await cluster.stop()
        be_single.close()
        be_dis.close()
    return out


@pytest.fixture(scope="module")
def disagg_runs(tmp_path_factory, lm_spec):
    runs = {}
    for pkg in ("port", "jax"):
        tmp = str(tmp_path_factory.mktemp(f"disagg_{pkg}"))
        runs[pkg] = asyncio.run(asyncio.wait_for(_disagg_cluster(pkg, tmp, lm_spec), 150.0))
    return runs


@pytest.mark.sharded
@pytest.mark.disagg
def test_disagg_cluster_tokens_equal_jax_and_generate(disagg_runs):
    """Every step's tokens (the job through the pipeline, the slab form,
    both forms under a failing tunnel, a slow tunnel) equal JAX's run of
    the same plan, which equal isolated generate() per prompt."""
    port, jax_run = disagg_runs["port"], disagg_runs["jax"]
    steps = [s["step"] for s in port["steps"]]
    assert steps == [s["step"] for s in jax_run["steps"]]
    rng = np.random.RandomState(1)
    expected = {}
    for i in range(4):
        prompt = rng.randint(0, SPEC["vocab_size"], int(rng.randint(4, 20)))
        expected[f"p{i}.tokens.txt"] = list(_expect(SPEC, prompt, NEW_TOKENS))
    for step in steps:
        assert port[step] == jax_run[step], step
        assert set(port[step]) == set(expected), step
        for name, toks in port[step].items():
            assert toks == expected[name], (step, name)


@pytest.mark.sharded
@pytest.mark.disagg
def test_disagg_cluster_handoffs_and_fallbacks_equal_jax(disagg_runs):
    """The handoff counters after each step are JAX's for the same plan:
    the job's 8 requests all adopted from the prefill member, the slab
    form's 4, a failing tunnel demoting exactly its 4 requests in each
    form (the fallback metric ticking once per request), a slow tunnel
    still adopting all 4."""
    port, jax_run = disagg_runs["port"], disagg_runs["jax"]
    assert port["steps"] == jax_run["steps"]
    want = [(8, 0), (12, 0), (12, 4), (12, 8), (16, 8)]
    assert [(s["handoffs"], s["fallbacks"]) for s in port["steps"]] == want
    assert all(s["bytes"] and s["warm"] == 0 for s in port["steps"])
    assert port["fallback_metric"] == jax_run["fallback_metric"] == 8


@pytest.mark.tracing
@pytest.mark.disagg
def test_disagg_ingress_request_yields_full_stitched_trace(tmp_path):
    """One sampled per-request submit through the disaggregated LM path
    of a port cluster yields one cross-node trace covering admission ->
    formation -> dispatch -> fetch -> prefill -> handoff -> decode ->
    infer -> put -> result, exported in Chrome trace format (the
    counterpart of test_tracing.py's case, at dp 1 x tp 1)."""
    from dml_tpu_torch.cluster.chaos import LocalCluster
    from dml_tpu_torch.config import Timing
    from dml_tpu_torch.jobs.service import JobService
    from dml_tpu_torch.tracing import TRACER, chrome_trace, trace_covers

    spec = dict(SPEC)
    params, cfg = lm_spec_parts(spec, device="cpu")
    be_dis = tls.sharded_lm_backend(spec, _world1(), form="resident", device="cpu")
    be_single = LMBackend(params, cfg, max_new_tokens=8, max_slots=2, max_len=64, chunk=4)
    prefill_be = tls.LMPrefillBackend(params, cfg, max_len=64)
    group = WorkerGroupSpec("tp0", ("H3", "H4"), MeshSpec(dp=1, tp=1), lm_models=("ShardLM",),
                            roles={"H3": "decode", "H4": "prefill"})

    def make_jobs(node, store):
        js = JobService(node, store)
        members = node.spec.group_members_unique(group.name)
        gb = None
        if members and node.me.unique_name == members[0]:
            gb = tls.DisaggLMBackend(
                be_dis, model_name="ShardLM", group_name=group.name, node=node, store=store,
                members=members, capacity=2.0,
                alive_fn=lambda: {n.unique_name for n in node.membership.alive_nodes()})
        js.register_lm("ShardLM", backend=be_single.backend, cost=be_single.cost(),
                       prefill=prefill_be, group_backend=gb)
        return js

    root = str(tmp_path / "disagg_trc")
    os.makedirs(root)

    def make(base):
        return LocalCluster(4, root, base, with_ingress=True, timing=Timing(**TIMING),
                            worker_groups=[group], make_jobs=make_jobs)

    def no_orphans(spans):
        sids = {d["sid"] for d in spans}
        return all((d.get("par") or "") in sids or not d.get("par") for d in spans)

    async def run():
        cluster = await _start(make)
        try:
            client = cluster.client()
            p = os.path.join(root, "p0.tokens.txt")
            write_prompt_file(p, np.random.RandomState(1).randint(0, SPEC["vocab_size"], 9))
            await client.store.put(p, "p0.tokens.txt")
            term = await client.ingress.request("ShardLM", store_name="p0.tokens.txt",
                                                timeout=60.0)
            assert term["ok"] and term["trace_id"]
            leader = cluster.nodes[cluster.leader_uname()]
            view = await leader.node.pull_cluster_traces(max_spans=2048)
            spans = view["traces"].get(term["trace_id"])
            assert spans, "disagg request's trace not collected"
            assert trace_covers(spans, (
                "request", "admission", "formation", "dispatch", "fetch", "prefill",
                "handoff", "decode", "infer", "put", "result",
            )), sorted({d["name"] for d in spans})
            assert no_orphans(spans)
            assert len({d["node"] for d in spans}) >= 3  # router, decode primary, prefill
            doc = chrome_trace(spans)
            assert any(e["ph"] == "X" and e["name"] == "handoff" for e in doc["traceEvents"])
        finally:
            await cluster.stop()
            be_single.close()
            be_dis.close()

    saved = (TRACER.sample_rate, TRACER.seed, TRACER.span_budget)
    TRACER.configure(sample_rate=1.0, seed=0, span_budget=4096)
    TRACER.reset()
    try:
        asyncio.run(asyncio.wait_for(run(), timeout=120.0))
    finally:
        TRACER.configure(sample_rate=saved[0], seed=saved[1], span_budget=saved[2])
        TRACER.reset()
