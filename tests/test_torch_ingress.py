"""The port's request front door (`ingress/`: router, load generator,
token streaming) on the port's `chaos.LocalCluster`.

- The JAX package's own cases of test_ingress, run against the port
  (`test_torch_cluster.port_cases`, every cluster on a probed block in
  50000-54999). Left out: the case that needs `dml_tpu.tools.
  claim_check` (the tools are ROADMAP A8; `port_cases` drops it by
  itself).
- The two packages on one seeded script: `open_loop_trace`,
  `diurnal_trace` and `multi_turn_trace` give equal arrivals, `summarize`
  an equal scorecard, and `BatchFormer` the same batches.
- The slice as a whole, on the CPU: a 3-node JAX `LocalCluster` and a
  3-node port `LocalCluster`, both with the front door, serving a narrow
  ResNet (float32, the same weights) and a tiny float32 LM (the same
  weights) behind the routers: 8 pinned image requests and 2 sessions x
  2 streamed turns. Top-5 labels equal, scores within atol 1e-4
  (test_torch_engine's bar); streamed and final tokens equal exactly.
"""

from __future__ import annotations

import asyncio
import os
import random
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dml_tpu.ingress import loadgen as jload
from dml_tpu.ingress import router as jrouter
from dml_tpu.ingress.slo import DEFAULT_CLASSES as JCLASSES
from dml_tpu_torch.ingress import loadgen as tload
from dml_tpu_torch.ingress import router as trouter
from dml_tpu_torch.ingress.slo import DEFAULT_CLASSES as TCLASSES

from test_torch_cluster import JOIN_SPAN, TESTS, free_port_block, port_cases, release_ports
from test_torch_models import jax_init, perturb_bn

globals().update(port_cases("test_ingress", "ingress", probe_ports=True))

#: the case of test_ingress that needs the tools (ROADMAP A8)
TOOLS_CASES = {"claim_check_request_block"}


def test_port_cases_cover_each_file():
    with open(os.path.join(TESTS, "test_ingress.py"), encoding="utf-8") as f:
        want = set(re.findall(r"^(?:async )?def test_(\w+)", f.read(), re.M))
    got = {k[len("ingress") + 6:] for k in globals() if k.startswith("test_ingress_")}
    assert got == want - TOOLS_CASES, sorted(want - got)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------------------
# the two packages on one seeded script
# ----------------------------------------------------------------------


@pytest.mark.parametrize("seed", [1, 7, 23])
def test_traces_equal_across_packages(seed):
    kw = dict(slo_mix={"interactive": 0.6, "batch": 0.3, "train": 0.1},
              session_pct=30.0, n_sessions=5, stream_pct=20.0)
    for a, b in (
            (jload.open_loop_trace(seed, 6.0, 25.0, model="m", **kw),
             tload.open_loop_trace(seed, 6.0, 25.0, model="m", **kw)),
            (jload.diurnal_trace(seed, 20.0, 2.0, 40.0, model="m", **kw),
             tload.diurnal_trace(seed, 20.0, 2.0, 40.0, model="m", **kw)),
            (jload.multi_turn_trace(seed, 4, 3, "lm", slo="batch", suffix_len=16,
                                    vocab=32000, budget=32),
             tload.multi_turn_trace(seed, 4, 3, "lm", slo="batch", suffix_len=16,
                                    vocab=32000, budget=32))):
        assert len(a.arrivals) > 10
        assert [vars(x) for x in a.arrivals] == [vars(x) for x in b.arrivals]
        assert a.to_json() == b.to_json()


def _outcomes(pkg, seed):
    rng = random.Random(seed)
    out = []
    for i in range(60):
        terminal = rng.choice(["completed"] * 6 + ["shed", "rejected", "lost"])
        done = terminal == "completed"
        out.append(pkg.Outcome(
            slo=rng.choice(["interactive", "batch"]), terminal=terminal,
            e2e_s=rng.uniform(0.01, 2.0) if done else None,
            deadline_met=done and rng.random() < 0.8, model="m",
            turn=rng.randrange(0, 4), ttft_s=rng.uniform(0.005, 0.5) if done else None,
            tpot_s=rng.uniform(0.001, 0.02) if done and rng.random() < 0.5 else None,
            stages={"formation": rng.uniform(0, 0.1), "infer": rng.uniform(0, 1)} if done else None,
            trace_id=f"t{i}"))
    return out


def test_summarize_equal_across_packages():
    j = jload.summarize(_outcomes(jload, 5), 12.5)
    t = tload.summarize(_outcomes(tload, 5), 12.5)
    assert j["by_turn"] and j["p99_attribution"] and j == t


def _former_script(router, classes, seed):
    """Seeded adds and `due` calls on one BatchFormer under an injected
    clock; every formed batch in order."""
    rng = np.random.RandomState(seed)
    clock = [0.0]
    sizes = {"A": 4, "B": 8}
    f = router.BatchFormer(batch_size_of=lambda m: sizes[m],
                           est_exec_s=lambda m, n: 0.01 * n + (0.05 if m == "B" else 0.02),
                           now=lambda: clock[0])
    log = []
    for i in range(400):
        clock[0] += float(rng.uniform(0.0, 0.03))
        if rng.randint(0, 3):
            slo = classes[("interactive", "batch", "train")[rng.randint(0, 3)]]
            model = "AB"[rng.randint(0, 2)]
            aff = None if rng.randint(0, 3) else f"w{rng.randint(0, 3)}"
            f.add(router.PendingRequest(
                id=f"r{i}", client="c", model=model, slo=slo, file="x", payload=None,
                session=None, stream=False, arrival=clock[0],
                deadline=clock[0] + slo.deadline_s), aff)
        else:
            hungry = {m for m in "AB" if rng.randint(0, 2)}
            log.append([(b.model, b.slo.name, b.affinity, b.opened_at, [r.id for r in b.reqs])
                        for b in f.due(hungry)])
    return log


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batch_former_script_forms_identical_batches(seed):
    j = _former_script(jrouter, JCLASSES, seed)
    t = _former_script(trouter, TCLASSES, seed)
    assert sum(len(x) for x in j) > 30
    assert j == t


# ----------------------------------------------------------------------
# the slice as a whole: a JAX cluster and a port cluster, same traffic
# ----------------------------------------------------------------------

N_NODES = 3
N_IMAGES = 8
ENGINE_BS = 4
IMAGE_SIZE = 64
LM_SHAPE = dict(vocab_size=61, d_model=32, n_heads=4, n_layers=2, d_ff=64, n_kv_heads=2)
LM_SERVE = dict(max_new_tokens=6, max_slots=2, max_len=64, chunk=3)
SESSIONS, TURNS, SUFFIX, BUDGET = 2, 2, 4, 6


def _register_narrow(pkg):
    """'NarrowResNet' (bottleneck ResNet, one block a stage, 1000 classes,
    64x64 caffe input) in `pkg`'s model registry."""
    if pkg == "jax":
        from dml_tpu.models.registry import CostDefaults, ModelSpec, register
        from dml_tpu.models.resnet import ResNet

        register(ModelSpec(
            name="NarrowResNet", input_size=(IMAGE_SIZE, IMAGE_SIZE), preprocess="caffe",
            builder=lambda num_classes=1000, dtype=jnp.float32: ResNet(
                depths=(1, 1, 1, 1), num_classes=num_classes, dtype=dtype),
            cost=CostDefaults(load_time=0.1, first_query=0.05, per_query=0.01,
                              default_batch_size=ENGINE_BS)))
    else:
        from dml_tpu_torch.models.registry import CostDefaults, ModelSpec, register
        from dml_tpu_torch.models.resnet import ResNet

        register(ModelSpec(
            name="NarrowResNet", input_size=(IMAGE_SIZE, IMAGE_SIZE), preprocess="caffe",
            builder=lambda num_classes=1000, dtype=torch.float32, param_dtype=None: ResNet(
                depths=(1, 1, 1, 1), num_classes=num_classes, dtype=dtype,
                param_dtype=param_dtype),
            cost=CostDefaults(load_time=0.1, first_query=0.05, per_query=0.01,
                              default_batch_size=ENGINE_BS)))


def _jpegs(tmp):
    from PIL import Image

    rng = np.random.RandomState(13)
    paths = []
    for i in range(N_IMAGES):
        p = os.path.join(tmp, f"img_{i}.jpeg")
        img = np.clip(rng.randint(0, 128, (IMAGE_SIZE, IMAGE_SIZE, 3))
                      + rng.randint(0, 128, (1, 1, 3)), 0, 255).astype(np.uint8)
        Image.fromarray(img).save(p, quality=90)
        paths.append(p)
    return paths


class _Recorder:
    """A router's client verbs, recording each streaming request's
    payload and streamed chunks."""

    def __init__(self, ingress):
        self.ingress, self.payloads, self.streamed = ingress, {}, {}

    async def submit(self, model, **kw):
        rid = await self.ingress.submit(model, **kw)
        self.payloads[rid] = kw.get("payload")
        return rid

    async def wait(self, rid, **kw):
        return await self.ingress.wait(rid, **kw)

    async def stream_text(self, rid, **kw):
        chunks = await self.ingress.stream_text(rid, **kw)
        self.streamed[rid] = chunks
        return chunks


async def _serve(pkg, tmp, engine, make_lm, images):
    """Bring up a 3-node cluster of `pkg` with the front door, every node
    a JobService on `engine` and an LM backend from `make_lm`; serve the
    pinned image requests and the sessions through one client."""
    if pkg == "jax":
        from dml_tpu.cluster.chaos import LocalCluster
        from dml_tpu.config import Timing
        from dml_tpu.jobs.service import JobService
    else:
        from dml_tpu_torch.cluster.chaos import LocalCluster
        from dml_tpu_torch.config import Timing
        from dml_tpu_torch.jobs.service import JobService
    backends = []

    def make_jobs(node, store):
        js = JobService(node, store, engine=engine)
        be = make_lm()
        backends.append(be)
        js.register_lm("TinyLM", backend=be.backend, cost=be.cost(),
                       patterns=("*.tokens.txt", "ingress_*.req"))
        return js

    root = os.path.join(tmp, pkg)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    span = N_NODES + JOIN_SPAN
    base = free_port_block(span)
    c = LocalCluster(N_NODES, root, base, make_jobs=make_jobs, with_ingress=True,
                     timing=Timing(ping_interval=0.2, ack_timeout=0.3, cleanup_time=1.0,
                                   leader_rpc_timeout=10.0))
    try:
        await c.start()
        await c.wait_for(c.converged, 20.0, f"{pkg} cluster convergence")
        client = c.client()
        for p in images:
            await client.store.put(p, os.path.basename(p))
        terms = await asyncio.gather(*(
            client.ingress.request("NarrowResNet", store_name=os.path.basename(p), timeout=120.0)
            for p in images))
        rec = _Recorder(client.ingress)
        trace = tload.multi_turn_trace(4, SESSIONS, TURNS, "TinyLM", slo="batch", start_gap_s=0.1,
                                       think_s=0.1, suffix_len=SUFFIX,
                                       vocab=LM_SHAPE["vocab_size"], budget=BUDGET)
        outcomes, _, transcripts = await tload.run_sessions(rec, trace, wait_timeout=120.0)
    finally:
        await c.stop()
        for be in backends:
            be.close()
        release_ports(base, span)
    images_out = {}
    for p, t in zip(images, terms):
        assert t["ok"] and t["terminal"] == "completed", t
        images_out[os.path.basename(p)] = t["result"]
    streamed = {rec.payloads[rid]: [int(x) for x in "".join(ch).split()]
                for rid, ch in rec.streamed.items()}
    return images_out, [o.terminal for o in outcomes], transcripts, streamed


@pytest.fixture(scope="module")
def slice_run(tmp_path_factory):
    from dml_tpu.inference.engine import InferenceEngine as JaxEngine
    from dml_tpu.inference.generate import LMConfig as JaxLMConfig
    from dml_tpu.inference.lm_backend import LMBackend as JaxLMBackend
    from dml_tpu.models.resnet import ResNet as JaxResNet
    from dml_tpu.models.transformer import TransformerLM
    from dml_tpu_torch.inference import InferenceEngine
    from dml_tpu_torch.inference.generate import LMConfig
    from dml_tpu_torch.inference.lm_backend import LMBackend
    from dml_tpu_torch.models.lm_params import lm_params_from_flax

    tmp = str(tmp_path_factory.mktemp("ingress_slice"))
    images = _jpegs(tmp)
    _register_narrow("jax")
    _register_narrow("port")
    weights = perturb_bn(jax_init(JaxResNet(depths=(1, 1, 1, 1)), IMAGE_SIZE), seed=8)
    lm_jax = TransformerLM(dtype=jnp.float32, **LM_SHAPE).init(
        jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32))["params"]
    lm_port = lm_params_from_flax(jax.tree_util.tree_map(np.asarray, lm_jax), device="cpu")

    jeng = JaxEngine(dtype=jnp.float32)
    jeng.load_model("NarrowResNet", variables=weights, batch_size=ENGINE_BS)
    teng = InferenceEngine(dtype=torch.float32, device="cpu")
    teng.load_model("NarrowResNet", variables=weights, batch_size=ENGINE_BS)
    out = {}
    out["jax"] = asyncio.run(asyncio.wait_for(_serve(
        "jax", tmp, jeng,
        lambda: JaxLMBackend(lm_jax, JaxLMConfig(dtype=jnp.float32, **LM_SHAPE), **LM_SERVE),
        images), 240.0))
    out["port"] = asyncio.run(asyncio.wait_for(_serve(
        "port", tmp, teng,
        lambda: LMBackend(lm_port, LMConfig(dtype=torch.float32, **LM_SHAPE), **LM_SERVE),
        images), 240.0))
    yield out
    from dml_tpu.models.registry import MODEL_REGISTRY as JREG
    from dml_tpu_torch.models.registry import MODEL_REGISTRY as TREG

    JREG.pop("narrowresnet", None)
    TREG.pop("narrowresnet", None)


def test_image_requests_match_the_jax_cluster(slice_run):
    got, want = slice_run["port"][0], slice_run["jax"][0]
    assert set(got) == set(want) and len(got) == N_IMAGES
    for k in want:
        assert len(got[k]) == 5, k
        assert [r["wnid"] for r in got[k]] == [r["wnid"] for r in want[k]], k
        np.testing.assert_allclose([r["score"] for r in got[k]], [r["score"] for r in want[k]],
                                   atol=1e-4, rtol=0, err_msg=k)


def test_streamed_session_tokens_equal_the_jax_cluster(slice_run):
    _, jterms, jtx, jstream = slice_run["jax"]
    _, tterms, ttx, tstream = slice_run["port"]
    assert jterms == tterms == ["completed"] * (SESSIONS * TURNS)
    assert ttx == jtx and len(ttx) == SESSIONS
    assert all(len(turns) == TURNS and all(len(t) == BUDGET for t in turns)
               for turns in ttx.values())
    # every turn streamed its whole completion, equal on both sides
    assert tstream == jstream and len(tstream) == SESSIONS * TURNS
    finals = sorted(t for turns in ttx.values() for t in turns)
    assert sorted(tstream.values()) == finals
