"""The port's sharded LM serving and KV slab codec
(`dml_tpu_torch.inference.lm_sharded`) against the JAX package's
(`dml_tpu/inference/lm_sharded.py`) on the CPU, on the same weights: the
JAX package's seeded tree, written with the flax-msgpack codec and named
in the port's spec (`"weights"`).

In this process:
- the slab codec, bf16 and kv_quant layouts: the port's blob is
  byte-identical to JAX's for the same entries, each package reads the
  other's bit for bit, garbage and truncation are refused; the framed
  stream the same way, with a fake feed (`tests/test_lm_sharded.py`'s);
- `LMPrefillBackend` rows within 1e-5 of JAX's `prefill_one` in float32,
  first tokens and shipped draft tokens equal; `serve_prefilled` over
  the port's slabs and over JAX's gives JAX's `generate` tokens;
- `pp_hbm_report` equal to JAX's, `check_hbm_budget`'s cases, and
  `PipelinedLMBackend`'s refusals with JAX's messages.

One module-scoped session of two gloo ranks (real processes, `file://`
rendezvous under the test's temporary directory) runs the mesh forms:
`PipelinedLMBackend` at pp 2 (`generate_batch` with JAX's prompts and
budgets [8, 3, 1, 5], at 2 and 1 microbatches; `serve_files`) and
`sharded_lm_backend` in both forms at tp 2, with `shard_lm_params`'
pieces. Tokens are held equal to JAX's `PipelinedLMBackend`, JAX's
`sharded_lm_backend` forms and JAX's `generate`, and equal on both
ranks; each rank's pieces bit-equal to JAX's device shards at its tp
index; K2 and K4 calls by formula on each rank (the pipeline: (n_layers /
pp) x microbatches a batch; the tp servers: n_layers x placement
prefills, n_layers x chunk x chunk steps).
"""

import asyncio
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dml_tpu.config import MeshSpec as JaxMeshSpec
from dml_tpu.inference import lm_sharded as jls
from dml_tpu.inference.generate import generate as jax_generate
from dml_tpu.inference.lm_backend import lm_spec_parts as jax_lm_spec_parts
from dml_tpu.inference.lm_backend import write_prompt_file
from dml_tpu.models import params_io as jpio
from dml_tpu.parallel.mesh import make_mesh as jax_make_mesh
from dml_tpu_torch.config import MeshSpec, WorkerGroupSpec
from dml_tpu_torch.inference import lm_sharded as tls
from dml_tpu_torch.inference.lm_backend import LMBackend, lm_spec_parts
from dml_tpu_torch.models.lm_params import lm_params_from_flax

WORLD = 2
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = {"name": "ShardLM", "vocab_size": 64, "d_model": 32, "n_heads": 4, "n_kv_heads": 2,
        "n_layers": 2, "d_ff": 64, "dtype": "float32", "max_new_tokens": 8, "max_slots": 2,
        "max_len": 64, "chunk": 4, "seed": 0}
PP_SPEC = {"name": "PPLM", "vocab_size": 64, "d_model": 32, "n_heads": 4, "n_kv_heads": 2,
           "n_layers": 4, "d_ff": 64, "dtype": "float32", "max_new_tokens": 8, "max_len": 64,
           "seed": 0}
NEW_TOKENS = 8
PP_BUDGETS = [8, 3, 1, 5]


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _prompts(n=3, lens=(5, 11, 16)):
    rng = np.random.RandomState(0)
    return [rng.randint(0, SPEC["vocab_size"], tp).astype(np.int32) for tp in lens[:n]]


def _pp_prompts():
    return _prompts() + [_prompts(1)[0]]


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _weights_spec(spec, path):
    """`spec` with the JAX package's seeded tree written to `path`."""
    params, _ = _jax_parts(spec)
    with open(path, "wb") as f:
        f.write(jpio.variables_to_bytes({"params": _host(params)}))
    return dict(spec, weights=str(path))


@pytest.fixture(scope="module")
def specs(tmp_path_factory):
    d = tmp_path_factory.mktemp("lm_weights")
    out = {}
    for name, spec in (("spec", SPEC), ("pp", PP_SPEC), ("bf16", {**SPEC, "dtype": "bfloat16"}),
                       ("kv_quant", {**SPEC, "kv_quant": True})):
        out[name] = (spec, _weights_spec(spec, d / f"{name}.msgpack"))
    return out


_JAX_PARTS = {}


def _jax_parts(spec):
    key = json.dumps(spec, sort_keys=True)
    if key not in _JAX_PARTS:
        _JAX_PARTS[key] = jax_lm_spec_parts(spec)
    return _JAX_PARTS[key]


def _expect(spec, prompt, budget):
    params, cfg = _jax_parts(spec)
    return np.asarray(jax_generate(params, cfg, jnp.asarray(np.asarray(prompt)[None]), budget))[0]


# ----------------------------------------------------------------------
# KV slab serialization
# ----------------------------------------------------------------------


def _entries(specs, name, budgets=None):
    """(JAX's prefill_one entries, the port's) for `_prompts()`."""
    jspec, tspec = specs[name]
    jp, jcfg = _jax_parts(jspec)
    tp, tcfg = lm_spec_parts(tspec, device="cpu")
    budgets = budgets or [NEW_TOKENS] * 3
    je = [jls.LMPrefillBackend(jp, jcfg, max_len=64).prefill_one(p, b)
          for p, b in zip(_prompts(), budgets)]
    te = [tls.LMPrefillBackend(tp, tcfg, max_len=64).prefill_one(p, b)
          for p, b in zip(_prompts(), budgets)]
    return je, te


def _as_numpy(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("name", ["bf16", "kv_quant"])
def test_kv_slab_bytes_equal_jax_and_read_across(specs, name):
    """The port writes JAX's exact blob for JAX's entries; each package
    reads the other's blob bit for bit (bfloat16 as raw words, int8 and
    f32 scales as they are); the port's own entries round-trip."""
    je, te = _entries(specs, name)
    jblob = jls.kv_slab_to_bytes(je)
    assert tls.kv_slab_to_bytes(je) == jblob and jblob[:4] == b"KVS1"
    back = tls.kv_slab_from_bytes(jblob)
    tblob = tls.kv_slab_to_bytes(te)
    jback = jls.kv_slab_from_bytes(tblob)
    if name == "kv_quant":
        assert set(te[0]["rows"]["block_0"]) == {"k_q", "k_s", "v_q", "v_s"}
        assert te[0]["rows"]["block_0"]["k_q"].dtype == torch.int8
    for a, b, t, jt in zip(je, back, te, jback):
        for key in ("prompt_len", "first_token", "budget"):
            assert a[key] == b[key] and t[key] == jt[key]
        for layer in a["rows"]:
            for key, arr in a["rows"][layer].items():
                got = b["rows"][layer][key]
                assert str(got.dtype).split(".")[-1] == np.asarray(arr).dtype.name
                np.testing.assert_array_equal(_as_numpy(got), _bits(arr))
                mine = t["rows"][layer][key]
                np.testing.assert_array_equal(_bits(jt["rows"][layer][key]), _as_numpy(mine))
    # the port's own blob round-trips, and re-serializes to the same bytes
    assert tls.kv_slab_to_bytes(tls.kv_slab_from_bytes(tblob)) == tblob


def test_kv_slab_rejects_garbage(specs):
    with pytest.raises(ValueError, match="magic"):
        tls.kv_slab_from_bytes(b"nope" + b"\0" * 32)
    _, te = _entries(specs, "spec")
    blob = tls.kv_slab_to_bytes(te[:1])
    with pytest.raises(ValueError):
        tls.kv_slab_from_bytes(blob[: len(blob) - 7])  # truncated tail
    with pytest.raises(ValueError, match="size mismatch"):
        tls.kv_slab_from_bytes(blob + b"\0")


# ----------------------------------------------------------------------
# chunk-streamed slab framing
# ----------------------------------------------------------------------


class _FakeFeed:
    """Collects pushed chunks like a data-plane stream feed."""

    def __init__(self):
        self.chunks = []

    async def put(self, data: bytes) -> None:
        self.chunks.append(bytes(data))


async def _drain(mod, chunks):
    async def it():
        for c in chunks:
            yield c

    return [item async for item in mod.iter_slab_stream(it())]


@pytest.mark.parametrize("name", ["bf16", "kv_quant"])
def test_slab_stream_chunks_bit_exact_and_equal_jax(specs, name, monkeypatch):
    """Frames through push_slab_entry -> iter_slab_stream reassemble every
    leaf bit-exact, at the default chunk and at 1 KiB (a blob in many
    pieces); the port's frames are JAX's, and each package reads the
    other's stream."""
    _, te = _entries(specs, name)
    for chunk in (tls.SLAB_STREAM_CHUNK, 1 << 10):
        monkeypatch.setattr(tls, "SLAB_STREAM_CHUNK", chunk)
        monkeypatch.setattr(jls, "SLAB_STREAM_CHUNK", chunk)
        feed, jfeed = _FakeFeed(), _FakeFeed()
        for i, e in enumerate(te):
            blob = tls.kv_slab_to_bytes([e])
            asyncio.run(tls.push_slab_entry(feed, i, blob))
            asyncio.run(jls.push_slab_entry(jfeed, i, blob))
        assert feed.chunks == jfeed.chunks
        if chunk == 1 << 10:
            assert len(feed.chunks) > len(te) * 2  # header + more than one piece
        for mod in (tls, jls):
            back = asyncio.run(_drain(mod, feed.chunks))
            assert [i for i, _ in back] == list(range(len(te)))
            for (_, got), want in zip(back, te):
                assert got["prompt_len"] == want["prompt_len"]
                assert got["first_token"] == want["first_token"]
                for layer in want["rows"]:
                    for key, arr in want["rows"][layer].items():
                        g = got["rows"][layer][key]
                        g = _as_numpy(g) if isinstance(g, torch.Tensor) else _bits(g)
                        np.testing.assert_array_equal(g, _as_numpy(arr))


def test_slab_stream_rejects_garbage_and_truncation(specs):
    _, te = _entries(specs, "spec")
    blob = tls.kv_slab_to_bytes(te[:1])
    feed = _FakeFeed()
    asyncio.run(tls.push_slab_entry(feed, 0, blob))
    with pytest.raises(ValueError, match="header"):
        asyncio.run(_drain(tls, [b"\xff\xfe not json"] + feed.chunks))
    with pytest.raises(ValueError, match="mid-entry"):
        asyncio.run(_drain(tls, feed.chunks[:-1]))
    efeed = _FakeFeed()
    asyncio.run(tls.push_slab_error(efeed, 2, "boom"))
    assert asyncio.run(_drain(tls, efeed.chunks)) == [(2, None)]
    hdr = json.loads(feed.chunks[0])
    hdr["size"] = 10
    with pytest.raises(ValueError, match="overran"):
        asyncio.run(_drain(tls, [json.dumps(hdr).encode()] + feed.chunks[1:]))


# ----------------------------------------------------------------------
# the prefill worker and adopted decode
# ----------------------------------------------------------------------


def test_prefill_one_matches_jax(specs):
    """float32 rows within 1e-5 of JAX's prefill_one, first tokens equal;
    with a draft model, the shipped proposals equal JAX's."""
    je, te = _entries(specs, "spec")
    for a, b in zip(je, te):
        assert a["first_token"] == b["first_token"] and a["prompt_len"] == b["prompt_len"]
        for layer in a["rows"]:
            for key, arr in a["rows"][layer].items():
                assert tuple(b["rows"][layer][key].shape) == arr.shape
                np.testing.assert_allclose(b["rows"][layer][key].numpy(), arr, atol=1e-5)
    draft = {**SPEC, "n_layers": 1, "d_model": 16, "d_ff": 32, "seed": 1}
    jp, jcfg = _jax_parts(SPEC)
    jd = _jax_parts(draft)
    tp, tcfg = lm_spec_parts(specs["spec"][1], device="cpu")
    td = lm_params_from_flax(_host(jd[0]), device="cpu"), lm_spec_parts(draft, device="cpu")[1]
    jpf = jls.LMPrefillBackend(jp, jcfg, max_len=64, draft=jd, draft_k=3)
    tpf = tls.LMPrefillBackend(tp, tcfg, max_len=64, draft=td, draft_k=3)
    for p in _prompts():
        want, got = jpf.prefill_one(p, 5), tpf.prefill_one(p, 5)
        assert len(got["draft"]) == 3 and got["draft"] == want["draft"]
    assert tpf.drafts_shipped == 3
    assert "draft" not in tpf.prefill_one(_prompts()[0], 1)  # budget 1: nothing to verify


@pytest.mark.parametrize("source", ["port", "jax"])
def test_serve_prefilled_token_identical(specs, source):
    """Slabs through the port's codec adopted by the port's LMBackend
    decode to JAX's generate tokens, mixed budgets and budget 1 included,
    whichever package prefilled them."""
    budgets = [NEW_TOKENS, 3, 1]
    je, te = _entries(specs, "spec", budgets)
    blob = (tls.kv_slab_to_bytes(te) if source == "port" else jls.kv_slab_to_bytes(je))
    slabs = tls.kv_slab_from_bytes(blob)
    tp, tcfg = lm_spec_parts(specs["spec"][1], device="cpu")
    be = LMBackend(tp, tcfg, max_new_tokens=NEW_TOKENS, max_slots=2, max_len=64, chunk=4)
    toks, infer_time = be.serve_prefilled(_prompts(), budgets, slabs)
    assert infer_time > 0
    for p, b, ts in zip(_prompts(), budgets, toks):
        np.testing.assert_array_equal(ts, _expect(SPEC, p, b))
    be.close()


# ----------------------------------------------------------------------
# memory accounting, the budget gate, and the pipeline form's refusals
# ----------------------------------------------------------------------


@pytest.mark.pp
@pytest.mark.parametrize("pp", [1, 2, 4])
def test_pp_hbm_report_equals_jax(specs, pp):
    assert tls.pp_hbm_report(PP_SPEC, pp) == jls.pp_hbm_report(PP_SPEC, pp)
    rep = tls.pp_hbm_report(PP_SPEC, pp)
    assert rep["per_member_bytes"] == rep["io_bytes"] + rep["block_bytes"] // pp


@pytest.mark.pp
def test_hbm_budget_gate():
    """A model whose whole tree exceeds a member's budget serves through
    a pp axis (whose slice fits) and is refused elsewhere; a budget under
    the slice is refused; no budget is unchecked; a mesh declared pp=-1
    is checked at the resolved size (`tests/test_lm_sharded.py:310-345,
    402-420`)."""
    rep = tls.pp_hbm_report(PP_SPEC, 2)
    budget = (rep["per_member_bytes"] + rep["full_bytes"]) // 2
    g_pp = WorkerGroupSpec("g", ("H1", "H2"), MeshSpec(dp=1, tp=1, pp=2), lm_models=("PPLM",),
                           hbm_bytes=budget)
    out = tls.check_hbm_budget(g_pp, PP_SPEC)
    assert out is not None and out["per_member_bytes"] <= budget
    g_tp = WorkerGroupSpec("g", ("H1", "H2"), MeshSpec(dp=1, tp=2), lm_models=("PPLM",),
                           hbm_bytes=budget)
    with pytest.raises(RuntimeError, match="pp axis"):
        tls.check_hbm_budget(g_tp, PP_SPEC)
    g_tiny = WorkerGroupSpec("g", ("H1", "H2"), MeshSpec(dp=1, tp=1, pp=2), lm_models=("PPLM",),
                             hbm_bytes=1000)
    with pytest.raises(RuntimeError, match="hbm_bytes"):
        tls.check_hbm_budget(g_tiny, PP_SPEC)
    assert tls.check_hbm_budget(
        WorkerGroupSpec("g", ("H1", "H2"), MeshSpec(dp=1, tp=1, pp=2)), PP_SPEC) is None
    g = WorkerGroupSpec("g", ("H1", "H2"), MeshSpec(dp=1, tp=1, pp=-1), lm_models=("PPLM",),
                        hbm_bytes=budget)
    with pytest.raises(RuntimeError, match="pp axis"):
        tls.check_hbm_budget(g, PP_SPEC)
    assert tls.check_hbm_budget(g, PP_SPEC, pp=2)["per_member_bytes"] <= budget
    assert tls.SPEC_DECODE_SUPPORT == jls.SPEC_DECODE_SUPPORT


@pytest.mark.pp
def test_pp_engine_rejects_bad_layouts():
    """JAX's refusals and messages (`tests/test_lm_sharded.py:290-307`),
    checked on the mesh's axis sizes before any rank is needed."""
    pp2 = {"dp": 1, "tp": 1, "pp": 2}
    with pytest.raises(ValueError, match="divisible"):
        tls.PipelinedLMBackend({**PP_SPEC, "n_layers": 3}, pp2, device="cpu")
    with pytest.raises(ValueError, match="kv_quant|bf16"):
        tls.PipelinedLMBackend({**PP_SPEC, "kv_quant": True}, pp2, device="cpu")
    with pytest.raises(ValueError, match="greedy"):
        tls.PipelinedLMBackend({**PP_SPEC, "temperature": 0.7}, pp2, device="cpu")
    with pytest.raises(ValueError, match="pp axis"):
        tls.PipelinedLMBackend(PP_SPEC, {"dp": 1, "tp": 1, "pp": 1}, device="cpu")
    with pytest.raises(ValueError, match="pp.*only|replicate"):
        tls.PipelinedLMBackend(PP_SPEC, {"dp": 1, "tp": 2, "pp": 2}, device="cpu")
    with pytest.raises(ValueError, match="microbatches"):
        tls.PipelinedLMBackend(PP_SPEC, pp2, microbatches=3, device="cpu")


def test_entry_points_need_cuda_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tls.sharded_lm_backend(SPEC, {"tp": 1})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tls.PipelinedLMBackend(PP_SPEC, {"pp": 2})
    be = tls.sharded_lm_backend(SPEC, {"tp": 1}, device="cpu")
    assert be.server.device.type == "cpu"
    be.close()


@pytest.mark.sharded
def test_sharded_backend_rejects_other_axes_and_forms():
    with pytest.raises(ValueError, match="unknown param form"):
        tls.sharded_lm_backend(SPEC, {"tp": 2}, form="bogus", device="cpu")
    with pytest.raises(ValueError, match="pp=2"):
        tls.sharded_lm_backend(SPEC, {"tp": 1, "pp": 2}, device="cpu")


# ----------------------------------------------------------------------
# the mesh forms on two gloo ranks
# ----------------------------------------------------------------------

CHILD = r'''
import json, os, sys
import numpy as np
import torch

torch.set_num_threads(1)
import torch.distributed as dist

out_dir, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
dist.init_process_group("gloo", init_method="file://" + os.path.join(out_dir, "rendezvous"),
                        world_size=world, rank=rank)

from dml_tpu_torch.config import MeshSpec
from dml_tpu_torch.inference import generate as gen
from dml_tpu_torch.inference import lm_sharded as ls
from dml_tpu_torch.inference.lm_backend import lm_spec_parts
from dml_tpu_torch.observability import METRICS
from dml_tpu_torch.parallel.mesh import make_mesh

cfg_in = json.load(open(os.path.join(out_dir, "inputs.json")))
calls = {"flash": 0, "decode": 0}


def counted(name, fn):
    def wrapped(*a, **k):
        calls[name] += 1
        return fn(*a, **k)
    return wrapped


# every K2 and K4 call on the serving paths (the plain versions run here)
ls.flash_attention = counted("flash", ls.flash_attention)
gen.flash_attention = counted("flash", gen.flash_attention)
gen.decode_attention = counted("decode", gen.decode_attention)


def moved(fn):
    before = dict(calls)
    out = fn()
    return out, {k: calls[k] - before[k] for k in calls}


def dispatches():
    pre = METRICS.histogram("lm_server_prefill_dispatch_seconds").items()
    return {"prefill": sum(st[0] for _, st in pre),
            "steps": int(METRICS.counter("lm_server_steps_total").value())}


R = {}
prompts = [np.asarray(p, np.int32) for p in cfg_in["pp_prompts"]]
pp = make_mesh(MeshSpec(dp=1, pp=2))
for mb in (2, 1):
    be = ls.PipelinedLMBackend(cfg_in["pp_spec"], pp, microbatches=mb, device="cpu")
    toks, mv = moved(lambda: be.generate_batch(prompts, cfg_in["pp_budgets"]))
    R[f"pp_mb{mb}"] = {"tokens": toks, "moved": mv, "held": be.held_bytes(), "hbm": be.hbm,
                       "stage": pp.coords["pp"]}
res, t, cost = be.serve_files(cfg_in["paths"])
R["pp_files"] = {"results": res, "infer_time": t, "cost": cost,
                 "decoded": be.decode_tokens_total()}

tp = make_mesh(MeshSpec(dp=1, tp=2))
params, _ = lm_spec_parts(cfg_in["spec"], device="cpu")


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: v.numpy()})
    return out


R["pieces"] = flat(ls.shard_lm_params(params, tp))
for form in ("resident", "gather"):
    be = ls.sharded_lm_backend(cfg_in["spec"], tp, form=form, device="cpu")
    d0 = dispatches()
    (res, t, cost), mv = moved(lambda: be.serve_files(cfg_in["paths"]))
    d = {k: v - d0[k] for k, v in dispatches().items()}
    R[form] = {"results": res, "infer_time": t, "cost": cost, "overlap": be.overlap,
               "moved": mv, "dispatches": d, "chunk": be.server.chunk}
    be.close()

# worker groups: `wire_lm_group` on an unstarted node of a 4-node spec
# (nothing binds); both ranks wire the primary H3, so both build the mesh
import asyncio

from dml_tpu_torch.cluster.node import Node
from dml_tpu_torch.cluster.store_service import StoreService
from dml_tpu_torch.config import ClusterSpec, StoreConfig, WorkerGroupSpec
from dml_tpu_torch.jobs.groups import GroupDegraded


def wired(group, name, spec_lm):
    spec = ClusterSpec.localhost(
        4, base_port=19451, introducer_port=19450, worker_groups=[group],
        store=StoreConfig(root=os.path.join(out_dir, f"roots{rank}"),
                          download_dir=os.path.join(out_dir, f"dl{rank}")))
    node = Node(spec, spec.node_by_name(name))
    store = StoreService(node, root=os.path.join(out_dir, f"st{rank}_{group.name}_{name}"))
    return ls.wire_lm_group(node, store, spec_lm, device="cpu"), spec


def serve(gb, model, mode):
    """The wired engine through a group backend whose members are alive
    (the unstarted node sees only itself, so the wired one degrades)."""
    try:
        asyncio.run(gb(model, cfg_in["paths"]))
        degraded = False
    except GroupDegraded:
        degraded = True
    members = ("a", "b")
    live = ls.sharded_lm_group_backend(gb.lm_backend, model_name=model, group_name="g",
                                       members=members, alive_fn=lambda: set(members),
                                       capacity=gb.capacity, mode=mode)
    (res, _, _), mv = moved(lambda: asyncio.run(live(model, cfg_in["paths"])))
    return {"degraded": degraded, "results": res, "moved": mv, "capacity": gb.capacity,
            "model": gb.model, "engine": type(gb.lm_backend).__name__}


pp_group = WorkerGroupSpec("pp0", ("H3", "H4"), MeshSpec(dp=1, tp=1, pp=2),
                           lm_models=("PPLM",), hbm_bytes=cfg_in["pp_budget"])
(gb, pf), _ = wired(pp_group, "H3", cfg_in["pp_spec"])
R["wire_pp"] = dict(serve(gb, "PPLM", "pp"), prefill=pf is None,
                    stage=gb.lm_backend.stage, held=gb.lm_backend.held_bytes())
R["wire_pp"]["lender"] = wired(pp_group, "H4", cfg_in["pp_spec"])[0] == (None, None)
roles = WorkerGroupSpec("pp0", ("H3", "H4"), MeshSpec(dp=1, tp=1, pp=2), lm_models=("PPLM",),
                        hbm_bytes=cfg_in["pp_budget"], roles={"H3": "decode", "H4": "prefill"})
R["wire_pp"]["prefill_role_ignored"] = wired(roles, "H4", cfg_in["pp_spec"])[0] == (None, None)
tp_group = WorkerGroupSpec("tp0", ("H3", "H4"), MeshSpec(dp=1, tp=2), lm_models=("ShardLM",))
(gb, pf), _ = wired(tp_group, "H3", cfg_in["spec"])
R["wire_tp"] = dict(serve(gb, "ShardLM", "resident"), prefill=pf is None,
                    replicate=gb.lm_backend.server._gather_shardings.replicate)
gb.lm_backend.close()
torch.save(R, os.path.join(out_dir, f"rank{rank}.pt"))
dist.barrier()
print(f"RANK_OK {rank}", flush=True)
'''


class Session:
    def __init__(self, out_dir, specs):
        self.dir = out_dir
        paths = []
        for i, p in enumerate(_prompts()):
            fp = str(out_dir / f"p{i}.tokens.txt")
            write_prompt_file(fp, p)
            paths.append(fp)
        self.paths = paths
        rep = tls.pp_hbm_report(PP_SPEC, 2)
        (out_dir / "inputs.json").write_text(json.dumps({
            "spec": specs["spec"][1], "pp_spec": specs["pp"][1], "paths": paths,
            "pp_prompts": [p.tolist() for p in _pp_prompts()], "pp_budgets": PP_BUDGETS,
            "pp_budget": (rep["per_member_bytes"] + rep["full_bytes"]) // 2}))
        (out_dir / "child.py").write_text(CHILD)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join([REPO] + env.get("PYTHONPATH", "").split(os.pathsep))
        self.procs = [subprocess.Popen(
            [sys.executable, str(out_dir / "child.py"), str(out_dir), str(r), str(WORLD)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True)
            for r in range(WORLD)]
        self._results = None

    def results(self):
        if self._results is None:
            outs = []
            try:
                for p in self.procs:
                    outs.append(p.communicate(timeout=180)[0])
            except subprocess.TimeoutExpired:
                for p in self.procs:
                    p.kill()
                pytest.fail("the gloo ranks hung:\n" + "\n---\n".join(outs))
            for r, (p, out) in enumerate(zip(self.procs, outs)):
                assert p.returncode == 0 and f"RANK_OK {r}" in out, f"rank {r} failed:\n{out}"
            self._results = [torch.load(self.dir / f"rank{r}.pt", weights_only=False)
                             for r in range(WORLD)]
        return self._results


@pytest.fixture(scope="module")
def session(tmp_path_factory, specs):
    s = Session(tmp_path_factory.mktemp("lm_ranks"), specs)
    yield s
    for p in s.procs:
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.mark.pp
def test_pp_engine_token_exact(session):
    """`generate_batch` at pp 2 equals JAX's PipelinedLMBackend and JAX's
    generate per prompt (mixed lengths and budgets, budget 1 included),
    at 2 and 1 microbatches, on both ranks; each rank holds its half of
    the blocks and the io params (`pp_hbm_report`) and runs K2 (n_layers
    / pp) x microbatches times."""
    mesh = jax_make_mesh(JaxMeshSpec(dp=1, tp=1, pp=2), devices=jax.devices()[:2])
    want = jls.PipelinedLMBackend(PP_SPEC, mesh).generate_batch(_pp_prompts(), PP_BUDGETS)
    for p, b, w in zip(_pp_prompts(), PP_BUDGETS, want):
        np.testing.assert_array_equal(w, _expect(PP_SPEC, p, b))
    for r, res in enumerate(session.results()):
        for mb in (2, 1):
            row = res[f"pp_mb{mb}"]
            assert row["tokens"] == [list(map(int, w)) for w in want], f"rank {r} mb {mb}"
            assert row["moved"] == {"flash": PP_SPEC["n_layers"] // 2 * mb, "decode": 0}
            assert row["held"] == row["hbm"]["per_member_bytes"] < row["hbm"]["full_bytes"]
        assert res["pp_mb2"]["stage"] == r


@pytest.mark.pp
def test_pp_engine_serve_files(session):
    for r, res in enumerate(session.results()):
        row = res["pp_files"]
        for fp, p in zip(session.paths, _prompts()):
            np.testing.assert_array_equal(row["results"][fp]["tokens"],
                                          _expect(PP_SPEC, p, NEW_TOKENS), err_msg=f"rank {r}")
        assert row["decoded"] == 3 * NEW_TOKENS and row["cost"]["per_query"] > 0


@pytest.mark.sharded
def test_shard_lm_params_pieces_are_jax_device_shards(session, specs):
    """Each rank's piece of every leaf is, bit for bit, JAX's device shard
    at its tp index (the last axis of each Flax-layout leaf)."""
    params, _ = _jax_parts(SPEC)
    mesh = jax_make_mesh(JaxMeshSpec(dp=1, tp=2), devices=jax.devices()[:2])
    placed = _flat(jls.shard_lm_params(params, mesh))
    sharded = 0
    for r, res in enumerate(session.results()):
        dev = jax.devices()[r]
        assert set(res["pieces"]) == set(placed)
        for name, arr in placed.items():
            want = next(np.asarray(s.data) for s in arr.addressable_shards if s.device == dev)
            np.testing.assert_array_equal(res["pieces"][name], want, err_msg=f"{name} rank {r}")
            sharded += want.shape != arr.shape
    assert sharded > 0


@pytest.mark.sharded
@pytest.mark.parametrize("form", ["resident", "gather"])
def test_sharded_forms_token_identical(session, form):
    """Both tp forms at tp 2 serve JAX's sharded_lm_backend tokens (and
    JAX's generate's), the same on both ranks, with K2 = n_layers x
    placement prefills and K4 = n_layers x chunk x chunk steps."""
    mesh = jax_make_mesh(JaxMeshSpec(dp=1, tp=2), devices=jax.devices()[:2])
    jbe = jls.sharded_lm_backend(SPEC, mesh, form=form)
    want, _, _ = jbe.serve_files(session.paths)
    jbe.close()
    rows = [res[form] for res in session.results()]
    for r, row in enumerate(rows):
        assert row["overlap"] is False and row["infer_time"] > 0 and row["cost"]["per_query"] > 0
        for fp, p in zip(session.paths, _prompts()):
            np.testing.assert_array_equal(row["results"][fp]["tokens"], want[fp]["tokens"],
                                          err_msg=f"{form} rank {r}")
            np.testing.assert_array_equal(row["results"][fp]["tokens"],
                                          _expect(SPEC, p, NEW_TOKENS))
        d, n = row["dispatches"], SPEC["n_layers"]
        assert d["prefill"] >= 1 and d["steps"] >= 1
        assert row["moved"] == {"flash": n * d["prefill"],
                                "decode": n * row["chunk"] * d["steps"]}, f"{form} rank {r}"
    assert rows[0]["results"] == rows[1]["results"]


def _jax_wired(tmp, group, spec_lm):
    """JAX's `wire_lm_group` for the primary H3 of a 4-node spec."""
    from dml_tpu.cluster.node import Node as JaxNode
    from dml_tpu.cluster.store_service import StoreService as JaxStore
    from dml_tpu.config import ClusterSpec as JaxClusterSpec
    from dml_tpu.config import StoreConfig as JaxStoreConfig

    spec = JaxClusterSpec.localhost(
        4, base_port=19451, introducer_port=19450, worker_groups=[group],
        store=JaxStoreConfig(root=str(tmp / "roots"), download_dir=str(tmp / "dl")))
    node = JaxNode(spec, spec.node_by_name("H3"))
    return jls.wire_lm_group(node, JaxStore(node, root=str(tmp / "st")), spec_lm)


def _jax_group_tokens(gb, model, paths):
    live = jls.sharded_lm_group_backend(gb.lm_backend, model_name=model, group_name="g",
                                        members=("a", "b"), alive_fn=lambda: {"a", "b"},
                                        capacity=gb.capacity)
    return asyncio.run(live(model, paths))[0]


@pytest.mark.pp
def test_wire_lm_group_pp_primary(session, tmp_path):
    """A group whose mesh has a pp axis wires its primary with the
    pipelined engine under the budget gate, on both ranks (rank r holds
    stage r, under the per-member bytes), with JAX's capacity; the lender
    and a prefill role on a pp group wire nothing; the wired backend
    degrades while its other member is not alive; served through a live
    group backend, both ranks give JAX's wired pp-2 engine's tokens and
    JAX's generate's, K2 (n_layers / pp) x pp microbatches once."""
    from dml_tpu.config import WorkerGroupSpec as JaxWorkerGroupSpec

    rep = jls.pp_hbm_report(PP_SPEC, 2)
    budget = (rep["per_member_bytes"] + rep["full_bytes"]) // 2
    jgb, jpf = _jax_wired(tmp_path, JaxWorkerGroupSpec(
        "pp0", ("H3", "H4"), JaxMeshSpec(dp=1, tp=1, pp=2), lm_models=("PPLM",),
        hbm_bytes=budget), PP_SPEC)
    assert jpf is None and isinstance(jgb.lm_backend, jls.PipelinedLMBackend)
    want = _jax_group_tokens(jgb, "PPLM", session.paths)
    for r, res in enumerate(session.results()):
        row = res["wire_pp"]
        assert row["engine"] == "PipelinedLMBackend" and row["prefill"] and row["stage"] == r
        assert row["capacity"] == jgb.capacity == 2.0 and row["model"] == jgb.model == "PPLM"
        assert row["lender"] and row["prefill_role_ignored"] and row["degraded"]
        assert row["held"] <= budget
        for fp, p in zip(session.paths, _prompts()):
            assert row["results"][fp]["tokens"] == list(want[fp]["tokens"]), f"rank {r}"
            np.testing.assert_array_equal(row["results"][fp]["tokens"],
                                          _expect(PP_SPEC, p, NEW_TOKENS))
        assert row["moved"] == {"flash": PP_SPEC["n_layers"] // 2 * 2, "decode": 0}


@pytest.mark.sharded
def test_wire_lm_group_tp_primary_serves_the_resident_form(session, tmp_path):
    """A tp-2 group without roles wires its primary with
    `sharded_lm_group_backend` over the resident form on both ranks
    (dispatches compute with the pieces, nothing replicated), capacity
    dp x tp as JAX's; through a live group backend both ranks give JAX's
    wired tp-2 backend's tokens (float32, exact)."""
    from dml_tpu.config import WorkerGroupSpec as JaxWorkerGroupSpec

    jgb, jpf = _jax_wired(tmp_path, JaxWorkerGroupSpec(
        "tp0", ("H3", "H4"), JaxMeshSpec(dp=1, tp=2), lm_models=("ShardLM",)), SPEC)
    assert jpf is None
    want = _jax_group_tokens(jgb, "ShardLM", session.paths)
    jgb.lm_backend.close()
    rows = [res["wire_tp"] for res in session.results()]
    for r, row in enumerate(rows):
        assert row["engine"] == "LMBackend" and row["prefill"] and row["replicate"] is False
        assert row["capacity"] == jgb.capacity == 2.0 and row["model"] == "ShardLM"
        assert row["degraded"]
        for fp in session.paths:
            assert row["results"][fp]["tokens"] == list(want[fp]["tokens"]), f"rank {r}"
    assert rows[0]["results"] == rows[1]["results"]
