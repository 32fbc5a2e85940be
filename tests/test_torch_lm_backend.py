"""The port's LM backend (dml_tpu_torch/inference/lm_backend.py), its
weights codec (`models/params_io.variables_to_bytes` /
`variables_from_bytes`), and its copies of the metrics registry
(`observability.py`) and the speculative-decoding settings
(`config.py`), against the JAX package's, on the CPU.

- `parse_prompt_file` on the same files as JAX's, error messages
  included.
- `serve_files` (overlap and serial modes, per-file budgets, token
  streaming) against JAX's `LMBackend` on the same JAX-initialised
  weights: equal tokens.
- The codec: the port reads flax's bytes (float32 and bfloat16 leaves,
  chunked leaves) bit for bit, flax reads the port's, and the port
  writes the JAX package's exact bytes.
- `from_spec` over a JAX-written weights file gives JAX's greedy tokens.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dml_tpu import config as jconfig
from dml_tpu import observability as jobs
from dml_tpu.inference import generate as jg
from dml_tpu.inference import lm_backend as jlb
from dml_tpu.models import params_io as jpio
from dml_tpu.models.transformer import TransformerLM as JaxLM
from dml_tpu_torch import config as tconfig
from dml_tpu_torch import observability as tobs
from dml_tpu_torch.inference import generate as tg
from dml_tpu_torch.inference import lm_backend as tlb
from dml_tpu_torch.models import params_io as tpio
from dml_tpu_torch.models.lm_params import lm_params_from_flax

SHAPE = dict(vocab_size=61, d_model=32, n_heads=4, n_layers=2, d_ff=64, n_kv_heads=2)
JCFG = jg.LMConfig(dtype=jnp.float32, **SHAPE)
CFG = tg.LMConfig(dtype=torch.float32, **SHAPE)
SPEC = dict(SHAPE, name="TinyLM", dtype="float32", max_new_tokens=6, max_slots=2, max_len=64,
            chunk=3)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def both():
    model = JaxLM(dtype=jnp.float32, **SHAPE)
    jp = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    return jp, lm_params_from_flax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def _isolated(jp, prompt, n):
    return np.asarray(jg.generate(jp, JCFG, jnp.asarray(np.asarray(prompt, np.int32)[None]), n))[0]


# ----------------------------------------------------------------------
# prompt files
# ----------------------------------------------------------------------

PROMPT_FILES = {
    "plain": "3 1 4 1 5",
    "commas": "1, 2,3",
    "directive": "# max_new_tokens: 7\n3 1 4",
    "comment": "# note: hi\n5 6",
    "prose-mention": "# see max_new_tokens docs\n5 6",
    "out-of-range": "7 99",
    "empty": " ",
    "non-integer": "1 x",
    "bad-directive": "# max_new_tokens: zero\n5",
    "zero-budget": "# max_new_tokens: 0\n5",
    "missing-colon": "# max_new_tokens 64\n5",
}


@pytest.mark.parametrize("case", list(PROMPT_FILES))
def test_parse_prompt_file_matches_jax(tmp_path, case):
    path = str(tmp_path / f"{case}.tokens.txt")
    with open(path, "w") as f:
        f.write(PROMPT_FILES[case])
    results = []
    for mod in (jlb, tlb):
        try:
            ids, budget = mod.parse_prompt_file(path, 61)
            results.append(("ok", ids.tolist(), ids.dtype, budget))
        except ValueError as e:
            results.append(("error", str(e)))
    assert results[0] == results[1]


def test_write_prompt_file_round_trip(tmp_path):
    p = str(tmp_path / "a.tokens.txt")
    tlb.write_prompt_file(p, [3, 1, 4], max_new_tokens=7)
    ids, budget = jlb.parse_prompt_file(p, 61)
    assert ids.tolist() == [3, 1, 4] and budget == 7
    with pytest.raises(ValueError, match=">= 1"):
        tlb.write_prompt_file(p, [1], max_new_tokens=0)


# ----------------------------------------------------------------------
# serving
# ----------------------------------------------------------------------


def _files(tmp_path, rng, budgets, lens):
    paths, prompts = [], []
    for i, (b, n) in enumerate(zip(budgets, lens)):
        p = str(tmp_path / f"p{i}.tokens.txt")
        prompt = rng.randint(0, 61, n)
        jlb.write_prompt_file(p, prompt, max_new_tokens=b)
        paths.append(p)
        prompts.append(prompt)
    return paths, prompts


@pytest.mark.parametrize("overlap", [True, False], ids=["driver", "serial"])
def test_serve_files_matches_jax_backend(both, tmp_path, overlap):
    """Per-file budgets, both serving modes: the port's results equal the
    JAX backend's and each file's isolated generate."""
    jp, tp = both
    paths, prompts = _files(tmp_path, np.random.RandomState(10), [3, 8, None, 5], [4, 7, 10, 13])
    results = []
    for mod, params, cfg in ((tlb, tp, CFG), (jlb, jp, JCFG)):
        be = mod.LMBackend(params, cfg, max_new_tokens=6, max_slots=2, max_len=64, chunk=3)
        be.overlap = overlap
        try:
            res, infer_t, cost = be.serve_files(paths)
        finally:
            be.close()
        assert infer_t > 0 and cost["batch_size"] == 2 and cost["per_query"] > 0
        results.append(res)
    assert results[0] == results[1]
    for p, prompt, b in zip(paths, prompts, [3, 8, None, 5]):
        np.testing.assert_array_equal(results[0][p]["tokens"],
                                      _isolated(jp, prompt, b if b is not None else 6))


def test_on_token_streams_and_backend_coroutine(both, tmp_path):
    """Token streaming through serve_files (driver and serial) and the
    async `backend` form: the streamed text is the result's tokens."""
    _, tp = both
    paths, _ = _files(tmp_path, np.random.RandomState(5), [None] * 3, [5, 7, 9])
    for overlap in (True, False):
        be = tlb.LMBackend(tp, CFG, max_new_tokens=6, max_slots=2, max_len=64, chunk=3)
        be.overlap = overlap
        streamed = {}
        try:
            res, _, _ = be.serve_files(
                paths, on_token=lambda path, text: streamed.setdefault(path, []).append(text))
            via_async, _, _ = asyncio.run(be.backend("TinyLM", paths))
        finally:
            be.close()
        assert via_async == res
        for p in paths:
            assert [int(t) for t in "".join(streamed[p]).split()] == res[p]["tokens"]
        assert be.decode_tokens_total() == 36


def test_serve_files_validates_every_file_first(both, tmp_path):
    _, tp = both
    ok = str(tmp_path / "ok.tokens.txt")
    big = str(tmp_path / "big.tokens.txt")
    tlb.write_prompt_file(ok, [1, 2])
    tlb.write_prompt_file(big, list(range(60)), max_new_tokens=10)
    be = tlb.LMBackend(tp, CFG, max_new_tokens=4, max_slots=2, max_len=64, chunk=2)
    try:
        with pytest.raises(ValueError, match="big.tokens.txt: prompt of 60 tokens"):
            be.serve_files([ok, big])
        assert not be.server.has_work()
    finally:
        be.close()


def test_serve_prefilled_adopts_jax_slabs(both):
    """Slabs prefilled by the JAX package's prefill role, adopted by the
    port's backend, one of them None (a local prefill): tokens equal
    generate's, the first token streams too."""
    from dml_tpu.inference.lm_sharded import LMPrefillBackend

    jp, tp = both
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, 61, n) for n in (5, 9, 6)]
    pf = LMPrefillBackend(jp, JCFG, max_len=64)
    slabs = [pf.prefill_one(prompts[0], 5), pf.prefill_one(prompts[1], 5)]
    be = tlb.LMBackend(tp, CFG, max_new_tokens=5, max_slots=2, max_len=64, chunk=2)
    got = {i: [] for i in range(3)}
    try:
        toks, _ = be.serve_prefilled(prompts[:2], [5, 5], slabs,
                                     on_token=[(lambda t, i=i: got[i].append(int(t)))
                                               for i in range(2)])
        import queue

        q = queue.Queue()
        q.put((1, None))
        q.put((0, slabs[1]))
        toks2, _, stats = be.serve_prefilled_stream([prompts[1], prompts[1]], [5, 5], q)
    finally:
        be.close()
    for i in range(2):
        assert got[i] == [int(t) for t in toks[i]]
        np.testing.assert_array_equal(toks[i], _isolated(jp, prompts[i], 5))
    assert stats == {"adopted": 1, "local": 1}
    for t in toks2:
        np.testing.assert_array_equal(t, _isolated(jp, prompts[1], 5))


def test_cost_waits_for_the_jobs_layer(both):
    _, tp = both
    be = tlb.LMBackend(tp, CFG, max_slots=3, max_len=32, chunk=2)
    try:
        with pytest.raises(NotImplementedError, match="A6"):
            be.cost()
        assert be.cost_constants()["batch_size"] == 3
        assert be.kv_cache_stats() is None and be.spec_stats() is None
    finally:
        be.close()


# ----------------------------------------------------------------------
# the weights codec
# ----------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_codec_reads_and_writes_flax_bytes_bit_exactly(both, dtype):
    """The JAX package's bytes of the LM tree (float32, or every leaf
    cast to bfloat16) -> the port's tensors, bit-equal; the port's bytes
    of those tensors are the same bytes, and flax reads them back
    bit-equal."""
    jp, _ = both
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tree = {"params": jax.tree_util.tree_map(lambda x: np.asarray(x.astype(jdt)), jp),
            "step": np.int32(3)}
    data = jpio.variables_to_bytes(tree)
    mine = tpio.variables_from_bytes(data)
    flat_j = jax.tree_util.tree_leaves_with_path(tree)
    for path, leaf in flat_j:
        node = mine
        for k in path:
            node = node[k.key]
        assert node.dtype == {"float32": torch.float32, "bfloat16": torch.bfloat16,
                              "int32": torch.int32}[np.asarray(leaf).dtype.name]
        want = np.asarray(leaf)
        got = node.view(torch.int16).numpy() if node.dtype == torch.bfloat16 else node.numpy()
        np.testing.assert_array_equal(got, want.view(np.int16) if dtype == "bfloat16"
                                      and want.dtype.name == "bfloat16" else want)
    assert tpio.variables_to_bytes(mine) == data
    back = jpio.variables_from_bytes(tpio.variables_to_bytes(mine), tree)
    for (_, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(back), flat_j):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


def test_codec_scalars_chunks_and_like(monkeypatch):
    """flax's ext type 3 scalars, its chunked form (a leaf over the chunk
    size; shrunk here to 64 bytes on both sides), and a `like` tree whose
    keys the data lacks."""
    from flax import serialization

    data = serialization.to_bytes({"s": np.float32(2.5), "i": np.int8(-3)})
    assert tpio.variables_from_bytes(data) == {"s": 2.5, "i": -3}
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(tpio, "_MAX_CHUNK_BYTES", 64)
    big = np.arange(100, dtype=np.float32).reshape(4, 25)
    flax_bytes = serialization.to_bytes({"w": big})
    got = tpio.variables_from_bytes(flax_bytes)["w"]
    np.testing.assert_array_equal(got.numpy(), big)
    assert tpio.variables_to_bytes({"w": torch.from_numpy(big)}) == flax_bytes
    with pytest.raises(ValueError, match="no keys"):
        tpio.variables_from_bytes(flax_bytes, {"w": None, "b": None})
    assert set(tpio.variables_from_bytes(flax_bytes, {"w": None})) == {"w"}


def test_from_spec_over_jax_weights_file_gives_jax_tokens(both, tmp_path):
    """A weights file written by the JAX package, named in the spec: the
    port's backend serves JAX's greedy tokens, and the JAX backend built
    from the same spec agrees; the port's own bytes of the same params
    serve the same tokens."""
    jp, tp = both
    wpath = str(tmp_path / "lm.msgpack")
    with open(wpath, "wb") as f:
        f.write(jpio.variables_to_bytes({"params": jp}))
    spec = dict(SPEC, weights=wpath)
    paths, prompts = _files(tmp_path, np.random.RandomState(23), [None, 4], [6, 11])
    be = tlb.LMBackend.from_spec(spec, device="cpu")
    jbe = jlb.LMBackend.from_spec(spec)
    try:
        mine, _, _ = be.serve_files(paths)
        theirs, _, _ = jbe.serve_files(paths)
    finally:
        be.close()
        jbe.close()
    assert mine == theirs
    for p, prompt, b in zip(paths, prompts, [6, 4]):
        np.testing.assert_array_equal(mine[p]["tokens"], _isolated(jp, prompt, b))
    own = str(tmp_path / "own.msgpack")
    with open(own, "wb") as f:
        f.write(tpio.variables_to_bytes({"params": tp}))
    be2 = tlb.LMBackend.from_spec(dict(spec, weights=own), device="cpu")
    try:
        assert be2.serve_files(paths)[0] == mine
    finally:
        be2.close()


def test_from_spec_options_and_device(monkeypatch):
    spec = dict(SPEC, n_layers=1, kv_cache_mb=8, spec_k=2, overlap=False)
    be = tlb.LMBackend.from_spec(spec, device="cpu")
    try:
        assert be.kv_cache is not None and be.kv_cache.max_bytes == 8 << 20
        assert be.server.kv_cache is be.kv_cache and be.overlap is False
        st = be.spec_stats()
        assert st["k"] == 2 and st["enabled"]
        assert be.server._spec.draft_cfg.d_model == 16  # config.draft_lm_spec's half width
        assert be.server._spec.min_accept == tconfig.SPEC_MIN_ACCEPT_DEFAULT
    finally:
        be.close()
    plain = tlb.LMBackend.from_spec(SPEC, device="cpu")
    try:
        assert plain.kv_cache is None and plain.spec_stats() is None
        assert plain.server.chunk == 3 and plain.server.params["block_0"]["qkv"]["kernel"].dtype \
            == torch.float32
    finally:
        plain.close()
    # no device argument means cuda, which raises where there is none
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlb.LMBackend.from_spec(SPEC)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlb.lm_spec_parts(SPEC)


# ----------------------------------------------------------------------
# the copies: config and the metrics registry
# ----------------------------------------------------------------------


@pytest.mark.parametrize("spec", [
    {"vocab_size": 61, "d_model": 32, "n_heads": 4, "n_layers": 2, "n_kv_heads": 2},
    {"vocab_size": 32000, "d_model": 1024, "n_heads": 16, "n_layers": 12, "d_ff": 4096,
     "n_kv_heads": 4, "seed": 5, "name": "LM198M", "max_slots": 8, "weights": "w"},
    {"vocab_size": 256, "d_model": 36, "n_heads": 6, "dtype": "float32"},
])
def test_config_copy_matches_jax(spec):
    assert tconfig.draft_lm_spec(spec) == jconfig.draft_lm_spec(spec)
    assert tconfig.draft_lm_spec(spec, n_layers=3) == jconfig.draft_lm_spec(spec, n_layers=3)
    assert tconfig.SPEC_MIN_ACCEPT_DEFAULT == jconfig.SPEC_MIN_ACCEPT_DEFAULT
    assert tconfig.SPEC_MIN_SAMPLES_DEFAULT == jconfig.SPEC_MIN_SAMPLES_DEFAULT
    assert tlb.LMBackend._draft_spec_of(dict(spec, spec_k=2)) == \
        jlb.LMBackend._draft_spec_of(dict(spec, spec_k=2))


def test_registry_copy_matches_jax():
    """The same operations on a fresh JAX registry and a fresh port
    registry: the same snapshot (less the clock and pid) and the same
    Prometheus text; the shared bucket edges are equal."""
    assert tobs.log_buckets(1e-3, 10.0, 4) == jobs.log_buckets(1e-3, 10.0, 4)
    assert tobs.DEFAULT_TIME_BUCKETS == jobs.DEFAULT_TIME_BUCKETS
    regs = (jobs.MetricsRegistry(), tobs.MetricsRegistry())
    for reg in regs:
        c = reg.counter("lm_server_requests_total", "requests")
        c.inc(3)
        c.labels(reason="acceptance").inc()
        g = reg.gauge("lm_server_slots_active", "slots")
        g.set(5)
        g.labels(pool="a").inc(2)
        g.labels(pool="a").dec()
        h = reg.histogram("lm_server_step_seconds", "step")
        for v in (0.0002, 0.03, 0.03, 7.0, 500.0):
            h.observe(v)
        reg.histogram("lm_custom", edges=(1.0, 2.0)).observe(1.5)
        assert reg.counter("lm_server_requests_total") is c
        with pytest.raises(ValueError, match="already registered"):
            reg.gauge("lm_server_requests_total")
    snaps = [r.snapshot(node="n1") for r in regs]
    for s in snaps:
        s.pop("ts"), s.pop("proc")
    assert snaps[0] == snaps[1]
    assert regs[0].to_prometheus_text() == regs[1].to_prometheus_text()
    for reg in regs:
        reg.reset()
    assert regs[1].snapshot()["counters"] == {} and regs[1].to_prometheus_text() == ""
    assert regs[1].counter("lm_server_requests_total").value() == 0.0
    with pytest.raises(ValueError, match="strictly increase"):
        tobs.Histogram("x", edges=(2.0, 1.0))


def test_server_and_cache_write_the_port_registry():
    """The port's server and cache register the JAX package's metric
    names in the port's own METRICS."""
    from dml_tpu_torch.inference import kv_cache, lm_server  # noqa: F401

    assert {"lm_server_requests_total", "lm_server_steps_total", "lm_specdec_disabled_total",
            "lm_kv_cache_hits_total", "lm_kv_cache_bytes"} <= set(tobs.METRICS._metrics)


def test_from_spec_over_jax_moe_weights_file(tmp_path):
    """An MoE tree in a JAX weights file (the spec has no MoE field; the
    layout is the tree's): the codec reads and writes its bytes exactly,
    and the port's backend serves JAX generate's tokens. (The JAX
    backend restores a file into the dense tree its spec describes, so
    it cannot load this one.)"""
    model = JaxLM(dtype=jnp.float32, num_experts=4, moe_every=2, **SHAPE)
    jp = model.init(jax.random.PRNGKey(4), jnp.zeros((1, 8), jnp.int32))["params"]
    data = jpio.variables_to_bytes({"params": jp})
    assert tpio.variables_to_bytes(tpio.variables_from_bytes(data)) == data
    wpath = str(tmp_path / "moe.msgpack")
    with open(wpath, "wb") as f:
        f.write(data)
    spec = dict(SPEC, weights=wpath)
    paths, prompts = _files(tmp_path, np.random.RandomState(24), [None, 5], [9, 14])
    be = tlb.LMBackend.from_spec(spec, device="cpu")
    try:
        mine, _, _ = be.serve_files(paths)
    finally:
        be.close()
    for p, prompt, b in zip(paths, prompts, [6, 5]):
        np.testing.assert_array_equal(mine[p]["tokens"], _isolated(jp, prompt, b))
