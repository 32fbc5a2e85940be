"""The port's KV prefix cache (dml_tpu_torch/inference/kv_cache.py)
against the JAX package's, on the CPU: the counterparts of
tests/test_kv_cache.py's cache and server cases.

- The trie, LRU budget, refcounts and close: the same operation sequence
  on the JAX package's `KVPrefixCache` (numpy slabs) and the port's (CPU
  tensor slabs of the same bytes) gives the same answers and the same
  `stats()`.
- `SuffixPrefiller` against JAX's on the same prefix slab and suffix:
  rows and logits-level agreement at atol 2e-4, the same first token.
- Warm starts through the server: tokens equal JAX `generate`'s (and a
  cold server's under kv_quant), with hits and saved tokens counted.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dml_tpu.inference import generate as jg
from dml_tpu.inference import kv_cache as jkv
from dml_tpu.models.transformer import TransformerLM as JaxLM
from dml_tpu_torch.inference import generate as tg
from dml_tpu_torch.inference import kv_cache as tkv
from dml_tpu_torch.inference.lm_server import LMServer
from dml_tpu_torch.models.lm_params import lm_params_from_flax

pytestmark = pytest.mark.kvcache

SHAPE = dict(vocab_size=61, d_model=32, n_heads=4, n_layers=2, d_ff=64, n_kv_heads=2)
JCFG = jg.LMConfig(dtype=jnp.float32, **SHAPE)
CFG = tg.LMConfig(dtype=torch.float32, **SHAPE)


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


def _isolated(jp, prompt, n, cfg=JCFG):
    return np.asarray(jg.generate(jp, cfg, jnp.asarray(np.asarray(prompt, np.int32)[None]), n))[0]


# ----------------------------------------------------------------------
# cache mechanics: one script, both caches
# ----------------------------------------------------------------------


def _rows(n, fill=1.0, width=4, torch_side=False):
    """A synthetic slab for n positions: one layer, [1, n, width] f32."""
    a = np.full((1, n, width), fill, np.float32)
    if torch_side:
        return {"block_0": {"k": torch.from_numpy(a.copy()), "v": torch.from_numpy(a.copy())}}
    return {"block_0": {"k": a, "v": a.copy()}}


def _arr(*toks):
    return np.asarray(toks, np.int32)


class _Pair:
    """Runs every call on the JAX cache and the port's, asserting equal
    results (leases compared by their usable length)."""

    def __init__(self, max_bytes=1 << 20, **kw):
        self.j = jkv.KVPrefixCache(max_bytes, **kw)
        self.t = tkv.KVPrefixCache(max_bytes, **kw)

    def offer(self, tokens, n, **kw):
        a = self.j.offer(tokens, _rows(n, **kw))
        b = self.t.offer(tokens, _rows(n, torch_side=True, **kw))
        assert a == b
        return a

    def match_len(self, prompt):
        a, b = self.j.match_len(prompt), self.t.match_len(prompt)
        assert a == b
        return a

    def acquire(self, prompt):
        a, b = self.j.acquire(prompt), self.t.acquire(prompt)
        assert (a is None) == (b is None)
        if a is not None:
            assert a.m == b.m
            ja, ta = a.prefix_rows(), b.prefix_rows()
            np.testing.assert_array_equal(ta["block_0"]["k"].numpy(), ja["block_0"]["k"])
        return (a, b)

    def stats(self):
        a, b = self.j.stats(), self.t.stats()
        assert a == b, (a, b)
        return a


def _release(pair_lease):
    for lease in pair_lease:
        lease.release()


def test_trie_longest_match_and_partial_overlap():
    c = _Pair()
    toks = np.arange(10, dtype=np.int32)
    assert c.offer(toks, 10)
    assert c.match_len(np.concatenate([toks, [77, 78]]).astype(np.int32)) == 10
    assert c.match_len(np.concatenate([toks[:6], [50, 51, 52]]).astype(np.int32)) == 6
    assert c.match_len(toks) == 9  # one suffix token must remain
    assert c.match_len(_arr(99, 98)) == 0
    c2 = _Pair(min_match=8)
    assert c2.offer(toks, 10)
    assert c2.match_len(np.concatenate([toks[:6], [50, 51, 52]]).astype(np.int32)) == 0
    assert c.stats()["misses"] == 0
    assert c.acquire(_arr(99)) == (None, None)
    assert c.stats()["misses"] == 1


def test_budget_lru_eviction_order():
    sz = tkv.rows_nbytes(_rows(8, torch_side=True))
    assert sz == jkv.rows_nbytes(_rows(8))
    c = _Pair(max_bytes=3 * sz)
    a, b = np.arange(1, 9, dtype=np.int32), np.arange(11, 19, dtype=np.int32)
    d, e = np.arange(21, 29, dtype=np.int32), np.arange(31, 39, dtype=np.int32)
    assert c.offer(a, 8) and c.offer(b, 8) and c.offer(d, 8)
    lease = c.acquire(np.concatenate([a, [9]]).astype(np.int32))
    assert lease[1].m == 8
    _release(lease)
    assert c.offer(e, 8)
    assert c.match_len(np.concatenate([b, [9]]).astype(np.int32)) == 0
    assert c.match_len(np.concatenate([a, [9]]).astype(np.int32)) == 8
    assert c.stats()["evictions"] == 1
    assert not c.offer(np.arange(100, 200, dtype=np.int32), 100, width=4096)


def test_refcount_blocks_eviction_until_release():
    sz = tkv.rows_nbytes(_rows(8, torch_side=True))
    c = _Pair(max_bytes=2 * sz)
    a, b = np.arange(1, 9, dtype=np.int32), np.arange(11, 19, dtype=np.int32)
    d = np.arange(21, 29, dtype=np.int32)
    assert c.offer(a, 8) and c.offer(b, 8)
    la = c.acquire(np.concatenate([a, [9]]).astype(np.int32))
    lb = c.acquire(np.concatenate([b, [9]]).astype(np.int32))
    assert not c.offer(d, 8)
    st = c.stats()
    assert st["entries"] == 2 and st["evictions"] == 0
    _release(la)
    assert c.offer(d, 8)
    assert c.match_len(np.concatenate([a, [9]]).astype(np.int32)) == 0
    assert c.match_len(np.concatenate([b, [9]]).astype(np.int32)) == 8
    _release(lb)
    c.stats()


def test_dominated_prefix_entry_dropped_on_insert():
    c = _Pair()
    a, longer = _arr(1, 2, 3, 4), _arr(1, 2, 3, 4, 5, 6)
    assert c.offer(a, 4) and c.offer(longer, 6)
    st = c.stats()
    assert st["entries"] == 1 and st["evictions"] == 1
    assert c.match_len(_arr(1, 2, 3, 4, 9)) == 4
    assert not c.offer(a, 4)
    assert c.stats()["inserts"] == 2


def test_close_refuses_inserts_and_drops_pinned_on_release():
    c = _Pair()
    a, b = _arr(1, 2, 3, 4), _arr(9, 8, 7, 6)
    assert c.offer(a, 4) and c.offer(b, 4)
    lease = c.acquire(_arr(1, 2, 3, 4, 5))
    c.j.close()
    c.t.close()
    assert c.stats()["entries"] == 1
    assert not c.offer(_arr(5, 5, 5), 3)
    _release(lease)
    st = c.stats()
    assert st["entries"] == 0 and st["bytes"] == 0


def test_slab_helpers_and_capture_copies():
    """slice/concat along each leaf's position axis (scales on axis 2),
    and capture_slot_rows copies: changing the cache afterwards leaves
    the captured rows as they were."""
    cache = tg.init_cache(dataclasses.replace(CFG, kv_quant=True), 2, 16, device="cpu")
    for lay in cache.values():
        for v in lay.values():
            v.copy_(torch.arange(v.numel()).reshape(v.shape).to(v.dtype))
    rows = tkv.capture_slot_rows(cache, 1, 5)
    assert rows["block_0"]["k_q"].shape == (2, 5, 8) and rows["block_0"]["k_s"].shape == (2, 1, 5)
    want = cache["block_1"]["v_s"][1, :, :, :5].clone()
    cache["block_1"]["v_s"].zero_()
    assert torch.equal(rows["block_1"]["v_s"], want)
    assert rows["block_0"]["k_q"].is_contiguous()
    head = tkv.slice_rows(rows, 2)
    assert head["block_0"]["v_q"].shape == (2, 2, 8) and head["block_0"]["v_s"].shape == (2, 1, 2)
    both_ = tkv.concat_rows(head, tkv.slice_rows(rows, 3))
    assert both_["block_0"]["k_s"].shape == (2, 1, 5)
    assert tkv.rows_nbytes(rows) == sum(a.numel() * a.element_size()
                                        for kv in rows.values() for a in kv.values())
    # host slabs are CPU tensors
    c = tkv.KVPrefixCache(1 << 20)
    assert c.offer(np.arange(5, dtype=np.int32), rows)
    lease = c.acquire(np.arange(7, dtype=np.int32))
    assert isinstance(lease.prefix_rows()["block_0"]["k_q"], torch.Tensor)
    lease.release()


# ----------------------------------------------------------------------
# suffix prefill against JAX's
# ----------------------------------------------------------------------


@pytest.mark.parametrize("kv_quant", [False, True], ids=["f32", "kv_quant"])
def test_suffix_prefiller_matches_jax(both, kv_quant):
    """The same prefix slab (JAX's cold prefill rows for the first m
    positions), the same suffix: the port's suffix rows equal JAX's
    within 2e-4 (int8 values within one quantization step), and the
    first token is the same; both equal a full cold prefill's."""
    jp, tp = both
    jcfg = dataclasses.replace(JCFG, kv_quant=kv_quant)
    tcfg = dataclasses.replace(CFG, kv_quant=kv_quant)
    rng = np.random.RandomState(21)
    prompt = rng.randint(0, 61, 23).astype(np.int32)
    m = 14
    _, jcache = jg.prefill(jp, jcfg, jnp.asarray(prompt[None]), 64)
    prefix = {name: {k: np.asarray(v)[0][:, :, :m] if k.endswith("_s") else np.asarray(v)[0][:, :m]
                     for k, v in lay.items()} for name, lay in jcache.items()}
    j_first, j_rows = jkv.SuffixPrefiller(jcfg, 64)(jp, prefix, m, prompt[m:])
    t_prefix = {n: {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in kv.items()}
                for n, kv in prefix.items()}
    t_first, t_rows = tkv.SuffixPrefiller(tcfg, 64)(tp, t_prefix, m, prompt[m:])
    assert t_first == j_first
    cold = np.asarray(jg.generate(jp, jcfg, jnp.asarray(prompt[None]), 1))[0, 0]
    assert t_first == int(cold)
    for name, kv in j_rows.items():
        for key, a in kv.items():
            mine = t_rows[name][key]
            assert isinstance(mine, torch.Tensor) and mine.device.type == "cpu"
            a = np.asarray(a)
            assert tuple(mine.shape) == a.shape, (name, key)
            if key.endswith("_q"):
                scale = np.swapaxes(np.asarray(kv[key[0] + "_s"]), 1, 2)
                deq_m = mine.float().numpy() * np.swapaxes(t_rows[name][key[0] + "_s"].numpy(), 1, 2)
                assert (np.abs(deq_m - a.astype(np.float32) * scale) <= scale + 2e-4).all()
            else:
                np.testing.assert_allclose(mine.float().numpy(), a.astype(np.float32), atol=2e-4,
                                           err_msg=f"{name}/{key}")


# ----------------------------------------------------------------------
# warm placement through the server
# ----------------------------------------------------------------------


def test_warm_equals_cold_mixed_budgets_and_bucket_boundaries(both):
    """Multi-turn warm starts across the 16-token bucket boundary and
    mixed budgets give JAX generate's tokens; a burst of warm prompts too."""
    jp, tp = both
    srv = LMServer(tp, CFG, max_slots=2, max_len=128, chunk=4)
    cache = tkv.KVPrefixCache(64 << 20)
    srv.enable_kv_cache(cache)
    rng = np.random.RandomState(11)
    for tp_len, budget in ((15, 5), (16, 3), (17, 7), (9, 1)):
        base = rng.randint(0, 61, tp_len).astype(np.int32)
        r1 = srv.submit(base, budget)
        out1 = srv.run([r1])[r1]
        np.testing.assert_array_equal(out1, _isolated(jp, base, budget))
        nxt = np.concatenate([base, out1, rng.randint(0, 61, 4).astype(np.int32)])
        r2 = srv.submit(nxt, budget + 2)
        np.testing.assert_array_equal(srv.run([r2])[r2], _isolated(jp, nxt, budget + 2))
    st = cache.stats()
    assert st["hits"] >= 4 and st["tokens_saved"] > 0
    hist = rng.randint(0, 61, 12).astype(np.int32)
    r = srv.submit(hist, 6)
    out = srv.run([r])[r]
    prompts = [np.concatenate([hist, out, rng.randint(0, 61, k).astype(np.int32)]) for k in (2, 3)]
    rids = srv.submit_many(prompts, [4, 9])
    done = srv.run(rids)
    for rid, p, b in zip(rids, prompts, [4, 9]):
        np.testing.assert_array_equal(done[rid], _isolated(jp, p, b))
    assert cache.stats()["hits"] >= st["hits"] + 2


def test_warm_equals_cold_kv_quant(both):
    """kv_quant slabs (int8 + scale leaves) round-trip through the cache
    and the warm continuation equals a cold server of the same config,
    the port's and the JAX package's."""
    from dml_tpu.inference.lm_server import LMServer as JaxServer

    jp, tp = both
    qcfg = dataclasses.replace(CFG, kv_quant=True)
    warm = LMServer(tp, qcfg, max_slots=2, max_len=128, chunk=4)
    warm.enable_kv_cache(tkv.KVPrefixCache(64 << 20))
    cold = LMServer(tp, qcfg, max_slots=2, max_len=128, chunk=4)
    rng = np.random.RandomState(5)
    base = rng.randint(0, 61, 14).astype(np.int32)
    r1 = warm.submit(base, 6)
    out1 = warm.run([r1])[r1]
    nxt = np.concatenate([base, out1, rng.randint(0, 61, 3).astype(np.int32)])
    rw = warm.submit(nxt, 5)
    got = warm.run([rw])[rw]
    rc = cold.submit(nxt, 5)
    np.testing.assert_array_equal(got, cold.run([rc])[rc])
    js = JaxServer(jp, dataclasses.replace(JCFG, kv_quant=True), max_slots=2, max_len=128, chunk=4)
    rj = js.submit(nxt, 5)
    np.testing.assert_array_equal(got, js.run([rj])[rj])
    assert warm.kv_cache.stats()["hits"] == 1


def test_sampled_serving_never_warm_starts(both):
    _, tp = both
    srv = LMServer(tp, CFG, max_slots=2, max_len=128, chunk=4, temperature=0.8, seed=3)
    srv.enable_kv_cache(tkv.KVPrefixCache(64 << 20))
    rng = np.random.RandomState(7)
    base = rng.randint(0, 61, 10).astype(np.int32)
    r1 = srv.submit(base, 5)
    out1 = srv.run([r1])[r1]
    r2 = srv.submit(np.concatenate([base, out1, [3, 4]]).astype(np.int32), 5)
    srv.run([r2])
    st = srv.kv_cache.stats()
    assert st["hits"] == 0 and st["misses"] == 0 and st["inserts"] == 0


def test_enable_disable_roundtrip_is_cold_path(both):
    jp, tp = both
    srv = LMServer(tp, CFG, max_slots=2, max_len=128, chunk=4)
    cache = tkv.KVPrefixCache(64 << 20)
    srv.enable_kv_cache(cache)
    srv.enable_kv_cache(None)
    assert srv.kv_cache is None and srv._warm is None
    p = np.random.RandomState(9).randint(0, 61, 12).astype(np.int32)
    r = srv.submit(p, 6)
    np.testing.assert_array_equal(srv.run([r])[r], _isolated(jp, p, 6))
    assert cache.stats()["inserts"] == 0


def test_failed_warm_start_falls_back_to_cold(both, monkeypatch):
    """A warm start that raises demotes to the cold prefill: the request
    is still exact, and no hit is counted."""
    jp, tp = both
    srv = LMServer(tp, CFG, max_slots=2, max_len=128, chunk=4)
    cache = tkv.KVPrefixCache(64 << 20)
    srv.enable_kv_cache(cache)
    rng = np.random.RandomState(19)
    base = rng.randint(0, 61, 10).astype(np.int32)
    r1 = srv.submit(base, 3)
    out1 = srv.run([r1])[r1]

    def broken(*a, **k):
        raise RuntimeError("stale slab")

    monkeypatch.setattr(srv._warm.prefiller, "__call__", broken)
    monkeypatch.setattr(tkv.SuffixPrefiller, "__call__", broken)
    nxt = np.concatenate([base, out1, [5, 6]]).astype(np.int32)
    r2 = srv.submit(nxt, 4)
    np.testing.assert_array_equal(srv.run([r2])[r2], _isolated(jp, nxt, 4))
    assert cache.stats()["hits"] == 0


def test_moe_suffix_prefill_and_warm_start_match_jax():
    """An MoE tree (block_1 a mixture of 4 experts): the suffix prefill
    over a prefix slab gives JAX's rows and first token, and a warm second
    turn through the server gives JAX generate's tokens."""
    model = JaxLM(dtype=jnp.float32, num_experts=4, moe_every=2, **SHAPE)
    jp = model.init(jax.random.PRNGKey(3), jnp.zeros((1, 8), jnp.int32))["params"]
    tp = lm_params_from_flax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    rng = np.random.RandomState(22)
    prompt = rng.randint(0, 61, 21).astype(np.int32)
    m = 13
    _, jcache = jg.prefill(jp, JCFG, jnp.asarray(prompt[None]), 64)
    prefix = {name: {k: np.asarray(v)[0][:, :m] for k, v in lay.items()}
              for name, lay in jcache.items()}
    j_first, j_rows = jkv.SuffixPrefiller(JCFG, 64)(jp, prefix, m, prompt[m:])
    t_prefix = {n: {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in kv.items()}
                for n, kv in prefix.items()}
    t_first, t_rows = tkv.SuffixPrefiller(CFG, 64)(tp, t_prefix, m, prompt[m:])
    assert t_first == j_first
    for name, kv in j_rows.items():
        for key, a in kv.items():
            np.testing.assert_allclose(t_rows[name][key].numpy(), np.asarray(a), atol=2e-4,
                                       err_msg=f"{name}/{key}")
    srv = LMServer(tp, CFG, max_slots=2, max_len=128, chunk=4)
    cache = tkv.KVPrefixCache(64 << 20)
    srv.enable_kv_cache(cache)
    r1 = srv.submit(prompt, 6)
    out1 = srv.run([r1])[r1]
    np.testing.assert_array_equal(out1, _isolated(jp, prompt, 6))
    nxt = np.concatenate([prompt, out1, rng.randint(0, 61, 5).astype(np.int32)])
    r2 = srv.submit(nxt, 7)
    np.testing.assert_array_equal(srv.run([r2])[r2], _isolated(jp, nxt, 7))
    assert cache.stats()["hits"] >= 1
