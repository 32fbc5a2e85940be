"""The port's speculative decoding (dml_tpu_torch/inference/lm_server.py
`enable_spec_decode`, `generate.batched_verify_step`) against the JAX
package's, on the CPU: the counterparts of tests/test_specdec.py's
server cases.

Same JAX-initialised weights (the JAX tests' config), carried across by
`lm_params_from_flax`. The verify step is held to JAX's at logits atol
2e-4 (the port's bar, tests/test_torch_generate.py). Every proposal
source (an oracle, garbage, the target as its own draft, a smaller
draft, shipped drafts) must give JAX `generate`'s greedy tokens
exactly, and the acceptance accounting must equal the JAX server's on
the same proposals. Adopted slabs come from the JAX package's
`LMPrefillBackend.prefill_one`, so the port also adopts JAX-made rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dml_tpu.inference import generate as jg
from dml_tpu.inference.lm_server import LMServer as JaxServer
from dml_tpu.inference.lm_sharded import LMPrefillBackend
from dml_tpu.models.transformer import TransformerLM as JaxLM
from dml_tpu_torch.inference import generate as tg
from dml_tpu_torch.inference.lm_server import LMServer
from dml_tpu_torch.models.lm_params import lm_params_from_flax

pytestmark = pytest.mark.specdec

SHAPE = dict(vocab_size=61, d_model=32, n_heads=4, n_layers=2, d_ff=64, n_kv_heads=2)
JCFG = jg.LMConfig(dtype=jnp.float32, **SHAPE)
CFG = tg.LMConfig(dtype=torch.float32, **SHAPE)
DRAFT_SHAPE = dict(SHAPE, n_layers=1, d_model=16, d_ff=32)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _both(shape, seed):
    model = JaxLM(dtype=jnp.float32, **shape)
    jp = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    return jp, lm_params_from_flax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


@pytest.fixture(scope="module")
def both():
    return _both(SHAPE, 0)


def _isolated(jp, prompt, n):
    return np.asarray(jg.generate(jp, JCFG, jnp.asarray(np.asarray(prompt, np.int32)[None]), n))[0]


def _srv(params, **kw):
    kw.setdefault("max_slots", 4)
    kw.setdefault("max_len", 64)
    kw.setdefault("chunk", 4)
    return LMServer(params, CFG, **kw)


def _oracle_for(ref_of, vocab=None, corrupt_every=0):
    """A proposer reading precomputed isolated continuations; positions
    with e % corrupt_every == corrupt_every - 1 are made wrong."""

    def oracle(reqs, k):
        rows = np.zeros((len(reqs), k), np.int32)
        for i, r in enumerate(reqs):
            ref = ref_of[r.rid]
            for j in range(k):
                e = r.emitted + j
                tok = ref[e] if e < len(ref) else 0
                if corrupt_every and e % corrupt_every == corrupt_every - 1:
                    tok = (tok + 1) % vocab
                rows[i, j] = tok
        return rows

    return oracle


def test_verify_step_matches_jax_and_sequential_decode(both):
    """batched_verify_step's logits and cache rows against JAX's within
    2e-4, and equal (within float32 rounding) to T successive
    batched_decode_step calls, the equivalence that makes greedy
    speculation lossless."""
    jp, tp = both
    rng = np.random.RandomState(3)
    pp = rng.randint(0, CFG.vocab_size, (2, 8)).astype(np.int32)
    _, jcache = jg.prefill(jp, JCFG, jnp.asarray(pp), 32, logits_index=jnp.int32(7))
    _, cache = tg.prefill(tp, CFG, torch.from_numpy(pp), 32, logits_index=7)
    pos = np.asarray([8, 8], np.int32)
    toks = rng.randint(0, CFG.vocab_size, (2, 3)).astype(np.int32)
    j_lg, j_cache = jg.batched_verify_step(jp, JCFG, jcache, jnp.asarray(toks), jnp.asarray(pos))
    seq = {b: {k: v.clone() for k, v in lay.items()} for b, lay in cache.items()}
    lg, cache_v = tg.batched_verify_step(tp, CFG, cache, torch.from_numpy(toks), torch.from_numpy(pos))
    np.testing.assert_allclose(lg.numpy(), np.asarray(j_lg), atol=2e-4)
    for name in cache_v:
        for key in cache_v[name]:
            np.testing.assert_allclose(cache_v[name][key].numpy(), np.asarray(j_cache[name][key]),
                                       atol=2e-4, err_msg=f"{name}/{key}")
    for t in range(3):
        lt, seq = tg.batched_decode_step(tp, CFG, seq, torch.from_numpy(toks[:, t]),
                                         torch.from_numpy(pos + t))
        np.testing.assert_allclose(lg[:, t].numpy(), lt.numpy(), atol=2e-5)


def _spec_both(both, k, prompts, budget, proposer_of, **kw):
    """Serve the same burst on the port's and the JAX server with spec on;
    returns ((port outs, port stats), (JAX outs, JAX stats))."""
    jp, tp = both
    res = []
    for cls, params, cfg in ((LMServer, tp, CFG), (JaxServer, jp, JCFG)):
        ref_of = {}
        kw2 = dict(max_slots=4, max_len=64, chunk=4)
        kw2.update(kw)
        srv = cls(params, cfg, **kw2)
        srv.enable_spec_decode(k, proposer=proposer_of(ref_of))
        rids = srv.submit_many(prompts, budget)
        for rid, p in zip(rids, prompts):
            ref_of[rid] = [int(t) for t in _isolated(jp, p, budget)]
        out = srv.run()
        res.append(([out[r] for r in rids], srv.spec_stats()))
    return res


def test_oracle_proposer_exact_with_high_acceptance(both):
    jp, _ = both
    rng = np.random.RandomState(4)
    prompts = [rng.randint(0, CFG.vocab_size, n) for n in (7, 16, 11)]
    (mine, st), (theirs, jst) = _spec_both(both, 3, prompts, 12, lambda ref: _oracle_for(ref))
    for m, t, p in zip(mine, theirs, prompts):
        np.testing.assert_array_equal(m, t)
        np.testing.assert_array_equal(m, _isolated(jp, p, 12))
    assert st == jst
    assert st["enabled"] and st["accept_rate"] > 0.6 and st["rounds"] > 0


def test_corrupted_oracle_accounting_equals_jax(both):
    """An oracle wrong every third position: the same accept lengths,
    rounds and tokens on both servers."""
    rng = np.random.RandomState(15)
    prompts = [rng.randint(0, CFG.vocab_size, n) for n in (5, 12)]
    (mine, st), (theirs, jst) = _spec_both(
        both, 4, prompts, 14, lambda ref: _oracle_for(ref, vocab=61, corrupt_every=3))
    for m, t in zip(mine, theirs):
        np.testing.assert_array_equal(m, t)
    assert st == jst and 0.0 < st["accept_rate"] < 1.0


def test_garbage_proposals_never_change_tokens(both):
    jp, tp = both
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, CFG.vocab_size, n) for n in (9, 14)]
    grng = np.random.RandomState(99)
    srv = _srv(tp)
    srv.enable_spec_decode(4, proposer=lambda reqs, k: grng.randint(
        0, CFG.vocab_size, (len(reqs), k)).astype(np.int32))
    rids = srv.submit_many(prompts, 10)
    out = srv.run()
    for rid, p in zip(rids, prompts):
        np.testing.assert_array_equal(out[rid], _isolated(jp, p, 10))
    st = srv.spec_stats()
    assert st["accept_rate"] < 0.5 and st["enabled"]


def test_device_self_draft_is_exact_and_fully_accepted(both):
    jp, tp = both
    rng = np.random.RandomState(6)
    prompts = [rng.randint(0, CFG.vocab_size, n) for n in (8, 13)]
    srv = _srv(tp)
    srv.enable_spec_decode(3, draft_params=tp, draft_cfg=CFG)
    rids = srv.submit_many(prompts, 11)
    out = srv.run()
    for rid, p in zip(rids, prompts):
        np.testing.assert_array_equal(out[rid], _isolated(jp, p, 11))
    st = srv.spec_stats()
    assert st["accept_rate"] == 1.0 and st["proposed"] == st["accepted"] > 0 and st["enabled"]


def test_small_draft_model_exact_and_accounting_equals_jax(both):
    """A 1-layer draft (its own weights): tokens equal generate's and the
    acceptance accounting equals the JAX server's with the same draft."""
    jp, tp = both
    jd, td = _both(DRAFT_SHAPE, 1)
    dj = jg.LMConfig(dtype=jnp.float32, **DRAFT_SHAPE)
    dt = tg.LMConfig(dtype=torch.float32, **DRAFT_SHAPE)
    rng = np.random.RandomState(16)
    prompts = [rng.randint(0, CFG.vocab_size, n) for n in (6, 17, 10)]
    srv = _srv(tp)
    srv.enable_spec_decode(4, draft_params=td, draft_cfg=dt)
    rids = srv.submit_many(prompts, 13)
    out = srv.run()
    js = JaxServer(jp, JCFG, max_slots=4, max_len=64, chunk=4)
    js.enable_spec_decode(4, draft_params=jd, draft_cfg=dj)
    jrids = js.submit_many(prompts, 13)
    jout = js.run()
    for rid, jrid, p in zip(rids, jrids, prompts):
        np.testing.assert_array_equal(out[rid], jout[jrid])
        np.testing.assert_array_equal(out[rid], _isolated(jp, p, 13))
    assert srv.spec_stats() == js.spec_stats()


def test_auto_disable_below_break_even_is_typed_and_exact(both):
    jp, tp = both
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, CFG.vocab_size, n) for n in (6, 10)]
    grng = np.random.RandomState(123)
    srv = _srv(tp)
    srv.enable_spec_decode(4, proposer=lambda reqs, k: grng.randint(
        0, CFG.vocab_size, (len(reqs), k)).astype(np.int32), min_accept=0.6, min_samples=8)
    rids = srv.submit_many(prompts, 16)
    out = srv.run()
    for rid, p in zip(rids, prompts):
        np.testing.assert_array_equal(out[rid], _isolated(jp, p, 16))
    st = srv.spec_stats()
    assert st["enabled"] is False and st["disabled_reason"] == "acceptance"
    assert st["proposed"] >= 8
    srv.disable_spec_decode()  # idempotent
    assert srv.spec_stats()["disabled_reason"] == "acceptance"


def test_shipped_draft_seeds_exactly_one_verify_round(both):
    """A slab made by the JAX package's prefill role, with 3 shipped draft
    tokens, adopted by a port server with no local proposal source: one
    verify round consumes the shipment, then the chunk path takes over."""
    jp, tp = both
    rng = np.random.RandomState(8)
    prompt = rng.randint(0, CFG.vocab_size, 12).astype(np.int32)
    pf = LMPrefillBackend(jp, JCFG, max_len=64, draft=(jp, JCFG), draft_k=3)
    entry = pf.prefill_one(prompt, 10)
    assert len(entry["draft"]) == 3
    srv = _srv(tp)
    srv.enable_spec_decode(3)  # shipped-draft-only mode
    rid = srv.submit_prefilled(prompt, 10, entry["rows"], entry["first_token"],
                               draft_tokens=entry["draft"])
    out = srv.run()
    np.testing.assert_array_equal(out[rid], _isolated(jp, prompt, 10))
    st = srv.spec_stats()
    assert st["proposed"] == 3 and st["accepted"] == 3 and st["rounds"] == 1


def test_spec_near_max_len_falls_back_exactly(both):
    jp, tp = both
    rng = np.random.RandomState(9)
    prompt = rng.randint(0, CFG.vocab_size, 20).astype(np.int32)
    ref = _isolated(jp, prompt, 12)  # 20 + 12 == max_len exactly
    ref_of = {}
    srv = _srv(tp, max_len=32)
    srv.enable_spec_decode(4, proposer=_oracle_for(ref_of))
    rid = srv.submit(prompt, 12)
    ref_of[rid] = [int(t) for t in ref]
    np.testing.assert_array_equal(srv.run()[rid], ref)
    assert int(srv._pos_dev.max()) <= srv.max_len


def test_enable_spec_decode_validation(both):
    _, tp = both
    srv = _srv(tp)
    with pytest.raises(ValueError, match="k must be >= 1"):
        srv.enable_spec_decode(0)
    with pytest.raises(ValueError, match="no room in max_len"):
        _srv(tp, max_len=8).enable_spec_decode(7)
    with pytest.raises(ValueError, match="come together"):
        srv.enable_spec_decode(2, draft_params=tp)
    with pytest.raises(ValueError, match="ONE of"):
        srv.enable_spec_decode(2, draft_params=tp, draft_cfg=CFG,
                               proposer=lambda r, k: np.zeros((len(r), k), np.int32))
    bad_cfg = tg.LMConfig(vocab_size=7, d_model=32, n_heads=4, n_layers=2, d_ff=64,
                          dtype=torch.float32, n_kv_heads=2)
    with pytest.raises(ValueError, match="vocab"):
        srv.enable_spec_decode(2, draft_params=tp, draft_cfg=bad_cfg)
    with pytest.raises(ValueError, match="temperature"):
        _srv(tp, temperature=0.8).enable_spec_decode(2)
    busy = _srv(tp)
    busy.submit(np.arange(1, 5, dtype=np.int32), 4)
    with pytest.raises(RuntimeError, match="busy"):
        busy.enable_spec_decode(2)
    assert _srv(tp).spec_stats() is None


# -- adoption races: submit_prefilled from inside a step ---------------


def test_adoption_from_on_token_mid_step_is_exactly_once(both):
    """An on_token callback adopts a prefilled request during the step's
    delivery: the adoptee must not take this step's stale column; its
    first token arrives once (from the slab) and its decode starts at the
    next dispatch."""
    jp, tp = both
    rng = np.random.RandomState(10)
    p1 = rng.randint(0, CFG.vocab_size, 9).astype(np.int32)
    p2 = rng.randint(0, CFG.vocab_size, 13).astype(np.int32)
    entry = LMPrefillBackend(jp, JCFG, max_len=64).prefill_one(p2, 8)
    srv = _srv(tp, max_slots=2)
    holder = {}

    def adopt(_tok):
        if "rid" not in holder:
            holder["rid"] = srv.submit_prefilled(p2, 8, entry["rows"], entry["first_token"])

    rid1 = srv.submit_many([p1], [8], on_token=[adopt])[0]
    out = srv.run()
    assert set(out) == {rid1, holder["rid"]}
    np.testing.assert_array_equal(out[rid1], _isolated(jp, p1, 8))
    np.testing.assert_array_equal(out[holder["rid"]], _isolated(jp, p2, 8))
    assert len(out[holder["rid"]]) == 8


def test_adoption_races_slot_retirement_no_kv_aliasing(both):
    """A short request retires; a long request's callback adopts a slab
    into the freed slot while the long one decodes: the insert overwrites
    the retired rows whole and every request stays exact."""
    jp, tp = both
    rng = np.random.RandomState(11)
    p_short = rng.randint(0, CFG.vocab_size, 8).astype(np.int32)
    p_long = rng.randint(0, CFG.vocab_size, 10).astype(np.int32)
    p_new = rng.randint(0, CFG.vocab_size, 15).astype(np.int32)
    entry = LMPrefillBackend(jp, JCFG, max_len=64).prefill_one(p_new, 6)
    srv = _srv(tp, max_slots=2)
    state = {"seen": 0}

    def adopt_late(_tok):
        state["seen"] += 1
        if state["seen"] == 8 and "rid" not in state:
            state["rid"] = srv.submit_prefilled(p_new, 6, entry["rows"], entry["first_token"])

    rid_s, rid_l = srv.submit_many([p_short, p_long], [4, 16], on_token=[None, adopt_late])
    out = srv.run()
    assert "rid" in state, "adoption callback never fired"
    np.testing.assert_array_equal(out[rid_s], _isolated(jp, p_short, 4))
    np.testing.assert_array_equal(out[rid_l], _isolated(jp, p_long, 16))
    np.testing.assert_array_equal(out[state["rid"]], _isolated(jp, p_new, 6))


def test_adoption_mid_spec_step_is_exact(both):
    jp, tp = both
    rng = np.random.RandomState(12)
    p1 = rng.randint(0, CFG.vocab_size, 7).astype(np.int32)
    p2 = rng.randint(0, CFG.vocab_size, 12).astype(np.int32)
    ref1, ref2 = _isolated(jp, p1, 10), _isolated(jp, p2, 10)
    entry = LMPrefillBackend(jp, JCFG, max_len=64).prefill_one(p2, 10)
    ref_of = {}
    srv = _srv(tp, max_slots=2)
    srv.enable_spec_decode(3, proposer=_oracle_for(ref_of))
    holder = {}

    def adopt(_tok):
        if "rid" not in holder:
            holder["rid"] = srv.submit_prefilled(p2, 10, entry["rows"], entry["first_token"])
            ref_of[holder["rid"]] = [int(t) for t in ref2]

    rid1 = srv.submit_many([p1], [10], on_token=[adopt])[0]
    ref_of[rid1] = [int(t) for t in ref1]
    out = srv.run()
    np.testing.assert_array_equal(out[rid1], ref1)
    np.testing.assert_array_equal(out[holder["rid"]], ref2)
    assert srv.spec_stats()["proposed"] > 0


def test_submit_prefilled_validation(both):
    jp, tp = both
    prompt = np.arange(1, 6, dtype=np.int32)
    entry = LMPrefillBackend(jp, JCFG, max_len=64).prefill_one(prompt, 4)
    srv = _srv(tp, max_slots=1)
    short = {n: {k: v[:, :3] if not k.endswith("_s") else v[:, :, :3] for k, v in kv.items()}
             for n, kv in entry["rows"].items()}
    with pytest.raises(ValueError, match="T=3 != prompt 5"):
        srv.submit_prefilled(prompt, 4, short, entry["first_token"])
    rid = srv.submit_prefilled(prompt, 4, entry["rows"], entry["first_token"])
    with pytest.raises(RuntimeError, match="no free slot"):
        srv.submit_prefilled(prompt, 4, entry["rows"], entry["first_token"])
    np.testing.assert_array_equal(srv.run()[rid], _isolated(jp, prompt, 4))
