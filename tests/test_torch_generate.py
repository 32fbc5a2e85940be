"""The port's LM serving path (prefill, per-slot decode, verify, generate)
against the JAX package's, on the CPU.

Same JAX-initialised weights on both sides (converted by
`lm_params_from_flax`), same numpy-seeded prompts. JAX's prefill runs its
flash kernel in interpret mode and its decode step its einsum (what it
runs off the TPU); the port runs the kernels' plain versions on CPU
tensors. Configurations: the small config of tests/test_generate.py
(float32, MHA), a GQA-2 variant, an int8-KV-cache (`kv_quant`) variant,
and a bfloat16 one.

Tolerances: float32 logits and caches within 2e-4, the bar of
tests/test_generate.py. The int8 cache is held to one quantization step
(its scale) beside that: a K or V value that lands within float32
rounding of a half step may round to the neighbouring int8 on the other
side. Greedy tokens are held equal exactly, for float and int8 weights.
The bfloat16 configuration is held to JAX's generate run op by op
(prefill, then one decode_step per token): the port rounds where JAX's
ops do, and matches that bit for bit, but compiled into one scan XLA
fuses elementwise bf16 ops and drops some of those roundings, so the
scan's tokens can differ from both on a near tie.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dml_tpu.inference import generate as jg
from dml_tpu.inference.quantize import quantize_lm_params as jax_quantize
from dml_tpu.models.transformer import TransformerLM as JaxLM
from dml_tpu_torch.inference import generate as tg
from dml_tpu_torch.inference.quantize import quantize_lm_params
from dml_tpu_torch.models.lm_params import lm_params_from_flax
from dml_tpu_torch.ops import decode_attention as da
from dml_tpu_torch.ops import flash_attention as fa

# name -> (n_heads, n_kv_heads, kv_quant)
CONFIGS = {"base": (2, None, False), "gqa2": (4, 2, False), "kvq": (4, 2, True)}
TP, MAX_LEN = 7, 16


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    # the tests run beside other test processes on a shared CPU; torch's
    # default of one thread per core oversubscribes it
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfgs(name, jdtype=jnp.float32, tdtype=torch.float32):
    h, kv, quant = CONFIGS[name]
    shape = dict(vocab_size=61, d_model=32, n_heads=h, n_layers=2, d_ff=64, n_kv_heads=kv,
                 kv_quant=quant)
    return jg.LMConfig(dtype=jdtype, **shape), tg.LMConfig(dtype=tdtype, **shape)


_PARAMS = {}


def _params(name):
    """(JAX params, port params) on the same JAX-initialised weights."""
    if name not in _PARAMS:
        jcfg, _ = _cfgs(name)
        model = JaxLM(vocab_size=jcfg.vocab_size, d_model=jcfg.d_model, n_heads=jcfg.n_heads,
                      n_layers=jcfg.n_layers, d_ff=jcfg.d_ff, dtype=jnp.float32,
                      n_kv_heads=jcfg.n_kv_heads)
        jp = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
        _PARAMS[name] = jp, lm_params_from_flax(jax.tree_util.tree_map(np.asarray, jp),
                                                device="cpu")
    return _PARAMS[name]


def _prompt(b=2, t=TP, seed=5):
    return np.random.RandomState(seed).randint(0, 61, (b, t)).astype(np.int32)


def _to_torch_cache(cache):
    return {blk: {k: torch.from_numpy(np.array(v)) for k, v in lay.items()}
            for blk, lay in cache.items()}


def _check_cache(mine, theirs, quant):
    for blk, lay in theirs.items():
        if quant:
            for q, s in (("k_q", "k_s"), ("v_q", "v_s")):
                deq_t = np.asarray(lay[q], np.float32) * np.swapaxes(np.asarray(lay[s]), 2, 3)
                deq_m = (mine[blk][q].float() * mine[blk][s].transpose(2, 3)).numpy()
                step = np.swapaxes(np.asarray(lay[s]), 2, 3)
                assert (np.abs(deq_m - deq_t) <= step + 2e-4).all(), f"{blk}.{q}"
                np.testing.assert_allclose(mine[blk][s].numpy(), np.asarray(lay[s]), atol=2e-4,
                                           err_msg=f"{blk}.{s}")
        else:
            for kv in ("k", "v"):
                np.testing.assert_allclose(mine[blk][kv].float().numpy(),
                                           np.asarray(lay[kv], np.float32), atol=2e-4,
                                           err_msg=f"{blk}.{kv}")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_prefill_matches_jax(name):
    jcfg, tcfg = _cfgs(name)
    jp, tp_ = _params(name)
    prompt = _prompt()
    j_logits, j_cache = jg.prefill(jp, jcfg, jnp.asarray(prompt), MAX_LEN)
    before = fa.flash_launches
    logits, cache = tg.prefill(tp_, tcfg, torch.from_numpy(prompt), MAX_LEN)
    assert fa.flash_launches == before  # CPU tensors: the plain version
    assert logits.dtype == torch.float32 and logits.shape == (2, 61)
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), atol=2e-4)
    _check_cache(cache, j_cache, tcfg.kv_quant)
    # logits_index: a scalar for every row, and one index per row
    j_s, _ = jg.prefill(jp, jcfg, jnp.asarray(prompt), MAX_LEN, logits_index=jnp.int32(3))
    t_s, _ = tg.prefill(tp_, tcfg, prompt, MAX_LEN, logits_index=3)
    np.testing.assert_allclose(t_s.numpy(), np.asarray(j_s), atol=2e-4)
    idx = np.asarray([2, 6], np.int32)
    j_r, _ = jg.prefill(jp, jcfg, jnp.asarray(prompt), MAX_LEN, logits_index=jnp.asarray(idx))
    t_r, _ = tg.prefill(tp_, tcfg, prompt, MAX_LEN, logits_index=torch.from_numpy(idx))
    np.testing.assert_allclose(t_r.numpy(), np.asarray(j_r), atol=2e-4)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_batched_decode_and_verify_steps_match_jax(name):
    jcfg, tcfg = _cfgs(name)
    jp, tp_ = _params(name)
    prompt = _prompt(seed=8)
    _, j_cache = jg.prefill(jp, jcfg, jnp.asarray(prompt), MAX_LEN)
    # per-slot positions: slot 0 appends, slot 1 rewrites an earlier row
    tokens, pos = np.asarray([3, 50], np.int32), np.asarray([TP, TP - 3], np.int32)
    j_logits, j_next = jg.batched_decode_step(jp, jcfg, j_cache, jnp.asarray(tokens),
                                              jnp.asarray(pos))
    cache = _to_torch_cache(j_cache)
    before = da.decode_launches
    logits, out = tg.batched_decode_step(tp_, tcfg, cache, torch.from_numpy(tokens),
                                         torch.from_numpy(pos))
    assert out is cache and da.decode_launches == before  # in place; plain version on CPU
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), atol=2e-4)
    _check_cache(out, j_next, tcfg.kv_quant)
    # verify: three candidate tokens per slot at per-slot starts
    cand = np.asarray([[4, 9, 11], [20, 1, 0]], np.int32)
    vpos = np.asarray([TP + 1, 2], np.int32)
    j_vl, j_vc = jg.batched_verify_step(jp, jcfg, j_next, jnp.asarray(cand), jnp.asarray(vpos))
    t_vl, t_vc = tg.batched_verify_step(tp_, tcfg, out, cand, vpos)
    assert t_vl.shape == (2, 3, 61)
    np.testing.assert_allclose(t_vl.numpy(), np.asarray(j_vl), atol=2e-4)
    _check_cache(t_vc, j_vc, tcfg.kv_quant)
    # the shared-position form is the same step
    c1, c2 = _to_torch_cache(j_cache), _to_torch_cache(j_cache)
    a, _ = tg.decode_step(tp_, tcfg, c1, torch.from_numpy(tokens), TP)
    b, _ = tg.batched_decode_step(tp_, tcfg, c2, tokens, np.full(2, TP, np.int32))
    assert torch.equal(a, b)


def _jax_greedy_op_by_op(jp, jcfg, prompt, n):
    """JAX's generate (prefill, then one decode_step per token, greedy)
    run op by op rather than compiled into one scan."""
    logits, cache = jg.prefill(jp, jcfg, jnp.asarray(prompt), prompt.shape[1] + n)
    toks = [jnp.argmax(logits, axis=-1).astype(jnp.int32)]
    for t in range(prompt.shape[1], prompt.shape[1] + n - 1):
        logits, cache = jg.decode_step(jp, jcfg, cache, toks[-1], jnp.int32(t))
        toks.append(jnp.argmax(logits, axis=-1).astype(jnp.int32))
    return np.stack([np.asarray(t) for t in toks], axis=1)


@pytest.mark.parametrize("weights", ["float", "int8"])
@pytest.mark.parametrize("name", ["base", "kvq", "gqa2-bf16"])
def test_greedy_generate_matches_jax(name, weights):
    bf16 = name.endswith("-bf16")
    jcfg, tcfg = _cfgs(name.split("-")[0], *((jnp.bfloat16, torch.bfloat16) if bf16 else ()))
    jp, tp_ = _params(name.split("-")[0])
    if weights == "int8":
        jp, tp_ = jax_quantize(jp), quantize_lm_params(tp_)
    prompt = _prompt(seed=11)
    if bf16:
        want = _jax_greedy_op_by_op(jp, jcfg, prompt, 6)
    else:
        want = np.asarray(jg.generate(jp, jcfg, jnp.asarray(prompt), max_new_tokens=6))
    got = tg.generate(tg.serving_params(tp_, tcfg), tcfg, torch.from_numpy(prompt), 6)
    assert got.dtype == torch.int32 and got.shape == (2, 6)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sampling_serving_params_and_devices(monkeypatch):
    jcfg, tcfg = _cfgs("gqa2")
    _, tp_ = _params("gqa2")
    prompt = torch.from_numpy(_prompt())
    greedy = tg.generate(tp_, tcfg, prompt, 5)
    # top_k=1 is greedy; a seed fixes the draw; tokens stay in range
    assert torch.equal(tg.generate(tp_, tcfg, prompt, 5, temperature=0.7, top_k=1), greedy)
    s1 = tg.generate(tp_, tcfg, prompt, 5, temperature=1.0, top_k=10, seed=3)
    s2 = tg.generate(tp_, tcfg, prompt, 5, temperature=1.0, top_k=10, seed=3)
    assert torch.equal(s1, s2) and int(s1.min()) >= 0 and int(s1.max()) < 61
    assert tg.generate(tp_, tcfg, prompt, 0).shape == (2, 0)
    # serving_params casts float block kernels once, keeps lm_head f32 and int8 as is
    bcfg = tg.LMConfig(61, 32, 4, 2, 64, dtype=torch.bfloat16, n_kv_heads=2)
    sp = tg.serving_params(tp_, bcfg)
    assert sp["block_0"]["up"]["kernel"].dtype == torch.bfloat16
    assert sp["lm_head"]["kernel"] is tp_["lm_head"]["kernel"]
    qp = tg.serving_params(quantize_lm_params(tp_), bcfg)
    assert qp["block_1"]["qkv"]["kernel"]["q"].dtype == torch.int8
    # the cache defaults to cuda and raises without it
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tg.init_cache(tcfg, 1, 8)
    assert tg.init_cache(tcfg, 1, 8, device="cpu")["block_0"]["k"].shape == (1, 2, 8, 8)
