"""The port's flash attention (forward) against the JAX package's, on the CPU.

The JAX side runs its Pallas kernel in interpret mode (what
`_util.interpret_default` picks off the TPU), with 32-row blocks so that
several q and k blocks, the causal block skip and the padded-KV mask are
exercised; the port's `flash_attention_lse` on a CPU tensor runs its
plain version. Same numpy-seeded inputs.

Tolerances, the JAX package's own bars (tests/test_ops.py): float32 out
and lse within 2e-5; bfloat16 out within 2e-2. bfloat16 lse within
1e-4: the scores are products of the same bf16 values accumulated in
float32 on both sides, so only the summation order differs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dml_tpu.ops.flash_attention import flash_attention as jax_flash
from dml_tpu.ops.flash_attention import flash_attention_lse as jax_flash_lse
from dml_tpu.parallel.ring_attention import reference_attention as jax_reference
from dml_tpu_torch.ops import flash_attention as fa

BLOCK = 32  # JAX kernel blocks: T=100 pads to 4 blocks, causal skips some


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    # the tests run beside other test processes on a shared CPU; torch's
    # default of one thread per core oversubscribes it
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _qkv(b, tq, tk, h, d, seed, kv=None):
    rng = np.random.RandomState(seed)
    q = rng.standard_normal((b, tq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, tk, kv or h, d)).astype(np.float32)
    v = rng.standard_normal((b, tk, kv or h, d)).astype(np.float32)
    return q, k, v


def _tols(dtype):
    return (2e-5, 2e-5) if dtype == torch.float32 else (2e-2, 1e-4)


CASES = [
    # (b, tq, tk, h, d, causal)
    pytest.param(2, 64, 64, 2, 32, True, id="causal"),
    pytest.param(2, 64, 64, 2, 32, False, id="noncausal"),
    pytest.param(1, 100, 100, 2, 16, True, id="causal-padded-T100"),
    pytest.param(2, 64, 192, 2, 32, False, id="cross-Tq64-Tk192"),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,tq,tk,h,d,causal", CASES)
def test_flash_matches_jax_kernel(b, tq, tk, h, d, causal, dtype):
    q, k, v = _qkv(b, tq, tk, h, d, seed=tq + tk + h)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    j_out, j_lse = jax_flash_lse(jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
                                 causal=causal, block_q=BLOCK, block_k=BLOCK, interpret=True)
    tq_, tk_, tv_ = (torch.from_numpy(x).to(dtype) for x in (q, k, v))
    before = fa.flash_launches
    out, lse = fa.flash_attention_lse(tq_, tk_, tv_, causal=causal)
    assert fa.flash_launches == before  # a CPU tensor runs the plain version
    assert out.dtype == dtype and out.shape == (b, tq, h, d)
    assert lse.dtype == torch.float32 and lse.shape == (b, h, tq)
    tol_out, tol_lse = _tols(dtype)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(j_out, np.float32), atol=tol_out)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse), atol=tol_lse)
    # flash_attention is the out half, and agrees with JAX's oracle too
    out_only = fa.flash_attention(tq_, tk_, tv_, causal=causal)
    assert torch.equal(out_only, out)
    ref = jax_reference(jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt), causal=causal)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), atol=tol_out)


def test_lse_merge_identity_and_grouped_kv_heads():
    # two KV halves merged by the (out, lse) recurrence equal attention
    # over the whole KV: the ring-attention contract, as in test_ops.py
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 64, 64, 2, 32, seed=9))
    full, _ = fa.flash_attention_lse(q, k, v, causal=False)
    o1, l1 = fa.flash_attention_lse(q, k[:, :32], v[:, :32], causal=False)
    o2, l2 = fa.flash_attention_lse(q, k[:, 32:], v[:, 32:], causal=False)
    m = torch.maximum(l1, l2)
    a1, a2 = torch.exp(l1 - m), torch.exp(l2 - m)
    w1 = (a1 / (a1 + a2)).permute(0, 2, 1)[..., None]  # [B, Tq, H, 1]
    np.testing.assert_allclose((o1 * w1 + o2 * (1 - w1)).numpy(), full.numpy(), atol=2e-5)
    # KV heads dividing H read kv head h // G: JAX's kernel on k and v
    # repeated to full heads (generate.prefill's GQA form) is the same
    q, k, v = _qkv(2, 48, 48, 4, 16, seed=4, kv=2)
    j_out = jax_flash(jnp.asarray(q), jnp.repeat(jnp.asarray(k), 2, axis=2),
                      jnp.repeat(jnp.asarray(v), 2, axis=2), causal=True,
                      block_q=BLOCK, block_k=BLOCK, interpret=True)
    out = fa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), causal=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), atol=2e-5)


def test_wrapper_contract():
    q = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError, match="equal q/k lengths"):
        fa.flash_attention(q, torch.zeros((1, 9, 2, 16)), torch.zeros((1, 9, 2, 16)), causal=True)
    with pytest.raises(ValueError, match="must divide"):
        fa.flash_attention(torch.zeros((1, 8, 3, 16)), q, q, causal=True)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        fa.flash_attention(q.half(), q.half(), q.half())
    # neither CPU nor CUDA: the wrapper raises, it never takes the plain version
    m = q.to("meta")
    with pytest.raises(RuntimeError, match="no flash attention kernel"):
        fa.flash_attention(m, m, m)
