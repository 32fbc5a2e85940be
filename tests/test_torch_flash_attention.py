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


# The Hopper kernel's tile edges: 128-row q- and k-tiles, 64-column
# sub-tiles (D 128 is two). The plain version is what the kernel is held
# to on the card; here it is held to JAX's kernel (interpret mode) with
# 128-row blocks, at lengths below, across and far past one tile.
EDGE_CASES = [
    pytest.param(1, t, t, 2, 2, d, True, id=f"causal-D{d}-T{t}")
    for d in (64, 128) for t in (100, 200, 1000)
] + [pytest.param(1, 200, 1000, 4, 1, 64, False, id="cross-Tq200-Tk1000-GQA4")]


@pytest.mark.parametrize("b,tq,tk,h,kv,d,causal", EDGE_CASES)
def test_plain_matches_jax_at_kernel_tile_edges(b, tq, tk, h, kv, d, causal):
    q, k, v = _qkv(b, tq, tk, h, d, seed=tq + tk + d, kv=kv)
    g = h // kv
    jb = lambda x: jnp.asarray(x, jnp.bfloat16)  # noqa: E731
    j_out, j_lse = jax_flash_lse(jb(q), jnp.repeat(jb(k), g, axis=2), jnp.repeat(jb(v), g, axis=2),
                                 causal=causal, block_q=128, block_k=128, interpret=True)
    out, lse = fa.flash_attention_lse(*(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)),
                                      causal=causal)
    tol_out, tol_lse = _tols(torch.bfloat16)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(j_out, np.float32), atol=tol_out)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse), atol=tol_lse)


def _prefill_qkv(b, t, h, kv, d, seed):
    """The LM prefill's layout: q, k contiguous, v a strided view of the
    qkv projection's output [B, T, (H + 2 KV) D]."""
    rng = np.random.RandomState(seed)
    q = torch.from_numpy(rng.standard_normal((b, t, h, d)).astype(np.float32)).to(torch.bfloat16)
    qkv = torch.from_numpy(rng.standard_normal((b, t, (h + 2 * kv) * d)).astype(np.float32))
    qkv = qkv.to(torch.bfloat16)
    k = qkv[..., h * d:(h + kv) * d].reshape(b, t, kv, d).contiguous()
    v = qkv[..., (h + kv) * d:].reshape(b, t, kv, d)
    return q, k, v


def test_gqa4_strided_v_matches_jax():
    q, k, v = _prefill_qkv(2, 200, 8, 2, 64, seed=11)
    assert not v.is_contiguous() and fa._kernel_view(v) is v
    out, lse = fa.flash_attention_lse(q, k, v, causal=True)
    jx = lambda x: jnp.asarray(x.float().numpy(), jnp.bfloat16)  # noqa: E731
    j_out, j_lse = jax_flash_lse(jx(q), jnp.repeat(jx(k), 4, axis=2), jnp.repeat(jx(v.contiguous()), 4, axis=2),
                                 causal=True, block_q=128, block_k=128, interpret=True)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(j_out, np.float32), atol=2e-2)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse), atol=1e-4)


@pytest.mark.parametrize("dtype,d,route", [
    (torch.bfloat16, 16, "mma.sync"), (torch.bfloat16, 32, "mma.sync"),
    (torch.bfloat16, 64, "wgmma+tma"), (torch.bfloat16, 128, "wgmma+tma"),
    (torch.float32, 16, "fma"), (torch.float32, 32, "fma"),
    (torch.float32, 64, "fma"), (torch.float32, 128, "fma"),
])
def test_kernel_route_by_dtype_and_head_dim(dtype, d, route):
    assert fa.kernel_route(dtype, d) == route


def test_kernel_route_refuses_what_no_kernel_takes():
    with pytest.raises(ValueError, match="no flash attention kernel"):
        fa.kernel_route(torch.bfloat16, 96)
    with pytest.raises(ValueError, match="no flash attention kernel"):
        fa.kernel_route(torch.float16, 64)


def _misaligned_base():
    flat = torch.zeros(1 + 2 * 8 * 2 * 64, dtype=torch.bfloat16)
    return flat[1:].view(2, 8, 2, 64)  # base 2 bytes past an aligned one


VIEW_CASES = [
    # (make x, passes through unchanged)
    pytest.param(lambda: torch.zeros((2, 8, 2, 64), dtype=torch.bfloat16), True, id="contiguous"),
    pytest.param(lambda: _prefill_qkv(2, 16, 8, 2, 64, seed=0)[2], True, id="prefill-strided-v"),
    pytest.param(lambda: torch.zeros((2, 16, 4, 64))[:, :10], True, id="f32-row-slice"),
    pytest.param(_misaligned_base, False, id="base-not-16B-aligned"),
    pytest.param(lambda: torch.zeros((2, 8, 2, 68), dtype=torch.bfloat16)[..., :64], False,
                 id="row-stride-not-16B"),
    pytest.param(lambda: torch.zeros((2, 1152, 4, 64), dtype=torch.bfloat16)[:, :1000], True,
                 id="rows-of-a-longer-buffer"),
    pytest.param(lambda: torch.zeros((1, 8, 1, 64), dtype=torch.bfloat16).expand(2, 8, 3, 64), False,
                 id="broadcast-stride-0"),
    pytest.param(lambda: torch.zeros((2, 64, 8, 2), dtype=torch.bfloat16).permute(0, 2, 3, 1), False,
                 id="last-stride-not-1"),
]


@pytest.mark.parametrize("make,passes", VIEW_CASES)
def test_kernel_view_copies_only_what_the_kernels_cannot_read(make, passes):
    x = make()
    y = fa._kernel_view(x)
    assert (y is x) == passes
    assert torch.equal(y, x) and y.shape == x.shape
    if not passes:
        assert y.is_contiguous() and y.data_ptr() % 16 == 0
