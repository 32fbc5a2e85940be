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


# bf16 from D 8 up to 256 runs the wgmma + TMA kernels at the least of
# 64, 128 and 256 >= D (the drafts' 8-48 at 64, Phi-2's 80, Phi-3-mini's
# 96, Gemma-2B's 256) where D is a multiple of 8 (the TMA stores' rows are
# whole 16-byte units); every other bf16 D mma.sync and float32 split TF32
# ("tf32x3") at the least native width >= D
ROUTES = [
    (torch.bfloat16, 16, ("wgmma+tma", 64)), (torch.bfloat16, 32, ("wgmma+tma", 64)),
    (torch.bfloat16, 48, ("wgmma+tma", 64)), (torch.bfloat16, 56, ("wgmma+tma", 64)),
    (torch.bfloat16, 64, ("wgmma+tma", 64)), (torch.bfloat16, 80, ("wgmma+tma", 128)),
    (torch.bfloat16, 96, ("wgmma+tma", 128)), (torch.bfloat16, 128, ("wgmma+tma", 128)),
    (torch.bfloat16, 136, ("wgmma+tma", 256)), (torch.bfloat16, 200, ("wgmma+tma", 256)),
    (torch.bfloat16, 256, ("wgmma+tma", 256)),
    (torch.bfloat16, 50, ("mma.sync", 64)), (torch.bfloat16, 100, ("mma.sync", 128)),
    (torch.bfloat16, 129, ("mma.sync", 256)), (torch.bfloat16, 201, ("mma.sync", 256)),
    (torch.float32, 16, ("tf32x3", 16)), (torch.float32, 32, ("tf32x3", 32)),
    (torch.float32, 64, ("tf32x3", 64)), (torch.float32, 80, ("tf32x3", 80)),
    (torch.float32, 128, ("tf32x3", 128)), (torch.float32, 256, ("tf32x3", 256)),
    (torch.float32, 40, ("tf32x3", 48)), (torch.float32, 100, ("tf32x3", 128)),
    (torch.bfloat16, 8, ("wgmma+tma", 64)), (torch.bfloat16, 24, ("wgmma+tma", 64)),
    (torch.bfloat16, 40, ("wgmma+tma", 64)), (torch.bfloat16, 20, ("mma.sync", 32)),
]


@pytest.mark.parametrize("dtype,d,route", ROUTES)
def test_kernel_route_by_dtype_and_head_dim(dtype, d, route):
    assert fa.kernel_route(dtype, d) == route


@pytest.mark.parametrize("dtype,d,route", ROUTES)
def test_bwd_kernel_route_by_dtype_and_head_dim(dtype, d, route):
    # dml_flash_bwd picks its kernels by the forward's rule: one table
    assert fa.kernel_route(dtype, d, backward=True) == route


H100_SMS = 132  # an H100 SXM's SMs


# the bf16 wgmma forward's consumers a block and its grid on an H100's 132
# SMs (csrc/flash_attention.cu::launch_d64 picks the same): at width 64
# three consumers (192-row q-tiles) where their blocks make four waves (the
# B=8 prefill and its draft's), one (64-row q-tiles) where blocks of two
# would fill less than one wave (the drafts' small prefills, the JAX
# tests' D 8, the 198M LM's served prefills at D 64 and its draft's at
# D 32), else two; two at 128 and 256 (ShardLM's D 96)
@pytest.mark.parametrize("shape,plan", [
    ((4, 300, 4, 48), (64, 1, 64, 80)), ((2, 128, 4, 8), (64, 1, 64, 16)),
    ((8, 2048, 16, 64), (64, 3, 192, 1408)), ((8, 2048, 16, 32), (64, 3, 192, 1408)),
    ((1, 2048, 16, 64), (64, 2, 128, 256)), ((2, 512, 32, 40), (64, 2, 128, 256)),
    ((2, 300, 4, 32), (64, 1, 64, 40)), ((4, 300, 4, 96), (128, 2, 128, 48)),
    ((8, 16, 16, 32), (64, 1, 64, 128)), ((8, 16, 16, 64), (64, 1, 64, 128)),
    ((1, 1024, 16, 64), (64, 1, 64, 256)),
], ids=["draft_d48", "jax_d8", "prefill_b8", "lm198m_draft_d32", "prefill_b1", "draft_d40", "d32",
        "shardlm_d96", "lm198m_draft_served_d32", "lm_served_d64", "prefill_b1_t1024"])
def test_wgmma_fwd_plan_by_grid(shape, plan):
    b, tq, h, d = shape
    got = fa.wgmma_fwd_plan(b, tq, h, d, H100_SMS)
    assert got == plan and got.blocks == -(-tq // got.rows) * h * b
    # one consumer exactly below one wave of two-consumer blocks
    assert fa.wgmma_fwd_plan(1, 128 * 131, 1, 64, H100_SMS).consumers == 1
    assert fa.wgmma_fwd_plan(1, 128 * 132, 1, 64, H100_SMS).consumers == 2
    assert fa.wgmma_fwd_plan(b, tq, h, d, n_sm=1).consumers == (3 if got.width == 64 else 2)
    for off_route in (20, 257):
        with pytest.raises(ValueError, match="not on the bf16 wgmma route"):
            fa.wgmma_fwd_plan(b, tq, h, off_route, H100_SMS)


# past 256 the chunked routes, at each direction's column chunk: `kind`
# forward (256 output columns a block) and float32's backward (128
# gradient columns a block); bf16's backward is the wgmma + TMA pair at
# 256 gradient columns a block, as its forward is
@pytest.mark.parametrize("dtype,kind", [(torch.bfloat16, "wgmma+tma chunked"),
                                        (torch.float32, "tf32x3 chunked")])
@pytest.mark.parametrize("d", [257, 512])
@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
def test_kernel_route_past_256_by_direction(dtype, kind, d, backward):
    if backward and dtype == torch.bfloat16:
        assert fa.kernel_route(dtype, d, backward=True) == ("wgmma+tma chunked", fa.WIDE_BWD_CHUNK)
        return
    width = fa.BWD_CHUNK if backward else fa.FWD_CHUNK
    assert fa.kernel_route(dtype, d, backward=backward) == (kind, width)


# the dkv kernel's blocks a kv head, as the backward's launch counts key
# them: a two-block cluster on the wgmma route at width 256 with more than
# one query head a kv head (Gemma-2B's 8 on 1); past 256 in bf16 the
# clusters of both chunked wgmma kernels, from the shape's plan (here the
# wide-head LM's training shape, [1, 512] over 2 query heads on 1)
@pytest.mark.parametrize("dtype,d,group,split", [
    (torch.bfloat16, 256, 8, 2), (torch.bfloat16, 200, 2, 2), (torch.bfloat16, 256, 1, 1),
    (torch.bfloat16, 96, 2, 1), (torch.bfloat16, 64, 4, 1), (torch.bfloat16, 201, 2, 1),
    (torch.float32, 256, 8, 1), (torch.bfloat16, 512, 2, "dq8 dkv8"),
], ids=["gemma2b_d256", "d200_gqa2", "d256_mha", "d96_gqa2", "d64_gqa4", "odd_d201_mma_sync",
        "f32_d256", "d512_chunked"])
def test_dkv_split_by_route_and_group(dtype, d, group, split):
    route = fa.kernel_route(dtype, d, backward=True)
    plan = fa.wide_bwd_plan(1, 512, 512, group, 1, d) if d > 256 else None
    assert fa.dkv_split(route, group, plan) == split
    before = fa.route_launches.copy()
    fa._count("bwd", dtype, d, False, group, plan)
    assert fa.route_launches - before == {("bwd", route.kind, route.width, split): 1}


# D 0 and float16 have no kernel; a D past the widest native width (257)
# takes the chunked routes: wgmma + TMA both ways
@pytest.mark.parametrize("dtype,d,route", [
    (torch.bfloat16, 0, None), (torch.float16, 64, None),
    (torch.bfloat16, 257, ("wgmma+tma chunked", 256)),
], ids=["d0", "float16", "d257"])
def test_kernel_route_refuses_what_no_kernel_takes(dtype, d, route):
    if route is None:
        with pytest.raises(ValueError, match="no flash attention kernel"):
            fa.kernel_route(dtype, d)
    else:
        assert fa.kernel_route(dtype, d) == route
        assert fa.kernel_route(dtype, d, backward=True) == ("wgmma+tma chunked", fa.WIDE_BWD_CHUNK)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_delta_and_backward_rows_match_the_jax_expression(dtype):
    # delta = rowsum(dO * O), as dml_tpu/ops/flash_attention.py computes it
    # beside its backward kernels (on [B, H, T, D]); the row arrays the
    # Hopper kernels read: lse and delta - dlse, padded to 128 rows with
    # lse = +1e30 and delta = 0 (the JAX code pads lse with +1e30 too)
    rng = np.random.RandomState(21)
    b, t, h, d = 2, 129, 4, 64
    out, dout = (rng.standard_normal((b, t, h, d)).astype(np.float32) for _ in range(2))
    lse, dlse = (rng.standard_normal((b, h, t)).astype(np.float32) for _ in range(2))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jo, jg = (jnp.transpose(jnp.asarray(x, jdt), (0, 2, 1, 3)) for x in (out, dout))
    j_delta = np.asarray(jnp.sum(jg.astype(jnp.float32) * jo.astype(jnp.float32), axis=-1))
    to = lambda x: torch.from_numpy(x).to(dtype)  # noqa: E731
    delta = fa._delta(to(out), to(dout))
    assert delta.dtype == torch.float32 and delta.shape == (b, h, t)
    np.testing.assert_allclose(delta.numpy(), j_delta, atol=1e-5, rtol=1e-5)
    lse_r, delta_r = fa.bwd_rows_plain(to(out), to(dout), torch.from_numpy(lse), torch.from_numpy(dlse))
    assert lse_r.shape == delta_r.shape == (b, h, 256) and lse_r.dtype == delta_r.dtype == torch.float32
    np.testing.assert_array_equal(lse_r[..., :t].numpy(), lse)
    assert bool((lse_r[..., t:] == 1e30).all()) and bool((delta_r[..., t:] == 0).all())
    np.testing.assert_allclose(delta_r[..., :t].numpy(), j_delta - dlse, atol=1e-5, rtol=1e-5)
    assert torch.equal(fa.bwd_rows_plain(to(out), to(dout), torch.from_numpy(lse))[1][..., :t], delta)


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
