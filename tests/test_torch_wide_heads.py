"""The attention kernels past head dim 256, held to the JAX package on the CPU.

The JAX kernels take any head dim D (a full-D block); the port's CUDA
kernels take every D up to 256 on a native width (tests/test_torch_
head_dims.py) and every D past it on the chunked route: the flash kernels
split the output's (or the gradients') columns over blocks, each reducing
Q K^T (and dO V^T) over the whole of D in slices, and the decode kernel
(`decode_wide_kernel`) takes a row in slices of WIDE_SLICE columns. On the
CPU the wrappers run the plain versions, so these tests hold the port's
arithmetic and its route tables; the kernels themselves are held to the
same plain versions on the card (chip_smoke.py, phases 6, 7, 9 and 25).

- K2 (flash forward) out and lse at D 257, 320, 512 and 576, float32 and
  bfloat16, causal and full, GQA-2 and MQA, against JAX's Pallas kernel in
  interpret mode on k/v repeated to full heads; K3's dq, dk and dv at the
  same D through `jax.grad` of its custom VJP (lse cotangent included).
- K4 (decode) at the same D x f32, bf16 and int8 caches x G 1, 16 and 128
  against the JAX package's own decode einsum on the dequantized cache,
  and on one G per D its Pallas kernel in interpret mode; the absorbed
  form of multi-head latent attention (DeepSeek-V2-Lite's decode: 16 query
  heads over one latent row of 576 columns, V the latent itself, an
  explicit softmax scale of the 192-wide q/k head) against both.
- The route tables: every D in 1..4096 gets a flash route in both
  directions and a decode plan; the chunked route's column chunks cover
  [0, D) exactly once; one block's shared memory is at most 227 KB.

The path that runs these head dims (a wide-head LM served and trained) is
held to the JAX package in tests/test_torch_wide_heads_path.py.

Tolerances, the JAX package's own bars (tests/test_ops.py,
tests/test_decode_attention.py), as in tests/test_torch_head_dims.py:
float32 out and lse within 2e-5, bfloat16 out within 2e-2 and lse within
1e-4; gradients in float32 within atol 5e-5 + rtol 5e-4, in bfloat16
within 1e-2 of the largest reference magnitude; decode within 2e-5 (int8
against JAX's kernel within 5e-3: it rounds q to bf16 for its int8 dot).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dml_tpu.ops.decode_attention import decode_attention as jax_decode
from dml_tpu.ops.flash_attention import flash_attention_lse as jax_flash_lse
from dml_tpu_torch.ops import decode_attention as da
from dml_tpu_torch.ops import flash_attention as fa

BLOCK = 64  # JAX kernel blocks
WIDE_DIMS = (257, 320, 512, 576)
GROUPS = (1, 16, 128)
DTYPES = [pytest.param(torch.float32, id="f32"), pytest.param(torch.bfloat16, id="bf16")]
KV_FORMS = [pytest.param(2, id="gqa2"), pytest.param(1, id="mqa")]
H = 4
SMEM_LIMIT = 227 << 10  # an H100 block's dynamic shared memory at most


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    # the tests run beside other test processes on a shared CPU; torch's
    # default of one thread per core oversubscribes it
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _jdt(dtype):
    return jnp.float32 if dtype == torch.float32 else jnp.bfloat16


# ----------------------------------------------------------------------
# K2 and K3: flash attention past 256
# ----------------------------------------------------------------------


@pytest.mark.parametrize("kv", KV_FORMS)
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", WIDE_DIMS)
def test_flash_forward_past_256_matches_jax_kernel(d, dtype, causal, kv):
    tq, tk = (64, 64) if causal else (32, 96)
    rng = np.random.RandomState(d + kv)
    q, k, v = _normal(rng, 1, tq, H, d), _normal(rng, 1, tk, kv, d), _normal(rng, 1, tk, kv, d)
    jdt = _jdt(dtype)
    j_out, j_lse = jax_flash_lse(jnp.asarray(q, jdt), jnp.repeat(jnp.asarray(k, jdt), H // kv, axis=2),
                                 jnp.repeat(jnp.asarray(v, jdt), H // kv, axis=2), causal=causal,
                                 block_q=BLOCK, block_k=BLOCK, interpret=True)
    before = fa.flash_launches
    out, lse = fa.flash_attention_lse(*(torch.from_numpy(x).to(dtype) for x in (q, k, v)), causal=causal)
    assert fa.flash_launches == before  # a CPU tensor runs the plain version
    assert out.dtype == dtype and out.shape == (1, tq, H, d) and lse.shape == (1, H, tq)
    tol_out, tol_lse = (2e-5, 2e-5) if dtype == torch.float32 else (2e-2, 1e-4)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(j_out, np.float32), atol=tol_out)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse), atol=tol_lse)


# causal attention over GQA-2 and full cross attention over MQA (the
# JAX side's interpret-mode gradients dominate this file's time)
@pytest.mark.parametrize("causal,kv", [(True, 2), (False, 1)], ids=["causal-gqa2", "full-mqa"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", WIDE_DIMS)
def test_flash_backward_past_256_matches_jax_kernels(d, dtype, causal, kv):
    tq, tk = (64, 64) if causal else (32, 96)
    rng = np.random.RandomState(100 + d + kv)
    q, k, v = _normal(rng, 1, tq, H, d), _normal(rng, 1, tk, kv, d), _normal(rng, 1, tk, kv, d)
    jdt = _jdt(dtype)

    def loss(q, k, v):  # k and v repeated inside: their gradients sum over each group
        o, lse = jax_flash_lse(q, jnp.repeat(k, H // kv, axis=2), jnp.repeat(v, H // kv, axis=2),
                               causal=causal, block_q=BLOCK, block_k=BLOCK, interpret=True)
        return jnp.sum(jnp.sin(o.astype(jnp.float32))) + jnp.sum(jnp.cos(lse))

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x, jdt) for x in (q, k, v)))
    ts = [torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v)]
    before = (fa.flash_bwd_launches, fa.flash_bwd_delta_launches)
    o, lse = fa.flash_attention_lse(*ts, causal=causal)
    (o.float().sin().sum() + lse.cos().sum()).backward()
    assert (fa.flash_bwd_launches, fa.flash_bwd_delta_launches) == before
    for t, w in zip(ts, want):
        got, ref = t.grad.float().numpy(), np.asarray(w, np.float32)
        assert t.grad.dtype == dtype and got.shape == ref.shape
        if dtype == torch.float32:
            np.testing.assert_allclose(got, ref, atol=5e-5, rtol=5e-4)
        else:
            assert np.abs(got - ref).max() <= 1e-2 * np.abs(ref).max()


# ----------------------------------------------------------------------
# K4: decode attention past 256
# ----------------------------------------------------------------------

B, T = 2, 40
POS = [39, 7]  # one slot at the end, one early


def _quantize(x):
    amax = np.max(np.abs(x), axis=-1, keepdims=True)
    scale = (np.maximum(amax, 1e-12) / 127.0).astype(np.float32)
    return np.clip(np.round(x / scale), -127, 127).astype(np.int8), scale


def _jax_einsum(q, ck, cv, pos, scale):
    """JAX's batched_decode_step attention off the TPU (generate.py:369-376)."""
    b, _, h, d = q.shape
    kv, t = ck.shape[1], ck.shape[2]
    valid = jnp.arange(t)[None, :] <= pos[:, None]
    qg = q.astype(jnp.float32).reshape(b, 1, kv, h // kv, d)
    s = jnp.einsum("bqkgd,bktd->bkgqt", qg, ck.astype(jnp.float32)) * scale
    s = jnp.where(valid[:, None, None, None, :], s, -1e30)
    o = jnp.einsum("bkgqt,bktd->bqkgd", jax.nn.softmax(s, axis=-1), cv.astype(jnp.float32))
    return o.reshape(b, 1, h, d)


_jax_einsum_jit = jax.jit(_jax_einsum, static_argnums=(4,))


@pytest.mark.parametrize("g", GROUPS)
@pytest.mark.parametrize("cache", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("d", WIDE_DIMS)
def test_decode_past_256_matches_jax(d, cache, g):
    kv = 2 if g == 1 else 1  # MQA at 16 and 128 heads (MLA's absorbed form)
    h = kv * g
    rng = np.random.RandomState(1000 * d + g)
    q, k, v = _normal(rng, B, 1, h, d), _normal(rng, B, kv, T, d), _normal(rng, B, kv, T, d)
    pos = jnp.asarray(POS, jnp.int32)
    kw, jkw = {}, {}
    if cache == "int8":
        (kq, ks), (vq, vs) = _quantize(k), _quantize(v)
        k_scale, v_scale = ks.transpose(0, 1, 3, 2).copy(), vs.transpose(0, 1, 3, 2).copy()  # [B, KV, 1, T]
        tq, tk, tv = torch.from_numpy(q).bfloat16(), torch.from_numpy(kq), torch.from_numpy(vq)
        kw = dict(k_scale=torch.from_numpy(k_scale), v_scale=torch.from_numpy(v_scale))
        jkw = dict(k_scale=jnp.asarray(k_scale), v_scale=jnp.asarray(v_scale))
        jq, jk, jv = jnp.asarray(tq.float().numpy(), jnp.bfloat16), jnp.asarray(kq), jnp.asarray(vq)
        ref = _jax_einsum_jit(jq, jnp.asarray(kq * ks), jnp.asarray(vq * vs), pos, d ** -0.5)
    else:
        tdt = torch.float32 if cache == "f32" else torch.bfloat16
        tq, tk, tv = (torch.from_numpy(x).to(tdt) for x in (q, k, v))
        jq, jk, jv = (jnp.asarray(x.float().numpy(), _jdt(tdt)) for x in (tq, tk, tv))
        ref = _jax_einsum_jit(jq, jk, jv, pos, d ** -0.5)
    before = da.decode_launches
    got = da.decode_attention(tq, tk, tv, torch.tensor(POS, dtype=torch.int32), **kw)
    assert da.decode_launches == before  # a CPU tensor runs the plain version
    assert got.dtype == torch.float32 and got.shape == (B, 1, h, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)
    # on one group per head dim, the JAX package's Pallas kernel too
    # (f32 and int8; bf16 at G 1)
    if GROUPS.index(g) == WIDE_DIMS.index(d) % len(GROUPS) and cache in ("f32", "int8"):
        want = jax_decode(jq if cache == "int8" else jnp.asarray(q), jk, jv, pos, block_k=32,
                          interpret=True, **jkw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-3 if cache == "int8" else 2e-5)


@pytest.mark.parametrize("cache", ["f32", "bf16"])
def test_decode_absorbed_mla_shape_matches_jax(cache):
    # DeepSeek-V2-Lite's decode in its absorbed form: 16 query heads over
    # one latent row of kv_lora_rank 512 + qk_rope_head_dim 64 = 576
    # columns, V the latent itself (MQA at D 576 with v = k), the softmax
    # scale of the 192-wide q/k head; the caller keeps the first 512
    # columns of the output
    g, d, t, scale = 16, 576, 96, 192 ** -0.5
    rng = np.random.RandomState(576)
    q, c = _normal(rng, B, 1, g, d), _normal(rng, B, 1, t, d)
    pos_np = [t - 1, 30]
    tdt = torch.float32 if cache == "f32" else torch.bfloat16
    tq, tc = torch.from_numpy(q).to(tdt), torch.from_numpy(c).to(tdt)
    got = da.decode_attention(tq, tc, tc, torch.tensor(pos_np, dtype=torch.int32), scale=scale)
    jq, jc = (jnp.asarray(x.float().numpy(), _jdt(tdt)) for x in (tq, tc))
    pos = jnp.asarray(pos_np, jnp.int32)
    ref = _jax_einsum_jit(jq, jc, jc, pos, scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)
    if cache == "f32":  # the JAX kernel rounds a bf16 row's probabilities to bf16 for P V
        want = jax_decode(jq, jc, jc, pos, scale=scale, block_k=32, interpret=True)
        np.testing.assert_allclose(got[..., :512].numpy(), np.asarray(want)[..., :512], atol=2e-5)


# ----------------------------------------------------------------------
# route tables
# ----------------------------------------------------------------------


def test_every_head_dim_to_4096_has_a_route_whose_chunks_cover_it():
    # one block's shared memory at every D is a static_assert beside each
    # chunked layout in the CUDA sources; here the routes and the plans
    for d in range(1, 4097):
        for backward in (False, True):
            for dtype in (torch.float32, torch.bfloat16):
                route = fa.kernel_route(dtype, d, backward)
                if dtype == torch.bfloat16 and d <= 256 and d % 8 == 0:  # wgmma + TMA
                    assert route == ("wgmma+tma", min(w for w in fa.WGMMA_HEAD_DIMS if w >= d))
                elif dtype == torch.bfloat16 and backward and d > 256:  # wgmma + TMA, chunked
                    assert route == ("wgmma+tma chunked", fa.WIDE_BWD_CHUNK)
                else:
                    assert route.width == fa.native_head_dim(d, backward)
                n = -(-d // route.width)  # the blocks of a tile, one column chunk each
                assert n * route.width >= d > (n - 1) * route.width
                if d > fa.NATIVE_HEAD_DIMS[-1]:
                    assert route.kind.endswith(" chunked")
                    wide = dtype == torch.bfloat16 and backward
                    assert route.width == (fa.WIDE_BWD_CHUNK if wide else fa.BWD_CHUNK if backward
                                           else fa.FWD_CHUNK)
                else:
                    assert n == 1 and not route.kind.endswith(" chunked")
        for itemsize, quantized in ((4, False), (2, False), (1, True)):
            plan = da.split_plan(2, 1, 1000, d, 71, itemsize, quantized, 132)
            assert plan.smem_bytes <= SMEM_LIMIT and plan.blocks_per_sm >= 1
            assert (plan.n_hc, plan.gc) == (5, 15)
            assert plan.n_split * plan.chunk >= 1000 > (plan.n_split - 1) * plan.chunk
            if d > da.ROW_WIDTHS[-1]:
                assert plan.width == da.WIDE_SLICE and plan.chunk <= da.WIDE_MAX_CHUNK
            else:
                assert plan.width == min(w for w in da.ROW_WIDTHS if w >= d)


@pytest.mark.parametrize("b,kv,t,g", [(4, 1, 2112, 16), (4, 1, 2112, 128), (8, 1, 144, 2),
                                      (1, 1, 65536, 16), (64, 8, 4096, 16)])
@pytest.mark.parametrize("d", [320, 576, 1024, 4096])
def test_wide_decode_plan_budgets(d, b, kv, t, g):
    # past a row of 256: the rows a block takes (WIDE_MAX_CHUNK at most),
    # its partials within WIDE_MERGE_BYTES unless the fewest splits
    # exceed them, one wave wherever the fewest splits fit one
    for itemsize, quantized in ((4, False), (2, False), (1, True)):
        plan = da.split_plan(b, kv, t, d, g, itemsize, quantized, 132)
        assert plan.chunk % da.SUB_ROWS == 0 and plan.chunk <= da.WIDE_MAX_CHUNK
        assert plan.n_split * plan.chunk >= t > (plan.n_split - 1) * plan.chunk
        min_split = -(-t // da.WIDE_MAX_CHUNK)
        dpad = -(-d // 4) * 4
        assert plan.n_split * plan.gc * dpad * 4 <= da.WIDE_MERGE_BYTES or plan.n_split == min_split
        planes = b * kv * plan.n_hc
        if planes * min_split <= 132 * plan.blocks_per_sm:
            assert planes * plan.n_split <= 132 * plan.blocks_per_sm
