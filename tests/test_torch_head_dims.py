"""The attention kernels' whole domain, held to the JAX package on the CPU:
every head dim 1 <= D <= 256 and every query-head group G = H / KV.

The JAX kernels take any D (a full-D block) and any G; the port's CUDA
kernels run a D on the least native width >= D (the flash kernels' 16,
32, 48, 64, 80, 96, 128, 256; the decode kernel's powers of two up to
256), with the columns past D read as zeros, and cut a kv head's G query
heads into chunks of at most 16 for one decode block. On the CPU the
wrappers run the plain versions, so these tests hold the port's
arithmetic and its route tables; the kernels themselves are held to the
same plain versions on the card (chip_smoke.py, phases 6, 7, 9 and 24).

- K2 (flash forward) out and lse at D 8, 32, 40, 48, 80, 96 and 256, float32
  and bfloat16, causal and full, GQA-2, against JAX's Pallas kernel in
  interpret mode on k/v repeated to full heads; K3's dq, dk and dv at the
  same D through `jax.grad` of its custom VJP (lse cotangent included).
- K4 (decode) at D 8, 48, 80, 96 and 256 x f32, bf16 and int8 caches x
  G 1, 4, 24, 48 and 71 against the JAX package's own decode einsum (what
  `batched_decode_step` runs off the TPU) on the dequantized cache, and
  on one G per D its Pallas kernel in interpret mode (f32 and int8).
- The route tables: every D in 1..256 gets a native width >= D from
  `kernel_route` (the forward's and the backward's rule) and the decode
  plan; D 0 raises, and 257 takes the chunked route (every D past 256:
  tests/test_torch_wide_heads.py).

The path that runs these head dims (ShardLM and its draft served in
bfloat16, LongContextLM trained at D 96 and 48) is held to the JAX
package in tests/test_torch_head_dims_path.py, a file of its own so that
the test runners take the two in parallel.

Tolerances, the JAX package's own bars (tests/test_ops.py,
tests/test_decode_attention.py): float32 out and lse within 2e-5,
bfloat16 out within 2e-2 and lse within 1e-4 (the same bf16 products
summed in float32 in another order); gradients in float32 within atol
5e-5 + rtol 5e-4, in bfloat16 within 1e-2 of the largest reference
magnitude; decode within 2e-5 (int8 against JAX's kernel within 5e-3:
it rounds q to bf16 for its int8 dot).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dml_tpu import config as jconfig
from dml_tpu.ops.decode_attention import decode_attention as jax_decode
from dml_tpu.ops.flash_attention import flash_attention_lse as jax_flash_lse
from dml_tpu_torch import config as tconfig
from dml_tpu_torch.ops import decode_attention as da
from dml_tpu_torch.ops import flash_attention as fa

BLOCK = 64  # JAX kernel blocks (a full one at T 64; T 96 pads to two)
FLASH_DIMS = (8, 32, 40, 48, 80, 96, 256)
DECODE_DIMS = (8, 48, 80, 96, 256)
GROUPS = (1, 4, 24, 48, 71)
DTYPES = [pytest.param(torch.float32, id="f32"), pytest.param(torch.bfloat16, id="bf16")]


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
# K2 and K3: flash attention at every head dim
# ----------------------------------------------------------------------

H, KV = 4, 2  # GQA-2: query head h reads kv head h // 2


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", FLASH_DIMS)
def test_flash_forward_matches_jax_kernel(d, dtype, causal):
    tq, tk = (64, 64) if causal else (32, 96)
    rng = np.random.RandomState(d)
    q, k, v = _normal(rng, 1, tq, H, d), _normal(rng, 1, tk, KV, d), _normal(rng, 1, tk, KV, d)
    jdt = _jdt(dtype)
    j_out, j_lse = jax_flash_lse(jnp.asarray(q, jdt), jnp.repeat(jnp.asarray(k, jdt), H // KV, axis=2),
                                 jnp.repeat(jnp.asarray(v, jdt), H // KV, axis=2), causal=causal,
                                 block_q=BLOCK, block_k=BLOCK, interpret=True)
    before = fa.flash_launches
    out, lse = fa.flash_attention_lse(*(torch.from_numpy(x).to(dtype) for x in (q, k, v)), causal=causal)
    assert fa.flash_launches == before  # a CPU tensor runs the plain version
    assert out.dtype == dtype and out.shape == (1, tq, H, d) and lse.shape == (1, H, tq)
    tol_out, tol_lse = (2e-5, 2e-5) if dtype == torch.float32 else (2e-2, 1e-4)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(j_out, np.float32), atol=tol_out)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse), atol=tol_lse)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", FLASH_DIMS)
def test_flash_backward_matches_jax_kernels(d, dtype):
    rng = np.random.RandomState(100 + d)
    q, k, v = _normal(rng, 1, 64, H, d), _normal(rng, 1, 64, KV, d), _normal(rng, 1, 64, KV, d)
    jdt = _jdt(dtype)

    def loss(q, k, v):  # k and v repeated inside: their gradients sum over each group
        o, lse = jax_flash_lse(q, jnp.repeat(k, H // KV, axis=2), jnp.repeat(v, H // KV, axis=2),
                               causal=True, block_q=BLOCK, block_k=BLOCK, interpret=True)
        return jnp.sum(jnp.sin(o.astype(jnp.float32))) + jnp.sum(jnp.cos(lse))

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x, jdt) for x in (q, k, v)))
    ts = [torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v)]
    o, lse = fa.flash_attention_lse(*ts, causal=True)
    (o.float().sin().sum() + lse.cos().sum()).backward()
    for t, w in zip(ts, want):
        got, ref = t.grad.float().numpy(), np.asarray(w, np.float32)
        assert t.grad.dtype == dtype and got.shape == ref.shape
        if dtype == torch.float32:
            np.testing.assert_allclose(got, ref, atol=5e-5, rtol=5e-4)
        else:
            assert np.abs(got - ref).max() <= 1e-2 * np.abs(ref).max()


# ----------------------------------------------------------------------
# K4: decode attention at every head dim and group
# ----------------------------------------------------------------------

B, T = 2, 40
POS = [39, 7]  # one slot at the end, one early


def _quantize(x):
    amax = np.max(np.abs(x), axis=-1, keepdims=True)
    scale = (np.maximum(amax, 1e-12) / 127.0).astype(np.float32)
    return np.clip(np.round(x / scale), -127, 127).astype(np.int8), scale


@jax.jit
def _jax_einsum(q, ck, cv, pos):
    """JAX's batched_decode_step attention off the TPU (generate.py:369-376)."""
    b, _, h, d = q.shape
    kv, t = ck.shape[1], ck.shape[2]
    valid = jnp.arange(t)[None, :] <= pos[:, None]
    qg = q.astype(jnp.float32).reshape(b, 1, kv, h // kv, d)
    s = jnp.einsum("bqkgd,bktd->bkgqt", qg, ck.astype(jnp.float32)) * (d ** -0.5)
    s = jnp.where(valid[:, None, None, None, :], s, -1e30)
    o = jnp.einsum("bkgqt,bktd->bqkgd", jax.nn.softmax(s, axis=-1), cv.astype(jnp.float32))
    return o.reshape(b, 1, h, d)


@pytest.mark.parametrize("g", GROUPS)
@pytest.mark.parametrize("cache", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("d", DECODE_DIMS)
def test_decode_matches_jax_at_every_head_dim_and_group(d, cache, g):
    kv = 2 if g <= 4 else 1  # MQA past 4 heads (StarCoder's 48, Falcon's 71)
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
        ref = _jax_einsum(jq, jnp.asarray(kq * ks), jnp.asarray(vq * vs), pos)
    else:
        tdt = torch.float32 if cache == "f32" else torch.bfloat16
        tq, tk, tv = (torch.from_numpy(x).to(tdt) for x in (q, k, v))
        jq, jk, jv = (jnp.asarray(x.float().numpy(), _jdt(tdt)) for x in (tq, tk, tv))
        ref = _jax_einsum(jq, jk, jv, pos)
    before = da.decode_launches
    got = da.decode_attention(tq, tk, tv, torch.tensor(POS, dtype=torch.int32), **kw)
    assert da.decode_launches == before  # a CPU tensor runs the plain version
    assert got.dtype == torch.float32 and got.shape == (B, 1, h, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)
    # on one group per head dim, the JAX package's Pallas kernel too (f32;
    # int8 at the least and the widest head dim)
    if GROUPS.index(g) == DECODE_DIMS.index(d) and (cache == "f32" or cache == "int8" and d in (8, 256)):
        want = jax_decode(jq if cache == "int8" else jnp.asarray(q), jk, jv, pos, block_k=32,
                          interpret=True, **jkw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-3 if cache == "int8" else 2e-5)


# ----------------------------------------------------------------------
# route tables
# ----------------------------------------------------------------------


@pytest.mark.parametrize("case", ["native_widths", "d0_raises", "d257_routes", "padded_copy"])
def test_routes_give_a_native_width_for_every_head_dim_and_raise_past_256(case):
    # the test's name is older than the chunked route: past 256 a head dim
    # now routes (case d257_routes), and D 0 is what raises
    if case == "native_widths":
        for d in range(1, 257):
            for dtype in (torch.float32, torch.bfloat16):
                route = fa.kernel_route(dtype, d)
                if dtype == torch.bfloat16 and d % 8 == 0 and d <= 256:
                    # the wgmma + TMA kernels at 64, 128 or 256, the least >= d
                    assert route == ("wgmma+tma", min(w for w in fa.WGMMA_HEAD_DIMS if w >= d))
                else:
                    assert route.width == min(w for w in fa.NATIVE_HEAD_DIMS if w >= d)
                    assert route.kind == ("tf32x3" if dtype == torch.float32 else "mma.sync")
                assert fa.kernel_route(dtype, d, backward=True) == route
            for itemsize, quantized in ((4, False), (2, False), (1, True)):
                plan = da.split_plan(2, 1, 100, d, 71, itemsize, quantized, 132)
                assert plan.width == min(w for w in da.ROW_WIDTHS if w >= d)
                assert (plan.n_hc, plan.gc) == (5, 15) and plan.smem_bytes <= 227 << 10
    elif case == "d0_raises":
        with pytest.raises(ValueError, match="head_dim >= 1"):
            fa.kernel_route(torch.bfloat16, 0)
        with pytest.raises(ValueError, match="head_dim >= 1"):
            da.split_plan(1, 1, 100, 0, 1, 2, False, 132)
        # the wrappers raise before any launch, naming the domain
        with pytest.raises(ValueError, match="head_dim >= 1"):
            fa._flash_cuda(*(torch.zeros((1, 4, 1, 0)),) * 3, True, 1.0)
        with pytest.raises(ValueError, match="head_dim >= 1"):
            da._decode_cuda(torch.zeros((1, 1, 1, 0)), torch.zeros((1, 1, 4, 0)),
                            torch.zeros((1, 1, 4, 0)), torch.zeros(1, dtype=torch.int32), None, None, 1.0)
    elif case == "d257_routes":
        assert fa.kernel_route(torch.bfloat16, 257) == ("wgmma+tma chunked", fa.FWD_CHUNK)
        assert fa.kernel_route(torch.float32, 257, backward=True) == ("tf32x3 chunked", fa.BWD_CHUNK)
        plan = da.split_plan(1, 1, 100, 257, 1, 2, False, 132)
        assert plan.width == da.WIDE_SLICE and plan.smem_bytes <= 227 << 10
    else:
        # a row that is not whole 16-byte units (bf16 D 20 at one head) is
        # copied with zero columns to D 24; the kernels' strides need it
        x = torch.randn((1, 3, 1, 20)).bfloat16()
        view = fa._kernel_view(x)
        assert view.shape == (1, 3, 1, 24) and torch.equal(view[..., :20], x)
        assert not view[..., 20:].any() and view.stride(2) * 2 % 16 == 0
        assert fa._kernel_view(torch.randn((1, 3, 2, 48)).bfloat16()).shape[-1] == 48
        # and past 256 the same (bf16 D 257 to 264)
        assert fa._kernel_view(torch.randn((1, 3, 1, 257)).bfloat16()).shape[-1] == 264


# the repo's 198M LM as the cluster LM bench specifies it (bench.py:2421-2425)
LM198M = dict(name="BenchLM", vocab_size=32000, d_model=1024, n_heads=16, n_kv_heads=4, n_layers=12,
              d_ff=4096, dtype="bfloat16", max_new_tokens=32, max_slots=8, max_len=256, seed=0)


@pytest.mark.parametrize("n_layers", [None, 2], ids=["default", "2_layers"])
def test_198m_lm_draft_has_head_dim_32_on_the_wgmma_route(n_layers):
    # draft_lm_spec halves d_model and keeps the heads: the speculative
    # draft of the target's D 64 has D 32, which runs the wgmma + TMA pair at
    # width 64 both ways, as the target does
    kw = {} if n_layers is None else {"n_layers": n_layers}
    draft = tconfig.draft_lm_spec(LM198M, **kw)
    assert draft == jconfig.draft_lm_spec(LM198M, **kw)
    assert (draft["d_model"], draft["n_heads"], draft["n_kv_heads"]) == (512, 16, 4)
    d = draft["d_model"] // draft["n_heads"]
    assert d == 32 and draft["dtype"] == "bfloat16"
    for backward in (False, True):
        assert fa.kernel_route(torch.bfloat16, d, backward) == ("wgmma+tma", 64)
        assert fa.kernel_route(torch.bfloat16, LM198M["d_model"] // LM198M["n_heads"], backward) == \
            ("wgmma+tma", 64)
