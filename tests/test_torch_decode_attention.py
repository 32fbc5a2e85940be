"""The port's decode attention against the JAX package's, on the CPU.

The JAX side runs its Pallas kernel in interpret mode (what
`_util.interpret_default` picks off the TPU) with 32-row k-blocks, so the
online softmax spans blocks; the port's `decode_attention` on a CPU
tensor runs its plain version, the float32 einsum of
`batched_decode_step`. Same numpy-seeded inputs, per-slot positions.

Tolerances: float32 caches within 2e-5, the JAX package's bar
(tests/test_decode_attention.py). int8 caches within 5e-3: JAX's kernel
rounds q to bf16 for its dot with the int8 block (decode_attention.py:
79); the port computes in float32. A bfloat16 cache is held against
the JAX package's own einsum path (what it runs off the TPU) within
2e-5: JAX's kernel would round q to bf16 there too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dml_tpu.ops.decode_attention import decode_attention as jax_decode
from dml_tpu_torch.ops import decode_attention as da

B, T, D = 3, 80, 16
POS = [79, 5, 40]  # one slot at the end, one early, one in the middle


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    # the tests run beside other test processes on a shared CPU; torch's
    # default of one thread per core oversubscribes it
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _inputs(kv, h, seed):
    rng = np.random.RandomState(seed)
    q = rng.standard_normal((B, 1, h, D)).astype(np.float32)
    k = rng.standard_normal((B, kv, T, D)).astype(np.float32)
    v = rng.standard_normal((B, kv, T, D)).astype(np.float32)
    return q, k, v


def _quantize(x):
    amax = np.max(np.abs(x), axis=-1, keepdims=True)
    scale = (np.maximum(amax, 1e-12) / 127.0).astype(np.float32)
    return np.clip(np.round(x / scale), -127, 127).astype(np.int8), scale


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


def _port(q, k, v, pos, **kw):
    before = da.decode_launches
    out = da.decode_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                              torch.tensor(pos, dtype=torch.int32), **kw)
    assert da.decode_launches == before  # a CPU tensor runs the plain version
    assert out.dtype == torch.float32 and out.shape == q.shape
    return out.numpy()


@pytest.mark.parametrize("kv,h", [(2, 4), (1, 4), (4, 4)], ids=["gqa", "mqa", "mha"])
def test_f32_cache_matches_jax_kernel(kv, h):
    q, k, v = _inputs(kv, h, seed=kv + h)
    want = jax_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(POS, jnp.int32),
                      block_k=32, interpret=True)
    np.testing.assert_allclose(_port(q, k, v, POS), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("kv,h", [(2, 4), (1, 4)], ids=["gqa", "mqa"])
def test_int8_cache_matches_jax_kernel(kv, h):
    q, k, v = _inputs(kv, h, seed=10 + kv)
    (kq, ks), (vq, vs) = _quantize(k), _quantize(v)
    k_scale, v_scale = ks.transpose(0, 1, 3, 2).copy(), vs.transpose(0, 1, 3, 2).copy()  # [B, KV, 1, T]
    want = jax_decode(jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq), jnp.asarray(POS, jnp.int32),
                      k_scale=jnp.asarray(k_scale), v_scale=jnp.asarray(v_scale),
                      block_k=32, interpret=True)
    got = _port(q, kq, vq, POS, k_scale=torch.from_numpy(k_scale),
                v_scale=torch.from_numpy(v_scale))
    np.testing.assert_allclose(got, np.asarray(want), atol=5e-3)
    # and the dequantized cache through JAX's einsum path, in float32
    ref = _jax_einsum(jnp.asarray(q), jnp.asarray(kq * ks), jnp.asarray(vq * vs),
                      jnp.asarray(POS, jnp.int32))
    np.testing.assert_allclose(got, np.asarray(ref), atol=2e-5)


def test_bf16_cache_and_stale_rows():
    q, k, v = _inputs(2, 4, seed=21)
    kb = torch.from_numpy(k).bfloat16()
    vb = torch.from_numpy(v).bfloat16()
    pos = torch.tensor(POS, dtype=torch.int32)
    got = da.decode_attention(torch.from_numpy(q).bfloat16(), kb, vb, pos)
    want = _jax_einsum(jnp.asarray(q, jnp.bfloat16), jnp.asarray(kb.float().numpy(), jnp.bfloat16),
                       jnp.asarray(vb.float().numpy(), jnp.bfloat16), jnp.asarray(POS, jnp.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    # rows past a slot's pos are invisible: poison them with +-1e4
    kp, vp = kb.clone(), vb.clone()
    for i, p in enumerate(POS):
        kp[i, :, p + 1:] = 1e4 if i % 2 else -1e4
        vp[i, :, p + 1:] = -1e4 if i % 2 else 1e4
    poisoned = da.decode_attention(torch.from_numpy(q).bfloat16(), kp, vp, pos)
    assert torch.equal(poisoned, got)


def _block_rows(plan, t, pos, split):
    """The cache rows block `split` of a plane reads when its slot sees
    rows <= pos: the kernel's arithmetic (csrc/decode_attention.cu)."""
    t0 = split * plan.chunk
    return range(t0, max(t0, min(t0 + plan.chunk, pos + 1, t)))


def _scale_spans(row0, n):
    """The kernel's int8 scale loads for the n rows from cache row row0:
    the bulk-copied 16-byte-aligned interior and the rows loaded by hand
    (csrc/decode_attention.cu)."""
    lo, hi = (row0 + 3) & ~3, (row0 + n) & ~3
    if hi <= lo:
        return range(0), list(range(n))
    return range(lo - row0, hi - row0), list(range(lo - row0)) + list(range(hi - row0, n))


def _span_copy(addr, nbytes):
    """The kernel's copy of a span whose rows are not whole 16-byte units
    (csrc/decode_attention.cu::copy_span): bytes up to the first 16-byte
    boundary, 16-byte words, bytes after the last."""
    head = min((16 - addr % 16) % 16, nbytes)
    words = (nbytes - head) // 16
    return head, words, nbytes - head - 16 * words


#: D 16-128 (every kernel instance but 256, and D 48 and 96, whose rows
#: leave lanes idle), then the new head dims: the JAX tests' 8, an odd
#: 20, a D-80 target's draft 40, Phi-2's 80 and Gemma-2B's 256
PLAN_HEAD_DIMS = (16, 32, 48, 64, 96, 128, 8, 20, 40, 80, 256)


@pytest.mark.parametrize("d", PLAN_HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8],
                         ids=["f32", "bf16", "int8"])
def test_split_plan_covers_budgets_aligns_and_fits_one_wave(dtype, d):
    itemsize = torch.tensor([], dtype=dtype).element_size()
    quantized = dtype == torch.int8
    rng = np.random.RandomState(d + itemsize)
    dpad = -(-d // 4) * 4
    for n_sm in (132, 114):
        # (8, 1, 48): StarCoder's MQA, past one block's 16 heads
        for b, kv, g in ((1, 4, 4), (8, 4, 4), (8, 1, 16), (1, 16, 1), (64, 4, 4), (3, 2, 3),
                         (8, 1, 48)):
            for t in (1, 16, 100, 2112, 4096, 4099):
                plan = da.split_plan(b, kv, t, d, g, itemsize, quantized, n_sm)
                chunk, n_split = plan.chunk, plan.n_split
                assert chunk % da.SUB_ROWS == 0 and da.SUB_ROWS <= chunk <= da.MAX_CHUNK
                assert n_split * chunk >= t > (n_split - 1) * chunk
                # every head in one chunk of at most 16, the instance wide enough
                assert plan.gc <= da.MAX_CHUNK_HEADS and plan.n_hc * plan.gc >= g > (plan.n_hc - 1) * plan.gc
                assert plan.width >= d and plan.width in da.ROW_WIDTHS
                # the byte budget, and what an SM can hold
                row = 2 * d * itemsize + (8 if quantized else 0)
                assert chunk * row <= da.CHUNK_BYTES or chunk == da.SUB_ROWS
                assert plan.smem_bytes <= 227 << 10 and plan.blocks_per_sm >= 1
                # one wave wherever the budget's fewest splits fit one
                planes = b * kv * plan.n_hc
                min_split = -(-t // min(da.MAX_CHUNK, da.CHUNK_BYTES // row // 32 * 32))
                if planes * min_split <= n_sm * plan.blocks_per_sm:
                    assert planes * n_split <= n_sm * plan.blocks_per_sm
                else:
                    assert n_split == min_split
                # a chunk's partials stay small enough for one block to merge
                assert n_split * plan.gc * dpad * 4 <= da.MERGE_BYTES or n_split == min_split
                # every row <= pos read exactly once, sub-tiles and scales aligned
                for p in {0, t - 1, t // 2, int(rng.randint(0, t)), t + 5}:
                    seen = []
                    for split in range(n_split):
                        rows = _block_rows(plan, t, p, split)
                        seen += list(rows)
                        n = len(rows)
                        assert n * row <= max(da.CHUNK_BYTES, da.SUB_ROWS * row)
                        for plane in (0, 1, b * kv - 1):
                            row0 = plane * t + split * chunk
                            if da.bulk_rows(d, itemsize):
                                for j in range(0, n, da.SUB_ROWS):
                                    nr = min(da.SUB_ROWS, n - j)
                                    assert ((row0 + j) * d * itemsize) % 16 == 0
                                    assert (nr * d * itemsize) % 16 == 0
                            else:  # the threads' copy: aligned words, < 16 bytes at each end
                                head, words, tail = _span_copy(row0 * d * itemsize, n * d * itemsize)
                                assert head < 16 and tail < 16 and head + 16 * words + tail == n * d * itemsize
                                assert not words or (row0 * d * itemsize + head) % 16 == 0
                            if quantized:
                                bulk, by_hand = _scale_spans(row0, n)
                                assert not bulk or ((row0 + bulk.start) * 4) % 16 == 0
                                assert (len(bulk) * 4) % 16 == 0
                                assert len(by_hand) <= 6 and sorted(list(bulk) + by_hand) == list(range(n))
                    assert seen == list(range(min(p + 1, t)))


def test_wrapper_contract():
    q = torch.zeros((2, 1, 4, 8))
    c = torch.zeros((2, 2, 16, 8))
    pos = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="not divisible"):
        da.decode_attention(q, torch.zeros((2, 3, 16, 8)), torch.zeros((2, 3, 16, 8)), pos)
    with pytest.raises(ValueError, match=r"B,1,H,D"):
        da.decode_attention(torch.zeros((2, 2, 4, 8)), c, c, pos)
    with pytest.raises(ValueError, match="both k_scale"):
        da.decode_attention(q, c, c, pos, k_scale=torch.zeros((2, 2, 1, 16)))
    c8 = c.to(torch.int8)
    with pytest.raises(TypeError, match="int8 cache needs"):
        da.decode_attention(q, c8, c8, pos)
    m = q.to("meta")
    with pytest.raises(RuntimeError, match="no decode attention kernel"):
        da.decode_attention(m, c.to("meta"), c.to("meta"), pos.to("meta"))
