"""The bf16 flash forward past head dim 256 on wgmma + TMA
(csrc/flash_attention.cu, `flash_fwd_wgmma_wide_kernel<CS>`), held on the
CPU before any card runs it: its route, its launch plan and its order of
arithmetic.

K2's bf16 kernel past 256 runs blocks of one 128-row q-tile (two consumer
warpgroups of 64 rows) x 256 output columns, each block reducing S = Q K^T
over all of D in 64-column sub-tiles. Where the grid would be small, the
CS blocks of a thread-block cluster split a block's 64-key k-tiles (rank r
taking r, r + CS, ...), each rank running the online softmax over its own
k-tiles, and the ranks' (m, l, O) meet in rank order. `ops.
flash_attention.wide_fwd_plan` mirrors the C launch (`dml_flash_fwd`):
these tests check that its column chunks and its ranks' k-tiles cover the
work once, its shared memory and clusters stay within the card's limits,
and its grids at the shapes chip_smoke.py times. A CUDA kernel cannot run
here, so the last tests emulate its arithmetic in plain torch (P rounded
to bf16 for P V, l summed from the unrounded p, a rank with no k-tile
left at m = -1e30, l = 0, O = 0, the partials rescaled and added in rank
order, out in bf16) and hold it to `dml_tpu/ops/flash_attention.py::
flash_attention_lse` in interpret mode, as tests/test_ops.py runs it,
within the bars chip_smoke.py holds the kernel to (out 2e-2, lse 1e-4):
at multi-head latent attention's absorbed shape (16 query heads on one
576-column latent row) cut to T 128, and at the wide-head LM's training
shape (D 512 over 2 heads on 1) with clusters of 1 and 8.
"""

import collections
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dml_tpu.ops.flash_attention import flash_attention_lse as jax_flash_lse
from dml_tpu_torch.ops import flash_attention as fa


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    # the tests run beside other test processes on a shared CPU
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_forward_route_past_256_by_dtype(dtype):
    for d in range(257, 4097):
        fwd, bwd = fa.kernel_route(dtype, d), fa.kernel_route(dtype, d, backward=True)
        if dtype == torch.bfloat16:  # wgmma + TMA both ways, 256 columns a block
            assert fwd == bwd == ("wgmma+tma chunked", fa.FWD_CHUNK)
            assert fa.wide_fwd_plan(1, 64, 64, 1, 1, d).n_chunks == -(-d // fa.FWD_CHUNK)
        else:
            assert fwd == ("tf32x3 chunked", fa.FWD_CHUNK)
            assert bwd == ("tf32x3 chunked", fa.BWD_CHUNK)
    with pytest.raises(ValueError, match="not on the chunked route"):
        fa.wide_fwd_plan(1, 64, 64, 1, 1, 256)


# b, tq, tk, h, kv, d, causal: chip_smoke.py's chunked bf16 cases (the
# wide-head LM's prefill and training shapes, MLA's absorbed row, D 1024,
# odd D 257, an odd D over one kv head), D 320 cross attention, a D past
# 4000 over 8 heads on 1 and a one-row tail (T 65)
PLAN_CASES = {
    "widelm_d512": (8, 128, 128, 2, 1, 512, True),
    "widelm_train_d512": (1, 512, 512, 2, 1, 512, True),
    "mla_d576": (1, 1024, 1024, 16, 1, 576, True),
    "d1024": (1, 1024, 1024, 4, 4, 1024, True),
    "odd_d257": (2, 300, 300, 4, 2, 257, True),
    "odd_d300_mqa": (2, 65, 65, 4, 1, 300, True),
    "cross_d320": (1, 100, 300, 4, 2, 320, False),
    "d4040_mqa": (1, 256, 256, 8, 1, 4040, True),
    "t65_d384": (3, 65, 65, 6, 3, 384, True),
}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_wide_fwd_plan_covers_every_column_and_k_tile_once(case):
    b, tq, tk, h, kv, d, causal = PLAN_CASES[case]
    plan = fa.wide_fwd_plan(b, tq, tk, h, kv, d)
    n_qt, n_kt = -(-tq // fa.WIDE_FWD_ROWS), -(-tk // fa.WIDE_FWD_KEYS)
    # column chunks: each output column owned by one chunk's block
    assert [c for cc in range(plan.n_chunks) for c in plan.columns(cc)] == list(range(d))
    assert plan.n_chunks == -(-d // fa.FWD_CHUNK) and plan.n_sub == -(-d // 64)
    # the cluster, the grid, one block's shared memory and the merge's partials
    assert plan.cluster in (1, 2, 4, 8) and plan.cluster <= fa.WIDE_MAX_CLUSTER
    assert plan.q_tiles == n_qt and plan.grid == (plan.cluster * plan.n_chunks * h, b, n_qt)
    assert plan.smem <= fa.SMEM_PER_BLOCK
    ring_and_v = plan.smem - 8 * (2 * fa.WIDE_FWD_STAGES + 4) - 1024
    assert plan.merge_smem <= ring_and_v and (plan.merge_smem == 0) == (plan.cluster == 1)
    # each q-tile's k-tiles (to the diagonal if causal) once over the ranks
    for qt in range(n_qt):
        walked = [kt for r in range(plan.cluster) for kt in plan.items(qt, r, causal)]
        want = range(min(n_kt, ((qt + 1) * fa.WIDE_FWD_ROWS - 1) // fa.WIDE_FWD_KEYS + 1) if causal else n_kt)
        assert collections.Counter(walked) == collections.Counter(want)
    # the busiest block (the last q-tile) gives every rank a k-tile
    assert all(plan.items(n_qt - 1, r, causal) for r in range(plan.cluster))
    # a cluster only where the grid is under WIDE_TARGET_BLOCKS blocks
    blocks = n_qt * plan.n_chunks * h * b
    assert plan.cluster == 1 or blocks * plan.cluster // 2 < fa.WIDE_TARGET_BLOCKS


# (cluster, grid) at the shapes chip_smoke.py times: 128-row q-tiles x 256
# columns, clusters doubled while a grid has fewer than 256 blocks and the
# busiest q-tile has a k-tile a rank
@pytest.mark.parametrize("case,want", [
    ("widelm_d512", (2, (8, 8, 1))),         # 32 blocks, 2 k-tiles: a cluster of 2
    ("widelm_train_d512", (8, (32, 1, 4))),  # 16 blocks, 8 k-tiles: 8
    ("mla_d576", (1, (48, 1, 8))),           # 3 chunks x 16 heads x 8 q-tiles = 384 blocks
    ("d1024", (2, (32, 1, 8))),              # 4 chunks x 4 heads x 8 q-tiles = 128
    ("odd_d257", (4, (32, 2, 3))),           # 2 chunks x 4 heads x 2 x 3 = 48, 5 k-tiles
])
def test_wide_fwd_plan_at_the_timed_shapes_and_its_launch_key(case, want):
    b, tq, tk, h, kv, d, _ = PLAN_CASES[case]
    plan = fa.wide_fwd_plan(b, tq, tk, h, kv, d)
    assert (plan.cluster, plan.grid) == want
    # the launch counts name the instance, flash_fwd_wgmma_wide_kernel<CS>
    route = fa.kernel_route(torch.bfloat16, d)
    assert fa.fwd_split(route, plan) == f"cs{want[0]}"
    before = fa.route_launches.copy()
    fa._count("fwd", torch.bfloat16, d, False, plan=plan)
    assert fa.route_launches - before == {("fwd", "wgmma+tma chunked", fa.FWD_CHUNK, f"cs{want[0]}"): 1}
    with pytest.raises(ValueError, match="wide_fwd_plan"):
        fa.fwd_split(route)


def test_forced_forward_routes_raise_past_256():
    # the mma.sync chunked kernel is gone: past 256 only the rule's route
    # launches; the wrapper refuses another before any library loads
    x = torch.zeros((1, 4, 1, 300), dtype=torch.bfloat16)
    for route in (fa.FWD_MMA_SYNC, 2):
        with pytest.raises(ValueError, match="no forward route but the rule's"):
            fa._flash_cuda(x, x, x, True, 1.0, route=route)
    assert fa.fwd_split(fa.kernel_route(torch.float32, 300)) == 1


def emulated_wide_forward(q, k, v, causal, plan):
    """(out, lse) in the chunked wgmma forward's arithmetic and order: for
    each q-tile, each rank of its cluster runs the online softmax over its
    own k-tiles (s = q k^T scale in float32, masked; m_new = max(m, rowmax
    s), p = exp(s - m_new), l = l exp(m - m_new) + sum p, O = O exp(m -
    m_new) + bf16(p) V), from m = -1e30, l = 0, O = 0; then the ranks'
    partials are rescaled to their row max and added in rank order, out =
    bf16(O / l), lse = max + log(l). q [B, Tq, H, D], k and v [B, Tk, KV, D]
    bf16."""
    b, tq, h, d = q.shape
    tk, kv = k.shape[1], k.shape[2]
    g, scale, rows, keys = h // kv, d ** -0.5, fa.WIDE_FWD_ROWS, fa.WIDE_FWD_KEYS
    qf, kf, vf = q.float(), k.float(), v.float()
    out, lse = torch.zeros(b, tq, h, d), torch.zeros(b, h, tq)
    for bi in range(b):
        for hh in range(h):
            for qt in range(plan.q_tiles):
                qs = slice(qt * rows, min(tq, (qt + 1) * rows))
                qi = torch.arange(qs.start, qs.stop)[:, None]
                parts = []
                for r in range(plan.cluster):
                    n = qs.stop - qs.start
                    m, l, o = torch.full((n,), fa.NEG_INF), torch.zeros(n), torch.zeros(n, d)
                    for kt in plan.items(qt, r, causal):
                        ks = slice(kt * keys, min(tk, (kt + 1) * keys))
                        s = qf[bi, qs, hh] @ kf[bi, ks, hh // g].T * scale
                        if causal:
                            s = torch.where(torch.arange(ks.start, ks.stop)[None, :] > qi, -torch.inf, s)
                        m_new = torch.maximum(m, s.amax(-1))
                        alpha, p = torch.exp(m - m_new), torch.exp(s - m_new[:, None])
                        l = l * alpha + p.sum(-1)
                        o = o * alpha[:, None] + p.bfloat16().float() @ vf[bi, ks, hh // g]
                        m = m_new
                    parts.append((m, l, o))
                mx = functools.reduce(torch.maximum, [m for m, _, _ in parts])
                f = [torch.exp(m - mx) for m, _, _ in parts]
                l_sum = functools.reduce(torch.add, [fr * l for fr, (_, l, _) in zip(f, parts)])
                o_sum = functools.reduce(torch.add, [fr[:, None] * o for fr, (_, _, o) in zip(f, parts)])
                out[bi, qs, hh] = o_sum / l_sum.clamp_min(1e-30)[:, None]
                lse[bi, hh, qs] = mx + torch.log(l_sum.clamp_min(1e-30))
    return out.bfloat16(), lse


@functools.lru_cache(maxsize=None)
def _jax_reference(b, t, h, kv, d, seed):
    """Seeded bf16 q, k, v and JAX's interpret-mode (out, lse), k and v
    repeated to q's heads as generate.prefill gives them to it."""
    rng = np.random.RandomState(seed)
    q, k, v = (jnp.asarray(rng.standard_normal(s).astype(np.float32), jnp.bfloat16)
               for s in ((b, t, h, d), (b, t, kv, d), (b, t, kv, d)))
    out, lse = jax_flash_lse(q, jnp.repeat(k, h // kv, axis=2), jnp.repeat(v, h // kv, axis=2), causal=True,
                             block_q=fa.WIDE_FWD_ROWS, block_k=fa.WIDE_FWD_KEYS, interpret=True)
    t32 = lambda x: torch.from_numpy(np.array(x, np.float32))  # noqa: E731
    return (t32(q).bfloat16(), t32(k).bfloat16(), t32(v).bfloat16()), (t32(out), t32(lse))


# DeepSeek-V2-Lite's absorbed attention: 16 query heads on one latent row
# of 576 columns (kv_lora_rank 512 + rope 64), cut to T 128, whose plan
# splits each block's 2 k-tiles over a cluster of 2 (the first consumer's
# rows see no key of rank 1's tile: an empty partial); the wide-head LM's
# training shape [1, 512] over 2 heads on 1 at D 512, whose plan is a
# cluster of 8 (ranks 2-7 of the first q-tile hold nothing), and the same
# at one block a q-tile
@pytest.mark.parametrize("shape,cluster", [
    ((1, 128, 16, 1, 576), 2), ((1, 512, 2, 1, 512), 8), ((1, 512, 2, 1, 512), 1),
], ids=["mla_g16_d576_cs2", "widelm_train_d512_cs8", "widelm_train_d512_cs1"])
def test_order_of_arithmetic_within_the_bf16_bars(shape, cluster):
    b, t, h, kv, d = shape
    plan = fa.wide_fwd_plan(b, t, t, h, kv, d)
    if cluster != plan.cluster:
        plan = plan._replace(cluster=cluster)
    assert any(not plan.items(0, r, True) for r in range(plan.cluster)) == (plan.cluster > 2)
    (q, k, v), (j_out, j_lse) = _jax_reference(b, t, h, kv, d, d)
    out, lse = emulated_wide_forward(q, k, v, True, plan)
    assert bool(torch.isfinite(out.float()).all()) and bool(torch.isfinite(lse).all())
    assert float((out.float() - j_out).abs().max()) <= 2e-2
    assert float((lse - j_lse).abs().max()) <= 1e-4
    p_out, p_lse = fa.attention_with_lse(q, k, v, causal=True)
    assert float((out.float() - p_out.float()).abs().max()) <= 2e-2
    assert float((lse - p_lse).abs().max()) <= 1e-4
