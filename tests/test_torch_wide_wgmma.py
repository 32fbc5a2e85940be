"""The bf16 flash backward past head dim 256 on wgmma + TMA
(csrc/flash_attention_bwd_wide.cu), held on the CPU before any card runs
it: its route, its launch plan and its order of sums.

K3's bf16 pair past 256 (`flash_bwd_dq_wgmma_wide_kernel<CS>`,
`flash_bwd_dkv_wgmma_wide_kernel<CS>`) runs blocks of 64 own rows (queries
in dq, keys in dkv) x 256 gradient columns; consumer 0 forms S and P,
consumer 1 dP and dS, and each owns 128 of the block's columns. Where the
grid would be small, the CS blocks of a thread-block cluster split a
block's items (dq: its k-tiles; dkv: its kv head's (query head, q-tile)
pairs), rank r taking r, r + CS, ..., and each gradient element is the
sum of the ranks' float32 partials in rank order. `ops.flash_attention.
wide_bwd_plan` mirrors the C launch (`dml_flash_bwd_wide`): these tests
check that its column chunks and its ranks' items cover the work once,
its shared memory and clusters stay within the card's limits, and its
grids at the shapes chip_smoke.py times. A CUDA kernel cannot run here,
so the last test emulates the pair's arithmetic in plain torch (P and dS
rounded to bf16 as the wgmma operands, float32 partials a rank, the
ranks added in order) and holds it to `dml_tpu/ops/flash_attention.py`'s
VJP in interpret mode, as tests/test_ops.py runs it, within the bf16 bar
that chip_smoke.py holds the kernels to (1e-2 of the largest reference
magnitude), at multi-head latent attention's absorbed shape (16 query
heads on one 576-column latent row) cut to T 128.
"""

import collections

import jax
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
def test_backward_route_past_256_and_the_forward_it_keeps(dtype):
    for d in range(1, 4097):
        fwd, bwd = fa.kernel_route(dtype, d), fa.kernel_route(dtype, d, backward=True)
        if d <= 256:  # one rule both ways
            assert bwd == fwd
        elif dtype == torch.bfloat16:
            assert fwd == ("wgmma+tma chunked", fa.FWD_CHUNK)
            assert bwd == ("wgmma+tma chunked", fa.WIDE_BWD_CHUNK)
        else:
            assert fwd == ("tf32x3 chunked", fa.FWD_CHUNK)
            assert bwd == ("tf32x3 chunked", fa.BWD_CHUNK)


# b, tq, tk, h, kv, d, causal: chip_smoke.py's chunked bf16 cases (the
# wide-head LM's prefill and training shapes, MLA's absorbed row, D 1024,
# odd D 257, D 320 cross attention), a D past 4000 over 8 heads on 1 and
# a one-row tail (T 65)
PLAN_CASES = {
    "widelm_d512": (8, 128, 128, 2, 1, 512, True),
    "widelm_train_d512": (1, 512, 512, 2, 1, 512, True),
    "mla_d576": (1, 1024, 1024, 16, 1, 576, True),
    "d1024": (1, 1024, 1024, 4, 4, 1024, True),
    "odd_d257": (2, 300, 300, 4, 2, 257, True),
    "cross_d320": (1, 100, 300, 4, 2, 320, False),
    "d4040_mqa": (1, 256, 256, 8, 1, 4040, True),
    "t65_d384": (3, 65, 65, 6, 3, 384, True),
}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_wide_plan_covers_every_column_and_item_once(case):
    b, tq, tk, h, kv, d, causal = PLAN_CASES[case]
    plan = fa.wide_bwd_plan(b, tq, tk, h, kv, d)
    n_qt, n_kt, g = -(-tq // fa.WIDE_ROWS), -(-tk // fa.WIDE_ROWS), h // kv
    # column chunks: each gradient column owned by one consumer of one chunk
    cols = [c for cc in range(plan.n_chunks) for cons in (0, 1) for c in plan.columns(cc, cons)]
    assert cols == list(range(d))
    assert plan.n_chunks == -(-d // fa.WIDE_BWD_CHUNK)  # S and dP ceil(d / 256) times a tile pair
    # clusters and grids, and one block's shared memory
    for cs in (plan.dq_cluster, plan.dkv_cluster):
        assert cs in (1, 2, 4, 8) and cs <= fa.WIDE_MAX_CLUSTER
    assert plan.dq_grid == (plan.dq_cluster * plan.n_chunks * h, b, n_qt)
    assert plan.dkv_grid == (plan.dkv_cluster * plan.n_chunks * kv, b, n_kt)
    assert max(plan.dq_smem, plan.dkv_smem) <= fa.SMEM_PER_BLOCK
    # dq: each q-tile's k-tiles (to the diagonal if causal) once over the ranks
    for qt in range(n_qt):
        walked = [kt for r in range(plan.dq_cluster) for kt in plan.dq_items(qt, r, causal)]
        want = range(min(n_kt, qt + 1) if causal else n_kt)
        assert sorted(walked) == list(want)
    # dkv: each kv head's (query head, q-tile) pairs once over the ranks
    for kt in range(n_kt):
        walked = [it for r in range(plan.dkv_cluster) for it in plan.dkv_items(kt, r, causal)]
        want = [(gi, qt) for gi in range(g) for qt in range(kt if causal else 0, n_qt)]
        assert collections.Counter(walked) == collections.Counter(want)
    # the busiest blocks (the last q-tile, the first k-tile) give every rank an item
    assert all(plan.dq_items(n_qt - 1, r, causal) for r in range(plan.dq_cluster))
    assert all(plan.dkv_items(0, r, causal) for r in range(plan.dkv_cluster))


# (dq cluster, dq grid, dkv cluster, dkv grid) by formula at the shapes the
# kernels are timed at: blocks of 64 rows x 256 columns, clusters doubled
# while a grid has fewer than 256 blocks and the busiest block has an item
# a rank
@pytest.mark.parametrize("case,want", [
    ("mla_d576", (1, (48, 1, 16), 8, (24, 1, 16))),          # 3 chunks; dkv 48 blocks x 8 = 384
    ("widelm_train_d512", (8, (32, 1, 8), 8, (16, 1, 8))),  # 2 chunks; dq 32 x 8, dkv 16 x 8
    ("widelm_d512", (2, (8, 8, 2), 4, (8, 8, 2))),          # 2 k-tiles, 4 (head, q-tile) pairs
    ("d1024", (1, (16, 1, 16), 1, (16, 1, 16))),            # 4 chunks x 4 heads x 16 tiles = 256
])
def test_wide_plan_grids_at_the_timed_shapes(case, want):
    b, tq, tk, h, kv, d, _ = PLAN_CASES[case]
    plan = fa.wide_bwd_plan(b, tq, tk, h, kv, d)
    assert (plan.dq_cluster, plan.dq_grid, plan.dkv_cluster, plan.dkv_grid) == want
    if case == "mla_d576":  # the mma.sync pair ran its dkv on 16 k-tiles x 5 column chunks
        assert np.prod(plan.dkv_grid) >= 4 * 16 * 5
    # the launch counts name both clusters
    route = fa.kernel_route(torch.bfloat16, d, backward=True)
    assert fa.dkv_split(route, h // kv, plan) == f"dq{want[0]} dkv{want[2]}"
    with pytest.raises(ValueError, match="wide_bwd_plan"):
        fa.dkv_split(route, h // kv)


def emulated_wide_backward(q, k, v, out, lse, dout, dlse, causal, plan):
    """(dq, dk, dv) in the chunked wgmma pair's arithmetic and order of
    sums: S = Q K^T and dP = dO V^T in float32 over all of d, P = exp(S
    scale - lse) (0 where masked), dS = P (dP - delta') scale with delta' =
    rowsum(dO O) - g_lse; a rank's partials dQ += bf16(dS) K, dV +=
    bf16(P)^T dO, dK += bf16(dS)^T Q in float32 over its items, and the
    ranks' partials added in rank order. q/out/dout [B, Tq, H, D] and k/v
    [B, Tk, KV, D] bf16, lse/dlse [B, H, Tq] float32."""
    b, tq, h, d = q.shape
    tk, kv = k.shape[1], k.shape[2]
    g, rows, scale = h // kv, fa.WIDE_ROWS, d ** -0.5
    qf, kf, vf, dof = (x.float() for x in (q, k, v, dout))
    delta = (dof * out.float()).sum(-1).transpose(1, 2) - dlse

    def p_ds(bi, hh, qt, kt):
        qs, ks = slice(qt * rows, (qt + 1) * rows), slice(kt * rows, (kt + 1) * rows)
        s = qf[bi, qs, hh] @ kf[bi, ks, hh // g].T
        p = torch.exp(s * scale - lse[bi, hh, qs, None])
        if causal:
            qi = torch.arange(qs.start, qs.start + s.shape[0])[:, None]
            ki = torch.arange(ks.start, ks.start + s.shape[1])[None, :]
            p = torch.where(ki > qi, torch.zeros_like(p), p)
        dp = dof[bi, qs, hh] @ vf[bi, ks, hh // g].T
        ds = p * (dp - delta[bi, hh, qs, None]) * scale
        return qs, ks, p.bfloat16().float(), ds.bfloat16().float()

    dq, dk, dv = torch.zeros(b, tq, h, d), torch.zeros(b, tk, kv, d), torch.zeros(b, tk, kv, d)
    n_qt, n_kt = -(-tq // rows), -(-tk // rows)
    for bi in range(b):
        for hh in range(h):
            for qt in range(n_qt):
                parts = []
                for r in range(plan.dq_cluster):
                    acc = torch.zeros(min(tq, (qt + 1) * rows) - qt * rows, d)
                    for kt in plan.dq_items(qt, r, causal):
                        _, ks, _, ds = p_ds(bi, hh, qt, kt)
                        acc = acc + ds @ kf[bi, ks, hh // g]
                    parts.append(acc)
                dq[bi, qt * rows:(qt + 1) * rows, hh] = sum(parts[1:], parts[0])
        for j in range(kv):
            for kt in range(n_kt):
                pk, pv = [], []
                for r in range(plan.dkv_cluster):
                    ak = av = torch.zeros(min(tk, (kt + 1) * rows) - kt * rows, d)
                    for gi, qt in plan.dkv_items(kt, r, causal):
                        hh = j * g + gi
                        qs, _, p, ds = p_ds(bi, hh, qt, kt)
                        av = av + p.T @ dof[bi, qs, hh]
                        ak = ak + ds.T @ qf[bi, qs, hh]
                    pk.append(ak)
                    pv.append(av)
                dk[bi, kt * rows:(kt + 1) * rows, j] = sum(pk[1:], pk[0])
                dv[bi, kt * rows:(kt + 1) * rows, j] = sum(pv[1:], pv[0])
    return dq.bfloat16(), dk.bfloat16(), dv.bfloat16()


def test_order_of_sums_within_the_bf16_bar_at_mla_g16_d576():
    # DeepSeek-V2-Lite's absorbed attention: 16 query heads on one latent
    # row of 576 columns (kv_lora_rank 512 + rope 64), cut to T 128; its
    # plan splits each dq block's 2 k-tiles over a cluster of 2 and each
    # dkv block's 32 (head, q-tile) pairs over a cluster of 8
    b, t, h, kv, d = 1, 128, 16, 1, 576
    plan = fa.wide_bwd_plan(b, t, t, h, kv, d)
    assert (plan.dq_cluster, plan.dkv_cluster) == (2, 8)
    rng = np.random.RandomState(576)
    q, k, v, do = (rng.standard_normal(s).astype(np.float32)
                   for s in ((b, t, h, d), (b, t, kv, d), (b, t, kv, d), (b, t, h, d)))
    dlse = rng.standard_normal((b, h, t)).astype(np.float32)

    def f(q, k, v):  # k and v repeated inside: their gradients sum over the group
        return jax_flash_lse(q, jnp.repeat(k, h // kv, axis=2), jnp.repeat(v, h // kv, axis=2),
                             causal=True, block_q=fa.WIDE_ROWS, block_k=fa.WIDE_ROWS, interpret=True)

    bf = lambda x: jnp.asarray(x, jnp.bfloat16)  # noqa: E731
    (j_out, j_lse), vjp = jax.vjp(f, bf(q), bf(k), bf(v))
    want = vjp((bf(do), jnp.asarray(dlse)))
    t32 = lambda x: torch.from_numpy(np.array(x, np.float32))  # noqa: E731
    tq_, tk_, tv_, tdo = (t32(bf(x)).bfloat16() for x in (q, k, v, do))
    out, lse = t32(j_out).bfloat16(), t32(j_lse)
    got = emulated_wide_backward(tq_, tk_, tv_, out, lse, tdo, torch.from_numpy(dlse), True, plan)
    plain = fa.attention_backward(tq_, tk_, tv_, out, lse, tdo, torch.from_numpy(dlse), causal=True)
    for name, g_, w, p in zip(("dq", "dk", "dv"), got, want, plain):
        w = np.asarray(w, np.float32)
        bar = 1e-2 * np.abs(w).max()
        assert np.abs(g_.float().numpy() - w).max() <= bar, name
        assert (g_.float() - p.float()).abs().max() <= 1e-2 * p.float().abs().max(), name
