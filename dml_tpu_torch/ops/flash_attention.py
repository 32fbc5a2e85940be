"""Flash attention, forward and backward: PyTorch counterpart of
dml_tpu/ops/flash_attention.py.

The TPU kernels it replaces are `dml_tpu/ops/flash_attention.py::
_fwd_kernel` (K2) and the backward pair `_bwd_dq_kernel` and
`_bwd_dkv_kernel` (K3). On Hopper they are the CUDA C++ kernels in
`dml_tpu_torch/csrc/flash_attention.cu` and `csrc/flash_attention_bwd.cu`
(the float32 backward in `csrc/flash_attention_bwd_tf32.cu`, the bf16
backward past head dim 256 in `csrc/flash_attention_bwd_wide.cu`), built
with nvcc for sm_90a at first use and called through ctypes.

Routes follow from the dtype and the head dim (`kernel_route`), by one
rule for the forward and the backward up to 256:
bf16 at 8 <= D <= 256 with D a multiple of 8, every main-path shape (D
64), the public LMs' 80, 96 and 256 and the speculative drafts' 8-48
among them, runs warp-specialized kernels (a TMA producer streaming
tiles through a shared-memory ring, consumer warpgroups on `wgmma`, P
and dS kept in registers) at width 64, 128 or 256 (`WGMMA_HEAD_DIMS`;
the forward's consumers a block follow the grid, `wgmma_fwd_plan`);
every other bf16 D up to 256 (D % 8 != 0, since the wgmma kernels store
their D-wide outputs by TMA, whose rows must be whole 16-byte units)
runs `mma.sync` kernels; float32 runs the same `mma.sync` plan in split
TF32 ("tf32x3": x = hi + lo with hi = tf32(x), lo = tf32(x - hi), and a
b as hi lo + lo hi + hi hi, three TF32 tensor-core products into a
float32 sum, within
the JAX package's float32 bars, where one TF32 product alone is not; the
long sums (dQ, dK and dV along the sequence, S past 256 columns) added
step by step in float32, since the tensor cores' own sums truncate;
bound by those products at 495 / 3 = 165 TFLOP/s of float32 work, against
67 TFLOP/s of float32 FMAs, on an NVIDIA H100 80GB HBM3 at 700.00 W; the
float32 backward's kernels are their own source,
`csrc/flash_attention_bwd_tf32.cu`). The kernels take every head dim D >= 1,
as the JAX kernels' full-D block does: a D up to 256 runs on the least
width >= D of its route (`NATIVE_HEAD_DIMS` off the wgmma route), its
columns past D read as zeros and never written, which is exact. Past 256
no block holds a whole row (the forward's accumulator alone would need D
/ 2 float32 registers a thread), so the chunked routes split the output's
columns over a grid axis, each block reducing Q K^T (and dO V^T) over the
whole of D. float32 stages D in slices through shared memory on
`mma.sync` ("tf32x3 chunked": FWD_CHUNK output columns a forward block,
BWD_CHUNK gradient columns a backward one); bf16 runs `wgmma` + TMA both
ways ("wgmma+tma chunked", 256 columns a block: a TMA producer streams
D's 64-column sub-tiles of the operands of S (Q and K; in the backward
also dO and V for dP) through a ring in shared memory; the forward's two
consumer warpgroups split a 128-row q-tile, the backward's form S and P
and dP and dS and hand them to each other through shared memory; where
the grid is small a thread-block cluster splits a block's k-tiles, or
its kv head's (query head, q-tile) pairs, and adds the ranks' partials
in rank order: `wide_fwd_plan` and `wide_bwd_plan` mirror those
launches). The backward keeps the TPU's
two-kernel split (dq over k-tiles, dk and dv over q-tiles, no atomics),
after a small kernel that computes delta = rowsum(dO * O) and pads the
row arrays the two read. The source files say what bounds each kernel
and how it is laid out. The kernels pick their own tiles, so the TPU
knobs `block_q`, `block_k` and `interpret` are not part of these
signatures.

`flash_attention` and `flash_attention_lse` are the forward kernel's
wrappers. On a CUDA tensor they launch the kernel (and count the launch
in `flash_launches`) or raise; on a CPU tensor they run the plain
version, `attention_with_lse`: full-matrix attention in float32 that
rounds the probabilities to V's dtype before P V, as the kernel does.
When grad is enabled and an input requires it, both go through one
`torch.autograd.Function` (the custom VJPs `_flash` and `_flash_lse`),
whose backward is `flash_attention_backward`: K3 on a CUDA tensor (the
delta kernel, counted in `flash_bwd_delta_launches`, then the dq and dkv
kernels, counted once in `flash_bwd_launches`), the plain
`attention_backward` on a CPU tensor. An lse output that gets no
gradient passes nothing to the backward, as the JAX code leaves its
g_lse stream out of the kernels. `reference_attention` is this module's
copy of `dml_tpu/parallel/ring_attention.py::reference_attention`
(float32 throughout), the oracle and `TransformerLM`'s default
attention.

One extension over the JAX signature: k and v may carry fewer heads
than q (KV dividing H, grouped-query attention). Query head h then reads
kv head h // (H // KV), which is what `jnp.repeat(k, H // KV, axis=2)`
gives the JAX kernel, without the copy; the backward sums each group's
dk and dv, which is the repeat's gradient.
"""

from __future__ import annotations

import collections
import ctypes
import threading
from typing import NamedTuple, Optional, Tuple

import torch

NEG_INF = -1e30
#: the widths the mma.sync and split-TF32 kernels are built at
#: (csrc/hopper.cuh::native_head_dim): a head dim D runs on the least of
#: them >= D
NATIVE_HEAD_DIMS = (16, 32, 48, 64, 80, 96, 128, 256)
#: the widths of the bf16 wgmma + TMA kernels (csrc/hopper.cuh::
#: wgmma_head_dim), which take every bf16 D from WGMMA_MIN_HEAD_DIM up to
#: 256 that is a multiple of 8 (the drafts' 8-48 at 64)
WGMMA_HEAD_DIMS = (64, 128, 256)
WGMMA_MIN_HEAD_DIM = 8
#: `_flash_cuda`'s `route` (dml_flash_fwd's last argument): AUTO the rule
#: of `kernel_route` and `wgmma_fwd_plan` (the wrappers' only route),
#: MMA_SYNC the mma.sync kernel at every bf16 D up to 256, n > 0 the
#: width-64 wgmma kernel with n consumer warpgroups whatever the grid
FWD_AUTO, FWD_MMA_SYNC = 0, -1
#: past the widest native width, the chunked routes' output columns a
#: block: the forward's in both dtypes (csrc/flash_attention.cu::CHUNK) and
#: the float32 backward's (csrc/flash_bwd_common.cuh::CHUNK)
FWD_CHUNK = 256
BWD_CHUNK = 128
#: the bf16 forward past 256 (csrc/flash_attention.cu,
#: flash_fwd_wgmma_wide_kernel): query rows a block (two consumer
#: warpgroups of 64), keys a k-tile, and its ring's stages
WIDE_FWD_ROWS = 128
WIDE_FWD_KEYS = 64
WIDE_FWD_STAGES = 6
#: the bf16 backward past 256 (csrc/flash_attention_bwd_wide.cu): the
#: gradient columns a block owns, its rows (own and streamed, one wgmma M);
#: for it and the bf16 forward past 256, the largest cluster that splits a
#: block's items, the blocks a grid grows to by clusters, and an H100
#: block's shared memory at most
WIDE_BWD_CHUNK = 256
WIDE_ROWS = 64
WIDE_MAX_CLUSTER = 8
WIDE_TARGET_BLOCKS = 256
SMEM_PER_BLOCK = 227 * 1024
_DTYPES = (torch.bfloat16, torch.float32)

#: kernel launches since the last reset (plain ints; a test or
#: chip_smoke.py zeroes them, drives a path, and reads them back):
#: forward launches, backward launches (the dq and dkv kernels of one
#: backward count once) and the backward's delta-kernel launches
flash_launches = 0
flash_bwd_launches = 0
flash_bwd_delta_launches = 0
#: the forward and backward launches again, by the kernels they ran:
#: (direction "fwd" or "bwd", route kind, width, split) -> count, the
#: split being `fwd_split` forward (1; "cs{n}", the cluster, on the bf16
#: route past 256) and `dkv_split` backward (the dkv kernel's blocks a kv
#: head; "dq{n} dkv{m}", both kernels' clusters, on the bf16 route past
#: 256); cleared with the counts above
route_launches: collections.Counter = collections.Counter()
#: the same launches by (direction, head dim) -> count, which tells apart
#: the models that share a route (a target and its draft)
head_dim_launches: collections.Counter = collections.Counter()
#: the backward's row arrays (lse, delta) are padded to a multiple of this
ROW_PAD = 128
_count_lock = threading.Lock()


def _library() -> ctypes.CDLL:
    """Build (at first use) and load the forward kernel's library."""
    from ._build import load_library

    lib = load_library("dml_flash_attention", ["flash_attention.cu"])
    lib.dml_flash_fwd.argtypes = (
        [ctypes.c_void_p] * 5
        + [ctypes.c_int] * 7
        + [ctypes.c_longlong] * 9
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
    )
    lib.dml_flash_fwd.restype = ctypes.c_int
    return lib


class Route(NamedTuple):
    # "wgmma+tma", "mma.sync" (bf16), "tf32x3" (float32: split TF32 on
    # mma.sync), or past 256 "wgmma+tma chunked" (bf16), "tf32x3 chunked"
    # (float32)
    kind: str
    width: int  # the native head dim the kernel runs at (>= D), or past 256 its column chunk


def native_head_dim(head_dim: int, backward: bool = False) -> int:
    """The columns one block of the mma.sync and split-TF32 kernels computes, as
    the C entry points pick them: the least native width >= head_dim, or
    past the widest the chunked route's column chunk of that direction
    (FWD_CHUNK; BWD_CHUNK, float32's backward). Raises below 1."""
    if head_dim < 1:
        raise ValueError(f"no flash attention kernel at head_dim {head_dim}: "
                         "the kernels take head_dim >= 1")
    if head_dim > NATIVE_HEAD_DIMS[-1]:
        return BWD_CHUNK if backward else FWD_CHUNK
    return next(w for w in NATIVE_HEAD_DIMS if w >= head_dim)


def kernel_route(dtype: torch.dtype, head_dim: int, backward: bool = False) -> Route:
    """The kernels that `dml_flash_fwd` and `dml_flash_bwd` launch for
    (dtype, D), as the C entry points pick them, and the width they run
    at: "wgmma+tma" for bf16 at 8 <= D <= 256 with D % 8 == 0, at the
    least of `WGMMA_HEAD_DIMS` >= D (64, 128 or 256); "mma.sync" for
    every other bf16 D up to 256 and "tf32x3" (split TF32) for float32,
    each at `native_head_dim(D)`, the same both ways (`dml_flash_bwd`
    and `dml_flash_bwd_tf32` launch the backward); past 256 the chunked
    routes at their column chunk: in bf16 "wgmma+tma chunked" both ways
    (FWD_CHUNK forward, WIDE_BWD_CHUNK backward, `dml_flash_bwd_wide`: 256
    columns each), in float32 "tf32x3 chunked" (FWD_CHUNK forward,
    BWD_CHUNK backward; `backward` picks the backward's)."""
    if dtype not in _DTYPES:
        raise ValueError(f"no flash attention kernel for {dtype} at head_dim {head_dim}")
    width = native_head_dim(head_dim, backward)
    if (dtype == torch.bfloat16 and WGMMA_MIN_HEAD_DIM <= head_dim <= WGMMA_HEAD_DIMS[-1]
            and head_dim % 8 == 0):
        return Route("wgmma+tma", next(w for w in WGMMA_HEAD_DIMS if w >= head_dim))
    if dtype == torch.bfloat16 and head_dim > NATIVE_HEAD_DIMS[-1]:
        return Route("wgmma+tma chunked", WIDE_BWD_CHUNK if backward else FWD_CHUNK)
    kind = "tf32x3" if dtype == torch.float32 else "mma.sync"
    return Route(kind + " chunked" if head_dim > NATIVE_HEAD_DIMS[-1] else kind, width)


class WgmmaFwdPlan(NamedTuple):
    """The launch of the bf16 wgmma + TMA forward, as `dml_flash_fwd`
    makes it (csrc/flash_attention.cu, launch_d64 and dispatch)."""
    width: int      # 64, 128 or 256
    consumers: int  # consumer warpgroups a block, 64 query rows each
    rows: int       # query rows a block: 64 x consumers
    blocks: int     # the grid: H x B x ceil(Tq / rows)


def wgmma_fwd_plan(b: int, tq: int, h: int, d: int, n_sm: int) -> WgmmaFwdPlan:
    """The consumers a block of the bf16 wgmma forward gets for q [b, tq,
    h, d] on a card of `n_sm` SMs (the C rule reads the device's count;
    chip_smoke.py's traces hold the two to each other), and its grid. At
    width 64: three (192-row
    q-tiles) where their blocks still make four waves, one (64-row
    q-tiles, twice the blocks of two) where two-consumer blocks would fill
    less than one wave, else two; two at 128 and 256."""
    route = kernel_route(torch.bfloat16, d)
    if route.kind != "wgmma+tma":
        raise ValueError(f"head_dim {d} is not on the bf16 wgmma route ({route.kind})")
    nc = 2
    if route.width == 64:
        if -(-tq // 192) * h * b >= 4 * n_sm:
            nc = 3
        elif -(-tq // 128) * h * b < n_sm:
            nc = 1
    return WgmmaFwdPlan(route.width, nc, 64 * nc, -(-tq // (64 * nc)) * h * b)


_BWD_ARGTYPES = (
    [ctypes.c_void_p] * 9
    + [ctypes.c_int] * 8
    + [ctypes.c_longlong] * 12
    + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
)


def _bwd_library() -> ctypes.CDLL:
    """Build (at first use) and load the backward kernels' library: the
    bf16 pair and the delta kernel."""
    from ._build import load_library

    lib = load_library("dml_flash_attention_bwd", ["flash_attention_bwd.cu"])
    for fn in (lib.dml_flash_bwd, lib.dml_flash_bwd_mma):
        fn.argtypes = _BWD_ARGTYPES
        fn.restype = ctypes.c_int
    fn = lib.dml_flash_bwd_rows
    fn.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 6 + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return lib


def _bwd_tf32_library() -> ctypes.CDLL:
    """Build (at first use) and load the float32 backward pair's library
    (its own source, so that nvcc builds it beside the bf16 one)."""
    from ._build import load_library

    lib = load_library("dml_flash_attention_bwd_tf32", ["flash_attention_bwd_tf32.cu"])
    lib.dml_flash_bwd_tf32.argtypes = _BWD_ARGTYPES
    lib.dml_flash_bwd_tf32.restype = ctypes.c_int
    return lib


def _bwd_wide_library() -> ctypes.CDLL:
    """Build (at first use) and load the bf16 backward's library past head
    dim 256 (its own source, built beside the others)."""
    from ._build import load_library

    lib = load_library("dml_flash_attention_bwd_wide", ["flash_attention_bwd_wide.cu"])
    lib.dml_flash_bwd_wide.argtypes = _BWD_ARGTYPES
    lib.dml_flash_bwd_wide.restype = ctypes.c_int
    return lib


def _wide_cluster(blocks: int, items: int) -> int:
    """csrc/hopper.cuh::cluster_size, the chunked wgmma kernels' rule (the
    bf16 backward's and forward's): doubled from 1 while
    the grid has fewer than WIDE_TARGET_BLOCKS blocks, up to
    WIDE_MAX_CLUSTER and while every rank of the busiest block (`items`
    items) keeps one."""
    cs = 1
    while cs < WIDE_MAX_CLUSTER and blocks * cs < WIDE_TARGET_BLOCKS and 2 * cs <= items:
        cs *= 2
    return cs


def _wide_smem(stages: int, chunk_subs: int, row_arrays: bool) -> int:
    """csrc/flash_attention_bwd_wide.cu::Smem::bytes: the ring's stages (a
    64 x 64 bf16 sub-tile of each of Q, dO, K and V), a chunk buffer of
    `chunk_subs` sub-tiles (and a q-tile's lse and delta' rows), P in
    float32 and dS in bf16 for 128 threads, the mbarriers and 1 KB of
    alignment."""
    sub = WIDE_ROWS * 128
    return (stages * 4 * sub + chunk_subs * sub + (2 * WIDE_ROWS * 4 if row_arrays else 0)
            + 32 * 128 * 4 + 16 * 128 * 4 + 8 * (2 * stages + 2) + 1024)


class WideBwdPlan(NamedTuple):
    """The launches of the bf16 backward past head dim 256, as
    `dml_flash_bwd_wide` makes them (csrc/flash_attention_bwd_wide.cu)."""
    b: int
    tq: int
    tk: int
    h: int
    kv: int
    d: int
    n_sub: int       # 64-column sub-tiles of D
    n_chunks: int    # column chunks of WIDE_BWD_CHUNK (4 sub-tiles; the last may hold fewer)
    dq_cluster: int  # blocks a cluster splits one dq block's k-tiles over
    dkv_cluster: int  # blocks a cluster splits one kv head's (query head, q-tile) pairs over
    dq_grid: Tuple[int, int, int]   # (cluster x chunks x H, B, q-tiles)
    dkv_grid: Tuple[int, int, int]  # (cluster x chunks x KV, B, k-tiles)
    dq_smem: int
    dkv_smem: int

    def columns(self, chunk: int, consumer: int) -> range:
        """The gradient columns consumer 0 or 1 of a block of `chunk` owns."""
        lo = min(self.d, chunk * WIDE_BWD_CHUNK + consumer * WIDE_BWD_CHUNK // 2)
        return range(lo, min(self.d, lo + WIDE_BWD_CHUNK // 2))

    def dq_items(self, q_tile: int, rank: int, causal: bool) -> list:
        """The k-tiles that rank `rank` of q-tile `q_tile`'s cluster walks."""
        n_kt = -(-self.tk // WIDE_ROWS)
        if causal:
            n_kt = min(n_kt, q_tile + 1)
        return list(range(rank, n_kt, self.dq_cluster))

    def dkv_items(self, k_tile: int, rank: int, causal: bool) -> list:
        """The (query head within the group, q-tile) pairs that rank `rank`
        of k-tile `k_tile`'s cluster walks."""
        n_qt = -(-self.tq // WIDE_ROWS)
        qt0 = k_tile if causal else 0
        nq = n_qt - qt0
        return [(m // nq, qt0 + m % nq) for m in range(rank, (self.h // self.kv) * nq, self.dkv_cluster)]


def wide_bwd_plan(b: int, tq: int, tk: int, h: int, kv: int, d: int) -> WideBwdPlan:
    """The launch plan of the bf16 backward at head dim d > 256 for q
    [b, tq, h, d] and k, v [b, tk, kv, d]: blocks of WIDE_ROWS own rows x
    WIDE_BWD_CHUNK gradient columns, and the clusters that split a block's
    items where the grid would be small."""
    if d <= NATIVE_HEAD_DIMS[-1]:
        raise ValueError(f"head_dim {d} is not on the chunked route (past {NATIVE_HEAD_DIMS[-1]})")
    n_sub = -(-d // 64)
    n_cc = -(-n_sub // (WIDE_BWD_CHUNK // 64))
    n_qt, n_kt = -(-tq // WIDE_ROWS), -(-tk // WIDE_ROWS)
    cq = _wide_cluster(n_qt * n_cc * h * b, n_kt)
    ck = _wide_cluster(n_kt * n_cc * kv * b, (h // kv) * n_qt)
    return WideBwdPlan(b, tq, tk, h, kv, d, n_sub, n_cc, cq, ck,
                       (cq * n_cc * h, b, n_qt), (ck * n_cc * kv, b, n_kt),
                       _wide_smem(5, 4, False), _wide_smem(4, 8, True))


class WideFwdPlan(NamedTuple):
    """The launch of the bf16 forward past head dim 256, as `dml_flash_fwd`
    makes it (csrc/flash_attention.cu, wg::launch_wgmma_wide)."""
    b: int
    tq: int
    tk: int
    h: int
    kv: int
    d: int
    n_sub: int     # 64-column sub-tiles of D
    n_chunks: int  # output column chunks of FWD_CHUNK (4 sub-tiles; the last may hold fewer)
    q_tiles: int   # q-tiles of WIDE_FWD_ROWS rows
    cluster: int   # blocks a cluster splits one block's k-tiles over
    grid: Tuple[int, int, int]  # (cluster x chunks x H, B, q-tiles)
    smem: int      # one block's shared memory: the ring, V's two chunk buffers, the barriers
    merge_smem: int  # the cluster's partials in one owner's shared memory (0 without a cluster)

    def columns(self, chunk: int) -> range:
        """The output columns a block of `chunk` owns."""
        return range(min(self.d, chunk * FWD_CHUNK), min(self.d, (chunk + 1) * FWD_CHUNK))

    def items(self, q_tile: int, rank: int, causal: bool) -> list:
        """The k-tiles that rank `rank` of q-tile `q_tile`'s cluster walks."""
        n_kt = -(-self.tk // WIDE_FWD_KEYS)
        if causal:
            n_kt = min(n_kt, ((q_tile + 1) * WIDE_FWD_ROWS - 1) // WIDE_FWD_KEYS + 1)
        return list(range(rank, n_kt, self.cluster))


def wide_fwd_plan(b: int, tq: int, tk: int, h: int, kv: int, d: int) -> WideFwdPlan:
    """The launch plan of the bf16 forward at head dim d > 256 for q [b,
    tq, h, d] and k, v [b, tk, kv, d]: blocks of WIDE_FWD_ROWS query rows x
    FWD_CHUNK output columns, and the cluster that splits a block's k-tiles
    where the grid would be small (`_wide_cluster`'s rule, the busiest
    q-tile walking every k-tile)."""
    if d <= NATIVE_HEAD_DIMS[-1]:
        raise ValueError(f"head_dim {d} is not on the chunked route (past {NATIVE_HEAD_DIMS[-1]})")
    n_sub = -(-d // 64)
    n_cc = -(-n_sub // (FWD_CHUNK // 64))
    n_qt, n_kt = -(-tq // WIDE_FWD_ROWS), -(-tk // WIDE_FWD_KEYS)
    cs = _wide_cluster(n_qt * n_cc * h * b, n_kt)
    stage = (WIDE_FWD_ROWS + WIDE_FWD_KEYS) * 128  # a 64-column sub-tile of Q's rows and K's
    vbuf = FWD_CHUNK // 64 * WIDE_FWD_KEYS * 128
    smem = WIDE_FWD_STAGES * stage + 2 * vbuf + 8 * (2 * WIDE_FWD_STAGES + 4) + 1024
    merge = cs * 2 * (128 // cs // 4 + 1) * 128 * 16 if cs > 1 else 0
    return WideFwdPlan(b, tq, tk, h, kv, d, n_sub, n_cc, n_qt, cs, (cs * n_cc * h, b, n_qt), smem, merge)


def _expand_kv(x: torch.Tensor, heads: int) -> torch.Tensor:
    """[B, T, KV, D] -> [B, T, H, D], kv head j repeated H // KV times
    (jnp.repeat's order)."""
    kv = x.shape[2]
    return x if kv == heads else x.repeat_interleave(heads // kv, dim=2)


def _scores(q, k, causal, scale):
    """s = q k^T * scale in float32 [B, H, Tq, Tk] over kv heads
    expanded to q's, causal positions masked with NEG_INF."""
    k = _expand_kv(k, q.shape[2])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        tq, tk = s.shape[-2], s.shape[-1]
        mask = torch.arange(tq, device=q.device)[:, None] >= torch.arange(tk, device=q.device)[None, :]
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    return s


def _attention(q, k, v, causal, scale, round_p):
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    s = _scores(q, k, causal, scale)
    v = _expand_kv(v, q.shape[2])
    if not round_p:
        p = torch.softmax(s, dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype), None
    # the kernel's order: unnormalised p = exp(s - m) in V's dtype for
    # P V, divided by the f32 row sum l at the end
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    acc = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), v.float())
    out = (acc / l).permute(0, 2, 1, 3)
    return out.to(q.dtype), (m + torch.log(l))[..., 0]


def attention_with_lse(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: full-matrix attention in float32 in the
    kernel's order (and the TPU kernel's): unnormalised probabilities
    exp(s - rowmax) rounded to V's dtype for P V, then divided by their
    float32 row sum. q [B, Tq, H, D], k/v [B, Tk, KV, D] ->
    (out [B, Tq, H, D] in q's dtype, lse [B, H, Tq] f32)."""
    return _attention(q, k, v, causal, scale, round_p=True)


def reference_attention(q, k, v, *, causal: bool = True, scale=None) -> torch.Tensor:
    """Plain full-matrix attention, float32 throughout (the correctness
    oracle, and TransformerLM's default): q, k, v [B, T, H, D] ->
    [B, Tq, H, D]."""
    return _attention(q, k, v, causal, scale, round_p=False)[0]


def _delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in float32, [B, Tq, H, D] -> [B, H, Tq]
    (the JAX package computes it outside its kernels too)."""
    return (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def _rows_len(tq: int) -> int:
    return -(-tq // ROW_PAD) * ROW_PAD


def bwd_rows_plain(
    out: torch.Tensor, dout: torch.Tensor, lse: torch.Tensor, dlse: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The delta kernel's plain version: the row arrays the backward
    kernels read, (lse, delta - dlse) [B, H, Tp] in float32 with Tp = Tq
    rounded up to ROW_PAD; rows past Tq hold lse = +1e30 and delta = 0
    (the TPU pads lse the same way), so a padded query row gets P = 0."""
    b, tq, h, _ = out.shape
    delta = _delta(out, dout)
    if dlse is not None:
        delta = delta - dlse.float()
    lse_r = torch.full((b, h, _rows_len(tq)), -NEG_INF, dtype=torch.float32, device=out.device)
    delta_r = torch.zeros((b, h, _rows_len(tq)), dtype=torch.float32, device=out.device)
    lse_r[..., :tq] = lse
    delta_r[..., :tq] = delta
    return lse_r, delta_r


def attention_backward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, dout: torch.Tensor, dlse: Optional[torch.Tensor] = None, *,
    causal: bool, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward's plain version: recomputation from the saved lse in
    float32, rounded where the TPU kernels round. p = exp(s - lse),
    dp = dO V^T, ds = p (dp - delta [+ dlse]) scale; dv = p^T dO with p
    in dO's dtype, dk = ds^T Q with ds in Q's dtype, dq = ds K with ds in
    K's dtype. q/out/dout [B, Tq, H, D], k/v [B, Tk, KV, D], lse/dlse
    [B, H, Tq] f32 -> (dq, dk, dv) in q's, k's and v's dtypes; a grouped
    k/v gets its group's sum."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    b, tk, kv, d = k.shape
    p = torch.exp(_scores(q, k, causal, scale) - lse[..., None])
    dof = dout.float()
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, _expand_kv(v, q.shape[2]).float())
    row = dp - _delta(out, dout)[..., None]
    if dlse is not None:
        row = row + dlse.float()[..., None]
    ds = p * row * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dout.dtype).float(), dof)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float())
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), _expand_kv(k, q.shape[2]).float())
    if kv != q.shape[2]:
        dk = dk.reshape(b, tk, kv, -1, d).sum(3)
        dv = dv.reshape(b, tk, kv, -1, d).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(q, k, v, causal):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"expected [B,T,H,D], got {tuple(q.shape)}")
    if k.shape != v.shape or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"kv heads {k.shape[2]} must divide q heads {q.shape[2]}")
    if causal and q.shape[1] != k.shape[1]:
        raise ValueError("causal attention needs equal q/k lengths")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"q/k/v must share bfloat16 or float32, got {q.dtype}/{k.dtype}/{v.dtype}")


def _kernel_view(x: torch.Tensor) -> torch.Tensor:
    """x itself if the kernels can read it through strides (unit last
    stride, a 16-byte aligned base, 16-byte multiples for the other
    strides, none of them 0 where the dim is longer than 1: what a TMA
    tensor map takes, and whole 16-byte chunks a row for the other
    kernels' vector loads), else a contiguous copy in a new allocation
    (for a contiguous x at a misaligned offset, `x.contiguous()` would be
    x). Where D itself is not a multiple of 16 bytes (bf16 D % 8, float32
    D % 4) even a contiguous copy breaks that rule, so the copy pads D
    with zero columns to the next multiple: the kernels read zeros there,
    as they read the columns past D up to their native width."""
    vec = 16 // x.element_size()
    d = x.shape[3]
    if d % vec:
        return torch.nn.functional.pad(x, (0, -d % vec))
    ok = (x.stride(3) == 1 and x.data_ptr() % 16 == 0
          and all(s % vec == 0 and (s > 0 or n == 1) for s, n in zip(x.stride()[:3], x.shape[:3])))
    return x if ok else x.clone(memory_format=torch.contiguous_format)


def dkv_split(route: Route, group: int, plan: Optional[WideBwdPlan] = None):
    """The blocks that share one kv head's group of `group` query heads in
    the dkv kernel on `route` (csrc/flash_attention_bwd.cu, launch<256>):
    2 on the wgmma route at width 256 where the group has more than one
    head (a thread-block cluster, flash_bwd_dkv_wgmma_kernel<256, 2>),
    else 1. On the chunked wgmma route past 256 both kernels' clusters
    follow the shape: "dq{n} dkv{m}" from its `plan` (the instances
    flash_bwd_dq_wgmma_wide_kernel<n> and flash_bwd_dkv_wgmma_wide_kernel<m>)."""
    if route.kind == "wgmma+tma chunked":
        if plan is None:
            raise ValueError("the chunked wgmma route's clusters follow the shape: pass its wide_bwd_plan")
        return f"dq{plan.dq_cluster} dkv{plan.dkv_cluster}"
    return 2 if route == ("wgmma+tma", 256) and group > 1 else 1


def fwd_split(route: Route, plan: Optional[WideFwdPlan] = None):
    """The forward's launches past their route and width: on the chunked
    wgmma route the cluster of the shape's `plan`, "cs{n}" (the instance
    flash_fwd_wgmma_wide_kernel<n>), else 1."""
    if route.kind == "wgmma+tma chunked":
        if plan is None:
            raise ValueError("the chunked wgmma forward's cluster follows the shape: pass its wide_fwd_plan")
        return f"cs{plan.cluster}"
    return 1


def _count(direction: str, dtype: torch.dtype, d: int, mma_sync: bool, group: int = 1,
           plan=None) -> None:
    """Count one launch in `route_launches`, under the kernels it ran, and
    in `head_dim_launches`; `plan` is the shape's `wide_bwd_plan` or
    `wide_fwd_plan` on a chunked wgmma route."""
    route = (Route("mma.sync", native_head_dim(d)) if mma_sync
             else kernel_route(dtype, d, direction == "bwd"))
    split = dkv_split(route, group, plan) if direction == "bwd" else fwd_split(route, plan)
    route_launches[(direction, route.kind, route.width, split)] += 1
    head_dim_launches[(direction, d)] += 1


def _check_cuda(q, k, v):
    native_head_dim(q.shape[3])  # raises at D < 1
    if not (k.device == v.device == q.device):
        raise ValueError("q, k and v must be on one device")


def _flash_cuda(q, k, v, causal, scale, route=FWD_AUTO):
    """Launch K2 on the current stream; returns (out, lse). `route` other
    than FWD_AUTO (FWD_MMA_SYNC, or n consumers at width 64) times a
    route or a form beside the one the rule picks, up to head dim 256; the
    wrappers never pass it. Counts one launch."""
    global flash_launches
    _check_cuda(q, k, v)
    b, tq, h, d = q.shape
    if route != FWD_AUTO and d > NATIVE_HEAD_DIMS[-1]:
        raise ValueError(f"no forward route but the rule's past head_dim {NATIVE_HEAD_DIMS[-1]} "
                         f"(got route {route} at {d})")
    tk, kv = k.shape[1], k.shape[2]
    plan = (wide_fwd_plan(b, tq, tk, h, kv, d)
            if q.dtype == torch.bfloat16 and d > NATIVE_HEAD_DIMS[-1] else None)
    q, k, v = _kernel_view(q), _kernel_view(k), _kernel_view(v)
    out = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.dml_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            int(q.dtype == torch.bfloat16), b, h, h // kv, tq, tk, d,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            float(scale), int(causal), stream, int(route),
        )
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed: error {err} "
                           "(a cudaError, or 10000 + the CUresult of a tensor map)")
    with _count_lock:
        flash_launches += 1
        _count("fwd", q.dtype, d, route == FWD_MMA_SYNC, plan=plan)
    return out, lse


def _bwd_rows_cuda(out, dout, lse, dlse):
    """Launch the delta kernel on the current stream: the row arrays
    (lse_r, delta_r) of `bwd_rows_plain`. Counts one launch."""
    global flash_bwd_delta_launches
    b, tq, h, d = out.shape
    native_head_dim(d)  # raises at D < 1
    if dout.shape != out.shape or dout.dtype != out.dtype or dout.device != out.device:
        raise ValueError(f"dout {dout.dtype} {tuple(dout.shape)} does not fit out {out.dtype} {tuple(out.shape)}")
    rows = [lse] + ([] if dlse is None else [dlse])
    if any(r.shape != (b, h, tq) or r.dtype != torch.float32 or r.device != out.device for r in rows):
        raise ValueError(f"lse/dlse must be float32 [B, H, Tq] = {(b, h, tq)} on {out.device}")
    out, dout = _kernel_view(out), _kernel_view(dout)
    lse = lse.contiguous()
    dlse = None if dlse is None else dlse.contiguous()
    tp = _rows_len(tq)
    lse_r = torch.empty((b, h, tp), dtype=torch.float32, device=out.device)
    delta_r = torch.empty((b, h, tp), dtype=torch.float32, device=out.device)
    lib = _bwd_library()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = lib.dml_flash_bwd_rows(
            out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            None if dlse is None else dlse.data_ptr(), lse_r.data_ptr(), delta_r.data_ptr(),
            int(out.dtype == torch.bfloat16), b, h, tq, tp, d,
            out.stride(0), out.stride(1), out.stride(2),
            dout.stride(0), dout.stride(1), dout.stride(2), stream,
        )
    if err != 0:
        raise RuntimeError(f"flash attention backward delta kernel launch failed: cudaError {err}")
    with _count_lock:
        flash_bwd_delta_launches += 1
    return lse_r, delta_r


def _flash_bwd_cuda(q, k, v, dout, lse_r, delta_r, causal, scale, parts=3, mma_sync=False):
    """Launch K3's dq kernel (parts & 1) and dkv kernel (parts & 2) on
    the current stream, given the row arrays of `_bwd_rows_cuda`; returns
    (dq, dk, dv), a part not launched left unwritten. `mma_sync` runs the
    mma.sync kernels at any bf16 D up to 256 (to time them beside the
    wgmma route); the wrappers never pass it. Counts one backward launch."""
    global flash_bwd_launches
    _check_cuda(q, k, v)
    b, tq, h, d = q.shape
    if mma_sync and d > NATIVE_HEAD_DIMS[-1]:
        raise ValueError(f"no mma.sync backward past head_dim {NATIVE_HEAD_DIMS[-1]} (got {d})")
    tk, kv = k.shape[1], k.shape[2]
    if dout.shape != q.shape or dout.dtype != q.dtype or dout.device != q.device:
        raise ValueError(f"dout {dout.dtype} {tuple(dout.shape)} does not fit q {q.dtype} {tuple(q.shape)}")
    tp = _rows_len(tq)
    if any(r.shape != (b, h, tp) or r.dtype != torch.float32 or r.device != q.device
           or not r.is_contiguous() for r in (lse_r, delta_r)):
        raise ValueError(f"lse_r/delta_r must be contiguous float32 [B, H, Tp] = {(b, h, tp)} on {q.device}")
    q, k, v, dout = (_kernel_view(x) for x in (q, k, v, dout))
    dq = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, tk, kv, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, tk, kv, d), dtype=v.dtype, device=q.device)
    plan = None
    if q.dtype == torch.float32:
        fn = _bwd_tf32_library().dml_flash_bwd_tf32
    elif d > NATIVE_HEAD_DIMS[-1]:
        fn = _bwd_wide_library().dml_flash_bwd_wide
        plan = wide_bwd_plan(b, tq, tk, h, kv, d)
    else:
        lib = _bwd_library()
        fn = lib.dml_flash_bwd_mma if mma_sync else lib.dml_flash_bwd
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse_r.data_ptr(), delta_r.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            int(q.dtype == torch.bfloat16), b, h, kv, tq, tk, tp, d,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            dout.stride(0), dout.stride(1), dout.stride(2),
            float(scale), int(causal), int(parts), stream,
        )
    if err != 0:
        raise RuntimeError(f"flash attention backward kernel launch failed: error {err} "
                           "(a cudaError, or 10000 + the CUresult of a tensor map)")
    with _count_lock:
        flash_bwd_launches += 1
        _count("bwd", q.dtype, d, mma_sync, h // kv, plan)
    return dq, dk, dv


def flash_attention_backward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, dout: torch.Tensor, dlse: Optional[torch.Tensor] = None, *,
    causal: bool, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels' wrapper: (dq, dk, dv) of attention given
    the forward's (out, lse), the out cotangent `dout` and, for the lse
    variant, the lse cotangent `dlse` (None when lse gets no gradient).
    K3 on a CUDA tensor (the delta kernel, then the dq and dkv kernels),
    the plain version on a CPU tensor."""
    _check(q, k, v, causal)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if q.device.type == "cpu":
        return attention_backward(q, k, v, out, lse, dout, dlse, causal=causal, scale=scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"no flash attention kernel for device {q.device}")
    lse_r, delta_r = _bwd_rows_cuda(out, dout, lse, dlse)
    return _flash_bwd_cuda(q, k, v, dout, lse_r, delta_r, causal, scale)


def flash_block_backward(
    q: torch.Tensor, out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor, *,
    scale: Optional[float] = None,
):
    """The backward of attention whose key/value blocks were computed
    apart and merged into (`out`, `lse`), as ring attention merges them:
    returns `block(k, v, causal) -> (dq, dk, dv)`, one block's share of
    the gradients. Each block recomputes its probabilities from the
    merged lse, P_blk = exp(S_blk - lse), which is the whole softmax
    restricted to the block, so no lse cotangent enters and delta =
    rowsum(dO * O) is the same for every block. On a CUDA tensor the
    delta kernel runs once, here, and each `block` call launches K3's dq
    and dkv kernels; on a CPU tensor each call is the plain
    `attention_backward`. `out` and `dout` share q's shape and dtype."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if q.device.type == "cpu":
        def block(k, v, causal):
            _check(q, k, v, causal)
            return attention_backward(q, k, v, out, lse, dout, causal=causal, scale=scale)
        return block
    if q.device.type != "cuda":
        raise RuntimeError(f"no flash attention kernel for device {q.device}")
    lse_r, delta_r = _bwd_rows_cuda(out, dout, lse, None)

    def block(k, v, causal):
        _check(q, k, v, causal)
        return _flash_bwd_cuda(q, k, v, dout, lse_r, delta_r, causal, scale)
    return block


def _forward(q, k, v, causal, scale):
    if q.device.type == "cpu":
        return attention_with_lse(q, k, v, causal=causal, scale=scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"no flash attention kernel for device {q.device}")
    return _flash_cuda(q, k, v, causal, scale)


class _FlashAttention(torch.autograd.Function):
    """Flash attention with its backward: the counterpart of the JAX
    package's custom VJPs `_flash` and `_flash_lse` (one Function serves
    both: `flash_attention` keeps only `out`, and an output that gets no
    gradient reaches the backward as None)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        ctx.set_materialize_grads(False)
        out, lse = _forward(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        if dout is None:  # only lse reached the loss
            dout = torch.zeros_like(out)
        dq, dk, dv = flash_attention_backward(q, k, v, out, lse, dout, dlse,
                                              causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None


def flash_attention_lse(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = False, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash attention that also returns the per-row log-sum-exp.
    q [B, Tq, H, D], k/v [B, Tk, KV, D] -> (out [B, Tq, H, D] in q's
    dtype, lse [B, H, Tq] f32). The kernel on a CUDA tensor, the plain
    version on a CPU tensor; differentiable in both outputs."""
    _check(q, k, v, causal)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, scale)
    return _forward(q, k, v, causal, scale)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, scale: Optional[float] = None,
) -> torch.Tensor:
    """Blockwise (flash) attention. q [B, Tq, H, D], k/v [B, Tk, KV, D]
    (Tk may differ from Tq when not causal); returns [B, Tq, H, D] in
    q's dtype."""
    return flash_attention_lse(q, k, v, causal=causal, scale=scale)[0]
