// Flash attention backward: the Hopper counterpart of the TPU kernels
// dml_tpu/ops/flash_attention.py::_bwd_dq_kernel and ::_bwd_dkv_kernel
// (K3), plus the rowwise delta that the JAX code computes beside them.
//
// q and dO [B, Tq, H, d], k and v [B, Tk, KV, d] (BTHD, read through
// strides; KV divides H and query head h reads kv head h / (H / KV)), the
// forward's out [B, Tq, H, d] and lse [B, H, Tq] f32, the optional lse
// cotangent g_lse [B, H, Tq] f32 -> dq [B, Tq, H, d] in q's dtype, dk and
// dv [B, Tk, KV, d] in k's and v's dtype, all contiguous. Every head dim
// 1 <= d <= 256 and every group H / KV; past 256 the bf16 pair is
// flash_attention_bwd_wide.cu's and the float32 one
// flash_attention_bwd_tf32.cu's.
//
// What every route computes, by recomputation from the saved lse, in the
// TPU's two kernels:
//   S = Q K^T * scale, masked as the forward masks it (columns at Tk and
//   beyond and, if causal, past the row's position);
//   P = exp(S - lse); dP = dO V^T;
//   dS = P * (dP - delta') * scale, where delta' = rowsum(dO * O) - g_lse;
//   dq kernel: one block per q-tile loops over the k-tiles up to the
//     diagonal: dQ += dS K, dS rounded to K's dtype first (the TPU
//     kernel's `ds.astype(k_ref.dtype)`);
//   dkv kernel: one block per k-tile loops over the G query heads of its
//     group and, for each, over the q-tiles from the diagonal down: dV +=
//     P^T dO with P rounded to dO's dtype, dK += dS^T Q with dS rounded to
//     Q's dtype. The sum over the group is the gradient of a grouped k/v.
// No atomics: each dq row and each dk, dv row is summed by one block in a
// fixed order, so every gradient is the same from run to run (a
// checkpoint resume repeats the losses bit for bit). The one-kernel form
// that adds dq with atomics would save the dkv kernel's recomputation of
// S and dP, which is not where the time goes (below).
//
// Head dims as in the forward: the wgmma instances at D = 64, 128 and 256
// (hopper.cuh::wgmma_head_dim), the mma.sync ones (and the float32 ones) at D = 16, 32,
// 48, 64, 80, 96, 128 and 256 (hopper.cuh::native_head_dim), a head dim d
// on the least D >= d of its route with its columns past d loaded as
// zeros and never written. With K, Q and dO zero there, S, dP and delta
// are unchanged and dq, dk and dv are zero past d, so the result is
// exact. A bf16 d % 8 != 0 stays off the wgmma route: its TMA stores of
// dq, dk and dv (d wide) need rows of whole 16-byte units. The drafts'
// bf16 d 8-48 run the <64> pair: the maps' innermost extent is d, so a
// box's columns past d arrive as zeros and every store (dq, dk, dv, each
// a TMA store through a d-wide map) stops at d.
//
// flash_bwd_delta_kernel runs first: delta' (in f32, from out and dO
// through their strides) and a copy of lse into row arrays [B, H, Tp], Tp
// = Tq rounded up to 128, whose rows past Tq hold lse = +1e30 and delta'
// = 0 (the TPU pads lse the same way): a query row past Tq, zero-filled by
// TMA, then gets P = 0 and dS = 0 exactly, never a NaN from memory past
// the view. The TPU kernels carry dq (and dk, dv) in scratch across a
// sequential innermost grid axis; here each block loops over that axis
// itself and keeps the accumulators in registers.
//
// Routes, picked from the dtype and d alone:
//
// - bf16, 8 <= d <= 256, d % 8 == 0 (every main-path shape, the public
//   LMs' 80, 96 and 256, and the drafts' 8-48 at 64): flash_bwd_dq_wgmma_kernel and
//   flash_bwd_dkv_wgmma_kernel
//   at D 64, 128 or 256. Each block is a producer warpgroup and
//   two consumer warpgroups of 64 rows each; setmaxnreg gives the
//   consumers 232 registers and the producer 40. One producer thread
//   loads the block's own tiles once and streams the other operand's
//   tiles through a ring in shared memory with TMA over 4-d tensor maps
//   {D, heads, T, B} built from the tensors' strides (GQA reads kv head h
//   / G with no repeat; rows past T arrive as zeros; 128-byte swizzle);
//   "full" mbarriers complete on the copies' byte counts, "empty" ones on
//   the consumers' release. Products (SS: both operands in shared memory,
//   K-major; RS: A from registers, B read MN-major as TMA left it, so no
//   tile is ever transposed):
//     dq:  blocks of 128 query rows, longest causal q-tiles first; Q and
//          dO loaded once; K and V streamed in k-tiles of 128 rows (64 at
//          D 128, 32 at D 256). S = Q K^T (SS), dP = dO V^T (SS), P and dS in
//          registers, dQ += dS K (RS, dS packed from the accumulator into
//          A registers, K MN-major). dQ goes out by TMA store (rows past
//          Tq clipped).
//     dkv: blocks of 128 key rows, longest causal k-tiles first; K and V
//          loaded once; (Q, dO) pairs of 64-row q-tiles streamed with
//          their 64 lse and delta' rows (bulk copies into the same stage).
//          S^T = K Q^T (SS), dP^T = V dO^T (SS), P^T and dS^T in
//          registers (each thread reads its columns' lse and delta' from
//          shared memory), dV += P^T dO (RS, dO MN-major), dK += dS^T Q
//          (RS, Q MN-major). dK and dV are stored once per block by TMA.
//          At D 256 dK and dV would take 256 registers a thread: a block
//          is 64 keys and 128 of the gradient columns (a grid axis of two
//          column halves, each block computing S^T and dP^T over all 256
//          columns), the two consumers take the two 32-row halves of each
//          q-tile (S^T and dP^T m64n32), and consumer 1's dK and dV are
//          added to consumer 0's through shared memory at the end, in
//          that order. Where a kv head has several query heads (G > 1:
//          Gemma-2B's 8 on 1), two blocks of a thread-block cluster split
//          them, rank 1's sums added to rank 0's through distributed
//          shared memory (no atomics: bit-equal reruns).
//   P = exp2(S * scale * log2(e) - lse * log2(e)), one FMA and one exp2.
//   Masks are applied only on tiles that cross the diagonal (or Tk, in
//   dq); a consumer skips the products of a causal tile wholly past (or
//   before) its rows. An mbarrier wait that outlasts ~2 s traps.
// - bf16, d % 8 != 0: flash_bwd_dq_mma_kernel<D> and
//   flash_bwd_dkv_mma_kernel<D>, the first Hopper version: 64-row tiles,
//   4-warp blocks, synchronous tile loads, mma.sync m16n8k16 with dS, P^T
//   and dS^T in registers as A operands and the operands read along the
//   sequence copied transposed into shared memory. At D 256 the gradient
//   accumulators (dk and dv: 256 registers a thread) do not fit, so each
//   tile's block is two blocks, one per 128 gradient columns, which both
//   compute S and dP over the whole D. dml_flash_bwd_mma runs them at any
//   bf16 d up to 256 so one card can time them beside the wgmma route.
// - float32, every d: the split-TF32 pair (tensor cores, three TF32
//   products a float32 one) in flash_attention_bwd_tf32.cu, its own
//   library built in parallel with this one (dml_flash_bwd_tf32); the two
//   share flash_bwd_common.cuh.
// - bf16 d > 256: the wgmma + TMA pair in flash_attention_bwd_wide.cu,
//   its own library (dml_flash_bwd_wide): 256 gradient columns a block,
//   S and dP over all of d in 64-column sub-tiles streamed by TMA. The
//   delta kernel here takes every d and both dtypes as they are.
//
// Bound: tensor-core operations at the training shape. The backward needs
// 5 products of 2 * Tq * Tk * D operations per head (S, dP, dV, dK, dQ;
// halved for causal); the two-kernel split recomputes S and dP in the
// dkv kernel, 7 products (dq: 3, dkv: 4). At [1, 2048, 16, 64] bf16 causal
// that is 21.5 GFLOP (30.1 for the split: 0.0304 ms at 989 TFLOP/s;
// 0.0217 ms at the 5-product minimum) against ~34 MB of q, k, v, o, dO,
// dq, dk and dv (0.010 ms at 3.35 TB/s). The delta kernel is bound by
// its bytes (out and dO read once).
//
// Plain C interface for ctypes; launches on the caller's stream and
// returns cudaGetLastError() (or 10000 + the CUresult of
// cuTensorMapEncodeTiled when a tensor map cannot be encoded) so a
// refused launch raises in the wrapper.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "flash_bwd_common.cuh"

namespace {

// Copy rows [row0, row0 + R) of one head ([T, d] with row stride
// `stride_t` elements) into a shared tile of D columns with row stride
// `ld`, 16 bytes per thread per step; rows at `n_rows` and beyond and
// columns at d and beyond are zero. A row holds whole 16-byte chunks (the
// wrapper pads it so), so a chunk is all in or all out.
template <typename T, int D, int R>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src, long long stride_t,
                                          int row0, int n_rows, int d) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CHUNKS = D / VEC;
  for (int i = threadIdx.x; i < R * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS;
    const int c = (i % CHUNKS) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows && c < d) {
      val = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * stride_t + c);
    }
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// DC columns of the same 64 rows, stored transposed: dst[c * ldt + r] =
// src[row0 + r][c], zero past n_rows and past d columns.
template <int DC>
__device__ __forceinline__ void load_tile_t(__nv_bfloat16* dst, int ldt, const __nv_bfloat16* src,
                                            long long stride_t, int row0, int n_rows, int d) {
  for (int i = threadIdx.x; i < 64 * (DC / 8); i += THREADS) {
    const int r = i % 64, c = (i / 64) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows && c < d) val = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * stride_t + c);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[(c + j) * ldt + r] = e[j];
  }
}

// Per-row f32 values of one (batch, head) for rows [row0, row0 + R) into
// shared memory; rows at `n_rows` and beyond are zero.
template <int R>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int row0, int n_rows) {
  if (threadIdx.x < R) {
    const int r = row0 + threadIdx.x;
    dst[threadIdx.x] = r < n_rows ? src[r] : 0.f;
  }
}

// ---------------------------------------------------------------- delta

struct RowArgs {
  const void* out;
  const void* dout;
  const float* lse;
  const float* glse;  // nullptr when the lse output has no cotangent
  float* lse_r;
  float* delta_r;
  int H, Tq, Tp;
  int lane_shift;  // log2 of the lanes per row (2..32)
  int chunks;      // 16-byte chunks of a row that hold its d columns
  long long osb, ost, osh, dsb, dst, dsh;
};

// Grid (Tp * lanes / 256, H, B): one row t of head h per 2^lane_shift
// lanes, lane `part` reading the 16-byte chunks part, part + lanes, ... of
// out and of dO, so a row is whole cache lines and a warp's rows are
// consecutive in t (the row arrays are written in runs). The lanes'
// partial sums meet by shuffles.
template <int BF16>
__global__ void __launch_bounds__(256) flash_bwd_delta_kernel(RowArgs r) {
  const int lanes = 1 << r.lane_shift;
  const int i = blockIdx.x * 256 + threadIdx.x;
  const int t = i >> r.lane_shift;
  const int part = i & (lanes - 1);
  const int h = blockIdx.y, b = blockIdx.z;
  float sum = 0.f;
  if (t < r.Tq) {
    const uint4* orow = reinterpret_cast<const uint4*>(
        static_cast<const unsigned char*>(r.out) + (b * r.osb + t * r.ost + h * r.osh) * (BF16 ? 2 : 4));
    const uint4* drow = reinterpret_cast<const uint4*>(
        static_cast<const unsigned char*>(r.dout) + (b * r.dsb + t * r.dst + h * r.dsh) * (BF16 ? 2 : 4));
    for (int c = part; c < r.chunks; c += lanes) {
      const uint4 o = orow[c], d = drow[c];
      const uint32_t ov[4] = {o.x, o.y, o.z, o.w}, dv[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (BF16) {
          const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ov[j]));
          const float2 e = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&dv[j]));
          sum = fmaf(e.x, a.x, sum);
          sum = fmaf(e.y, a.y, sum);
        } else {
          sum = fmaf(__uint_as_float(dv[j]), __uint_as_float(ov[j]), sum);
        }
      }
    }
  }
  for (int off = lanes / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (part == 0) {
    const long long bh = (long long)b * r.H + h;
    const long long slot = bh * r.Tp + t;
    if (t < r.Tq) {
      const long long src = bh * r.Tq + t;
      r.lse_r[slot] = r.lse[src];
      r.delta_r[slot] = r.glse != nullptr ? sum - r.glse[src] : sum;
    } else {
      r.lse_r[slot] = -NEG_INF;
      r.delta_r[slot] = 0.f;
    }
  }
}

// ---------------------------------------------------------------- bf16

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// c[16x8] += a[16x16] b[16x8], bf16 in, f32 accumulate. Fragments
// (lane = 4 * g + t): a = {(g, 2t..2t+1), (g+8, 2t..), (g, 8+2t..),
// (g+8, 8+2t..)}, b = {(2t..2t+1, g), (8+2t.., g)}, c = {(g, 2t),
// (g, 2t+1), (g+8, 2t), (g+8, 2t+1)}.
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// This warp's A fragment of columns [16 kk, 16 kk + 16) of a row-major
// shared tile whose 16 rows start at `rows` (row stride `ld`).
__device__ __forceinline__ void a_frag(uint32_t* a, const bf16* rows, int ld, int kk, int g, int t) {
  const bf16* base = rows + 16 * kk + 2 * t;
  a[0] = ld32(base + g * ld);
  a[1] = ld32(base + (g + 8) * ld);
  a[2] = ld32(base + g * ld + 8);
  a[3] = ld32(base + (g + 8) * ld + 8);
}

// The A fragments of a 16 x 64 accumulator (8 tiles of 16x8 in C
// layout), rounded to bf16, for the 16 columns [16 kk, 16 kk + 16).
__device__ __forceinline__ void c_to_a(uint32_t* a, const float (*c)[4], int kk) {
  a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// dQ += dS K over W gradient columns: dS (bf16) straight from the
// accumulators into A fragments, K^T from the transposed tile Kt [W, 64]
// (row stride LDT), 16 keys at a time.
template <int W, int LDT>
__device__ __forceinline__ void dq_product(float (*acc)[4], const float (*s)[4], const bf16* Kt, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    uint32_t sa[4];
    c_to_a(sa, s, kk);
#pragma unroll
    for (int j = 0; j < W / 8; ++j) {
      const bf16* kr = Kt + (8 * j + g) * LDT + 16 * kk + 2 * t;
      mma16816(acc[j], sa, ld32(kr), ld32(kr + 8));
    }
  }
}

// dV += P^T dO and dK += dS^T Q over W gradient columns, 16 queries at a
// time; dO and Q from their transposed tiles [W, 64] (row stride LDT).
template <int W, int LDT>
__device__ __forceinline__ void dkv_product(float (*dk)[4], float (*dv)[4], const float (*s)[4],
                                            const float (*dpv)[4], const bf16* Qt, const bf16* dOt, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < BQ / 16; ++kk) {
    uint32_t pa[4], sa[4];
    c_to_a(pa, s, kk);
    c_to_a(sa, dpv, kk);
#pragma unroll
    for (int j = 0; j < W / 8; ++j) {
      const bf16* dr = dOt + (8 * j + g) * LDT + 16 * kk + 2 * t;
      const bf16* qr = Qt + (8 * j + g) * LDT + 16 * kk + 2 * t;
      mma16816(dv[j], pa, ld32(dr), ld32(dr + 8));
      mma16816(dk[j], sa, ld32(qr), ld32(qr + 8));
    }
  }
}

template <int D>
struct DqLayout {
  static constexpr int DO = grad_cols<D>();
  static constexpr int LD = D + 8;    // Q, dO, K, V tiles, row-major
  static constexpr int LDT = BK + 8;  // the block's DO columns of the K tile transposed: [DO, 64]
  static constexpr size_t bytes = sizeof(bf16) * (size_t)(2 * BQ * LD + 2 * BK * LD + DO * LDT);
};

template <int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_mma_kernel(Args a) {
  using L = DqLayout<D>;
  constexpr int DO = L::DO, NS = D / DO;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + BQ * L::LD;
  bf16* Ks = dOs + BQ * L::LD;
  bf16* Vs = Ks + BK * L::LD;
  bf16* Kt = Vs + BK * L::LD;

  const int qt = blockIdx.x / NS, col0 = (blockIdx.x % NS) * DO;  // this block's dQ columns
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / a.G;
  const int q0 = qt * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const bf16* qp = static_cast<const bf16*>(a.q) + b * a.qsb + h * a.qsh;
  const bf16* dp_ = static_cast<const bf16*>(a.dout) + b * a.dsb + h * a.dsh;
  const bf16* kp = static_cast<const bf16*>(a.k) + b * a.ksb + kvh * a.ksh;
  const bf16* vp = static_cast<const bf16*>(a.v) + b * a.vsb + kvh * a.vsh;

  load_tile<bf16, D, BQ>(Qs, L::LD, qp, a.qst, q0, a.Tq, a.d);
  load_tile<bf16, D, BQ>(dOs, L::LD, dp_, a.dst, q0, a.Tq, a.d);

  const int row[2] = {q0 + 16 * warp + g, q0 + 16 * warp + g + 8};
  const long long rbase = ((long long)b * a.H + h) * a.Tp;
  float lse[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // rows past Tq read the arrays' pad rows
    lse[r] = a.lse[rbase + row[r]];
    delta[r] = a.delta[rbase + row[r]];
  }

  float acc[DO / 8][4];
#pragma unroll
  for (int j = 0; j < DO / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  int n_tiles = (a.Tk + BK - 1) / BK;
  if (a.causal) n_tiles = min(n_tiles, (q0 + BQ - 1) / BK + 1);  // skip tiles above the diagonal

  const bf16* qrows = Qs + 16 * warp * L::LD;
  const bf16* drows = dOs + 16 * warp * L::LD;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every warp is done with the previous K/V tiles (and Q, dO are in)
    load_tile<bf16, D, BK>(Ks, L::LD, kp, a.kst, k0, a.Tk, a.d);
    load_tile<bf16, D, BK>(Vs, L::LD, vp, a.vst, k0, a.Tk, a.d);
    load_tile_t<DO>(Kt, L::LDT, kp + col0, a.kst, k0, a.Tk, a.d - col0);
    __syncthreads();

    // S = Q K^T and dP = dO V^T for this warp's 16 rows x 64 keys
    float s[BK / 8][4], dpv[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      dpv[nt][0] = dpv[nt][1] = dpv[nt][2] = dpv[nt][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], da[4];
      a_frag(qa, qrows, L::LD, kk, g, t);
      a_frag(da, drows, L::LD, kk, g, t);
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
        const bf16* kr = Ks + (8 * nt + g) * L::LD + 16 * kk + 2 * t;
        const bf16* vr = Vs + (8 * nt + g) * L::LD + 16 * kk + 2 * t;
        mma16816(s[nt], qa, ld32(kr), ld32(kr + 8));
        mma16816(dpv[nt], da, ld32(vr), ld32(vr + 8));
      }
    }

    ds_rows(s, dpv, lse, delta, row, k0, t, a);
    dq_product<DO, L::LDT>(acc, s, Kt, g, t);
  }
  store_dq<DO>(acc, row, col0, b, h, t, a);
}

template <int D>
struct DkvLayout {
  static constexpr int DO = grad_cols<D>();
  static constexpr int LD = D + 8;    // K, V, Q, dO tiles, row-major
  static constexpr int LDT = BQ + 8;  // the block's DO columns of the Q and dO tiles transposed: [DO, 64]
  static constexpr size_t bytes =
      sizeof(bf16) * (size_t)(2 * BK * LD + 2 * BQ * LD + 2 * DO * LDT) + sizeof(float) * 2 * BQ;
};

template <int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkv_mma_kernel(Args a) {
  using L = DkvLayout<D>;
  constexpr int DO = L::DO, NS = D / DO;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + BK * L::LD;
  bf16* Qs = Vs + BK * L::LD;
  bf16* dOs = Qs + BQ * L::LD;
  bf16* Qt = dOs + BQ * L::LD;
  bf16* dOt = Qt + DO * L::LDT;
  float* lse_s = reinterpret_cast<float*>(dOt + DO * L::LDT);
  float* delta_s = lse_s + BQ;

  const int kt = blockIdx.x / NS, col0 = (blockIdx.x % NS) * DO;  // this block's dK, dV columns
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int k0 = kt * BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const bf16* kp = static_cast<const bf16*>(a.k) + b * a.ksb + kvh * a.ksh;
  const bf16* vp = static_cast<const bf16*>(a.v) + b * a.vsb + kvh * a.vsh;
  load_tile<bf16, D, BK>(Ks, L::LD, kp, a.kst, k0, a.Tk, a.d);
  load_tile<bf16, D, BK>(Vs, L::LD, vp, a.vst, k0, a.Tk, a.d);

  const int key[2] = {k0 + 16 * warp + g, k0 + 16 * warp + g + 8};
  float dk[DO / 8][4], dv[DO / 8][4];
#pragma unroll
  for (int j = 0; j < DO / 8; ++j) {
    dk[j][0] = dk[j][1] = dk[j][2] = dk[j][3] = 0.f;
    dv[j][0] = dv[j][1] = dv[j][2] = dv[j][3] = 0.f;
  }

  const int n_qt = (a.Tq + BQ - 1) / BQ;
  const int qt0 = a.causal ? k0 / BQ : 0;  // q-tiles wholly above the diagonal see none of these keys
  const bf16* krows = Ks + 16 * warp * L::LD;
  const bf16* vrows = Vs + 16 * warp * L::LD;

  for (int gi = 0; gi < a.G; ++gi) {
    const int h = kvh * a.G + gi;
    const bf16* qp = static_cast<const bf16*>(a.q) + b * a.qsb + h * a.qsh;
    const bf16* dp_ = static_cast<const bf16*>(a.dout) + b * a.dsb + h * a.dsh;
    const long long rbase = ((long long)b * a.H + h) * a.Tp;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // every warp is done with the previous Q/dO tiles
      load_tile<bf16, D, BQ>(Qs, L::LD, qp, a.qst, q0, a.Tq, a.d);
      load_tile<bf16, D, BQ>(dOs, L::LD, dp_, a.dst, q0, a.Tq, a.d);
      load_tile_t<DO>(Qt, L::LDT, qp + col0, a.qst, q0, a.Tq, a.d - col0);
      load_tile_t<DO>(dOt, L::LDT, dp_ + col0, a.dst, q0, a.Tq, a.d - col0);
      load_rows<BQ>(lse_s, a.lse + rbase, q0, a.Tq);
      load_rows<BQ>(delta_s, a.delta + rbase, q0, a.Tq);
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x 64 queries
      float s[BQ / 8][4], dpv[BQ / 8][4];
#pragma unroll
      for (int nt = 0; nt < BQ / 8; ++nt) {
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
        dpv[nt][0] = dpv[nt][1] = dpv[nt][2] = dpv[nt][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ka[4], va[4];
        a_frag(ka, krows, L::LD, kk, g, t);
        a_frag(va, vrows, L::LD, kk, g, t);
#pragma unroll
        for (int nt = 0; nt < BQ / 8; ++nt) {
          const bf16* qr = Qs + (8 * nt + g) * L::LD + 16 * kk + 2 * t;
          const bf16* dr = dOs + (8 * nt + g) * L::LD + 16 * kk + 2 * t;
          mma16816(s[nt], ka, ld32(qr), ld32(qr + 8));
          mma16816(dpv[nt], va, ld32(dr), ld32(dr + 8));
        }
      }

      p_ds_cols(s, dpv, lse_s, delta_s, key, q0, t, a);
      dkv_product<DO, L::LDT>(dk, dv, s, dpv, Qt, dOt, g, t);
    }
  }
  store_dkv<DO>(dk, dv, key, col0, kvh, b, t, a);
}

// The mma.sync kernels (bf16) at native width D: 64-row tiles, D /
// grad_cols blocks a tile. parts: 1 = the dq kernel, 2 = the dkv kernel,
// 3 = both
template <int D>
int launch(const Args& a, int B, int parts, cudaStream_t stream) {
  constexpr int split = D / grad_cols<D>();
  const dim3 dq_grid((a.Tq + BQ - 1) / BQ * split, a.H, B);
  const dim3 dkv_grid((a.Tk + BK - 1) / BK * split, a.KV, B);
  int err = 0;
  if (parts & 1) {
    err = launch_one(flash_bwd_dq_mma_kernel<D>, DqLayout<D>::bytes, dq_grid, a, stream);
    if (err != 0) return err;
  }
  if (parts & 2) err = launch_one(flash_bwd_dkv_mma_kernel<D>, DkvLayout<D>::bytes, dkv_grid, a, stream);
  return err;
}

// ------------------------------------- bf16, D 8 to 256: wgmma + TMA

namespace wg {

using namespace hopper;

constexpr int NC = 2;                       // consumer warpgroups, 64 rows each
constexpr int WG_THREADS = 128 * (NC + 1);  // + the producer warpgroup
// registers after setmaxnreg: 128 * 40 + 256 * 232 <= 65536
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;

struct Params {
  const float* lse;    // [B, H, Tp], natural units, +1e30 past Tq
  const float* delta;  // [B, H, Tp], 0 past Tq
  int H, G, Tq, Tk, Tp, n_tiles;
  float scale;       // softmax scale
  float scale_log2;  // scale * log2(e)
  int causal;
};

// dq: 128 query rows per block (Q and dO loaded once), k-tiles of BN
// keys streamed. At D 64 the k-tile is 128 keys (S and dP take 64
// registers each beside dQ's 32); at D 128 it is 64 keys, so S, dP (32
// each) and dQ (64) fit the consumers' 232 registers; at D 256 it is 32
// keys: Q and dO take 128 KB, so K and V tiles of 64 keys (32 KB each a
// stage) would pass 227 KB at two stages, and dQ takes 128 registers
// beside S and dP's 16 each.
template <int D>
struct DqSmem {
  static constexpr int BQ = 64 * NC;
  static constexpr int BN = D == 64 ? 128 : D == 128 ? 64 : 32;
  static constexpr int STAGES = D == 128 ? 2 : 3;
  static constexpr int SUBS = D / 64;             // 64-column sub-tiles
  static constexpr int QSUB = BQ * ROW_BYTES;     // one sub-tile of Q or dO
  static constexpr int KSUB = BN * ROW_BYTES;     // one sub-tile of a K or V tile
  static constexpr int TILE = SUBS * KSUB;
  static constexpr int Q = 0;
  static constexpr int DO = Q + SUBS * QSUB;
  static constexpr int K = DO + SUBS * QSUB;      // + stage * TILE
  static constexpr int V = K + STAGES * TILE;     // + stage * TILE
  static constexpr int BAR = V + STAGES * TILE;   // mbarriers: q, k[S], v[S], empty[S]
  static constexpr int bytes = BAR + 8 * (1 + 3 * STAGES) + 1024;  // + slack for 1024-B alignment
};

// dkv: K and V loaded once, q-tiles of 64 rows streamed with their lse
// and delta' rows. At D 64 and 128 a block is 128 key rows, consumer c's
// keys [64c, 64c + 64) over every column: dK and dV (32 registers each at
// D 64, 64 at D 128) stay in registers beside S^T and dP^T (32 each). At
// D 256 dK and dV would take 256 registers a thread, so a block is 64 key
// rows and 128 gradient columns (a grid axis of NCOL = 2 column halves,
// each block computing S^T and dP^T over all 256 columns); both
// consumers own those keys and columns, consumer c taking the 32 query
// rows [32c, 32c + 32) of each q-tile (S^T and dP^T m64n32, 16 registers
// each; dK and dV 64 each), and consumer 1's sums are added to consumer
// 0's at the end, in that order. Where a kv head has more than one query
// head (G > 1: Gemma-2B's 8 heads on 1), HS = 2 blocks of a thread-block
// cluster split the group's heads, and rank
// 1's sums are added to rank 0's through distributed shared memory, in
// that order: still one fixed order for each gradient row, no atomics.
template <int D>
struct DkvSmem {
  static constexpr bool QSPLIT = D == 256;     // consumers split each q-tile's rows
  static constexpr int NCOL = QSPLIT ? 2 : 1;  // column chunks over the grid
  static constexpr int BK = QSPLIT ? 64 : 64 * NC;
  static constexpr int BQ = 64;
  static constexpr int QN = QSPLIT ? BQ / NC : BQ;  // query rows of a q-tile a consumer takes
  static constexpr int STAGES = QSPLIT ? 2 : 3;
  static constexpr int SUBS = D / 64;
  static constexpr int CSUBS = SUBS / NCOL;   // gradient sub-tiles a block owns
  static constexpr int KSUB = BK * ROW_BYTES;     // one sub-tile of K or V
  static constexpr int QSUB = BQ * ROW_BYTES;     // one sub-tile of a Q or dO tile
  static constexpr int QTILE = SUBS * QSUB;
  static constexpr int ROWS_BYTES = 2 * BQ * 4;   // a stage's lse and delta' rows
  static constexpr int K = 0;
  static constexpr int V = K + SUBS * KSUB;
  static constexpr int Q = V + SUBS * KSUB;       // + stage * QTILE
  static constexpr int DO = Q + STAGES * QTILE;   // + stage * QTILE
  static constexpr int ROWS = DO + STAGES * QTILE;  // + stage * ROWS_BYTES
  static constexpr int BAR = ROWS + STAGES * ROWS_BYTES;  // mbarriers: kv, full[S], empty[S]
  static constexpr int bytes = BAR + 8 * (1 + 2 * STAGES) + 1024;
};

// D 256: dq's Q and dO 2 x 64 KB + K and V 3 x 16 KB each = 224 KB of tiles
// (230,480 bytes with the barriers and the alignment slack); dkv's K and V
// 2 x 32 KB + Q and dO 2 x 32 KB each + the row arrays 2 x 512 B = 193 KB
// (198,696 bytes). Registers a consumer: dq's dQ 128 (four m64n64
// accumulators), S and dP 16 each; dkv's dK and dV 64 each, S^T and dP^T
// 16 each.
static_assert(DqSmem<256>::bytes <= SMEM_PER_BLOCK, "the D-256 dq block passes 227 KB");
static_assert(DkvSmem<256>::bytes <= SMEM_PER_BLOCK, "the D-256 dkv block passes 227 KB");
static_assert(DqSmem<128>::bytes <= SMEM_PER_BLOCK && DkvSmem<128>::bytes <= SMEM_PER_BLOCK,
              "a D-128 backward block passes 227 KB");

// d (+)= A B for one k16 step with both operands K-major in shared memory,
// N = 32, 64 or 128.
template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db, int scale_d) {
  if constexpr (N == 128) {
    wgmma_ss_m64n128(d, da, db, scale_d);
  } else if constexpr (N == 64) {
    wgmma_ss_m64n64(d, da, db, scale_d);
  } else {
    wgmma_ss_m64n32(d, da, db, scale_d);
  }
}

// acc = A B^T over D for 64 rows of A and the N rows of B, both row-major
// [rows, D] tiles in 64-column swizzled sub-tiles (a_sub and b_sub bytes
// apart): D / 16 steps; one commit group.
template <int D, int N>
__device__ __forceinline__ void issue_abt(float* acc, uint32_t a_addr, int a_sub, uint32_t b_addr,
                                          int b_sub) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t step = (kk % 4) * 32;
    wgmma_ss<N>(acc, kmajor_desc(a_addr + (kk / 4) * a_sub + step),
                kmajor_desc(b_addr + (kk / 4) * b_sub + step), kk > 0);
  }
  wgmma_commit();
}

// acc[j] += A B for each 64-column sub-tile j of B: A (KSTEPS x 16 rows of
// B's sequence axis) from registers, B a row-major [rows, D] tile read
// MN-major, 16 rows (2048 B) a step; no commit.
template <int SUBS, int KSTEPS>
__device__ __forceinline__ void issue_rs(float (*acc)[32], const uint32_t (*a)[4], uint32_t b_addr,
                                         int b_sub) {
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk)
#pragma unroll
    for (int j = 0; j < SUBS; ++j)
      wgmma_rs_m64n64_tb(acc[j], a[kk], mnmajor_desc(b_addr + j * b_sub + kk * 16 * ROW_BYTES));
}

// A registers (bf16) from an m64nN accumulator: its fragment of columns
// 16kk..16kk+15 is the A fragment of k16 step kk.
template <int KSTEPS>
__device__ __forceinline__ void pack_a(uint32_t (*a)[4], const float* c) {
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) a[kk][i] = pack_bf16(c[8 * kk + 2 * i], c[8 * kk + 2 * i + 1]);
}

// The consumer's accumulator (64 rows x 64 columns per sub-tile) as bf16
// into its own rows of a swizzled tile (sub-tiles `sub` bytes apart), for
// a TMA store.
template <int SUBS>
__device__ __forceinline__ void stage_out(unsigned char* dst, int sub, const float (*acc)[32], int warp,
                                          int g, int t) {
#pragma unroll
  for (int j = 0; j < SUBS; ++j)
#pragma unroll
    for (int i2 = 0; i2 < 8; ++i2)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int rl = 16 * warp + g + 8 * r;  // row within the consumer's 64
        const int byte = j * sub + rl * ROW_BYTES + ((i2 ^ (rl & 7)) << 4) + 4 * t;
        *reinterpret_cast<uint32_t*>(dst + byte) = pack_bf16(acc[j][4 * i2 + 2 * r], acc[j][4 * i2 + 2 * r + 1]);
      }
}

template <int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_do,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const __grid_constant__ CUtensorMap tm_dq, const Params a) {
  using L = DqSmem<D>;
  constexpr int BN = L::BN;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzled tiles need 1024-B alignment
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bar_q = base + L::BAR;
  const uint32_t bar_k = bar_q + 8;                // + 8 * stage
  const uint32_t bar_v = bar_k + 8 * L::STAGES;    // + 8 * stage
  const uint32_t bar_e = bar_v + 8 * L::STAGES;    // + 8 * stage

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (a.n_tiles - 1 - blockIdx.z) * L::BQ;  // longest causal q-tiles first
  const int kvh = h / a.G;
  int n_kt = (a.Tk + BN - 1) / BN;
  if (a.causal) n_kt = min(n_kt, (q0 + L::BQ - 1) / BN + 1);  // past the diagonal: never
  const bool ragged = (a.Tk % BN) != 0;

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_e + 8 * s, NC * 128);  // every consumer thread releases the stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (tid == 0) {
      mbar_expect_tx(bar_q, 2 * L::SUBS * L::QSUB);
#pragma unroll
      for (int j = 0; j < L::SUBS; ++j) {
        tma_load(base + L::Q + j * L::QSUB, &tm_q, bar_q, 64 * j, h, q0, b);
        tma_load(base + L::DO + j * L::QSUB, &tm_do, bar_q, 64 * j, h, q0, b);
      }
      for (int i = 0; i < n_kt; ++i) {
        const int s = i % L::STAGES;
        if (i >= L::STAGES) mbar_wait(bar_e + 8 * s, ((i / L::STAGES) - 1) & 1);
        const int k0 = i * BN;
        mbar_expect_tx(bar_k + 8 * s, L::TILE);
#pragma unroll
        for (int j = 0; j < L::SUBS; ++j)
          tma_load(base + L::K + s * L::TILE + j * L::KSUB, &tm_k, bar_k + 8 * s, 64 * j, kvh, k0, b);
        mbar_expect_tx(bar_v + 8 * s, L::TILE);
#pragma unroll
        for (int j = 0; j < L::SUBS; ++j)
          tma_load(base + L::V + s * L::TILE + j * L::KSUB, &tm_v, bar_v + 8 * s, 64 * j, kvh, k0, b);
      }
    }
  } else {
    // ------------------------------------------------------------ consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int c = tid / 128 - 1;  // rows [64c, 64c + 64) of the q-tile
    const int tw = tid % 128, warp = tw / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
    const int first = q0 + 64 * c;          // this consumer's first row
    const int row0 = first + 16 * warp + g;  // this thread's rows: row0, row0 + 8
    const uint32_t q_addr = base + L::Q + c * 64 * ROW_BYTES;
    const uint32_t do_addr = base + L::DO + c * 64 * ROW_BYTES;
    // lse (as -lse * log2(e)) and delta' of the thread's rows; the row
    // arrays reach Tp >= every block's last row
    const long long rbase = ((long long)b * a.H + h) * a.Tp;
    float neg_lse[2], delta[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      neg_lse[r] = -a.lse[rbase + row0 + 8 * r] * LOG2E;
      delta[r] = a.delta[rbase + row0 + 8 * r];
    }

    float dq[L::SUBS][32];  // dQ, one m64n64 accumulator per 64-column sub-tile
    float s[BN / 2];        // S, then P: one m64nBN accumulator
    float dp[BN / 2];       // dP, then dS
#pragma unroll
    for (int j = 0; j < L::SUBS; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) dq[j][i] = 0.f;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] = dp[i] = 0.f;

    mbar_wait(bar_q, 0);
    for (int i = 0; i < n_kt; ++i) {
      const int st = i % L::STAGES;
      const uint32_t parity = (i / L::STAGES) & 1;
      const int k0 = i * BN;
      const uint32_t k_addr = base + L::K + st * L::TILE;
      const uint32_t v_addr = base + L::V + st * L::TILE;
      mbar_wait(bar_k + 8 * st, parity);
      if (a.causal && k0 > first + 63) {  // every key past every row of this consumer
        mbar_arrive(bar_e + 8 * st);
        continue;
      }
      fence_regs<BN / 2>(s);
      fence_regs<BN / 2>(dp);
      wgmma_fence();
      issue_abt<D, BN>(s, q_addr, L::QSUB, k_addr, L::KSUB);
      mbar_wait(bar_v + 8 * st, parity);
      issue_abt<D, BN>(dp, do_addr, L::QSUB, v_addr, L::KSUB);
      wgmma_wait<1>();
      fence_regs<BN / 2>(s);
      // P = exp2(S scale log2(e) - lse log2(e)); a mask only where some key
      // passes this consumer's first row, or on the last tile past Tk
      const bool masked = (a.causal && k0 + BN - 1 > first) || (ragged && i == n_kt - 1);
      if (masked) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + 8 * j + 2 * t + (e & 1);
            if (key >= a.Tk || (a.causal && key > row0 + 8 * (e >> 1))) s[4 * j + e] = -INFINITY;
          }
      }
#pragma unroll
      for (int j = 0; j < BN / 2; ++j) s[j] = ex2(fmaf(s[j], a.scale_log2, neg_lse[(j >> 1) & 1]));
      wgmma_wait<0>();
      fence_regs<BN / 2>(dp);
      // dS = P (dP - delta') scale, rounded to bf16 as the A registers of dS K
#pragma unroll
      for (int j = 0; j < BN / 2; ++j) dp[j] = s[j] * (dp[j] - delta[(j >> 1) & 1]) * a.scale;
      uint32_t da[BN / 16][4];
      pack_a<BN / 16>(da, dp);
#pragma unroll
      for (int j = 0; j < L::SUBS; ++j) fence_regs<32>(dq[j]);
      wgmma_fence();
      issue_rs<L::SUBS, BN / 16>(dq, da, k_addr, L::KSUB);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int j = 0; j < L::SUBS; ++j) fence_regs<32>(dq[j]);
      mbar_arrive(bar_e + 8 * st);
    }

    // epilogue: dQ as bf16 into this consumer's own Q rows (no longer
    // read), one TMA store per sub-tile; rows past Tq are clipped
    stage_out<L::SUBS>(smem + L::Q + c * 64 * ROW_BYTES, L::QSUB, dq, warp, g, t);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
    if (tw == 0) {
#pragma unroll
      for (int j = 0; j < L::SUBS; ++j) tma_store(&tm_dq, q_addr + j * L::QSUB, 64 * j, h, first, b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  }
}

template <int D, int HS>
__global__ void __launch_bounds__(WG_THREADS, 1)
    flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                               const __grid_constant__ CUtensorMap tm_do,
                               const __grid_constant__ CUtensorMap tm_k,
                               const __grid_constant__ CUtensorMap tm_v,
                               const __grid_constant__ CUtensorMap tm_dk,
                               const __grid_constant__ CUtensorMap tm_dv, const Params a) {
  using L = DkvSmem<D>;
  static_assert(HS == 1 || (L::QSPLIT && HS == 2), "head splits only at D 256, over two blocks");
  constexpr int BQW = L::BQ;
  constexpr int QN = L::QN;  // query rows of a q-tile this consumer takes
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bar_kv = base + L::BAR;
  const uint32_t bar_f = bar_kv + 8;              // + 8 * stage
  const uint32_t bar_e = bar_f + 8 * L::STAGES;   // + 8 * stage

  // HS blocks of a cluster share a kv head, rank hr walking the group's
  // heads hr, hr + HS, ...
  const int kvh = blockIdx.x / HS, hr = HS > 1 ? (int)cluster_ctarank() : 0, b = blockIdx.y;
  // longest causal k-tiles (the first) first; with column chunks, the
  // chunk's first sub-tile cs0
  const int k0 = (blockIdx.z / L::NCOL) * L::BK;
  const int cs0 = (blockIdx.z % L::NCOL) * L::CSUBS;
  const int n_qt = (a.Tq + BQW - 1) / BQW;
  const int qt0 = a.causal ? k0 / BQW : 0;  // q-tiles wholly above the diagonal see none of these keys

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(bar_f + 8 * s, 1);
      mbar_init(bar_e + 8 * s, NC * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (tid == 0) {
      mbar_expect_tx(bar_kv, 2 * L::SUBS * L::KSUB);
#pragma unroll
      for (int j = 0; j < L::SUBS; ++j) {
        tma_load(base + L::K + j * L::KSUB, &tm_k, bar_kv, 64 * j, kvh, k0, b);
        tma_load(base + L::V + j * L::KSUB, &tm_v, bar_kv, 64 * j, kvh, k0, b);
      }
      int i = 0;
      for (int gi = hr; gi < a.G; gi += HS) {
        const int h = kvh * a.G + gi;
        const long long rbase = ((long long)b * a.H + h) * a.Tp;
        for (int qt = qt0; qt < n_qt; ++qt, ++i) {
          const int s = i % L::STAGES;
          if (i >= L::STAGES) mbar_wait(bar_e + 8 * s, ((i / L::STAGES) - 1) & 1);
          const int q0 = qt * BQW;
          const uint32_t full = bar_f + 8 * s;
          mbar_expect_tx(full, 2 * L::QTILE + L::ROWS_BYTES);
#pragma unroll
          for (int j = 0; j < L::SUBS; ++j) {
            tma_load(base + L::Q + s * L::QTILE + j * L::QSUB, &tm_q, full, 64 * j, h, q0, b);
            tma_load(base + L::DO + s * L::QTILE + j * L::QSUB, &tm_do, full, 64 * j, h, q0, b);
          }
          const uint32_t rows = base + L::ROWS + s * L::ROWS_BYTES;
          bulk_load(rows, a.lse + rbase + q0, BQW * 4, full);
          bulk_load(rows + BQW * 4, a.delta + rbase + q0, BQW * 4, full);
        }
      }
    }
  } else {
    // ------------------------------------------------------------ consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    // keys [64c, 64c + 64) of the k-tile and every query of a q-tile, or
    // (QSPLIT) the block's 64 keys and queries [32c, 32c + 32) of each
    const int c = tid / 128 - 1;
    const int tw = tid % 128, warp = tw / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
    const int kc = L::QSPLIT ? 0 : c;
    const int qoff = L::QSPLIT ? QN * c : 0;  // this consumer's first row of a q-tile
    const int first = k0 + 64 * kc;          // this consumer's first key
    const int key0 = first + 16 * warp + g;  // this thread's keys: key0, key0 + 8
    const uint32_t k_addr = base + L::K + kc * 64 * ROW_BYTES;
    const uint32_t v_addr = base + L::V + kc * 64 * ROW_BYTES;

    float dk[L::CSUBS][32], dv[L::CSUBS][32];  // one m64n64 accumulator per sub-tile
    float s[QN / 2];   // S^T, then P^T: keys x queries
    float dp[QN / 2];  // dP^T, then dS^T
#pragma unroll
    for (int j = 0; j < L::CSUBS; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) dk[j][i] = dv[j][i] = 0.f;
#pragma unroll
    for (int i = 0; i < QN / 2; ++i) s[i] = dp[i] = 0.f;

    mbar_wait(bar_kv, 0);
    int i = 0;
    for (int gi = hr; gi < a.G; gi += HS) {
      for (int qt = qt0; qt < n_qt; ++qt, ++i) {
        const int st = i % L::STAGES;
        const uint32_t parity = (i / L::STAGES) & 1;
        const int q0 = qt * BQW;
        const int qc = q0 + qoff;  // this consumer's first query of the tile
        mbar_wait(bar_f + 8 * st, parity);
        if (a.causal && qc + QN - 1 < first) {  // every query before every key of this consumer
          mbar_arrive(bar_e + 8 * st);
          continue;
        }
        const uint32_t q_addr = base + L::Q + st * L::QTILE + qoff * ROW_BYTES;
        const uint32_t do_addr = base + L::DO + st * L::QTILE + qoff * ROW_BYTES;
        const float* rows = reinterpret_cast<const float*>(smem + L::ROWS + st * L::ROWS_BYTES) + qoff;
        fence_regs<QN / 2>(s);
        fence_regs<QN / 2>(dp);
        wgmma_fence();
        issue_abt<D, QN>(s, k_addr, L::KSUB, q_addr, L::QSUB);
        issue_abt<D, QN>(dp, v_addr, L::KSUB, do_addr, L::QSUB);
        wgmma_wait<1>();
        fence_regs<QN / 2>(s);
        // P^T: each thread's columns are the queries 8j + 2t and 8j + 2t + 1
        const bool masked = a.causal && qc < first + 63;  // some key of this consumer past a query
#pragma unroll
        for (int j = 0; j < QN / 8; ++j) {
          const float2 l2 = *reinterpret_cast<const float2*>(rows + 8 * j + 2 * t);
          const float nl[2] = {-l2.x * LOG2E, -l2.y * LOG2E};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = s[4 * j + e];
            if (masked && key0 + 8 * (e >> 1) > qc + 8 * j + 2 * t + (e & 1)) x = -INFINITY;
            s[4 * j + e] = ex2(fmaf(x, a.scale_log2, nl[e & 1]));
          }
        }
        wgmma_wait<0>();
        fence_regs<QN / 2>(dp);
        // dS^T = P^T (dP^T - delta') scale
#pragma unroll
        for (int j = 0; j < QN / 8; ++j) {
          const float2 d2 = *reinterpret_cast<const float2*>(rows + BQW + 8 * j + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - ((e & 1) ? d2.y : d2.x)) * a.scale;
        }
        // P^T in dO's dtype and dS^T in Q's, as A registers
        uint32_t pa[QN / 16][4], da[QN / 16][4];
        pack_a<QN / 16>(pa, s);
        pack_a<QN / 16>(da, dp);
#pragma unroll
        for (int j = 0; j < L::CSUBS; ++j) {
          fence_regs<32>(dv[j]);
          fence_regs<32>(dk[j]);
        }
        wgmma_fence();
        // dV += P^T dO, dK += dS^T Q over the block's gradient sub-tiles
        issue_rs<L::CSUBS, QN / 16>(dv, pa, do_addr + cs0 * L::QSUB, L::QSUB);
        issue_rs<L::CSUBS, QN / 16>(dk, da, q_addr + cs0 * L::QSUB, L::QSUB);
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int j = 0; j < L::CSUBS; ++j) {
          fence_regs<32>(dv[j]);
          fence_regs<32>(dk[j]);
        }
        mbar_arrive(bar_e + 8 * st);
      }
    }

    if constexpr (L::QSPLIT) {
      // consumer 1's dK and dV into the Q/dO ring (every tile there read
      // once both consumers pass the first barrier), added to consumer 0's
      // in that order: one fixed order for each gradient row. Each thread
      // moves its own registers, so both consumers' fragments line up.
      float* part = reinterpret_cast<float*>(smem + L::Q);
      static_assert(2 * L::CSUBS * 32 * 128 * 4 <= 2 * L::STAGES * L::QTILE, "partials past the ring");
      asm volatile("bar.sync 3, 256;\n" ::: "memory");
      if (c == 1) {
#pragma unroll
        for (int j = 0; j < L::CSUBS; ++j)
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            part[((2 * j) * 32 + i) * 128 + tw] = dk[j][i];
            part[((2 * j + 1) * 32 + i) * 128 + tw] = dv[j][i];
          }
      }
      asm volatile("bar.sync 3, 256;\n" ::: "memory");
      if (c == 1) return;
#pragma unroll
      for (int j = 0; j < L::CSUBS; ++j)
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          dk[j][i] += part[((2 * j) * 32 + i) * 128 + tw];
          dv[j][i] += part[((2 * j + 1) * 32 + i) * 128 + tw];
        }
      if constexpr (HS > 1) {
        // rank 1's sums into rank 0's ring, past the slot just read, once
        // both ranks are past their loops; rank 0 adds them after its own
        constexpr int SLOT = 2 * L::CSUBS * 32 * 128;  // floats of one rank's sums
        static_assert(2 * SLOT * 4 <= 2 * L::STAGES * L::QTILE, "a rank's sums past the ring");
        cluster_sync();
        if (hr == 1) {
          const uint32_t dst = map_shared_rank(smem_u32(part + SLOT), 0);
#pragma unroll
          for (int j = 0; j < L::CSUBS; ++j)
#pragma unroll
            for (int i = 0; i < 32; i += 4) {
              st_cluster_v4(dst + ((((2 * j) * 32 + i) / 4 * 128 + tw) << 4), dk[j][i], dk[j][i + 1], dk[j][i + 2],
                            dk[j][i + 3]);
              st_cluster_v4(dst + ((((2 * j + 1) * 32 + i) / 4 * 128 + tw) << 4), dv[j][i], dv[j][i + 1],
                            dv[j][i + 2], dv[j][i + 3]);
            }
        }
        cluster_sync();
        if (hr == 1) return;
        const float4* other = reinterpret_cast<const float4*>(part + SLOT);
#pragma unroll
        for (int j = 0; j < L::CSUBS; ++j)
#pragma unroll
          for (int i = 0; i < 32; i += 4) {
            const float4 k4 = other[((2 * j) * 32 + i) / 4 * 128 + tw];
            const float4 v4 = other[((2 * j + 1) * 32 + i) / 4 * 128 + tw];
            dk[j][i] += k4.x, dk[j][i + 1] += k4.y, dk[j][i + 2] += k4.z, dk[j][i + 3] += k4.w;
            dv[j][i] += v4.x, dv[j][i + 1] += v4.y, dv[j][i + 2] += v4.z, dv[j][i + 3] += v4.w;
          }
      }
    }

    // epilogue: dK and dV as bf16 into this consumer's own K and V rows
    // (no longer read), TMA stores; rows past Tk are clipped
    stage_out<L::CSUBS>(smem + L::K + kc * 64 * ROW_BYTES, L::KSUB, dk, warp, g, t);
    stage_out<L::CSUBS>(smem + L::V + kc * 64 * ROW_BYTES, L::KSUB, dv, warp, g, t);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
    if (tw == 0) {
#pragma unroll
      for (int j = 0; j < L::CSUBS; ++j) {
        tma_store(&tm_dk, k_addr + j * L::KSUB, 64 * (cs0 + j), kvh, first, b);
        tma_store(&tm_dv, v_addr + j * L::KSUB, 64 * (cs0 + j), kvh, first, b);
      }
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  }
}

template <int D, int HS>
int launch_dkv(const Args& a, int B, int d, const Params& base, cudaStream_t stream) {
  using L = DkvSmem<D>;
  int err;
  CUtensorMap tq, tdo, tk, tv, tdk, tdv;
  if ((err = encode_map(&tq, a.q, d, a.H, a.Tq, B, a.qsh, a.qst, a.qsb, L::BQ))) return err;
  if ((err = encode_map(&tdo, a.dout, d, a.H, a.Tq, B, a.dsh, a.dst, a.dsb, L::BQ))) return err;
  if ((err = encode_map(&tk, a.k, d, a.KV, a.Tk, B, a.ksh, a.kst, a.ksb, L::BK))) return err;
  if ((err = encode_map(&tv, a.v, d, a.KV, a.Tk, B, a.vsh, a.vst, a.vsb, L::BK))) return err;
  // dk and dv are contiguous [B, Tk, KV, d]
  const long long st = (long long)a.KV * d, sb = (long long)a.Tk * a.KV * d;
  if ((err = encode_map(&tdk, a.dk, d, a.KV, a.Tk, B, d, st, sb, 64))) return err;
  if ((err = encode_map(&tdv, a.dv, d, a.KV, a.Tk, B, d, st, sb, 64))) return err;
  Params p = base;
  p.n_tiles = (a.Tk + L::BK - 1) / L::BK;
  auto kernel = flash_bwd_dkv_wgmma_kernel<D, HS>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(a.KV * HS, B, p.n_tiles * L::NCOL);
  if constexpr (HS == 1) {
    kernel<<<grid, WG_THREADS, L::bytes, stream>>>(tq, tdo, tk, tv, tdk, tdv, p);
  } else {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(WG_THREADS);
    cfg.dynamicSmemBytes = L::bytes;
    cfg.stream = stream;
    cudaLaunchAttribute cluster[1];
    cluster[0].id = cudaLaunchAttributeClusterDimension;
    cluster[0].val.clusterDim.x = HS;  // the HS blocks of one kv head
    cluster[0].val.clusterDim.y = 1;
    cluster[0].val.clusterDim.z = 1;
    cfg.attrs = cluster;
    cfg.numAttrs = 1;
    if ((e = cudaLaunchKernelEx(&cfg, kernel, tq, tdo, tk, tv, tdk, tdv, p)) != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

template <int D>
int launch(const Args& a, int B, int parts, cudaStream_t stream) {
  int err;
  const Params base{a.lse, a.delta, a.H, a.G, a.Tq, a.Tk, a.Tp, 0, a.scale, a.scale * LOG2E, a.causal};
  // every map's innermost extent is d: a box's columns past it arrive as
  // zeros (and count toward the expected bytes), a store stops at it
  const int d = a.d;
  if (parts & 1) {
    using L = DqSmem<D>;
    CUtensorMap tq, tdo, tk, tv, tdq;
    if ((err = encode_map(&tq, a.q, d, a.H, a.Tq, B, a.qsh, a.qst, a.qsb, L::BQ))) return err;
    if ((err = encode_map(&tdo, a.dout, d, a.H, a.Tq, B, a.dsh, a.dst, a.dsb, L::BQ))) return err;
    if ((err = encode_map(&tk, a.k, d, a.KV, a.Tk, B, a.ksh, a.kst, a.ksb, L::BN))) return err;
    if ((err = encode_map(&tv, a.v, d, a.KV, a.Tk, B, a.vsh, a.vst, a.vsb, L::BN))) return err;
    // dq is contiguous [B, Tq, H, d]; each consumer stores its 64 rows
    if ((err = encode_map(&tdq, a.dq, d, a.H, a.Tq, B, d, (long long)a.H * d, (long long)a.Tq * a.H * d, 64)))
      return err;
    Params p = base;
    p.n_tiles = (a.Tq + L::BQ - 1) / L::BQ;
    auto kernel = flash_bwd_dq_wgmma_kernel<D>;
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes);
    if (e != cudaSuccess) return (int)e;
    kernel<<<dim3(a.H, B, p.n_tiles), WG_THREADS, L::bytes, stream>>>(tq, tdo, tk, tv, tdq, p);
    if ((err = (int)cudaGetLastError())) return err;
  }
  if (parts & 2) {
    if constexpr (D == 256) {
      // two blocks a kv head split its group's heads where it has more
      // than one (ops/flash_attention.py::dkv_split says the same)
      err = a.G > 1 ? launch_dkv<256, 2>(a, B, d, base, stream) : launch_dkv<256, 1>(a, B, d, base, stream);
    } else {
      err = launch_dkv<D, 1>(a, B, d, base, stream);
    }
    if (err) return err;
  }
  return 0;
}

}  // namespace wg

int flash_bwd(const void* q, const void* k, const void* v, const void* dout, const void* lse_r,
              const void* delta_r, void* dq, void* dk, void* dv, int is_bf16, int B, int H, int KV,
              int Tq, int Tk, int Tp, int D, long long qsb, long long qst, long long qsh, long long ksb,
              long long kst, long long ksh, long long vsb, long long vst, long long vsh, long long dsb,
              long long dst, long long dsh, float scale, int causal, int parts, void* stream,
              bool wgmma) {
  if (B <= 0 || Tq <= 0 || Tk <= 0) return 0;
  Args a{q, k, v, dout,
         static_cast<const float*>(lse_r), static_cast<const float*>(delta_r), dq, dk, dv,
         H, H / KV, KV, Tq, Tk, Tp, D,
         qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh, dsb, dst, dsh, scale, causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_bf16) return (int)cudaErrorInvalidValue;  // float32: flash_attention_bwd_tf32.cu
  if (wgmma) {
    switch (hopper::wgmma_head_dim(D)) {
      case 64: return wg::launch<64>(a, B, parts, s);
      case 128: return wg::launch<128>(a, B, parts, s);
      case 256: return wg::launch<256>(a, B, parts, s);
      default: break;  // D % 8 != 0 or past 256
    }
  }
  switch (hopper::native_head_dim(D)) {
    case 16: return launch<16>(a, B, parts, s);
    case 32: return launch<32>(a, B, parts, s);
    case 48: return launch<48>(a, B, parts, s);
    case 64: return launch<64>(a, B, parts, s);
    case 80: return launch<80>(a, B, parts, s);
    case 96: return launch<96>(a, B, parts, s);
    case 128: return launch<128>(a, B, parts, s);
    case 256: return launch<256>(a, B, parts, s);
    default: return (int)cudaErrorInvalidValue;  // D < 1, and past 256: flash_attention_bwd_wide.cu
  }
}

}  // namespace

// The row arrays of one backward: lse_r and delta_r [B, H, Tp] f32 (Tp a
// multiple of 128, at least Tq) from out and dO [B, Tq, H, D] (strided;
// 16-byte aligned rows of whole 16-byte chunks), lse and the optional
// g_lse [B, H, Tq].
extern "C" int dml_flash_bwd_rows(const void* out, const void* dout, const void* lse, const void* glse,
                                  void* lse_r, void* delta_r, int is_bf16, int B, int H, int Tq, int Tp,
                                  int D, long long osb, long long ost, long long osh,
                                  long long dsb, long long dst, long long dsh, void* stream) {
  if (B <= 0 || Tq <= 0) return 0;
  const int vec = is_bf16 ? 8 : 4;
  const int chunks = (D + vec - 1) / vec;
  if (Tp % 128 != 0 || Tp < Tq || D < 1) return (int)cudaErrorInvalidValue;
  int lanes = 2;  // at least 2, so that Tp * lanes is a multiple of 256
  while (lanes < chunks && lanes < 32) lanes *= 2;
  RowArgs r{out, dout, static_cast<const float*>(lse), static_cast<const float*>(glse),
            static_cast<float*>(lse_r), static_cast<float*>(delta_r), H, Tq, Tp, __builtin_ctz(lanes),
            chunks, osb, ost, osh, dsb, dst, dsh};
  const dim3 grid(Tp * lanes / 256, H, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    flash_bwd_delta_kernel<1><<<grid, 256, 0, s>>>(r);
  } else {
    flash_bwd_delta_kernel<0><<<grid, 256, 0, s>>>(r);
  }
  return (int)cudaGetLastError();
}

// bf16 dq, dk and dv given the row arrays, on the kernels for D: wgmma +
// TMA at 8 <= D <= 256 with D a multiple of 8, as the TMA stores need rows
// of whole 16-byte units (at width 64, 128 or 256), mma.sync at every
// other D up to 256, at the native width >= D (cudaErrorInvalidValue at
// D < 1; past 256, dml_flash_bwd_wide in flash_attention_bwd_wide.cu; for
// float32, dml_flash_bwd_tf32 in flash_attention_bwd_tf32.cu).
// parts: 1 = the dq kernel, 2 = the dkv kernel, 3 = both.
extern "C" int dml_flash_bwd(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse_r, const void* delta_r,
                             void* dq, void* dk, void* dv,
                             int is_bf16, int B, int H, int KV, int Tq, int Tk, int Tp, int D,
                             long long qsb, long long qst, long long qsh,
                             long long ksb, long long kst, long long ksh,
                             long long vsb, long long vst, long long vsh,
                             long long dsb, long long dst, long long dsh,
                             float scale, int causal, int parts, void* stream) {
  return flash_bwd(q, k, v, dout, lse_r, delta_r, dq, dk, dv, is_bf16, B, H, KV, Tq, Tk, Tp, D, qsb, qst,
                   qsh, ksb, kst, ksh, vsb, vst, vsh, dsb, dst, dsh, scale, causal, parts, stream, true);
}

// The same call on the mma.sync kernels at every bf16 D up to 256, so one
// card can time them beside the wgmma route.
extern "C" int dml_flash_bwd_mma(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse_r, const void* delta_r,
                                 void* dq, void* dk, void* dv,
                                 int is_bf16, int B, int H, int KV, int Tq, int Tk, int Tp, int D,
                                 long long qsb, long long qst, long long qsh,
                                 long long ksb, long long kst, long long ksh,
                                 long long vsb, long long vst, long long vsh,
                                 long long dsb, long long dst, long long dsh,
                                 float scale, int causal, int parts, void* stream) {
  return flash_bwd(q, k, v, dout, lse_r, delta_r, dq, dk, dv, is_bf16, B, H, KV, Tq, Tk, Tp, D, qsb, qst,
                   qsh, ksb, kst, ksh, vsb, vst, vsh, dsb, dst, dsh, scale, causal, parts, stream, false);
}
