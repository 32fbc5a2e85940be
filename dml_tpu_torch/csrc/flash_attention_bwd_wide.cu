// Flash attention backward in bf16 past head dim 256: the Hopper
// counterpart of the TPU kernels dml_tpu/ops/flash_attention.py::
// _bwd_dq_kernel and ::_bwd_dkv_kernel (K3) for bf16 q, k, v with d > 256
// (the absorbed latent row of multi-head latent attention, D 576; the
// wide-head LM, D 512; D 1024; an odd D through the wrapper's zero-padded
// copy). The arguments, the row arrays (lse and delta' = rowsum(dO * O) -
// g_lse, [B, H, Tp], from flash_attention_bwd.cu's delta kernel), the
// arithmetic and the no-atomics rule are flash_attention_bwd.cu's:
//   S = Q K^T scale, masked (keys at Tk and beyond; past the row if
//   causal); P = exp(S - lse); dP = dO V^T; dS = P (dP - delta') scale;
//   dQ = dS K with dS in K's dtype; dV = P^T dO with P in dO's dtype, dK =
//   dS^T Q with dS in Q's dtype, summed over q-tiles and the group's heads.
//
// What bounds it: no block holds a row of d (dK and dV for 64 keys at 576
// columns would be 576 float32 registers a thread), so each block owns a
// chunk of CHUNK_SUBS x 64 = 256 gradient columns and reduces S and dP over
// all of d: S and dP are computed ceil(d / 256) times a tile pair, the
// products' own operations (dq 3, dkv 4 of 2 Tq Tk d each) come to
// (2 ceil(d / 256) + 1) and (2 ceil(d / 256) + 2) of them. Every operand
// row of S and dP passes through shared memory once a tile pair (no block
// can keep its own rows there either: 64 rows of Q and dO at d 576 are
// 147 KB), so at d 576 the kernels move ~32 bytes from L2 a 64 x 64 x 64
// product pair, ~32 operations a byte: L2's rate, not the tensor cores',
// bounds them once the card is full (at MLA's D 576 the two streams came
// to about 8 and 7 TB/s from L2 on an NVIDIA H100 80GB HBM3 at 700 W).
//
// Each block is one TMA producer warpgroup and two consumer warpgroups
// (setmaxnreg 40 / 232) over 64 "own" rows (queries in dq, keys in dkv):
// - the producer streams, for each of the block's items (a k-tile in dq, a
//   query head's q-tile in dkv), the 64-column sub-tiles of the four
//   operands of S and dP (Q, dO, K, V) through a ring of stages in shared
//   memory (5 in dq, 4 in dkv: the bytes in flight from L2 bound the rate
//   here, and dkv's 2 stages of a double-buffered chunk ran 27-33% slower
//   at D 576-2048), then the item's chunk operands (K's 256 columns in dq;
//   Q's and dO's, with their lse and delta' rows, in dkv) into one buffer,
//   once the consumers are past the last item's. Tensor maps {d, heads,
//   T, B} over the tensors' strides, boxes of 64 x 64, 128-byte swizzle;
//   rows past T and columns past d arrive as zeros (GQA reads kv head h /
//   G, no repeat).
// - consumer 0 computes S (dkv: S^T = K Q^T) and consumer 1 dP (dP^T = V
//   dO^T), m64n64 wgmma on both operands in shared memory, chained over
//   d's sub-tiles: each operand is read once a tile pair. Consumer 0 turns
//   S into P and hands it, in float32, to consumer 1 through shared
//   memory, each thread's own accumulator slots (both consumers hold the
//   same layout); consumer 1 forms dS and hands it back as bf16. Each
//   consumer then owns 128 of the block's 256 gradient columns: dQ += dS K
//   (dq) or dV += P^T dO and dK += dS^T Q (dkv) as wgmma with P and dS
//   from registers and K (Q, dO) read MN-major as TMA left it: dQ is 64
//   registers a thread, dK and dV 128.
// - Filling the card: a block is (tile, column chunk, head, batch), and
//   where that grid is small (MLA's 16 k-tiles x 3 chunks on one kv head:
//   48 dkv blocks; the wide LM's 32 dq blocks) the items of a block are
//   split over the CS blocks of a thread-block cluster (CS = 2, 4 or 8,
//   hopper.cuh::cluster_size): rank r takes the items r, r + CS, ... (dq: its
//   k-tiles; dkv: the (query head, q-tile) pairs of the kv head). The
//   ranks' sums meet through distributed shared memory: each rank owns
//   1/CS of every thread's accumulator slots, every rank writes its slots
//   into their owner's shared memory, and the owner adds the CS partials in
//   rank order. No atomics: every gradient element is summed by one block
//   in one fixed order, so two backwards are bit-equal.
// Gradients go out from registers (bf16 pairs; rows past T and columns
// past d not written), so an odd d needs no store map.
//
// The tensor cores' own sums truncate (the float32 kernels add their long
// sums step by step for it, hopper.cuh::product_cb_rn); here the chains
// are S and dP over d (d / 16 k-steps) and dK, dV over a rank's items,
// against the bf16 bar of 1e-2 of the largest gradient, which chip_smoke.py
// holds every case to.
//
// Plain C interface for ctypes (dml_flash_bwd_wide, the arguments of
// dml_flash_bwd); launches on the caller's stream and returns
// cudaGetLastError() (or 10000 + the CUresult of cuTensorMapEncodeTiled).

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int NC = 2;                       // consumer warpgroups
constexpr int WG_THREADS = 128 * (NC + 1);  // + the producer warpgroup
// registers after setmaxnreg: 128 * 40 + 256 * 232 <= 65536
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int ROWS = 64;                // a block's own rows, and an item's: one wgmma M
constexpr int SUB = ROWS * ROW_BYTES;   // one 64 x 64 sub-tile: 8 KB
constexpr int STAGE = 4 * SUB;          // a ring stage: one sub-tile of each operand of S and dP
constexpr int CHUNK_SUBS = 4;           // gradient sub-tiles a block owns (256 columns), 2 a consumer

// Shared memory, in bytes from the 1024-aligned base: the ring, one chunk
// buffer (loaded after its item's stream, so that the ring's stages, the
// bytes in flight from L2, are as many as fit), the lse and delta' rows
// of a q-tile (dkv), P and dS. The reduction over a cluster reuses the
// start once every rank is past its items.
template <int STAGES, int CHUNK_BYTES, int ROW_ARRAYS>
struct Smem {
  static constexpr int RING = 0;                                 // + stage * STAGE
  static constexpr int CHUNK = RING + STAGES * STAGE;
  static constexpr int ROWSB = CHUNK + CHUNK_BYTES;              // lse, then delta' rows
  static constexpr int XP = ROWSB + (ROW_ARRAYS ? 2 * ROWS * 4 : 0);  // P, float32: 32 a thread
  static constexpr int XS = XP + 32 * 128 * 4;                   // dS, bf16 pairs: 16 a thread
  static constexpr int BAR = XS + 16 * 128 * 4;  // mbarriers: full[S], empty[S], cfull, cempty
  static constexpr int bytes = BAR + 8 * (2 * STAGES + 2) + 1024;  // + slack for the alignment
};
// dq: 5 stages and K's chunk (4 sub-tiles); dkv: 4 stages and Q's and dO's
// chunks (8 sub-tiles) with their rows
using DqSmem = Smem<5, CHUNK_SUBS * SUB, 0>;
using DkvSmem = Smem<4, 2 * CHUNK_SUBS * SUB, 1>;
static_assert(DqSmem::bytes <= SMEM_PER_BLOCK, "the chunked dq block passes 227 KB");
static_assert(DkvSmem::bytes <= SMEM_PER_BLOCK, "the chunked dkv block passes 227 KB");
// the reduction's partials: every consumer thread's slots from each rank
static_assert(NC * 64 * 128 * 4 <= DqSmem::XP && NC * 128 * 128 * 4 <= DkvSmem::XP,
              "a cluster's partials past the free shared memory");

struct Params {
  const float* lse;    // [B, H, Tp], natural units, +1e30 past Tq
  const float* delta;  // [B, H, Tp], 0 past Tq
  void* out0;          // dq (dq kernel), dk (dkv kernel): contiguous [B, T, heads, d]
  void* out1;          // dv (dkv kernel)
  int H, G, KV, Tq, Tk, Tp, d;
  int nsub;     // 64-column sub-tiles of d
  int n_cc;     // column chunks of CHUNK_SUBS sub-tiles
  int n_tiles;  // the own rows' tiles: q-tiles (dq), k-tiles (dkv)
  float scale, scale_log2;
  int causal;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void bar_consumers(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

// acc += A B with A = 64 x 64 bf16 from registers (the k16 steps of an
// m64n64 accumulator, pack_a's order) and B one 64 x 64 sub-tile read
// MN-major (the sequence axis K, 16 rows a step); no commit.
__device__ __forceinline__ void issue_rs(float* acc, const uint32_t (*a)[4], uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs_m64n64_tb(acc, a[kk], mnmajor_desc(b + kk * 16 * ROW_BYTES));
}

// One gradient pair of columns (c, c + 1) of row `row` of a contiguous
// [B, T, heads, d] bf16 output; nothing past T or d.
__device__ __forceinline__ void store_out(void* out, int b, int row, int head, int col, float lo, float hi,
                                          int T, int heads, int d) {
  if (row >= T) return;
  bf16* p = static_cast<bf16*>(out) + (((long long)b * T + row) * heads + head) * d;
  store_pair(p, col, d, lo, hi);
}

// The block's gradients out of the consumers' accumulators: NT tensors
// (dQ; dK then dV) of two 64-column sub-tiles each, slot e of a thread =
// tensor e / 64, sub-tile (e / 32) % 2, register e % 32 (rows 16 warp + g
// + 8 (e >> 1 & 1), columns 8 (e % 32 / 4) + 2t + (e & 1) of sub-tile
// sub0 + its index). With CS > 1 the cluster's ranks first sum their
// partials: rank r owns the slots [r E, r E + E), E = 64 NT / CS, of every
// consumer thread; each rank writes each slot into its owner's shared
// memory (16 bytes at a time), and the owner adds the CS partials in rank
// order 0, 1, ... and stores them.
template <int NT, int CS>
__device__ __forceinline__ void finish(float (*acc)[2][32], unsigned char* smem, uint32_t base, int rank, int c,
                                       int tw, int own, int sub0, int row0, void* const* outs, int b, int head,
                                       int T, int heads, int d) {
  const int warp = tw / 32, lane = tw % 32, g = lane >> 2, t = lane & 3;
  const int row = row0 + 16 * warp + g;
  if constexpr (CS == 1) {
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        if (s >= own) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            store_out(outs[n], b, row + 8 * r, head, 64 * (sub0 + s) + 8 * j + 2 * t, acc[n][s][4 * j + 2 * r],
                      acc[n][s][4 * j + 2 * r + 1], T, heads, d);
      }
  } else {
    constexpr int E = 64 * NT / CS;  // slots a rank owns, a multiple of 4
    static_assert(E % 4 == 0, "a rank's slots are whole 16-byte stores");
    cluster_sync();  // every rank is past its items: its shared memory is free
    uint32_t dst[CS];
#pragma unroll
    for (int o = 0; o < CS; ++o) dst[o] = map_shared_rank(base, o);
    // partial of rank `rank`, consumer c, slots [4 k4, 4 k4 + 4) of the
    // owner's E, thread tw: float4 ((rank NC + c) (E / 4) + k4) 128 + tw
#pragma unroll
    for (int e = 0; e < 64 * NT; e += 4) {
      const int n = e / 64, s = (e / 32) % 2, r = e % 32, o = e / E, k4 = (e % E) / 4;
      st_cluster_v4(dst[o] + ((((rank * NC + c) * (E / 4) + k4) * 128 + tw) << 4), acc[n][s][r], acc[n][s][r + 1],
                    acc[n][s][r + 2], acc[n][s][r + 3]);
    }
    cluster_sync();
    const float4* part = reinterpret_cast<const float4*>(smem);
    for (int k4 = 0; k4 < E / 4; ++k4) {
      float4 sum = part[(c * (E / 4) + k4) * 128 + tw];
#pragma unroll
      for (int s = 1; s < CS; ++s) {
        const float4 p = part[((s * NC + c) * (E / 4) + k4) * 128 + tw];
        sum.x += p.x, sum.y += p.y, sum.z += p.z, sum.w += p.w;
      }
      const int e = rank * E + 4 * k4;  // slots e .. e + 3: rows g and g + 8, columns 2t, 2t + 1
      const int n = e / 64, s = (e / 32) % 2, j = (e % 32) / 4;
      if (s >= own) continue;
      const int col = 64 * (sub0 + s) + 8 * j + 2 * t;
      store_out(outs[n], b, row, head, col, sum.x, sum.y, T, heads, d);
      store_out(outs[n], b, row + 8, head, col, sum.z, sum.w, T, heads, d);
    }
  }
}

// dq: a block is 64 query rows x one chunk of 256 dQ columns of one head;
// its items are the k-tiles (to the diagonal if causal), rank r of a
// cluster of CS taking r, r + CS, ...; the last q-tiles (the longest
// causal walks) first. Stage: Q, dO, K, V sub-tiles j; chunk: K's.
template <int CS>
__global__ void __launch_bounds__(WG_THREADS, 1)
    flash_bwd_dq_wgmma_wide_kernel(const __grid_constant__ CUtensorMap tm_q,
                                   const __grid_constant__ CUtensorMap tm_do,
                                   const __grid_constant__ CUtensorMap tm_k,
                                   const __grid_constant__ CUtensorMap tm_v, const Params a) {
  using L = DqSmem;
  constexpr int STAGES = 5;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzled tiles need 1024-B alignment
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bar_full = base + L::BAR, bar_empty = bar_full + 8 * STAGES;
  const uint32_t bar_cfull = bar_empty + 8 * STAGES, bar_cempty = bar_cfull + 8;

  const int rank = CS > 1 ? (int)cluster_ctarank() : 0;
  const int bx = blockIdx.x / CS;
  const int cc = bx % a.n_cc, h = bx / a.n_cc, b = blockIdx.y;
  const int q0 = (a.n_tiles - 1 - blockIdx.z) * ROWS;
  const int kvh = h / a.G;
  int n_kt = (a.Tk + ROWS - 1) / ROWS;
  if (a.causal) n_kt = min(n_kt, q0 / ROWS + 1);  // past the diagonal: never
  const int n_items = n_kt > rank ? (n_kt - 1 - rank) / CS + 1 : 0;
  const int cs0 = cc * CHUNK_SUBS, csubs = min(CHUNK_SUBS, a.nsub - cs0);

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, NC * 128);  // every consumer thread releases a stage
    }
    mbar_init(bar_cfull, 1);
    mbar_init(bar_cempty, NC * 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (tid == 0) {
      int i = 0;
      for (int n = 0; n < n_items; ++n) {
        const int k0 = (rank + n * CS) * ROWS;
        for (int j = 0; j < a.nsub; ++j, ++i) {
          const int st = i % STAGES;
          if (i >= STAGES) mbar_wait(bar_empty + 8 * st, ((i / STAGES) - 1) & 1);
          const uint32_t stage = base + L::RING + st * STAGE, full = bar_full + 8 * st;
          mbar_expect_tx(full, STAGE);
          tma_load(stage, &tm_q, full, 64 * j, h, q0, b);
          tma_load(stage + SUB, &tm_do, full, 64 * j, h, q0, b);
          tma_load(stage + 2 * SUB, &tm_k, full, 64 * j, kvh, k0, b);
          tma_load(stage + 3 * SUB, &tm_v, full, 64 * j, kvh, k0, b);
        }
        // the item's chunk, once the consumers are done with the last one's
        if (n >= 1) mbar_wait(bar_cempty, (n - 1) & 1);
        mbar_expect_tx(bar_cfull, csubs * SUB);
        for (int s = 0; s < csubs; ++s)
          tma_load(base + L::CHUNK + s * SUB, &tm_k, bar_cfull, 64 * (cs0 + s), kvh, k0, b);
      }
    }
    return;
  }
  // -------------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int c = tid / 128 - 1;  // 0: S and P; 1: dP and dS. Each: dQ columns [128c, 128c + 128) of the chunk
  const int tw = tid % 128, warp = tw / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  const int row0 = q0 + 16 * warp + g;  // this thread's rows: row0, row0 + 8
  const int own = max(0, min(2, csubs - 2 * c));  // the chunk's sub-tiles this consumer owns
  const long long rbase = ((long long)b * a.H + h) * a.Tp;
  float neg_lse[2], delta[2];  // rows past Tq read the arrays' pad rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    neg_lse[r] = -a.lse[rbase + row0 + 8 * r] * LOG2E;
    delta[r] = a.delta[rbase + row0 + 8 * r];
  }
  float2* pf = reinterpret_cast<float2*>(smem + L::XP);   // P, slot pair r of thread tw at r * 128 + tw
  uint32_t* xs = reinterpret_cast<uint32_t*>(smem + L::XS);  // dS as bf16 pairs, likewise
  float acc[1][2][32];
  float x[32];
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int r = 0; r < 32; ++r) acc[0][s][r] = 0.f;
#pragma unroll
  for (int r = 0; r < 32; ++r) x[r] = 0.f;

  int i = 0;
  for (int n = 0; n < n_items; ++n) {
    const int k0 = (rank + n * CS) * ROWS;
    reduce_over_d<STAGES, STAGE>(x, base + L::RING, bar_full, bar_empty, c * SUB, (2 + c) * SUB, a.nsub, i);
    uint32_t da[4][4];
    if (c == 0) {
      // P = exp2(S scale log2(e) - lse log2(e)); masked only where a key of
      // the tile passes a row, or past Tk
      const bool masked = (a.causal && k0 + ROWS - 1 > q0) || k0 + ROWS > a.Tk;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + 2 * t + (e & 1);
          float s = x[4 * j + e];
          if (masked && (key >= a.Tk || (a.causal && key > row0 + 8 * (e >> 1)))) s = -INFINITY;
          x[4 * j + e] = ex2(fmaf(s, a.scale_log2, neg_lse[e >> 1]));
        }
#pragma unroll
      for (int r = 0; r < 16; ++r) pf[r * 128 + tw] = make_float2(x[2 * r], x[2 * r + 1]);
      bar_consumers(1);  // P is in
      bar_consumers(2);  // dS is in
#pragma unroll
      for (int r = 0; r < 16; ++r) da[r / 4][r % 4] = xs[r * 128 + tw];
    } else {
      bar_consumers(1);
      // dS = P (dP - delta') scale, rounded to bf16 as the A registers of dS K
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const float2 p = pf[r * 128 + tw];
        const float dl = delta[r & 1];
        da[r / 4][r % 4] = pack_bf16(p.x * (x[2 * r] - dl) * a.scale, p.y * (x[2 * r + 1] - dl) * a.scale);
        xs[r * 128 + tw] = da[r / 4][r % 4];
      }
      bar_consumers(2);
    }
    // dQ += dS K over this consumer's sub-tiles of the chunk
    mbar_wait(bar_cfull, n & 1);
    if (own > 0) {
      const uint32_t kc = base + L::CHUNK + 2 * c * SUB;
      fence_regs<32>(acc[0][0]);
      fence_regs<32>(acc[0][1]);
      wgmma_fence();
      issue_rs(acc[0][0], da, kc);
      if (own > 1) issue_rs(acc[0][1], da, kc + SUB);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<32>(acc[0][0]);
      fence_regs<32>(acc[0][1]);
    }
    mbar_arrive(bar_cempty);
  }
  void* const outs[1] = {a.out0};
  finish<1, CS>(acc, smem, base, rank, c, tw, own, cs0 + 2 * c, q0, outs, b, h, a.Tq, a.H, a.d);
}

// dkv: a block is 64 keys x one chunk of 256 dK and dV columns of one kv
// head; its items are the (query head, q-tile) pairs of the kv head's
// group (q-tiles from the diagonal if causal), item m = gi nq + the q-tile's
// offset, rank r of a cluster of CS taking m = r, r + CS, ...; the first
// k-tiles (the longest causal walks) first. Stage: K, V, Q, dO sub-tiles j;
// chunk: Q's and dO's, then the lse and delta' rows of the q-tile.
template <int CS>
__global__ void __launch_bounds__(WG_THREADS, 1)
    flash_bwd_dkv_wgmma_wide_kernel(const __grid_constant__ CUtensorMap tm_q,
                                    const __grid_constant__ CUtensorMap tm_do,
                                    const __grid_constant__ CUtensorMap tm_k,
                                    const __grid_constant__ CUtensorMap tm_v, const Params a) {
  using L = DkvSmem;
  constexpr int STAGES = 4, QC = CHUNK_SUBS * SUB;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bar_full = base + L::BAR, bar_empty = bar_full + 8 * STAGES;
  const uint32_t bar_cfull = bar_empty + 8 * STAGES, bar_cempty = bar_cfull + 8;

  const int rank = CS > 1 ? (int)cluster_ctarank() : 0;
  const int bx = blockIdx.x / CS;
  const int cc = bx % a.n_cc, kvh = bx / a.n_cc, b = blockIdx.y;
  const int k0 = blockIdx.z * ROWS;
  const int n_qt = (a.Tq + ROWS - 1) / ROWS;
  const int qt0 = a.causal ? k0 / ROWS : 0;  // q-tiles wholly above the diagonal see none of these keys
  const int nq = n_qt - qt0;
  const int total = a.G * nq;
  const int n_items = total > rank ? (total - 1 - rank) / CS + 1 : 0;
  const int cs0 = cc * CHUNK_SUBS, csubs = min(CHUNK_SUBS, a.nsub - cs0);

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, NC * 128);
    }
    mbar_init(bar_cfull, 1);
    mbar_init(bar_cempty, NC * 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (tid == 0) {
      int i = 0;
      for (int n = 0; n < n_items; ++n) {
        const int m = rank + n * CS;
        const int h = kvh * a.G + m / nq, q0 = (qt0 + m % nq) * ROWS;
        for (int j = 0; j < a.nsub; ++j, ++i) {
          const int st = i % STAGES;
          if (i >= STAGES) mbar_wait(bar_empty + 8 * st, ((i / STAGES) - 1) & 1);
          const uint32_t stage = base + L::RING + st * STAGE, full = bar_full + 8 * st;
          mbar_expect_tx(full, STAGE);
          tma_load(stage, &tm_k, full, 64 * j, kvh, k0, b);
          tma_load(stage + SUB, &tm_v, full, 64 * j, kvh, k0, b);
          tma_load(stage + 2 * SUB, &tm_q, full, 64 * j, h, q0, b);
          tma_load(stage + 3 * SUB, &tm_do, full, 64 * j, h, q0, b);
        }
        // the item's chunk and rows, once the consumers are done with the last one's
        if (n >= 1) mbar_wait(bar_cempty, (n - 1) & 1);
        const uint32_t chunk = base + L::CHUNK;
        mbar_expect_tx(bar_cfull, 2 * csubs * SUB + 2 * ROWS * 4);
        for (int s = 0; s < csubs; ++s) {
          tma_load(chunk + s * SUB, &tm_q, bar_cfull, 64 * (cs0 + s), h, q0, b);
          tma_load(chunk + QC + s * SUB, &tm_do, bar_cfull, 64 * (cs0 + s), h, q0, b);
        }
        const long long rbase = ((long long)b * a.H + h) * a.Tp;
        bulk_load(base + L::ROWSB, a.lse + rbase + q0, ROWS * 4, bar_cfull);
        bulk_load(base + L::ROWSB + ROWS * 4, a.delta + rbase + q0, ROWS * 4, bar_cfull);
      }
    }
    return;
  }
  // -------------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  // 0: S^T and P^T; 1: dP^T and dS^T. Each: dK and dV columns [128c, 128c + 128) of the chunk
  const int c = tid / 128 - 1;
  const int tw = tid % 128, warp = tw / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  const int key0 = k0 + 16 * warp + g;  // this thread's keys: key0, key0 + 8
  const int own = max(0, min(2, csubs - 2 * c));
  float2* pf = reinterpret_cast<float2*>(smem + L::XP);
  uint32_t* xs = reinterpret_cast<uint32_t*>(smem + L::XS);
  float acc[2][2][32];  // dK, dV: one m64n64 accumulator a sub-tile
  float x[32];          // S^T, then P^T (consumer 0); dP^T, then dS^T (consumer 1): keys x queries
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int r = 0; r < 32; ++r) acc[n][s][r] = 0.f;
#pragma unroll
  for (int r = 0; r < 32; ++r) x[r] = 0.f;

  int i = 0;
  for (int n = 0; n < n_items; ++n) {
    const int m = rank + n * CS;
    const int q0 = (qt0 + m % nq) * ROWS;
    reduce_over_d<STAGES, STAGE>(x, base + L::RING, bar_full, bar_empty, c * SUB, (2 + c) * SUB, a.nsub, i);
    mbar_wait(bar_cfull, n & 1);
    const float* rows = reinterpret_cast<const float*>(smem + L::ROWSB);
    const uint32_t qc = base + L::CHUNK + 2 * c * SUB, dc = qc + QC;
    uint32_t pa[4][4], da[4][4];
    if (c == 0) {
      // P^T: each thread's columns are the queries 8j + 2t and 8j + 2t + 1
      const bool masked = a.causal && q0 < k0 + ROWS - 1;  // some key of the block past a query
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(rows + 8 * j + 2 * t);
        const float nl[2] = {-l2.x * LOG2E, -l2.y * LOG2E};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float s = x[4 * j + e];
          if (masked && key0 + 8 * (e >> 1) > q0 + 8 * j + 2 * t + (e & 1)) s = -INFINITY;
          x[4 * j + e] = ex2(fmaf(s, a.scale_log2, nl[e & 1]));
        }
      }
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        pf[r * 128 + tw] = make_float2(x[2 * r], x[2 * r + 1]);
        pa[r / 4][r % 4] = pack_bf16(x[2 * r], x[2 * r + 1]);  // P^T in dO's dtype
      }
      bar_consumers(1);  // P^T is in
      // dV += P^T dO while consumer 1 forms dS^T
      fence_regs<32>(acc[1][0]);
      fence_regs<32>(acc[1][1]);
      wgmma_fence();
      if (own > 0) issue_rs(acc[1][0], pa, dc);
      if (own > 1) issue_rs(acc[1][1], pa, dc + SUB);
      bar_consumers(2);  // dS^T is in
#pragma unroll
      for (int r = 0; r < 16; ++r) da[r / 4][r % 4] = xs[r * 128 + tw];
    } else {
      bar_consumers(1);
      // dS^T = P^T (dP^T - delta') scale, in Q's dtype; P^T in dO's
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const float2 p = pf[r * 128 + tw];
        const float2 d2 = *reinterpret_cast<const float2*>(rows + ROWS + 8 * (r / 2) + 2 * t);
        pa[r / 4][r % 4] = pack_bf16(p.x, p.y);
        da[r / 4][r % 4] = pack_bf16(p.x * (x[2 * r] - d2.x) * a.scale, p.y * (x[2 * r + 1] - d2.y) * a.scale);
        xs[r * 128 + tw] = da[r / 4][r % 4];
      }
      bar_consumers(2);
      fence_regs<32>(acc[1][0]);
      fence_regs<32>(acc[1][1]);
      wgmma_fence();
      if (own > 0) issue_rs(acc[1][0], pa, dc);
      if (own > 1) issue_rs(acc[1][1], pa, dc + SUB);
    }
    // dK += dS^T Q over this consumer's sub-tiles of the chunk
    fence_regs<32>(acc[0][0]);
    fence_regs<32>(acc[0][1]);
    wgmma_fence();
    if (own > 0) issue_rs(acc[0][0], da, qc);
    if (own > 1) issue_rs(acc[0][1], da, qc + SUB);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int nn = 0; nn < 2; ++nn) {
      fence_regs<32>(acc[nn][0]);
      fence_regs<32>(acc[nn][1]);
    }
    mbar_arrive(bar_cempty);
  }
  void* const outs[2] = {a.out0, a.out1};
  finish<2, CS>(acc, smem, base, rank, c, tw, own, cs0 + 2 * c, k0, outs, b, kvh, a.Tk, a.KV, a.d);
}

}  // namespace

// bf16 dq, dk and dv past head dim 256 given the row arrays of
// dml_flash_bwd_rows (the arguments of dml_flash_bwd; D is the head dim
// d). parts: 1 = the dq kernel, 2 = the dkv kernel, 3 = both.
// cudaErrorInvalidValue for float32 and at D <= 256.
extern "C" int dml_flash_bwd_wide(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse_r, const void* delta_r,
                                  void* dq, void* dk, void* dv,
                                  int is_bf16, int B, int H, int KV, int Tq, int Tk, int Tp, int D,
                                  long long qsb, long long qst, long long qsh,
                                  long long ksb, long long kst, long long ksh,
                                  long long vsb, long long vst, long long vsh,
                                  long long dsb, long long dst, long long dsh,
                                  float scale, int causal, int parts, void* stream) {
  if (!is_bf16 || D <= WIDEST_NATIVE) return (int)cudaErrorInvalidValue;
  if (B <= 0 || Tq <= 0 || Tk <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nsub = (D + 63) / 64, n_cc = (nsub + CHUNK_SUBS - 1) / CHUNK_SUBS;
  const int n_qt = (Tq + ROWS - 1) / ROWS, n_kt = (Tk + ROWS - 1) / ROWS, G = H / KV;
  Params p{static_cast<const float*>(lse_r), static_cast<const float*>(delta_r), nullptr, nullptr,
           H, G, KV, Tq, Tk, Tp, D, nsub, n_cc, 0, scale, scale * LOG2E, causal};
  // every map's innermost extent is D: a box's columns past it arrive as
  // zeros (and count toward the expected bytes)
  int err;
  CUtensorMap tq, tdo, tk, tv;
  if ((err = encode_map(&tq, q, D, H, Tq, B, qsh, qst, qsb, ROWS))) return err;
  if ((err = encode_map(&tdo, dout, D, H, Tq, B, dsh, dst, dsb, ROWS))) return err;
  if ((err = encode_map(&tk, k, D, KV, Tk, B, ksh, kst, ksb, ROWS))) return err;
  if ((err = encode_map(&tv, v, D, KV, Tk, B, vsh, vst, vsb, ROWS))) return err;
  if (parts & 1) {
    const int cs = cluster_size((long long)n_qt * n_cc * H * B, n_kt);
    Params pq = p;
    pq.out0 = dq;
    pq.n_tiles = n_qt;
    const dim3 grid(cs * n_cc * H, B, n_qt);
    switch (cs) {
      case 1: err = launch_cluster(flash_bwd_dq_wgmma_wide_kernel<1>, 1, grid, WG_THREADS, DqSmem::bytes, s, tq, tdo, tk, tv, pq); break;
      case 2: err = launch_cluster(flash_bwd_dq_wgmma_wide_kernel<2>, 2, grid, WG_THREADS, DqSmem::bytes, s, tq, tdo, tk, tv, pq); break;
      case 4: err = launch_cluster(flash_bwd_dq_wgmma_wide_kernel<4>, 4, grid, WG_THREADS, DqSmem::bytes, s, tq, tdo, tk, tv, pq); break;
      default: err = launch_cluster(flash_bwd_dq_wgmma_wide_kernel<8>, 8, grid, WG_THREADS, DqSmem::bytes, s, tq, tdo, tk, tv, pq);
    }
    if (err) return err;
  }
  if (parts & 2) {
    const int cs = cluster_size((long long)n_kt * n_cc * KV * B, G * n_qt);
    Params pk = p;
    pk.out0 = dk;
    pk.out1 = dv;
    pk.n_tiles = n_kt;
    const dim3 grid(cs * n_cc * KV, B, n_kt);
    switch (cs) {
      case 1: err = launch_cluster(flash_bwd_dkv_wgmma_wide_kernel<1>, 1, grid, WG_THREADS, DkvSmem::bytes, s, tq, tdo, tk, tv, pk); break;
      case 2: err = launch_cluster(flash_bwd_dkv_wgmma_wide_kernel<2>, 2, grid, WG_THREADS, DkvSmem::bytes, s, tq, tdo, tk, tv, pk); break;
      case 4: err = launch_cluster(flash_bwd_dkv_wgmma_wide_kernel<4>, 4, grid, WG_THREADS, DkvSmem::bytes, s, tq, tdo, tk, tv, pk); break;
      default: err = launch_cluster(flash_bwd_dkv_wgmma_wide_kernel<8>, 8, grid, WG_THREADS, DkvSmem::bytes, s, tq, tdo, tk, tv, pk);
    }
    if (err) return err;
  }
  return 0;
}
