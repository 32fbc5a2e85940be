// Flash attention backward in float32: the Hopper counterpart of the TPU
// kernels dml_tpu/ops/flash_attention.py::_bwd_dq_kernel and
// ::_bwd_dkv_kernel (K3) for float32 q, k, v, at every head dim, on the
// tensor cores in split TF32. The arguments, the arithmetic, the row
// arrays and the no-atomics rule are flash_attention_bwd.cu's (which also
// holds the delta kernel that fills the row arrays, and the bf16
// kernels); this source is its own library so that nvcc builds it in
// parallel with that one.
//
// - d <= 256: flash_bwd_dq_tf32_kernel<D> and flash_bwd_dkv_tf32_kernel<D>
//   at the native width D >= d (hopper.cuh::native_head_dim), the
//   mma.sync pair's plan with every product in split TF32 (hopper.cuh:
//   three m16n8k8 TF32 products a float32 one, held to the JAX package's
//   float32 bars): 64-row blocks of 4 warps, the streamed tiles (K and V;
//   Q, dO and their row arrays) in two stages by cp.async, dS, P^T and
//   dS^T taken straight from the accumulators as A fragments (columns in
//   the order 0, 2, 4, 6, 1, 3, 5, 7, the B operand's rows read in the
//   same order), so no tile is transposed. One dkv block a (k-tile, kv
//   head) walks the group's query heads, as in bf16; training repeats k
//   and v to every query head (models/transformer.py), so its G is 1.
// - d > 256: flash_bwd_dq_tf32_wide_kernel and
//   flash_bwd_dkv_tf32_wide_kernel, the bf16 chunked pair's plan (128
//   gradient columns a block, S and dP over all of d in slices) in split
//   TF32, each slice's S and dP added in float32 (hopper.cuh::slice_product).
//
// dQ, dK and dV are long sums (over k-tiles; over the group's heads and
// q-tiles), and the tensor cores' own sums truncate, an error that grows
// along a chain into one accumulator (4 heads x 1000 queries a kv head
// passed the float32 bar): each column tile's products of a step are summed
// from zero and added in float32 (hopper.cuh::product_cb_rn). Where the
// 128-column accumulators leave no registers for that (dkv at D 256, the
// chunked pair) one of them lives in shared memory, each thread's own
// slots (product_cb_rn_shared).
//
// Bound: the split's three products at 495 TFLOP/s (165 TFLOP/s of float32
// work; the published dense rates of an NVIDIA H100 80GB HBM3 at 700.00
// W). The splits of the B fragments that every warp reads (two integer
// operations and a subtraction an element, hopper.cuh) share the warps'
// issue slots with the mma.sync; S^T and dP^T are recomputed in the dkv
// kernel (7 products against the backward's 5). There: ShardLM's K3 (dq,
// dkv and the delta kernel) as trained, [2,512,4,96] with k and v
// repeated, 0.2284 ms, 3.7% of the split's bound, 1.34x SDPA; at its
// GQA-2 prefill shape 0.2302 ms against 0.8221 ms on the FMA kernels this
// replaced (PERF.md §6).
//
// Plain C interface for ctypes (dml_flash_bwd_tf32, the arguments of
// dml_flash_bwd); launches on the caller's stream and returns
// cudaGetLastError().

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "flash_bwd_common.cuh"

namespace {

// ------------------------------------------------------------ d <= 256
//
// S and dP stay in registers; every product reads the row-major tiles,
// rows of D + 4 floats. At D 256 the gradient columns are split over two
// blocks (grad_cols, as in bf16), there is one stage (Q and dO, or K and
// V, at D 256 are 133 KB), the dq kernel streams 32-key tiles and the dkv
// kernel 16-query tiles with dV's sums in shared memory (in registers
// beside dK's, S^T's and dP^T's, ptxas spilled them).

// dq: the block's 64 query rows of Q and dO, k-tiles of BN keys of K and V.
template <int D>
struct Tf32DqLayout {
  static constexpr int BN = D > 128 ? 32 : 64;
  static constexpr int STAGES = D > 128 ? 1 : 2;
  static constexpr int LD = D + 4;
  static constexpr size_t bytes = sizeof(float) * (size_t)(2 * BQ + STAGES * 2 * BN) * LD;
};
// dkv: the block's 64 keys of K and V, q-tiles of BN queries of Q and dO
// with their lse and delta' rows; 32-query tiles at D 128 keep S^T and
// dP^T at 16 registers each beside dK's and dV's 128; at D 256 dV's sums
// (this thread's DO / 2 floats) after the stage.
template <int D>
struct Tf32DkvLayout {
  static constexpr int BN = D > 128 ? 16 : D == 128 ? 32 : 64;
  static constexpr int STAGES = D > 128 ? 1 : 2;
  static constexpr int LD = D + 4;
  static constexpr int STAGE = 2 * BN * LD + 2 * BN;  // Q, dO, lse, delta'
  static constexpr bool DV_SHARED = D > 128;
  static constexpr size_t bytes =
      sizeof(float) * ((size_t)(2 * BK * LD + STAGES * STAGE) + (DV_SHARED ? THREADS * grad_cols<D>() / 2 : 0));
};
static_assert(Tf32DqLayout<256>::bytes <= hopper::SMEM_PER_BLOCK && Tf32DqLayout<128>::bytes <= hopper::SMEM_PER_BLOCK &&
                  Tf32DkvLayout<256>::bytes <= hopper::SMEM_PER_BLOCK &&
                  Tf32DkvLayout<128>::bytes <= hopper::SMEM_PER_BLOCK,
              "a float32 backward block passes 227 KB");

// This thread's W / 2 sums from shared memory (hopper.cuh::product_cb_rn_shared).
template <int W>
__device__ __forceinline__ void load_sums(float (*acc)[4], const float4* acc_s) {
#pragma unroll
  for (int j = 0; j < W / 8; ++j) {
    const float4 v = acc_s[j * THREADS + threadIdx.x];
    acc[j][0] = v.x, acc[j][1] = v.y, acc[j][2] = v.z, acc[j][3] = v.w;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dq_tf32_kernel(Args a) {
  using L = Tf32DqLayout<D>;
  constexpr int DO = grad_cols<D>(), NS = D / DO, BN = L::BN, LD = L::LD;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* dOs = Qs + BQ * LD;
  float* stages = dOs + BQ * LD;  // stage s: K at stages + 2 s BN LD, V BN LD after it

  const int qt = blockIdx.x / NS, col0 = (blockIdx.x % NS) * DO;  // this block's dQ columns
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / a.G;
  const int q0 = qt * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const float* qp = static_cast<const float*>(a.q) + b * a.qsb + h * a.qsh;
  const float* dp_ = static_cast<const float*>(a.dout) + b * a.dsb + h * a.dsh;
  const float* kp = static_cast<const float*>(a.k) + b * a.ksb + kvh * a.ksh;
  const float* vp = static_cast<const float*>(a.v) + b * a.vsb + kvh * a.vsh;

  int n_tiles = (a.Tk + BN - 1) / BN;
  if (a.causal) n_tiles = min(n_tiles, (q0 + BQ - 1) / BN + 1);  // skip tiles above the diagonal

  hopper::load_f32_async<BQ, D, THREADS>(Qs, LD, qp, a.qst, q0, a.Tq, a.d);
  hopper::load_f32_async<BQ, D, THREADS>(dOs, LD, dp_, a.dst, q0, a.Tq, a.d);
  if (L::STAGES == 2 && n_tiles > 0) {
    hopper::load_f32_async<BN, D, THREADS>(stages, LD, kp, a.kst, 0, a.Tk, a.d);
    hopper::load_f32_async<BN, D, THREADS>(stages + BN * LD, LD, vp, a.vst, 0, a.Tk, a.d);
  }
  hopper::cp_async_commit();

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

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BN;
    const int next = L::STAGES == 2 ? kt + 1 : kt;  // the k-tile whose copy starts now
    if (next < n_tiles) {
      float* st = stages + (next & (L::STAGES - 1)) * 2 * BN * LD;
      hopper::load_f32_async<BN, D, THREADS>(st, LD, kp, a.kst, next * BN, a.Tk, a.d);
      hopper::load_f32_async<BN, D, THREADS>(st + BN * LD, LD, vp, a.vst, next * BN, a.Tk, a.d);
    }
    hopper::cp_async_commit();
    hopper::cp_async_wait<L::STAGES - 1>();
    __syncthreads();
    const float* Ks = stages + (kt & (L::STAGES - 1)) * 2 * BN * LD;
    const float* Vs = Ks + BN * LD;

    // S = Q K^T and dP = dO V^T for this warp's 16 rows x BN keys
    float s[BN / 8][4], dpv[BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      dpv[nt][0] = dpv[nt][1] = dpv[nt][2] = dpv[nt][3] = 0.f;
    }
    hopper::product_abt<D, BN>(s, Qs + 16 * warp * LD, LD, Ks, LD, g, t);
    hopper::product_abt<D, BN>(dpv, dOs + 16 * warp * LD, LD, Vs, LD, g, t);
    ds_rows<BN>(s, dpv, lse, delta, row, k0, t, a);
    hopper::product_cb_rn<DO, BN>(acc, s, Ks + col0, LD, g, t);  // dQ += dS K over this block's columns
    __syncthreads();  // every warp is done with this stage before its next copy
  }
  hopper::cp_async_wait<0>();
  store_dq<DO, float>(acc, row, col0, b, h, t, a);
}

// Step i of the float32 dkv kernel (query head kvh G + i / nq, q-tile
// qt0 + i % nq): its Q and dO rows and its lse and delta' rows into a
// stage. The row arrays are padded to Tp, a multiple of 128, so a q-tile's
// BN rows are always inside them (rows past Tq hold lse +1e30, delta' 0).
template <int D, int BN>
__device__ __forceinline__ void load_q_step(float* st, const Args& a, int b, int kvh, int i, int nq, int qt0) {
  constexpr int LD = D + 4;
  const int h = kvh * a.G + i / nq, q0 = (qt0 + i % nq) * BN;
  const float* qp = static_cast<const float*>(a.q) + b * a.qsb + h * a.qsh;
  const float* dp_ = static_cast<const float*>(a.dout) + b * a.dsb + h * a.dsh;
  hopper::load_f32_async<BN, D, THREADS>(st, LD, qp, a.qst, q0, a.Tq, a.d);
  hopper::load_f32_async<BN, D, THREADS>(st + BN * LD, LD, dp_, a.dst, q0, a.Tq, a.d);
  const long long rbase = ((long long)b * a.H + h) * a.Tp + q0;
  float* rows = st + 2 * BN * LD;
  for (int c = threadIdx.x; c < BN / 2; c += THREADS) {  // BN / 4 chunks of lse, then of delta'
    const bool is_lse = c < BN / 4;
    const int off = 4 * (is_lse ? c : c - BN / 4);
    hopper::cp_async16(rows + (is_lse ? 0 : BN) + off, (is_lse ? a.lse : a.delta) + rbase + off, true);
  }
}

// One block a (k-tile, kv head): the walk over the group's G query heads
// and their q-tiles.
template <int D>
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dkv_tf32_kernel(Args a) {
  using L = Tf32DkvLayout<D>;
  constexpr int DO = grad_cols<D>(), NS = D / DO, BN = L::BN, LD = L::LD;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + BK * LD;
  float* stages = Vs + BK * LD;  // stage s at stages + s STAGE: Q, dO (BN rows each), lse, delta'
  float4* dv_s = reinterpret_cast<float4*>(stages + L::STAGES * L::STAGE);  // L::DV_SHARED

  const int kt = blockIdx.x / NS, col0 = (blockIdx.x % NS) * DO;  // this block's dK, dV columns
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int k0 = kt * BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const float* kp = static_cast<const float*>(a.k) + b * a.ksb + kvh * a.ksh;
  const float* vp = static_cast<const float*>(a.v) + b * a.vsb + kvh * a.vsh;

  // the steps: the group's G query heads, each over its q-tiles from the
  // diagonal down (tiles wholly above it see none of these keys)
  const int n_qt = (a.Tq + BN - 1) / BN;
  const int qt0 = a.causal ? k0 / BN : 0;
  const int nq = n_qt - qt0, n_steps = a.G * nq;

  hopper::load_f32_async<BK, D, THREADS>(Ks, LD, kp, a.kst, k0, a.Tk, a.d);
  hopper::load_f32_async<BK, D, THREADS>(Vs, LD, vp, a.vst, k0, a.Tk, a.d);
  if (L::STAGES == 2 && n_steps > 0) load_q_step<D, BN>(stages, a, b, kvh, 0, nq, qt0);
  hopper::cp_async_commit();

  const int key[2] = {k0 + 16 * warp + g, k0 + 16 * warp + g + 8};
  float dk[DO / 8][4], dv[DO / 8][4];
#pragma unroll
  for (int j = 0; j < DO / 8; ++j) {
    dk[j][0] = dk[j][1] = dk[j][2] = dk[j][3] = 0.f;
    if constexpr (L::DV_SHARED) {
      dv_s[j * THREADS + threadIdx.x] = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      dv[j][0] = dv[j][1] = dv[j][2] = dv[j][3] = 0.f;
    }
  }

  for (int i = 0; i < n_steps; ++i) {
    const int q0 = (qt0 + i % nq) * BN;
    const int next = L::STAGES == 2 ? i + 1 : i;  // the step whose copy starts now
    if (next < n_steps) load_q_step<D, BN>(stages + (next & (L::STAGES - 1)) * L::STAGE, a, b, kvh, next, nq, qt0);
    hopper::cp_async_commit();
    hopper::cp_async_wait<L::STAGES - 1>();
    __syncthreads();
    const float* Qs = stages + (i & (L::STAGES - 1)) * L::STAGE;
    const float* dOs = Qs + BN * LD;
    const float* lse_s = dOs + BN * LD;
    const float* delta_s = lse_s + BN;

    // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x BN queries
    float s[BN / 8][4], dpv[BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      dpv[nt][0] = dpv[nt][1] = dpv[nt][2] = dpv[nt][3] = 0.f;
    }
    hopper::product_abt<D, BN>(s, Ks + 16 * warp * LD, LD, Qs, LD, g, t);
    hopper::product_abt<D, BN>(dpv, Vs + 16 * warp * LD, LD, dOs, LD, g, t);
    p_ds_cols<BN>(s, dpv, lse_s, delta_s, key, q0, t, a);
    if constexpr (L::DV_SHARED) {
      hopper::product_cb_rn_shared<DO, BN, THREADS>(dv_s, s, dOs + col0, LD, g, t);  // dV += P^T dO
    } else {
      hopper::product_cb_rn<DO, BN>(dv, s, dOs + col0, LD, g, t);
    }
    asm volatile("" ::: "memory");  // dK's loads after dV's products: interleaved, they spill
    hopper::product_cb_rn<DO, BN>(dk, dpv, Qs + col0, LD, g, t);  // dK += dS^T Q
    __syncthreads();  // every warp is done with this stage before its next copy
  }
  hopper::cp_async_wait<0>();
  if constexpr (L::DV_SHARED) load_sums<DO>(dv, dv_s);
  store_dkv<DO, float>(dk, dv, key, col0, kvh, b, t, a);
}

// The split-TF32 kernels at native width D: 64-row tiles, D / grad_cols
// blocks a tile. parts: 1 = the dq kernel, 2 = the dkv kernel, 3 = both
template <int D>
int launch(const Args& a, int B, int parts, cudaStream_t stream) {
  constexpr int split = D / grad_cols<D>();
  const dim3 dq_grid((a.Tq + BQ - 1) / BQ * split, a.H, B);
  const dim3 dkv_grid((a.Tk + BK - 1) / BK * split, a.KV, B);
  int err = 0;
  if (parts & 1) {
    err = launch_one(flash_bwd_dq_tf32_kernel<D>, Tf32DqLayout<D>::bytes, dq_grid, a, stream);
    if (err != 0) return err;
  }
  if (parts & 2) err = launch_one(flash_bwd_dkv_tf32_kernel<D>, Tf32DkvLayout<D>::bytes, dkv_grid, a, stream);
  return err;
}

// ------------------------------------------------- d > 256: column chunks

// Float32, d > 256: the bf16 pair's plan in split TF32 (hopper.cuh). S
// and dP (S^T and dP^T) over d in slices of TF32_SLICE columns, two
// stages, the next slice's copy in flight during a slice's products; the
// block's chunk of K (of Q and dO, with their row arrays) lands during
// them. The streamed tiles are 32 keys in dq (S and dP in 16 registers
// each; 64 keys spilled) and 16 queries in dkv (8 each beside dK's 64;
// 32 queries spilled). dQ's sums, and dV's, live in shared memory (this
// thread's CHUNK / 2 floats): in registers beside the slices' products
// ptxas spilled them.
struct Tf32WideDqLayout {
  static constexpr int BN = 32;
  static constexpr int SLICES = hopper::tf32_slice_floats<BN, 2>();
  static constexpr int LDC = CHUNK + 4;  // the block's chunk of the K tile
  static constexpr size_t bytes = sizeof(float) * (size_t)(SLICES + BN * LDC + THREADS * CHUNK / 2);
};
struct Tf32WideDkvLayout {
  static constexpr int BN = 16;
  static constexpr int SLICES = hopper::tf32_slice_floats<BN, 2>();
  static constexpr int LDC = CHUNK + 4;  // the block's chunks of the Q and dO tiles
  static constexpr size_t bytes = sizeof(float) * (size_t)(SLICES + 2 * BN * LDC + 2 * BN + THREADS * CHUNK / 2);
};
static_assert(Tf32WideDqLayout::bytes <= hopper::SMEM_PER_BLOCK && Tf32WideDkvLayout::bytes <= hopper::SMEM_PER_BLOCK,
              "one block of the chunked route at every d");

__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dq_tf32_wide_kernel(Args a) {
  using L = Tf32WideDqLayout;
  extern __shared__ __align__(128) unsigned char smem[];
  float* slices = reinterpret_cast<float*>(smem);
  float* Kc = slices + L::SLICES;
  float4* dq_s = reinterpret_cast<float4*>(Kc + L::BN * L::LDC);  // dQ's sums

  const int n_cc = (a.d + CHUNK - 1) / CHUNK;
  const int qt = blockIdx.x / n_cc, col0 = (blockIdx.x % n_cc) * CHUNK;  // this block's dQ columns
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / a.G;
  const int q0 = qt * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const float* qp = static_cast<const float*>(a.q) + b * a.qsb + h * a.qsh;
  const float* dp_ = static_cast<const float*>(a.dout) + b * a.dsb + h * a.dsh;
  const float* kp = static_cast<const float*>(a.k) + b * a.ksb + kvh * a.ksh;
  const float* vp = static_cast<const float*>(a.v) + b * a.vsb + kvh * a.vsh;

  const int row[2] = {q0 + 16 * warp + g, q0 + 16 * warp + g + 8};
  const long long rbase = ((long long)b * a.H + h) * a.Tp;
  float lse[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // rows past Tq read the arrays' pad rows
    lse[r] = a.lse[rbase + row[r]];
    delta[r] = a.delta[rbase + row[r]];
  }
#pragma unroll
  for (int j = 0; j < CHUNK / 8; ++j) dq_s[j * THREADS + threadIdx.x] = make_float4(0.f, 0.f, 0.f, 0.f);

  constexpr int BN = L::BN;
  int n_tiles = (a.Tk + BN - 1) / BN;
  if (a.causal) n_tiles = min(n_tiles, (q0 + BQ - 1) / BN + 1);  // skip tiles above the diagonal

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();  // every warp is done with the previous tile's chunk of K
    hopper::load_f32_async<BN, CHUNK, THREADS>(Kc, L::LDC, kp + col0, a.kst, k0, a.Tk, a.d - col0);
    hopper::cp_async_commit();
    float s[BN / 8][4], dpv[BN / 8][4];
    hopper::tf32_products_by_slices<BN, 2, THREADS>(s, dpv, slices, qp, dp_, a.qst, a.dst, q0, a.Tq, kp, vp,
                                                    a.kst, a.vst, k0, a.Tk, a.d, warp, g, t);
    ds_rows<BN>(s, dpv, lse, delta, row, k0, t, a);
    hopper::product_cb_rn_shared<CHUNK, BN, THREADS>(dq_s, s, Kc, L::LDC, g, t);  // dQ += dS K, this block's columns
  }
  float acc[CHUNK / 8][4];
  load_sums<CHUNK>(acc, dq_s);
  store_dq<CHUNK, float>(acc, row, col0, b, h, t, a);
}

__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dkv_tf32_wide_kernel(Args a) {
  using L = Tf32WideDkvLayout;
  constexpr int BN = L::BN;
  extern __shared__ __align__(128) unsigned char smem[];
  float* slices = reinterpret_cast<float*>(smem);
  float* Qc = slices + L::SLICES;
  float* dOc = Qc + BN * L::LDC;
  float* lse_s = dOc + BN * L::LDC;
  float* delta_s = lse_s + BN;
  float4* dv_s = reinterpret_cast<float4*>(delta_s + BN);  // dV's sums

  const int n_cc = (a.d + CHUNK - 1) / CHUNK;
  const int kt = blockIdx.x / n_cc, col0 = (blockIdx.x % n_cc) * CHUNK;  // this block's dK, dV columns
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int k0 = kt * BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const float* kp = static_cast<const float*>(a.k) + b * a.ksb + kvh * a.ksh;
  const float* vp = static_cast<const float*>(a.v) + b * a.vsb + kvh * a.vsh;

  const int key[2] = {k0 + 16 * warp + g, k0 + 16 * warp + g + 8};
  float dk[CHUNK / 8][4];
#pragma unroll
  for (int j = 0; j < CHUNK / 8; ++j) {
    dk[j][0] = dk[j][1] = dk[j][2] = dk[j][3] = 0.f;
    dv_s[j * THREADS + threadIdx.x] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  // the steps: the group's heads, each over its q-tiles from the diagonal
  // down (tiles wholly above it see none of these keys)
  const int n_qt = (a.Tq + BN - 1) / BN;
  const int qt0 = a.causal ? k0 / BN : 0;
  const int nq = n_qt - qt0, n_steps = a.G * nq;

  for (int i = 0; i < n_steps; ++i) {
    const int h = kvh * a.G + i / nq, q0 = (qt0 + i % nq) * BN;
    const float* qp = static_cast<const float*>(a.q) + b * a.qsb + h * a.qsh;
    const float* dp_ = static_cast<const float*>(a.dout) + b * a.dsb + h * a.dsh;
    const long long rbase = ((long long)b * a.H + h) * a.Tp;
    __syncthreads();  // every warp is done with the previous q-tile's chunks
    hopper::load_f32_async<BN, CHUNK, THREADS>(Qc, L::LDC, qp + col0, a.qst, q0, a.Tq, a.d - col0);
    hopper::load_f32_async<BN, CHUNK, THREADS>(dOc, L::LDC, dp_ + col0, a.dst, q0, a.Tq, a.d - col0);
    for (int c = threadIdx.x; c < BN / 2; c += THREADS) {  // BN / 4 chunks of lse, then of delta'
      const bool is_lse = c < BN / 4;
      const int off = 4 * (is_lse ? c : c - BN / 4);
      hopper::cp_async16((is_lse ? lse_s : delta_s) + off, (is_lse ? a.lse : a.delta) + rbase + q0 + off, true);
    }
    hopper::cp_async_commit();
    // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x BN queries
    float s[BN / 8][4], dpv[BN / 8][4];
    hopper::tf32_products_by_slices<BN, 2, THREADS>(s, dpv, slices, kp, vp, a.kst, a.vst, k0, a.Tk, qp, dp_,
                                                    a.qst, a.dst, q0, a.Tq, a.d, warp, g, t);
    p_ds_cols<BN>(s, dpv, lse_s, delta_s, key, q0, t, a);
    hopper::product_cb_rn_shared<CHUNK, BN, THREADS>(dv_s, s, dOc, L::LDC, g, t);  // dV += P^T dO, these columns
    asm volatile("" ::: "memory");  // dK's loads after dV's products: interleaved, they spill
    hopper::product_cb_rn<CHUNK, BN>(dk, dpv, Qc, L::LDC, g, t);  // dK += dS^T Q
  }
  float dv[CHUNK / 8][4];
  load_sums<CHUNK>(dv, dv_s);
  store_dkv<CHUNK, float>(dk, dv, key, col0, kvh, b, t, a);
}

// The chunked route: ceil(d / CHUNK) blocks a tile. parts as in launch.
int launch_wide(const Args& a, int B, int parts, cudaStream_t stream) {
  const int n_cc = (a.d + CHUNK - 1) / CHUNK;
  const dim3 dq_grid((a.Tq + BQ - 1) / BQ * n_cc, a.H, B);
  const dim3 dkv_grid((a.Tk + BK - 1) / BK * n_cc, a.KV, B);
  int err = 0;
  if (parts & 1) {
    err = launch_one(flash_bwd_dq_tf32_wide_kernel, Tf32WideDqLayout::bytes, dq_grid, a, stream);
    if (err != 0) return err;
  }
  if (parts & 2) err = launch_one(flash_bwd_dkv_tf32_wide_kernel, Tf32WideDkvLayout::bytes, dkv_grid, a, stream);
  return err;
}

}  // namespace

// dq, dk and dv in float32 given the row arrays (dml_flash_bwd_rows), on
// the split-TF32 kernels at the native width >= D up to 256 and on the
// chunked pair past it (cudaErrorInvalidValue at D < 1 and for bf16,
// which dml_flash_bwd takes). The arguments of dml_flash_bwd. parts: 1 =
// the dq kernel, 2 = the dkv kernel, 3 = both.
extern "C" int dml_flash_bwd_tf32(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse_r, const void* delta_r,
                                  void* dq, void* dk, void* dv,
                                  int is_bf16, int B, int H, int KV, int Tq, int Tk, int Tp, int D,
                                  long long qsb, long long qst, long long qsh,
                                  long long ksb, long long kst, long long ksh,
                                  long long vsb, long long vst, long long vsh,
                                  long long dsb, long long dst, long long dsh,
                                  float scale, int causal, int parts, void* stream) {
  if (B <= 0 || Tq <= 0 || Tk <= 0) return 0;
  if (is_bf16) return (int)cudaErrorInvalidValue;
  Args a{q, k, v, dout,
         static_cast<const float*>(lse_r), static_cast<const float*>(delta_r), dq, dk, dv,
         H, H / KV, KV, Tq, Tk, Tp, D,
         qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh, dsb, dst, dsh, scale, causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hopper::native_head_dim(D)) {
    case 16: return launch<16>(a, B, parts, s);
    case 32: return launch<32>(a, B, parts, s);
    case 48: return launch<48>(a, B, parts, s);
    case 64: return launch<64>(a, B, parts, s);
    case 80: return launch<80>(a, B, parts, s);
    case 96: return launch<96>(a, B, parts, s);
    case 128: return launch<128>(a, B, parts, s);
    case 256: return launch<256>(a, B, parts, s);
    default: return D > hopper::WIDEST_NATIVE ? launch_wide(a, B, parts, s)
                                              : (int)cudaErrorInvalidValue;  // D < 1
  }
}
