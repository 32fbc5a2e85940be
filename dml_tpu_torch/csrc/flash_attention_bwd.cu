// Flash attention backward: the Hopper counterpart of the TPU kernels
// dml_tpu/ops/flash_attention.py::_bwd_dq_kernel and ::_bwd_dkv_kernel.
//
// q and dO [B, Tq, H, D], k and v [B, Tk, KV, D] (BTHD, read through
// strides; KV divides H and query head h reads kv head h / (H / KV)),
// lse, delta = rowsum(dO * O) and the optional lse cotangent g_lse
// [B, H, Tq] f32 -> dq [B, Tq, H, D] in q's dtype, dk and dv
// [B, Tk, KV, D] in k's and v's dtype, all contiguous.
//
// Recomputation from the saved lse, as on the TPU, in the TPU's two
// kernels: no atomics, so every gradient is deterministic.
//   S = Q K^T * scale, masked as the forward masks it (columns at Tk and
//   beyond and, if causal, past the row's position, with -1e30);
//   P = exp(S - lse); dP = dO V^T;
//   dS = P * (dP - delta [+ g_lse]) * scale.
//   dq kernel: one block of 4 warps per (64-row q-tile, head, batch)
//     loops over the k-tiles up to the diagonal: dQ += dS K, dS rounded
//     to K's dtype first (the TPU kernel's `ds.astype(k_ref.dtype)`).
//   dkv kernel: one block per (64-row k-tile, kv head, batch) loops over
//     the G query heads of its group and, for each, over the q-tiles from
//     the diagonal down: dV += P^T dO with P rounded to dO's dtype, dK +=
//     dS^T Q with dS rounded to Q's dtype (the TPU kernel's roundings).
//     The sum over the group is the gradient of a grouped k/v input.
//   The TPU kernels carry dq (and dk, dv) in scratch across a sequential
//   innermost grid axis; here each block loops over that axis itself and
//   keeps the accumulators in registers (bf16) or shared memory (f32).
//   Query rows at Tq and beyond (the TPU pads lse with +1e30 for them)
//   are masked to P = 0 in the dkv kernel and never stored by the dq one.
//
// bf16: mma.sync m16n8k16 (bf16 in, f32 accumulate). Each warp owns 16
// rows of its block's tile (query rows in the dq kernel, key rows in the
// dkv kernel). The dq kernel computes S and dP with those rows as the
// M dimension, so the dS accumulator's register layout is the A operand
// layout of dS K and dS never touches shared memory (the same trick the
// forward plays with P V). The dkv kernel computes S^T = K Q^T and
// dP^T = V dO^T, so P^T and dS^T sit in registers as the A operands of
// P^T dO and dS^T Q. Tiles sit in shared memory row-major for the
// operands read along D, and transposed ([D, 64]) for those read along
// the sequence, so every fragment is one 32-bit read; rows are padded by
// 16 bytes to keep those reads on distinct banks. f32 inputs take plain
// FMAs with the tiles in shared memory (dq's accumulator too; dk and dv
// in registers).
//
// Bound: tensor-core operations at the training shape. The backward
// needs 5 products of 2 * Tq * Tk * D operations per head (S, dP, dV,
// dK, dQ; halved for causal); the two-kernel split recomputes S and dP
// in the dkv kernel, 7 products. At [1, 2048, 16, 64] bf16 causal that
// is 21.5 GFLOP (30.1 for the split) against ~34 MB of q, k, v, o, dO,
// dq, dk and dv: the H100's bf16 tensor cores (989 TFLOP/s dense), not
// its 3.35 TB/s, are the limit. This version loads tiles synchronously
// and uses mma.sync; TMA, wgmma and the one-kernel form with atomic dq
// are later work.
//
// Plain C interface for ctypes; launches on the caller's stream and
// returns cudaGetLastError() so a refused launch raises in the wrapper.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // key rows per tile
constexpr int THREADS = 128;  // 4 warps
constexpr float NEG_INF = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  const float* glse;  // nullptr when the lse output has no cotangent
  void* dq;
  void* dk;
  void* dv;
  int H, G, KV, Tq, Tk;
  long long qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh, dsb, dst, dsh;
  float scale;
  int causal;
};

// Copy rows [row0, row0 + 64) of one head ([T, D] with row stride
// `stride_t` elements) into a shared tile with row stride `ld`, 16 bytes
// per thread per step; rows at `n_rows` and beyond are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src, long long stride_t,
                                          int row0, int n_rows) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CHUNKS = D / VEC;
  for (int i = threadIdx.x; i < 64 * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS;
    const int c = (i % CHUNKS) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows) {
      val = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * stride_t + c);
    }
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// The same rows, stored transposed: dst[d * ldt + r] = src[row0 + r][d].
template <int D>
__device__ __forceinline__ void load_tile_t(__nv_bfloat16* dst, int ldt, const __nv_bfloat16* src,
                                            long long stride_t, int row0, int n_rows) {
  for (int i = threadIdx.x; i < 64 * (D / 8); i += THREADS) {
    const int r = i % 64, c = (i / 64) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows) val = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * stride_t + c);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[(c + j) * ldt + r] = e[j];
  }
}

// Per-row f32 values of one (batch, head) for rows [row0, row0 + 64) into
// shared memory; rows at `n_rows` and beyond are zero.
__device__ __forceinline__ void load_rows(float* dst, const float* src, int row0, int n_rows) {
  if (threadIdx.x < 64) {
    const int r = row0 + threadIdx.x;
    dst[threadIdx.x] = (src != nullptr && r < n_rows) ? src[r] : 0.f;
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

template <int D>
struct DqLayout {
  static constexpr int LD = D + 8;    // Q, dO, K, V tiles, row-major
  static constexpr int LDT = BK + 8;  // K tile transposed: [D, 64]
  static constexpr size_t bytes = sizeof(bf16) * (size_t)(2 * BQ * LD + 2 * BK * LD + D * LDT);
};

template <int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_mma_kernel(Args a) {
  using L = DqLayout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + BQ * L::LD;
  bf16* Ks = dOs + BQ * L::LD;
  bf16* Vs = Ks + BK * L::LD;
  bf16* Kt = Vs + BK * L::LD;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / a.G;
  const int q0 = qt * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const bf16* qp = static_cast<const bf16*>(a.q) + b * a.qsb + h * a.qsh;
  const bf16* dp_ = static_cast<const bf16*>(a.dout) + b * a.dsb + h * a.dsh;
  const bf16* kp = static_cast<const bf16*>(a.k) + b * a.ksb + kvh * a.ksh;
  const bf16* vp = static_cast<const bf16*>(a.v) + b * a.vsb + kvh * a.vsh;

  load_tile<bf16, D>(Qs, L::LD, qp, a.qst, q0, a.Tq);
  load_tile<bf16, D>(dOs, L::LD, dp_, a.dst, q0, a.Tq);

  const int row[2] = {q0 + 16 * warp + g, q0 + 16 * warp + g + 8};
  const long long rbase = ((long long)b * a.H + h) * a.Tq;
  float lse[2], delta[2], glse[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = row[r] < a.Tq;
    lse[r] = in ? a.lse[rbase + row[r]] : 0.f;
    delta[r] = in ? a.delta[rbase + row[r]] : 0.f;
    if (a.glse != nullptr && in) glse[r] = a.glse[rbase + row[r]];
  }
  const bool has_glse = a.glse != nullptr;

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  int n_tiles = (a.Tk + BK - 1) / BK;
  if (a.causal) n_tiles = min(n_tiles, (q0 + BQ - 1) / BK + 1);  // skip tiles above the diagonal

  const bf16* qrows = Qs + 16 * warp * L::LD;
  const bf16* drows = dOs + 16 * warp * L::LD;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every warp is done with the previous K/V tiles (and Q, dO are in)
    load_tile<bf16, D>(Ks, L::LD, kp, a.kst, k0, a.Tk);
    load_tile<bf16, D>(Vs, L::LD, vp, a.vst, k0, a.Tk);
    load_tile_t<D>(Kt, L::LDT, kp, a.kst, k0, a.Tk);
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

    // dS = P (dP - delta [+ g_lse]) scale, in place of S
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int key = k0 + 8 * nt + 2 * t + (e & 1);
        float sv = s[nt][e] * a.scale;
        if (key >= a.Tk || (a.causal && key > row[r])) sv = NEG_INF;
        const float p = expf(sv - lse[r]);
        float term = dpv[nt][e] - delta[r];
        if (has_glse) term += glse[r];
        s[nt][e] = p * term * a.scale;
      }
    }

    // dQ += dS K: dS (bf16) straight from the accumulators into A
    // fragments, K^T from the transposed tile, 16 keys at a time
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t sa[4];
      c_to_a(sa, s, kk);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const bf16* kr = Kt + (8 * j + g) * L::LDT + 16 * kk + 2 * t;
        mma16816(acc[j], sa, ld32(kr), ld32(kr + 8));
      }
    }
  }

  bf16* dq = static_cast<bf16*>(a.dq);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= a.Tq) continue;
    bf16* out = dq + (((long long)b * a.Tq + row[r]) * a.H + h) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) =
          __floats2bfloat162_rn(acc[j][2 * r], acc[j][2 * r + 1]);
    }
  }
}

template <int D>
struct DkvLayout {
  static constexpr int LD = D + 8;    // K, V, Q, dO tiles, row-major
  static constexpr int LDT = BQ + 8;  // Q and dO tiles transposed: [D, 64]
  static constexpr size_t bytes =
      sizeof(bf16) * (size_t)(2 * BK * LD + 2 * BQ * LD + 2 * D * LDT) + sizeof(float) * 3 * BQ;
};

template <int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkv_mma_kernel(Args a) {
  using L = DkvLayout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + BK * L::LD;
  bf16* Qs = Vs + BK * L::LD;
  bf16* dOs = Qs + BQ * L::LD;
  bf16* Qt = dOs + BQ * L::LD;
  bf16* dOt = Qt + D * L::LDT;
  float* lse_s = reinterpret_cast<float*>(dOt + D * L::LDT);
  float* delta_s = lse_s + BQ;
  float* glse_s = delta_s + BQ;

  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int k0 = kt * BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const bool has_glse = a.glse != nullptr;
  const bf16* kp = static_cast<const bf16*>(a.k) + b * a.ksb + kvh * a.ksh;
  const bf16* vp = static_cast<const bf16*>(a.v) + b * a.vsb + kvh * a.vsh;
  load_tile<bf16, D>(Ks, L::LD, kp, a.kst, k0, a.Tk);
  load_tile<bf16, D>(Vs, L::LD, vp, a.vst, k0, a.Tk);

  const int key[2] = {k0 + 16 * warp + g, k0 + 16 * warp + g + 8};
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
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
    const long long rbase = ((long long)b * a.H + h) * a.Tq;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // every warp is done with the previous Q/dO tiles
      load_tile<bf16, D>(Qs, L::LD, qp, a.qst, q0, a.Tq);
      load_tile<bf16, D>(dOs, L::LD, dp_, a.dst, q0, a.Tq);
      load_tile_t<D>(Qt, L::LDT, qp, a.qst, q0, a.Tq);
      load_tile_t<D>(dOt, L::LDT, dp_, a.dst, q0, a.Tq);
      load_rows(lse_s, a.lse + rbase, q0, a.Tq);
      load_rows(delta_s, a.delta + rbase, q0, a.Tq);
      if (has_glse) load_rows(glse_s, a.glse + rbase, q0, a.Tq);
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

      // P^T in place of S^T, dS^T in place of dP^T
#pragma unroll
      for (int nt = 0; nt < BQ / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int c = 8 * nt + 2 * t + (e & 1);  // query within the tile
          const int qpos = q0 + c;
          float sv = s[nt][e] * a.scale;
          if (qpos >= a.Tq || (a.causal && key[r] > qpos)) sv = NEG_INF;
          const float p = expf(sv - lse_s[c]);
          float term = dpv[nt][e] - delta_s[c];
          if (has_glse) term += glse_s[c];
          s[nt][e] = p;
          dpv[nt][e] = p * term * a.scale;
        }
      }

      // dV += P^T dO and dK += dS^T Q, 16 queries at a time; dO and Q
      // from their transposed tiles
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        uint32_t pa[4], sa[4];
        c_to_a(pa, s, kk);
        c_to_a(sa, dpv, kk);
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          const bf16* dr = dOt + (8 * j + g) * L::LDT + 16 * kk + 2 * t;
          const bf16* qr = Qt + (8 * j + g) * L::LDT + 16 * kk + 2 * t;
          mma16816(dv[j], pa, ld32(dr), ld32(dr + 8));
          mma16816(dk[j], sa, ld32(qr), ld32(qr + 8));
        }
      }
    }
  }

  bf16* dkp = static_cast<bf16*>(a.dk);
  bf16* dvp = static_cast<bf16*>(a.dv);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= a.Tk) continue;
    const long long off = (((long long)b * a.Tk + key[r]) * a.KV + kvh) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dkp + off + 8 * j) =
          __floats2bfloat162_rn(dk[j][2 * r], dk[j][2 * r + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dvp + off + 8 * j) =
          __floats2bfloat162_rn(dv[j][2 * r], dv[j][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------- f32

template <int D>
struct F32DqLayout {
  static constexpr int LDT = D + 4;   // Q, dO, K, V tiles and the dQ accumulator
  static constexpr int LDS = BK + 4;  // dS
  static constexpr size_t bytes = sizeof(float) * (size_t)(5 * 64 * LDT + BQ * LDS + 3 * BQ);
};

template <int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_f32_kernel(Args a) {
  using L = F32DqLayout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* dOs = Qs + 64 * L::LDT;
  float* Ks = dOs + 64 * L::LDT;
  float* Vs = Ks + 64 * L::LDT;
  float* dQ = Vs + 64 * L::LDT;
  float* dS = dQ + 64 * L::LDT;
  float* lse_s = dS + BQ * L::LDS;
  float* delta_s = lse_s + BQ;
  float* glse_s = delta_s + BQ;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / a.G;
  const int q0 = qt * BQ;
  const int tid = threadIdx.x;
  const float* qp = static_cast<const float*>(a.q) + b * a.qsb + h * a.qsh;
  const float* dp_ = static_cast<const float*>(a.dout) + b * a.dsb + h * a.dsh;
  const float* kp = static_cast<const float*>(a.k) + b * a.ksb + kvh * a.ksh;
  const float* vp = static_cast<const float*>(a.v) + b * a.vsb + kvh * a.vsh;
  const long long rbase = ((long long)b * a.H + h) * a.Tq;

  load_tile<float, D>(Qs, L::LDT, qp, a.qst, q0, a.Tq);
  load_tile<float, D>(dOs, L::LDT, dp_, a.dst, q0, a.Tq);
  for (int i = tid; i < 64 * L::LDT; i += THREADS) dQ[i] = 0.f;
  load_rows(lse_s, a.lse + rbase, q0, a.Tq);
  load_rows(delta_s, a.delta + rbase, q0, a.Tq);
  load_rows(glse_s, a.glse != nullptr ? a.glse + rbase : nullptr, q0, a.Tq);

  int n_tiles = (a.Tk + BK - 1) / BK;
  if (a.causal) n_tiles = min(n_tiles, (q0 + BQ - 1) / BK + 1);

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_tile<float, D>(Ks, L::LDT, kp, a.kst, k0, a.Tk);
    load_tile<float, D>(Vs, L::LDT, vp, a.vst, k0, a.Tk);
    __syncthreads();

    for (int i = tid; i < BQ * BK; i += THREADS) {
      const int r = i / BK, c = i % BK;
      const float* qr = Qs + r * L::LDT;
      const float* dr = dOs + r * L::LDT;
      const float* kr = Ks + c * L::LDT;
      const float* vr = Vs + c * L::LDT;
      float s = 0.f, dp = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) {
        s = fmaf(qr[d], kr[d], s);
        dp = fmaf(dr[d], vr[d], dp);
      }
      const int key = k0 + c;
      s *= a.scale;
      if (key >= a.Tk || (a.causal && key > q0 + r)) s = NEG_INF;
      const float p = expf(s - lse_s[r]);
      dS[r * L::LDS + c] = p * (dp - delta_s[r] + glse_s[r]) * a.scale;
    }
    __syncthreads();

    for (int i = tid; i < BQ * D; i += THREADS) {
      const int r = i / D, d = i % D;
      const float* sr = dS + r * L::LDS;
      float acc = dQ[r * L::LDT + d];
#pragma unroll 16
      for (int c = 0; c < BK; ++c) acc = fmaf(sr[c], Ks[c * L::LDT + d], acc);
      dQ[r * L::LDT + d] = acc;
    }
  }
  __syncthreads();

  float* dq = static_cast<float*>(a.dq);
  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    if (q0 + r < a.Tq) dq[(((long long)b * a.Tq + q0 + r) * a.H + h) * D + d] = dQ[r * L::LDT + d];
  }
}

template <int D>
struct F32DkvLayout {
  static constexpr int LDT = D + 4;   // K, V, Q, dO tiles
  static constexpr int LDS = BQ + 4;  // P^T and dS^T
  static constexpr size_t bytes = sizeof(float) * (size_t)(4 * 64 * LDT + 2 * BK * LDS + 3 * BQ);
};

template <int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkv_f32_kernel(Args a) {
  using L = F32DkvLayout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + 64 * L::LDT;
  float* Qs = Vs + 64 * L::LDT;
  float* dOs = Qs + 64 * L::LDT;
  float* Pt = dOs + 64 * L::LDT;
  float* dSt = Pt + BK * L::LDS;
  float* lse_s = dSt + BK * L::LDS;
  float* delta_s = lse_s + BQ;
  float* glse_s = delta_s + BQ;

  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int k0 = kt * BK;
  const int tid = threadIdx.x;
  const float* kp = static_cast<const float*>(a.k) + b * a.ksb + kvh * a.ksh;
  const float* vp = static_cast<const float*>(a.v) + b * a.vsb + kvh * a.vsh;
  load_tile<float, D>(Ks, L::LDT, kp, a.kst, k0, a.Tk);
  load_tile<float, D>(Vs, L::LDT, vp, a.vst, k0, a.Tk);

  // accumulators in registers: thread owns key row `own` and half the D columns
  const int own = tid >> 1, half = tid & 1;
  constexpr int HD = D / 2;
  float dk[HD], dv[HD];
#pragma unroll
  for (int j = 0; j < HD; ++j) dk[j] = dv[j] = 0.f;

  const int n_qt = (a.Tq + BQ - 1) / BQ;
  const int qt0 = a.causal ? k0 / BQ : 0;
  for (int gi = 0; gi < a.G; ++gi) {
    const int h = kvh * a.G + gi;
    const float* qp = static_cast<const float*>(a.q) + b * a.qsb + h * a.qsh;
    const float* dp_ = static_cast<const float*>(a.dout) + b * a.dsb + h * a.dsh;
    const long long rbase = ((long long)b * a.H + h) * a.Tq;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();
      load_tile<float, D>(Qs, L::LDT, qp, a.qst, q0, a.Tq);
      load_tile<float, D>(dOs, L::LDT, dp_, a.dst, q0, a.Tq);
      load_rows(lse_s, a.lse + rbase, q0, a.Tq);
      load_rows(delta_s, a.delta + rbase, q0, a.Tq);
      load_rows(glse_s, a.glse != nullptr ? a.glse + rbase : nullptr, q0, a.Tq);
      __syncthreads();

      for (int i = tid; i < BK * BQ; i += THREADS) {
        const int r = i / BQ, c = i % BQ;  // key r, query c
        const float* kr = Ks + r * L::LDT;
        const float* vr = Vs + r * L::LDT;
        const float* qr = Qs + c * L::LDT;
        const float* dr = dOs + c * L::LDT;
        float s = 0.f, dp = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) {
          s = fmaf(kr[d], qr[d], s);
          dp = fmaf(vr[d], dr[d], dp);
        }
        const int qpos = q0 + c;
        s *= a.scale;
        if (qpos >= a.Tq || (a.causal && k0 + r > qpos)) s = NEG_INF;
        const float p = expf(s - lse_s[c]);
        Pt[r * L::LDS + c] = p;
        dSt[r * L::LDS + c] = p * (dp - delta_s[c] + glse_s[c]) * a.scale;
      }
      __syncthreads();

      const float* pr = Pt + own * L::LDS;
      const float* sr = dSt + own * L::LDS;
      for (int c = 0; c < BQ; ++c) {
        const float pv = pr[c], sv = sr[c];
        const float* dr = dOs + c * L::LDT + half * HD;
        const float* qr = Qs + c * L::LDT + half * HD;
#pragma unroll
        for (int j = 0; j < HD; ++j) {
          dv[j] = fmaf(pv, dr[j], dv[j]);
          dk[j] = fmaf(sv, qr[j], dk[j]);
        }
      }
    }
  }

  if (k0 + own < a.Tk) {
    const long long off = (((long long)b * a.Tk + k0 + own) * a.KV + kvh) * D + half * HD;
    float* dkp = static_cast<float*>(a.dk) + off;
    float* dvp = static_cast<float*>(a.dv) + off;
#pragma unroll
    for (int j = 0; j < HD; ++j) {
      dkp[j] = dk[j];
      dvp[j] = dv[j];
    }
  }
}

template <typename K>
int launch_one(K kernel, size_t bytes, dim3 grid, const Args& a, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, THREADS, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// parts: 1 = the dq kernel, 2 = the dkv kernel, 3 = both
template <int D>
int launch(const Args& a, int B, int is_bf16, int parts, cudaStream_t stream) {
  const dim3 dq_grid((a.Tq + BQ - 1) / BQ, a.H, B);
  const dim3 dkv_grid((a.Tk + BK - 1) / BK, a.KV, B);
  int err = 0;
  if (parts & 1) {
    err = is_bf16 ? launch_one(flash_bwd_dq_mma_kernel<D>, DqLayout<D>::bytes, dq_grid, a, stream)
                  : launch_one(flash_bwd_dq_f32_kernel<D>, F32DqLayout<D>::bytes, dq_grid, a, stream);
    if (err != 0) return err;
  }
  if (parts & 2) {
    err = is_bf16
              ? launch_one(flash_bwd_dkv_mma_kernel<D>, DkvLayout<D>::bytes, dkv_grid, a, stream)
              : launch_one(flash_bwd_dkv_f32_kernel<D>, F32DkvLayout<D>::bytes, dkv_grid, a, stream);
  }
  return err;
}

}  // namespace

extern "C" int dml_flash_bwd(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, const void* glse,
                             void* dq, void* dk, void* dv,
                             int is_bf16, int B, int H, int KV, int Tq, int Tk, int D,
                             long long qsb, long long qst, long long qsh,
                             long long ksb, long long kst, long long ksh,
                             long long vsb, long long vst, long long vsh,
                             long long dsb, long long dst, long long dsh,
                             float scale, int causal, int parts, void* stream) {
  if (B <= 0 || Tq <= 0 || Tk <= 0) return 0;
  Args a{q, k, v, dout,
         static_cast<const float*>(lse), static_cast<const float*>(delta),
         static_cast<const float*>(glse), dq, dk, dv,
         H, H / KV, KV, Tq, Tk,
         qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh, dsb, dst, dsh, scale, causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(a, B, is_bf16, parts, s);
    case 32: return launch<32>(a, B, is_bf16, parts, s);
    case 64: return launch<64>(a, B, is_bf16, parts, s);
    case 128: return launch<128>(a, B, is_bf16, parts, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
