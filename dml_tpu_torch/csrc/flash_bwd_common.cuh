// What the flash attention backward's two sources share
// (flash_attention_bwd.cu: the bf16 kernels and the delta kernel;
// flash_attention_bwd_tf32.cu: the float32 kernels): the kernels'
// arguments and tile constants, the recomputation of P and dS on an
// accumulator tile (the mma.sync layout: rows g and g + 8, columns 2t and
// 2t + 1 of each 8-column tile), the gradients' stores, and a plain
// launch. Two sources, so that nvcc builds the two halves in parallel.
//
// Everything here sits in the including file's unnamed namespace, as in
// hopper.cuh.

#pragma once

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;        // query rows per tile (mma.sync)
constexpr int BK = 64;        // key rows per tile (mma.sync)
constexpr int THREADS = 128;  // 4 warps
constexpr float NEG_INF = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [B, H, Tp]: the forward's lse, +1e30 past Tq
  const float* delta;  // [B, H, Tp]: rowsum(dO * O) - g_lse, 0 past Tq
  void* dq;
  void* dk;
  void* dv;
  int H, G, KV, Tq, Tk, Tp;
  int d;  // the head dim; the kernel's D is the native width >= d
  long long qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh, dsb, dst, dsh;
  float scale;
  int causal;
};

constexpr int CHUNK = 128;  // gradient columns a block of the float32 chunked route (d > 256) owns

// Gradient columns a block of the mma.sync kernels accumulates: all D up
// to 128, half of them at D 256 (two blocks per tile).
template <int D>
__host__ __device__ constexpr int grad_cols() { return D > 128 ? 128 : D; }

// dS = P (dP - delta') scale in place of S, for this warp's 16 query rows
// (row[0], row[1]) x BN keys from k0: the dq kernels' step.
template <int BN = BK>
__device__ __forceinline__ void ds_rows(float (*s)[4], const float (*dpv)[4], const float* lse,
                                        const float* delta, const int* row, int k0, int t, const Args& a) {
#pragma unroll
  for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      const int key = k0 + 8 * nt + 2 * t + (e & 1);
      float sv = s[nt][e] * a.scale;
      if (key >= a.Tk || (a.causal && key > row[r])) sv = NEG_INF;
      const float p = expf(sv - lse[r]);
      s[nt][e] = p * (dpv[nt][e] - delta[r]) * a.scale;
    }
  }
}

// dQ's columns [col0, col0 + W) of this thread's two rows (none at d and
// beyond), in T.
template <int W, typename T = __nv_bfloat16>
__device__ __forceinline__ void store_dq(const float (*acc)[4], const int* row, int col0, int b, int h, int t,
                                         const Args& a) {
  T* dq = static_cast<T*>(a.dq);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= a.Tq) continue;
    T* out = dq + (((long long)b * a.Tq + row[r]) * a.H + h) * a.d;
#pragma unroll
    for (int j = 0; j < W / 8; ++j) hopper::store_pair(out, col0 + 8 * j + 2 * t, a.d, acc[j][2 * r], acc[j][2 * r + 1]);
  }
}

// P^T in place of S^T and dS^T in place of dP^T, for this warp's 16 keys
// (key[0], key[1]) x BN queries from q0: the dkv kernels' step.
template <int BN = BQ>
__device__ __forceinline__ void p_ds_cols(float (*s)[4], float (*dpv)[4], const float* lse_s, const float* delta_s,
                                          const int* key, int q0, int t, const Args& a) {
#pragma unroll
  for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      const int c = 8 * nt + 2 * t + (e & 1);  // query within the tile
      const int qpos = q0 + c;
      float sv = s[nt][e] * a.scale;
      if (qpos >= a.Tq || (a.causal && key[r] > qpos)) sv = NEG_INF;
      const float p = expf(sv - lse_s[c]);
      s[nt][e] = p;
      dpv[nt][e] = p * (dpv[nt][e] - delta_s[c]) * a.scale;
    }
  }
}

// dK's and dV's columns [col0, col0 + W) of this thread's two keys, in T.
template <int W, typename T = __nv_bfloat16>
__device__ __forceinline__ void store_dkv(const float (*dk)[4], const float (*dv)[4], const int* key, int col0,
                                          int kvh, int b, int t, const Args& a) {
  T* dkp = static_cast<T*>(a.dk);
  T* dvp = static_cast<T*>(a.dv);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= a.Tk) continue;
    const long long off = (((long long)b * a.Tk + key[r]) * a.KV + kvh) * a.d;
#pragma unroll
    for (int j = 0; j < W / 8; ++j) {
      const int c = col0 + 8 * j + 2 * t;
      hopper::store_pair(dkp + off, c, a.d, dk[j][2 * r], dk[j][2 * r + 1]);
      hopper::store_pair(dvp + off, c, a.d, dv[j][2 * r], dv[j][2 * r + 1]);
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

}  // namespace
