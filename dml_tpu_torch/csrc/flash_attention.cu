// Flash attention forward: the Hopper counterpart of the TPU kernel
// dml_tpu/ops/flash_attention.py::_fwd_kernel.
//
// q [B, Tq, H, D], k and v [B, Tk, KV, D] (BTHD, read through strides so
// no transpose copy is made; KV divides H and query head h reads kv head
// h / (H / KV), which is jnp.repeat's mapping in generate.prefill) ->
// out [B, Tq, H, D] in q's dtype and lse [B, H, Tq] f32.
//
// Work split: one block of 128 threads (4 warps) per (q-tile of 64 rows,
// head, batch). The block loops over 64-row k-tiles itself; this loop
// replaces the TPU kernel's sequential innermost grid axis, whose scratch
// carried the running max, denominator and accumulator from one grid
// step to the next. Here they live in registers (bf16) or shared memory
// (f32) for the whole loop.
//
// Per k-tile: S = Q K^T * scale in f32; mask columns at Tk and beyond
// and, if causal, columns past the row's position with the TPU kernel's
// -1e30 sentinel; the online-softmax update in f32 (m_new = max(m,
// rowmax S), p = exp(S - m_new), alpha = exp(m - m_new), l = l * alpha
// + sum p); P cast to V's dtype, as the TPU kernel does, then O = O *
// alpha + P V. Causal k-tiles wholly above the diagonal are never
// visited. At the end out = O / max(l, 1e-30), lse = m + log(l).
//
// bf16 (the LM's prefill): each warp owns 16 query rows and runs
// mma.sync m16n8k16 (bf16 in, f32 accumulate) with S, P and the O
// accumulator in registers: the S accumulator's layout is the A operand
// layout of the P V product, so P goes from one to the other without
// touching shared memory, and the row max and row sum are reduced over
// the 4 threads that share a row. K tiles sit in shared memory row-major
// and V tiles transposed ([D, 64]), so every fragment is a 32-bit read
// and rows are padded by 16 bytes to keep those reads on distinct banks.
// f32 inputs take plain FMAs with the tiles and accumulator in shared
// memory.
//
// Bound: tensor-core operations at the prefill shape. 4 * B * H * Tq *
// Tk * D operations (halved for causal) against 2 * (q + k + v + out)
// bytes: at [8, 2048, 16, 64] bf16 that is 68.7 GFLOP over 85 MB, about
// 800 operations per byte, above the ~295 where the H100's bf16 tensor
// cores (989 TFLOP/s dense) and not its 3.35 TB/s memory are the limit.
// This version loads each tile synchronously and uses mma.sync; TMA
// loads overlapped with compute and wgmma are later work.
//
// Plain C interface for ctypes; launches on the caller's stream and
// returns cudaGetLastError() so a refused launch raises in the wrapper.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // key rows per k-tile
constexpr int THREADS = 128;  // 4 warps; warp w owns query rows [16w, 16w + 16)
constexpr float NEG_INF = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;
  int H, G, Tq, Tk;
  long long qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh;
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

// ---------------------------------------------------------------- bf16

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
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

template <int D>
struct MmaLayout {
  static constexpr int LDK = D + 8;   // Q and K tiles, row-major
  static constexpr int LDV = BK + 8;  // V tile transposed: [D, 64]
  static constexpr size_t bytes = sizeof(__nv_bfloat16) * (size_t)(BQ * LDK + BK * LDK + D * LDV);
};

template <int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_mma_kernel(Args a) {
  using L = MmaLayout<D>;
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + BQ * L::LDK;
  bf16* Vt = Ks + BK * L::LDK;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / a.G;
  const int q0 = qt * BQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const bf16* qp = static_cast<const bf16*>(a.q) + b * a.qsb + h * a.qsh;
  const bf16* kp = static_cast<const bf16*>(a.k) + b * a.ksb + kvh * a.ksh;
  const bf16* vp = static_cast<const bf16*>(a.v) + b * a.vsb + kvh * a.vsh;

  load_tile<bf16, D>(Qs, L::LDK, qp, a.qst, q0, a.Tq);
  __syncthreads();
  uint32_t qf[D / 16][4];  // this warp's 16 query rows as A fragments
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const bf16* base = Qs + (16 * warp) * L::LDK + 16 * kk + 2 * t;
    qf[kk][0] = ld32(base + g * L::LDK);
    qf[kk][1] = ld32(base + (g + 8) * L::LDK);
    qf[kk][2] = ld32(base + g * L::LDK + 8);
    qf[kk][3] = ld32(base + (g + 8) * L::LDK + 8);
  }

  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const int row[2] = {q0 + 16 * warp + g, q0 + 16 * warp + g + 8};

  int n_tiles = (a.Tk + BK - 1) / BK;
  if (a.causal) n_tiles = min(n_tiles, (q0 + BQ - 1) / BK + 1);  // skip tiles above the diagonal

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<bf16, D>(Ks, L::LDK, kp, a.kst, k0, a.Tk);
    // V transposed: thread i takes key i % 64 and 8 consecutive d
    for (int i = tid; i < BK * (D / 8); i += THREADS) {
      const int key = i % BK, c = (i / BK) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + key < a.Tk) val = *reinterpret_cast<const uint4*>(vp + (long long)(k0 + key) * a.vst + c);
      const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) Vt[(c + j) * L::LDV + key] = e[j];
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys: 8 tiles of 16x8
    float s[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const bf16* kr = Ks + (8 * nt + g) * L::LDK + 2 * t;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) mma16816(s[nt], qf[kk], ld32(kr + 16 * kk), ld32(kr + 16 * kk + 8));
    }

    // scale, mask, row max over the 4 threads of a row
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int key = k0 + 8 * nt + 2 * t + (e & 1);
        float v = s[nt][e] * a.scale;
        if (key >= a.Tk || (a.causal && key > row[r])) v = NEG_INF;
        s[nt][e] = v;
        mx[r] = fmaxf(mx[r], v);
      }
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[nt][e] - m[e >> 1]);
        s[nt][e] = p;
        sum[e >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = l[r] * alpha[r] + sum[r];
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }

    // O += P V: P (bf16, as the TPU kernel casts it) straight from the
    // S accumulators into A fragments, 16 keys at a time
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const bf16* vr = Vt + (8 * j + g) * L::LDV + 16 * kk + 2 * t;
        mma16816(o[j], pa, ld32(vr), ld32(vr + 8));
      }
    }
  }

  bf16* out = static_cast<bf16*>(a.out);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= a.Tq) continue;
    const float inv_l = 1.f / fmaxf(l[r], 1e-30f);
    bf16* orow = out + (((long long)b * a.Tq + row[r]) * a.H + h) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const __nv_bfloat162 v = __floats2bfloat162_rn(o[j][2 * r] * inv_l, o[j][2 * r + 1] * inv_l);
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) = v;
    }
    if (t == 0) a.lse[((long long)b * a.H + h) * a.Tq + row[r]] = m[r] + logf(fmaxf(l[r], 1e-30f));
  }
}

// ---------------------------------------------------------------- f32

template <int D>
struct F32Layout {
  static constexpr int LDT = D + 4;   // Q, K, V tiles
  static constexpr int LDS = BK + 4;  // S, then P
  static constexpr int LDO = D + 4;   // O accumulator
  static constexpr size_t bytes =
      sizeof(float) * (size_t)(3 * 64 * LDT + BQ * LDS + BQ * LDO + 2 * BQ);
};

template <int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_f32_kernel(Args a) {
  using L = F32Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + 64 * L::LDT;
  float* Vs = Ks + 64 * L::LDT;
  float* S = Vs + 64 * L::LDT;
  float* O = S + BQ * L::LDS;
  float* m_s = O + BQ * L::LDO;
  float* l_s = m_s + BQ;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / a.G;
  const int q0 = qt * BQ;
  const int tid = threadIdx.x;
  const float* qp = static_cast<const float*>(a.q) + b * a.qsb + h * a.qsh;
  const float* kp = static_cast<const float*>(a.k) + b * a.ksb + kvh * a.ksh;
  const float* vp = static_cast<const float*>(a.v) + b * a.vsb + kvh * a.vsh;

  load_tile<float, D>(Qs, L::LDT, qp, a.qst, q0, a.Tq);
  for (int i = tid; i < BQ * L::LDO; i += THREADS) O[i] = 0.f;
  if (tid < BQ) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }

  int n_tiles = (a.Tk + BK - 1) / BK;
  if (a.causal) n_tiles = min(n_tiles, (q0 + BQ - 1) / BK + 1);

  // softmax mapping: two threads per row, 32 columns each
  const int r = tid >> 1, half = tid & 1;
  const int qpos = q0 + r;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_tile<float, D>(Ks, L::LDT, kp, a.kst, k0, a.Tk);
    load_tile<float, D>(Vs, L::LDT, vp, a.vst, k0, a.Tk);
    __syncthreads();

    for (int i = tid; i < BQ * BK; i += THREADS) {
      const int rr = i / BK, c = i % BK;
      const float* qr = Qs + rr * L::LDT;
      const float* kr = Ks + c * L::LDT;
      float acc = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) acc = fmaf(qr[d], kr[d], acc);
      S[rr * L::LDS + c] = acc * a.scale;
    }
    __syncthreads();

    {
      const float m_prev = m_s[r];
      const float l_prev = l_s[r];
      float* srow = S + r * L::LDS;
      float mx = NEG_INF;
      for (int c = half * 32; c < half * 32 + 32; ++c) {
        const int kpos = k0 + c;
        float v = srow[c];
        if (kpos >= a.Tk || (a.causal && kpos > qpos)) v = NEG_INF;
        srow[c] = v;
        mx = fmaxf(mx, v);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = half * 32; c < half * 32 + 32; ++c) {
        const float p = expf(srow[c] - m_new);
        sum += p;
        srow[c] = p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      const float alpha = expf(m_prev - m_new);
      float* orow = O + r * L::LDO;
      for (int d = half * (D / 2); d < half * (D / 2) + D / 2; ++d) orow[d] *= alpha;
      __syncwarp();
      if (half == 0) {
        m_s[r] = m_new;
        l_s[r] = l_prev * alpha + sum;
      }
    }
    __syncthreads();

    for (int i = tid; i < BQ * D; i += THREADS) {
      const int rr = i / D, d = i % D;
      const float* pr = S + rr * L::LDS;
      float acc = O[rr * L::LDO + d];
#pragma unroll 16
      for (int c = 0; c < BK; ++c) acc = fmaf(pr[c], Vs[c * L::LDT + d], acc);
      O[rr * L::LDO + d] = acc;
    }
  }
  __syncthreads();

  float* out = static_cast<float*>(a.out);
  for (int i = tid; i < BQ * D; i += THREADS) {
    const int rr = i / D, d = i % D;
    const int tq = q0 + rr;
    if (tq < a.Tq) {
      out[(((long long)b * a.Tq + tq) * a.H + h) * D + d] = O[rr * L::LDO + d] / fmaxf(l_s[rr], 1e-30f);
    }
  }
  if (tid < BQ && q0 + tid < a.Tq) {
    a.lse[((long long)b * a.H + h) * a.Tq + q0 + tid] = m_s[tid] + logf(fmaxf(l_s[tid], 1e-30f));
  }
}

template <int D>
int launch(const Args& a, int B, int is_bf16, cudaStream_t stream) {
  auto kernel = is_bf16 ? flash_fwd_mma_kernel<D> : flash_fwd_f32_kernel<D>;
  const size_t bytes = is_bf16 ? MmaLayout<D>::bytes : F32Layout<D>::bytes;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.Tq + BQ - 1) / BQ, a.H, B);
  kernel<<<grid, THREADS, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dml_flash_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                             int is_bf16, int B, int H, int G, int Tq, int Tk, int D,
                             long long qsb, long long qst, long long qsh,
                             long long ksb, long long kst, long long ksh,
                             long long vsb, long long vst, long long vsh,
                             float scale, int causal, void* stream) {
  if (B <= 0 || Tq <= 0) return 0;
  Args a{q, k, v, out, static_cast<float*>(lse), H, G, Tq, Tk,
         qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh, scale, causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(a, B, is_bf16, s);
    case 32: return launch<32>(a, B, is_bf16, s);
    case 64: return launch<64>(a, B, is_bf16, s);
    case 128: return launch<128>(a, B, is_bf16, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
