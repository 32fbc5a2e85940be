// Flash attention forward: the Hopper counterpart of the TPU kernel
// dml_tpu/ops/flash_attention.py::_fwd_kernel.
//
// q [B, Tq, H, D], k and v [B, Tk, KV, D] (BTHD, read through strides so
// no transpose copy is made; KV divides H and query head h reads kv head
// h / (H / KV), which is jnp.repeat's mapping in generate.prefill) ->
// out [B, Tq, H, D] in q's dtype and lse [B, H, Tq] f32.
//
// What every route computes, in the TPU kernel's order: S = Q K^T * scale
// in f32; columns at Tk and beyond and, if causal, columns past the row's
// position are masked (the TPU kernel's -1e30 sentinel); the online
// softmax in f32 (m_new = max(m, rowmax S), p = exp(S - m_new), alpha =
// exp(m - m_new), l = l * alpha + sum p, with l summed from the unrounded
// p); P cast to V's dtype for P V, as the TPU kernel does; at the end out
// = O / max(l, 1e-30) and lse = m + log(l) in natural-log units (the
// backward and the ring-attention merge read it). Causal k-tiles wholly
// above the diagonal are never visited. The TPU kernel carries m, l and O
// in scratch across its sequential innermost grid axis; here one block
// loops over the k-tiles itself and keeps them in registers.
//
// Routes, picked from the dtype and D alone:
//
// - bf16, D 64 or 128 (every main-path shape): flash_fwd_wgmma_kernel. One
//   block per (q-tile, head, batch) of a producer warpgroup and NC consumer
//   warpgroups of 64 query rows each: NC = 3 (192-row q-tiles) at D 64 when
//   that still gives four waves of blocks, else 2 (128-row q-tiles; always
//   at D 128). One thread of warpgroup 0 is the producer: it loads the Q
//   tile once and streams 128-row K and V tiles through a ring in shared
//   memory (3 stages at D 64, 2 at D 128) with TMA (cp.async.bulk.tensor
//   over 4-d tensor maps {D, heads, T, B} built from the tensors' strides,
//   so the prefill's strided v needs no copy, GQA reads kv head h / G, and
//   rows past T arrive as zeros); each stage has "full" mbarriers (K and V
//   apart, completed by the copies' byte counts) and an "empty" one the
//   consumers release after P V. Each consumer computes S = Q K^T for its
//   64 rows by wgmma m64n128k16 with both operands in shared memory
//   (K-major, the 128-byte swizzle TMA writes); the softmax in registers in
//   the log2 domain (exp2 of one FMA, scale * log2(e) folded in; lse
//   converted back to natural units); P packed from the S accumulator
//   straight into wgmma A registers (the accumulator's per-warp layout is
//   mma.sync's: rows 16w+g and 16w+g+8, columns 8j+2t and 8j+2t+1); O += P
//   V by wgmma m64n64k16 with P from registers and V read MN-major as TMA
//   left it (the transpose bit; no transposed copy). Only k-tiles that
//   cross a consumer's first row (causal) or Tk (the last one when Tk % 128
//   != 0) test a mask; the others skip the test. Q-tiles run longest first.
//   The epilogue writes O / l as bf16 into the consumer's own Q rows in the
//   swizzled layout and stores it with one TMA store per 64 columns (rows
//   past Tq are clipped); lse comes from one thread per row. setmaxnreg
//   gives the consumers 232 registers and the producer 40 (160 and 32 with
//   three consumers). D = 128 is two 64-column sub-tiles per tile (a
//   128-byte swizzle row holds 64 bf16): S steps its descriptors across
//   them, P V issues one 64-column product per sub-tile.
// - bf16, D 16 or 32: flash_fwd_mma_kernel, the first Hopper version:
//   one block of 4 warps per 64-row q-tile, synchronous tile loads,
//   mma.sync m16n8k16 with S, P and O in registers, V transposed in
//   shared memory. dml_flash_fwd_mma runs it at any D so one card can
//   time it beside the wgmma route.
// - float32: flash_fwd_f32_kernel, plain FMAs with the tiles and the
//   accumulator in shared memory.
//
// Bound: tensor-core operations at the prefill shape. 4 * B * H * Tq *
// Tk * D operations (halved for causal) against 2 * (q + k + v + out)
// bytes: at [8, 2048, 16, 64] bf16 that is 68.7 GFLOP over 85 MB, about
// 800 operations per byte, above the ~295 where the H100's bf16 tensor
// cores (989 TFLOP/s dense) and not its 3.35 TB/s memory are the limit.
// At D = 64 the softmax (an exp2, an FMA, a max, an add per score, a
// conversion per pair; the exponentials alone at 16 a cycle per SM take as
// long as a tile's two products) outweighs the tensor-core work, so this
// design keeps loads off the consumers (the producer's TMA) and lets the
// consumer warpgroups overlap one's softmax with another's wgmma.
// Overlapping a warpgroup's softmax with its own P V (S of the next tile
// issued early) measured slower with this code: ptxas serialized it
// (C7519, warpgroup.arrive injected).
//
// Plain C interface for ctypes; launches on the caller's stream and
// returns cudaGetLastError() (or 10000 + the CUresult of
// cuTensorMapEncodeTiled when a tensor map cannot be encoded) so a
// refused launch raises in the wrapper. That function is looked up at run
// time (cudaGetDriverEntryPoint), so the library links no libcuda.

#include <cuda.h>
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


// ------------------------------------------ bf16, D 64 / 128: wgmma + TMA

namespace wg {

constexpr int BK = 128;               // key rows per k-tile
constexpr int SUB_BYTES = 128 * 128;  // one K/V sub-tile: 128 rows of 64 bf16 (128 B)
constexpr int ROW_BYTES = 128;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Shape of one block for head dim D with NC consumer warpgroups of 64
// query rows each (warpgroup 0 produces). NC = 3 puts three consumer warps
// on each SM sub-partition, which hides more of the softmax's latency than
// two, but makes 192-row q-tiles: fewer blocks, so a short grid ends in a
// ragged wave. D = 128 takes NC = 2 (its O accumulator needs the
// registers). Registers after setmaxnreg: 128 * P + 128 * NC * C <= 65536.
template <int D, int NC>
struct Smem {
  static constexpr int BQ = 64 * NC;  // query rows per block
  static constexpr int THREADS = 128 * (NC + 1);
  static constexpr int PRODUCER_REGS = NC == 3 ? 32 : 40;
  static constexpr int CONSUMER_REGS = NC == 3 ? 160 : 232;
  // K/V ring depth: 3 at D = 64 (96 KB of tiles), 2 at D = 128 (128 KB;
  // a third stage there fits but timed slower on the H100)
  static constexpr int STAGES = D == 64 ? 3 : 2;
  static constexpr int SUBS = D / 64;            // 64-column sub-tiles per tile
  static constexpr int TILE = SUBS * SUB_BYTES;  // one K or V tile
  static constexpr int QSUB = BQ * ROW_BYTES;    // one 64-column sub-tile of Q
  static constexpr int Q = 0;
  static constexpr int K = Q + SUBS * QSUB;      // + stage * TILE
  static constexpr int V = K + STAGES * TILE;    // + stage * TILE
  static constexpr int BAR = V + STAGES * TILE;  // mbarriers: q, k[S], v[S], empty[S]
  static constexpr int bytes = BAR + 8 * (1 + 3 * STAGES) + 1024;  // + slack for 1024-B alignment
};

struct Params {
  float* lse;
  int H, G, Tq, Tk, n_qt;
  float scale_log2;  // scale * log2(e)
  int causal;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait for the completion of the barrier's phase of parity `parity`. A
// pipeline fault that would wait forever traps after ~2^32 cycles (about
// two seconds), so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long start = 0;
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > (1ll << 32)) {
      __trap();
    }
  }
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                         int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a tile in TMA's 128-byte swizzle:
// start address, leading and stride byte offsets (all >> 4), layout type
// 1 (128B swizzle) in bits 62-63. Tiles sit 1024-B aligned, so the base
// offset field stays 0; stepping along K inside a 128-byte row adds to the
// start address (32 B per 16 bf16), as the swizzle is applied to address
// bits.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// K-major (Q and K: D contiguous): 8-row groups 1024 B apart; the leading
// offset is unused under the swizzle.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) { return sw128_desc(addr, 16, 1024); }

// MN-major (V read as the B operand of P V: keys are K, D is N and
// contiguous): groups of 8 keys 1024 B apart. Each product covers one
// 64-column sub-tile, a single swizzle atom along N, so the offset between
// atoms along N is never stepped; both offsets are 1024.
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t addr) { return sw128_desc(addr, 1024, 1024); }

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving accumulator accesses across the
// asynchronous wgmma's issue and wait.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}


__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d[64] (+)= A B for one k16 step, m64n128k16 bf16 -> f32, A and B both
// K-major in shared memory; scale_d = 0 starts the sum from zero.
__device__ __forceinline__ void wgmma_ss_m64n128(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[32] += A B for one k16 step, m64n64k16 bf16 -> f32, A (bf16 pairs in
// the accumulator's row/column layout) from registers, B MN-major in shared
// memory (imm-trans-b = 1).
__device__ __forceinline__ void wgmma_rs_m64n64_tb(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// S = Q K^T for one k-tile: D / 16 steps of m64n128k16, stepping across
// the 64-column sub-tiles; one commit group (the caller fences and waits).
template <int D, int QSUB>
__device__ __forceinline__ void issue_qk(float* s, uint32_t q_addr, uint32_t k_addr) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t step = (kk % 4) * 32;
    wgmma_ss_m64n128(s, kmajor_desc(q_addr + (kk / 4) * QSUB + step),
                     kmajor_desc(k_addr + (kk / 4) * SUB_BYTES + step), kk > 0);
  }
  wgmma_commit();
}

// O += P V for one k-tile: V MN-major as TMA left it, 16 keys (2048 B)
// a step, one m64n64 product per 64-column sub-tile; one commit group.
template <int SUBS>
__device__ __forceinline__ void issue_pv(float (*o)[32], const uint32_t (*pa)[4], uint32_t v_addr) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int j = 0; j < SUBS; ++j)
      wgmma_rs_m64n64_tb(o[j], pa[kk], mnmajor_desc(v_addr + j * SUB_BYTES + kk * 16 * ROW_BYTES));
  wgmma_commit();
}

// The online softmax on one S tile, in the log2 domain: mask (only when
// asked: the last tile), the row max over the 4 threads of a row, alpha =
// exp2(m - m_new), p = exp2(s * scale * log2(e) - m_new) left in s (one FMA
// and one exp2 per element), l = l * alpha + this thread's sum of p.
__device__ __forceinline__ void softmax_tile(float* s, float* m, float* l, float* alpha, bool masked,
                                             int k0, int row0, int t, const Params& a) {
  if (masked) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * j + 2 * t + (e & 1);
        if (key >= a.Tk || (a.causal && key > row0 + 8 * (e >> 1))) s[4 * j + e] = -INFINITY;
      }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  float neg_m[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r] * a.scale_log2);  // m stays finite: no NaN
    alpha[r] = ex2(m[r] - m_new);
    m[r] = m_new;
    neg_m[r] = -m_new;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = ex2(fmaf(s[4 * j + e], a.scale_log2, neg_m[e >> 1]));
      s[4 * j + e] = p;
      sum[e >> 1] += p;
    }
  l[0] = l[0] * alpha[0] + sum[0];
  l[1] = l[1] * alpha[1] + sum[1];
}

template <int SUBS>
__device__ __forceinline__ void rescale(float (*o)[32], const float* alpha) {
#pragma unroll
  for (int j = 0; j < SUBS; ++j)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      o[j][4 * i] *= alpha[0];
      o[j][4 * i + 1] *= alpha[0];
      o[j][4 * i + 2] *= alpha[1];
      o[j][4 * i + 3] *= alpha[1];
    }
}

// P in bf16 (as the TPU kernel casts it) as A registers, 16 keys a step:
// the S accumulator's fragment of keys 16kk..16kk+15 is the A fragment.
__device__ __forceinline__ void pack_p(uint32_t (*pa)[4], const float* s) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

template <int D, int NC>
__global__ void __launch_bounds__(Smem<D, NC>::THREADS, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_o, const Params a) {
  using L = Smem<D, NC>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzled tiles need 1024-B alignment
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bar_q = base + L::BAR;
  const uint32_t bar_k = bar_q + 8;                // + 8 * stage
  const uint32_t bar_v = bar_k + 8 * L::STAGES;       // + 8 * stage
  const uint32_t bar_e = bar_v + 8 * L::STAGES;       // + 8 * stage

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (a.n_qt - 1 - blockIdx.z) * L::BQ;  // longest causal q-tiles first
  const int kvh = h / a.G;
  int n_tiles = (a.Tk + BK - 1) / BK;
  if (a.causal) n_tiles = min(n_tiles, (q0 + L::BQ - 1) / BK + 1);  // past the diagonal: never
  const bool ragged = (a.Tk % BK) != 0;

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
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(L::PRODUCER_REGS));
    if (tid == 0) {
      mbar_expect_tx(bar_q, L::SUBS * L::QSUB);
#pragma unroll
      for (int j = 0; j < L::SUBS; ++j) tma_load(base + L::Q + j * L::QSUB, &tm_q, bar_q, 64 * j, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % L::STAGES;
        if (i >= L::STAGES) mbar_wait(bar_e + 8 * s, ((i / L::STAGES) - 1) & 1);
        const int k0 = i * BK;
        mbar_expect_tx(bar_k + 8 * s, L::TILE);
#pragma unroll
        for (int j = 0; j < L::SUBS; ++j)
          tma_load(base + L::K + s * L::TILE + j * SUB_BYTES, &tm_k, bar_k + 8 * s, 64 * j, kvh, k0, b);
        mbar_expect_tx(bar_v + 8 * s, L::TILE);
#pragma unroll
        for (int j = 0; j < L::SUBS; ++j)
          tma_load(base + L::V + s * L::TILE + j * SUB_BYTES, &tm_v, bar_v + 8 * s, 64 * j, kvh, k0, b);
      }
    }
  } else {
    // ------------------------------------------------------------ consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(L::CONSUMER_REGS));
    const int c = tid / 128 - 1;  // rows [64c, 64c + 64) of the q-tile
    const int tw = tid % 128, warp = tw / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
    const int row0 = q0 + 64 * c + 16 * warp + g;  // this thread's rows: row0, row0 + 8
    const uint32_t q_addr = base + L::Q + c * 64 * ROW_BYTES;

    float o[L::SUBS][32];  // O, one m64n64 accumulator per 64-column sub-tile
    float s[64];           // S, then P: one m64n128 accumulator
#pragma unroll
    for (int j = 0; j < L::SUBS; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[j][i] = 0.f;
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = 0.f;
    float m[2] = {NEG_INF, NEG_INF};  // running max, log2 domain
    float l[2] = {0.f, 0.f};          // this thread's share of the row sums

    // Per k-tile: S = Q K^T, the softmax, O += P V. The consumers drift
    // apart, so one's softmax overlaps another's products. With three
    // consumers, one whose rows all lie past Tq (in the last q-tile) only
    // releases the stages. With two, such a consumer (Tq <= 64 past the
    // last q0) computes on zero rows that the store clips: the NC == 3
    // tests compile away there, as they slowed its loop.
    const bool active = NC == 2 || q0 + 64 * c < a.Tq;
    mbar_wait(bar_q, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % L::STAGES;
      const uint32_t parity = (i / L::STAGES) & 1;
      mbar_wait(bar_k + 8 * st, parity);
      if (!active) {
        mbar_arrive(bar_e + 8 * st);
        continue;
      }
      fence_regs<64>(s);
      wgmma_fence();
      issue_qk<D, L::QSUB>(s, q_addr, base + L::K + st * L::TILE);
      wgmma_wait0();
      fence_regs<64>(s);
      // a mask where some key passes this consumer's first row, or past
      // Tk; with 128-row q-tiles only the last k-tile can need one
      const bool last = i == n_tiles - 1;
      const bool masked = NC == 2 ? (a.causal || ragged) && last
                                  : (a.causal && i * BK + BK - 1 > q0 + 64 * c) || (ragged && last);
      float alpha[2];
      softmax_tile(s, m, l, alpha, masked, i * BK, row0, t, a);
      rescale<L::SUBS>(o, alpha);
      uint32_t pa[8][4];
      pack_p(pa, s);
      mbar_wait(bar_v + 8 * st, parity);
#pragma unroll
      for (int j = 0; j < L::SUBS; ++j) fence_regs<32>(o[j]);
      wgmma_fence();  // P and the rescaled O were written since the last products
      issue_pv<L::SUBS>(o, pa, base + L::V + st * L::TILE);
      wgmma_wait0();
#pragma unroll
      for (int j = 0; j < L::SUBS; ++j) fence_regs<32>(o[j]);
      mbar_arrive(bar_e + 8 * st);
    }

    if (!active) return;
    // epilogue: the row sums over the 4 threads of a row, O / l as bf16
    // into this consumer's own Q rows (no longer read) in the swizzled
    // layout, one TMA store per sub-tile; rows past Tq are clipped
    float inv_l[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv_l[r] = 1.f / fmaxf(l[r], 1e-30f);
    }
    unsigned char* o_smem = smem + L::Q + c * 64 * ROW_BYTES;
#pragma unroll
    for (int j = 0; j < L::SUBS; ++j)
#pragma unroll
      for (int i2 = 0; i2 < 8; ++i2)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int rl = 16 * warp + g + 8 * r;  // row within the consumer's 64
          const int byte = j * L::QSUB + rl * ROW_BYTES + ((i2 ^ (rl & 7)) << 4) + 4 * t;
          *reinterpret_cast<uint32_t*>(o_smem + byte) =
              pack_bf16(o[j][4 * i2 + 2 * r] * inv_l[r], o[j][4 * i2 + 2 * r + 1] * inv_l[r]);
        }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
    if (tw == 0) {
#pragma unroll
      for (int j = 0; j < L::SUBS; ++j)
        tma_store(&tm_o, q_addr + j * L::QSUB, 64 * j, h, q0 + 64 * c, b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
    if (t == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        if (row < a.Tq) a.lse[((long long)b * a.H + h) * a.Tq + row] = (m[r] + log2f(fmaxf(l[r], 1e-30f))) * LN2;
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;  // looked up at run time: no -lcuda
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                        cudaEnableDefault, &status);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    if (err == cudaSuccess && status == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-d map {D, heads, T, B} over a bf16 BTHD tensor with element strides
// (sh, st, sb), read or written in boxes of 64 columns x `rows` rows of
// one head, 128-byte swizzled. T is the tensor's own length, so rows past
// it read as zeros (and are not written). Returns 0 or 10000 + CUresult.
int encode_map(CUtensorMap* map, const void* ptr, int d, int heads, int t, int b, long long sh,
               long long st, long long sb, int rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads, (cuuint64_t)t, (cuuint64_t)b};
  cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)st * 2, (cuuint64_t)sb * 2};
  // a dimension of size 1 is never stepped, but its stride must still be
  // a legal one (a multiple of 16 B, not 0): the span of the dims inside
  cuuint64_t span = (cuuint64_t)d * 2;
  for (int i = 1; i < 4; ++i) {
    if (dims[i] == 1) strides[i - 1] = span;
    span = strides[i - 1] * dims[i];
  }
  cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
                      elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 10000 + (int)r;
}

template <int D, int NC>
int launch(const Args& a, int B, cudaStream_t stream) {
  using L = Smem<D, NC>;
  CUtensorMap tq, tk, tv, to;
  const int KV = a.H / a.G;
  int err;
  if ((err = encode_map(&tq, a.q, D, a.H, a.Tq, B, a.qsh, a.qst, a.qsb, L::BQ))) return err;
  if ((err = encode_map(&tk, a.k, D, KV, a.Tk, B, a.ksh, a.kst, a.ksb, BK))) return err;
  if ((err = encode_map(&tv, a.v, D, KV, a.Tk, B, a.vsh, a.vst, a.vsb, BK))) return err;
  // out is contiguous [B, Tq, H, D]; each consumer stores its 64 rows
  if ((err = encode_map(&to, a.out, D, a.H, a.Tq, B, D, (long long)a.H * D, (long long)a.Tq * a.H * D, 64)))
    return err;
  const int n_qt = (a.Tq + L::BQ - 1) / L::BQ;
  const Params p{a.lse, a.H, a.G, a.Tq, a.Tk, n_qt, a.scale * LOG2E, a.causal};
  auto kernel = flash_fwd_wgmma_kernel<D, NC>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3(a.H, B, n_qt), L::THREADS, L::bytes, stream>>>(tq, tk, tv, to, p);
  return (int)cudaGetLastError();
}

// D = 64 takes three consumers when their 192-row q-tiles still give at
// least four waves of blocks (the B = 8 prefill: 1408 blocks on 132 SMs,
// 5% faster than two consumers), else two (B = 1: three would leave 176
// blocks, 1.33 waves, and ran 10% slower).
int launch_d64(const Args& a, int B, cudaStream_t stream) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (long long)((a.Tq + 191) / 192) * a.H * B;
  return blocks >= 4ll * sms ? launch<64, 3>(a, B, stream) : launch<64, 2>(a, B, stream);
}

}  // namespace wg

int dispatch(const Args& a, int B, int D, int is_bf16, bool wgmma, cudaStream_t s) {
  if (is_bf16 && wgmma && D == 64) return wg::launch_d64(a, B, s);
  if (is_bf16 && wgmma && D == 128) return wg::launch<128, 2>(a, B, s);
  switch (D) {
    case 16: return launch<16>(a, B, is_bf16, s);
    case 32: return launch<32>(a, B, is_bf16, s);
    case 64: return launch<64>(a, B, is_bf16, s);
    case 128: return launch<128>(a, B, is_bf16, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int flash_fwd(const void* q, const void* k, const void* v, void* out, void* lse, int is_bf16, int B,
              int H, int G, int Tq, int Tk, int D, long long qsb, long long qst, long long qsh,
              long long ksb, long long kst, long long ksh, long long vsb, long long vst,
              long long vsh, float scale, int causal, void* stream, bool wgmma) {
  if (B <= 0 || Tq <= 0) return 0;
  Args a{q, k, v, out, static_cast<float*>(lse), H, G, Tq, Tk,
         qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh, scale, causal};
  return dispatch(a, B, D, is_bf16, wgmma, static_cast<cudaStream_t>(stream));
}

}  // namespace

// The kernel for (dtype, D): wgmma + TMA for bf16 at D 64 and 128,
// mma.sync for bf16 at D 16 and 32, FMAs for float32.
extern "C" int dml_flash_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                             int is_bf16, int B, int H, int G, int Tq, int Tk, int D,
                             long long qsb, long long qst, long long qsh,
                             long long ksb, long long kst, long long ksh,
                             long long vsb, long long vst, long long vsh,
                             float scale, int causal, void* stream) {
  return flash_fwd(q, k, v, out, lse, is_bf16, B, H, G, Tq, Tk, D, qsb, qst, qsh, ksb, kst, ksh, vsb,
                   vst, vsh, scale, causal, stream, true);
}

// The same call on the mma.sync kernel at every bf16 D (float32 as above),
// so one card can time the two routes side by side.
extern "C" int dml_flash_fwd_mma(const void* q, const void* k, const void* v, void* out, void* lse,
                                 int is_bf16, int B, int H, int G, int Tq, int Tk, int D,
                                 long long qsb, long long qst, long long qsh,
                                 long long ksb, long long kst, long long ksh,
                                 long long vsb, long long vst, long long vsh,
                                 float scale, int causal, void* stream) {
  return flash_fwd(q, k, v, out, lse, is_bf16, B, H, G, Tq, Tk, D, qsb, qst, qsh, ksb, kst, ksh, vsb,
                   vst, vsh, scale, causal, stream, false);
}
