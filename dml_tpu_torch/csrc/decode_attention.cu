// Decode-step attention over the KV cache: the Hopper counterpart of the
// TPU kernel dml_tpu/ops/decode_attention.py::_decode_kernel.
//
// q [B, 1, H, D] (f32 or bf16) attends the head-major cache
// [B, KV, T, D] (bf16, f32, or int8 with f32 scales [B, KV, 1, T]);
// slot b sees cache rows t <= pos[b]. H = KV * G with kv-major head order
// (head h = kv * G + g). Output f32 [B, 1, H, D].
//
// Numerics: f32 throughout. Cache elements widen exactly (bf16 and int8
// are exact in f32). For an int8 cache the K scale multiplies the score
// after the dot and the V scale folds into the probability row, as the
// TPU kernel does; the running denominator sums the probabilities before
// the V scale is folded in. No dequantized cache is ever written.
//
// Bound: device-memory bytes. A step reads each valid cache row once
// (2 * B * KV * (pos + 1) * D * itemsize bytes, plus 8 bytes of scales
// per row for int8) and does 4 * G operations per cache element, about
// 8 per byte at GQA-4 bf16, far below the ~295 where compute would bind.
//
// Work split: the TPU kernel folds every kv head of a slot into one
// program, because per-program overhead dominated there. On an H100,
// B * KV programs (32 at B=8, GQA-4) would leave most of the 132 SMs
// idle, so T is split across blocks as well: block (split, kv, b) takes
// at most 128 rows, [split * chunk, min((split + 1) * chunk, pos[b] + 1)),
// and writes a partial (o, m, l); blocks past pos[b] write an empty
// partial and read nothing. A second small kernel merges the partials of
// each (b, head) with the online-softmax rule: M = max m_s,
// L = sum l_s exp(m_s - M), out = sum o_s exp(m_s - M) / max(L, 1e-30).
//
// Inside a block (128 threads): the block's K and V rows are copied into
// shared memory with 16-byte loads issued all at once (a decode step is
// bound by how many bytes are in flight, so no thread waits on one row
// before asking for the next); rows are padded by 16 bytes so that the
// 16-byte reads of the next step hit distinct banks. Then thread r
// computes row r's scores for all G heads, each warp softmaxes the score
// rows of its heads, and threads split (row group, D) to accumulate P V
// from shared memory, reduced across row groups.
//
// Plain C interface for ctypes; launches on the caller's stream and
// returns cudaGetLastError() so a refused launch raises in the wrapper.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int ROWS = 128;  // cache rows per block at most
constexpr int WARPS = THREADS / 32;
constexpr int MAX_G = 16;  // query heads per kv head
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float widen(int8_t x) { return static_cast<float>(x); }

// 16 bytes of cache -> 16 / sizeof(T) floats, exactly
__device__ __forceinline__ void unpack(const uint4& u, float* out, const float*) {
  out[0] = __uint_as_float(u.x);
  out[1] = __uint_as_float(u.y);
  out[2] = __uint_as_float(u.z);
  out[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float* out, const __nv_bfloat16*) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    out[2 * j] = f.x;
    out[2 * j + 1] = f.y;
  }
}
__device__ __forceinline__ void unpack(const uint4& u, float* out, const int8_t*) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int j = 0; j < 16; ++j) out[j] = static_cast<float>(static_cast<int8_t>(w[j / 4] >> (8 * (j % 4))));
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* ks;  // [B, KV, 1, T] or null
  const float* vs;
  const int* pos;   // [B]
  float* o_part;    // [B, KV, n_split, G, D]
  float* m_part;    // [B, KV, n_split, G]
  float* l_part;
  int KV, G, T, D, chunk, n_split, q_is_bf16;
  float scale;
};

__host__ __device__ constexpr int row_bytes(int D, int elem) { return D * elem + 16; }

template <typename TC>
__global__ void __launch_bounds__(THREADS) decode_partial_kernel(Args a) {
  constexpr int EPV = 16 / sizeof(TC);  // cache elements per 16 bytes
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = a.G, D = a.D;
  const int rb = row_bytes(D, sizeof(TC));
  const int vecs = D / EPV;  // 16-byte vectors per cache row
  unsigned char* Ks = smem;                                  // [ROWS] padded rows
  unsigned char* Vs = Ks + ROWS * rb;                        // [ROWS] padded rows
  float* qs = reinterpret_cast<float*>(Vs + ROWS * rb);      // [G, D]
  float* sc = qs + G * D;                                    // [G, ROWS]
  float* red = sc + G * ROWS;                                // [THREADS / D, G, D]

  const int split = blockIdx.x, kv = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int H = a.KV * G;
  const long long part = ((long long)b * a.KV + kv) * a.n_split + split;
  const int t0 = split * a.chunk;
  const int n = min(min(t0 + a.chunk, a.T), a.pos[b] + 1) - t0;

  if (n <= 0) {  // every row of this split is past pos[b]
    for (int i = tid; i < G * D; i += THREADS) a.o_part[part * G * D + i] = 0.f;
    if (tid < G) {
      a.m_part[part * G + tid] = NEG_INF;
      a.l_part[part * G + tid] = 0.f;
    }
    return;
  }

  // this block's K and V rows (contiguous in the cache) -> shared memory
  const long long plane = ((long long)b * a.KV + kv) * a.T;  // row index of (b, kv, t=0)
  const unsigned char* kg =
      static_cast<const unsigned char*>(a.k) + (plane + t0) * D * (long long)sizeof(TC);
  const unsigned char* vg =
      static_cast<const unsigned char*>(a.v) + (plane + t0) * D * (long long)sizeof(TC);
  for (int i = tid; i < n * vecs; i += THREADS) {
    const int r = i / vecs, c = i % vecs;
    const uint4 ku = *reinterpret_cast<const uint4*>(kg + (long long)i * 16);
    const uint4 vu = *reinterpret_cast<const uint4*>(vg + (long long)i * 16);
    *reinterpret_cast<uint4*>(Ks + r * rb + c * 16) = ku;
    *reinterpret_cast<uint4*>(Vs + r * rb + c * 16) = vu;
  }
  const long long q_off = ((long long)b * H + (long long)kv * G) * D;
  for (int i = tid; i < G * D; i += THREADS) {
    qs[i] = a.q_is_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.q)[q_off + i])
                        : static_cast<const float*>(a.q)[q_off + i];
  }
  __syncthreads();

  // scores: thread r takes row r, all G heads
  if (tid < n) {
    float acc[MAX_G];
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) acc[g] = 0.f;
    const unsigned char* row = Ks + tid * rb;
    for (int c = 0; c < vecs; ++c) {
      float kd[EPV];
      unpack(*reinterpret_cast<const uint4*>(row + c * 16), kd, static_cast<const TC*>(nullptr));
#pragma unroll
      for (int j = 0; j < EPV; ++j) {
        const float* qd = qs + c * EPV + j;
#pragma unroll
        for (int g = 0; g < MAX_G; ++g)
          if (g < G) acc[g] = fmaf(qd[g * D], kd[j], acc[g]);
      }
    }
    const float kscale = a.ks ? a.ks[plane + t0 + tid] : 1.f;
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) {
      if (g < G) {
        float s = acc[g] * a.scale;
        if (a.ks) s *= kscale;
        sc[g * ROWS + tid] = s;
      }
    }
  }
  __syncthreads();

  // softmax over this block's rows, one head's row per warp at a time
  for (int g = warp; g < G; g += WARPS) {
    float* srow = sc + g * ROWS;
    float mx = NEG_INF;
    for (int i = lane; i < n; i += 32) mx = fmaxf(mx, srow[i]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int i = lane; i < n; i += 32) {
      const float p = expf(srow[i] - mx);
      sum += p;
      srow[i] = a.vs ? p * a.vs[plane + t0 + i] : p;  // fold the V scale into P
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      a.m_part[part * G + g] = mx;
      a.l_part[part * G + g] = sum;
    }
  }
  __syncthreads();

  // P V: thread (grp, d) takes rows grp, grp + NG, ...
  const int NG = THREADS / D;
  const int d = tid % D, grp = tid / D;
  float acc[MAX_G];
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) acc[g] = 0.f;
  const unsigned char* vcol = Vs + d * sizeof(TC);
  for (int i = grp; i < n; i += NG) {
    const float vd = widen(*reinterpret_cast<const TC*>(vcol + i * rb));
#pragma unroll
    for (int g = 0; g < MAX_G; ++g)
      if (g < G) acc[g] = fmaf(sc[g * ROWS + i], vd, acc[g]);
  }
#pragma unroll
  for (int g = 0; g < MAX_G; ++g)
    if (g < G) red[(grp * G + g) * D + d] = acc[g];
  __syncthreads();
  for (int i = tid; i < G * D; i += THREADS) {
    float o = 0.f;
    for (int j = 0; j < NG; ++j) o += red[j * G * D + i];
    a.o_part[part * G * D + i] = o;
  }
}

// One block per (b, head), one thread per element of D.
__global__ void decode_merge_kernel(const float* o_part, const float* m_part,
                                    const float* l_part, float* out, int H, int G,
                                    int n_split, int D) {
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kv = h / G, g = h % G;
  const int KV = H / G;
  const int d = threadIdx.x;
  const long long base = ((long long)b * KV + kv) * n_split;
  float M = NEG_INF;
  for (int s = 0; s < n_split; ++s) M = fmaxf(M, m_part[(base + s) * G + g]);
  float L = 0.f, O = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float w = expf(m_part[(base + s) * G + g] - M);
    L = fmaf(l_part[(base + s) * G + g], w, L);
    O = fmaf(o_part[((base + s) * G + g) * D + d], w, O);
  }
  out[(long long)bh * D + d] = O / fmaxf(L, 1e-30f);
}

template <typename TC>
int launch(const Args& a, int B, float* out, cudaStream_t stream) {
  const size_t bytes = 2 * (size_t)ROWS * row_bytes(a.D, sizeof(TC)) +
                       sizeof(float) * ((size_t)a.G * a.D + (size_t)a.G * ROWS +
                                        (size_t)THREADS * a.G);
  auto kernel = decode_partial_kernel<TC>;
  if (bytes > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(a.n_split, a.KV, B);
  kernel<<<grid, THREADS, bytes, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_merge_kernel<<<B * a.KV * a.G, a.D, 0, stream>>>(a.o_part, a.m_part, a.l_part, out,
                                                          a.KV * a.G, a.G, a.n_split, a.D);
  return (int)cudaGetLastError();
}

}  // namespace

// cache_kind: 0 = f32, 1 = bf16, 2 = int8 (ks and vs required)
extern "C" int dml_decode_attention(const void* q, const void* k, const void* v,
                                    const void* ks, const void* vs, const void* pos,
                                    void* o_part, void* m_part, void* l_part, void* out,
                                    int cache_kind, int q_is_bf16, int B, int KV, int G, int T,
                                    int D, int chunk, int n_split, float scale, void* stream) {
  if (B <= 0) return 0;
  if (G < 1 || G > MAX_G || (D != 16 && D != 32 && D != 64 && D != 128) || chunk < 1 ||
      chunk > ROWS)
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, static_cast<const float*>(ks), static_cast<const float*>(vs),
         static_cast<const int*>(pos), static_cast<float*>(o_part),
         static_cast<float*>(m_part), static_cast<float*>(l_part),
         KV, G, T, D, chunk, n_split, q_is_bf16, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  switch (cache_kind) {
    case 0: a.ks = a.vs = nullptr; return launch<float>(a, B, o, s);
    case 1: a.ks = a.vs = nullptr; return launch<__nv_bfloat16>(a, B, o, s);
    case 2:
      if (!a.ks || !a.vs) return (int)cudaErrorInvalidValue;
      return launch<int8_t>(a, B, o, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
