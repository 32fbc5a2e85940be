// Flash attention forward: the Hopper counterpart of the TPU kernel
// dml_tpu/ops/flash_attention.py::_fwd_kernel.
//
// q [B, Tq, H, d], k and v [B, Tk, KV, d] (BTHD, read through strides so
// no transpose copy is made; KV divides H and query head h reads kv head
// h / (H / KV), which is jnp.repeat's mapping in generate.prefill) ->
// out [B, Tq, H, d] in q's dtype and lse [B, H, Tq] f32. Every head dim
// d >= 1 and every group H / KV, as the TPU kernel (a full-d block) takes
// them: up to 256 on a native width (below), past it on the chunked route
// (column chunks over a grid axis, "D > 256" below).
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
// Head dims: the wgmma kernel is instantiated at D = 64, 128 and 256
// (hopper.cuh::wgmma_head_dim), the mma.sync and tf32 kernels at D = 16,
// 32, 48, 64, 80, 96, 128 and 256 (hopper.cuh::native_head_dim), the
// widths of real geometries (48: a D-96 model's speculative draft; 80:
// Phi-2; 96: Phi-3-mini and the cluster LM bench's ShardLM; 256:
// Gemma-2B); bf16 d 8-48 (the drafts: the 198M LM's 32, ShardLM's and
// Phi-3-mini's 48, Phi-2's 40) runs the wgmma kernel at 64. A head dim d
// runs on the least D >= d of its route: tile
// columns at d and beyond are loaded as zeros (the caller's scale is of
// the true d, and zero columns leave Q K^T and P V unchanged, so the
// result is exact), and output columns past d are never written. Rows are
// read in 16-byte chunks, so a row must hold a whole number of them: the
// wrapper pads a head dim that does not (bf16 d % 8, f32 d % 4) with zero
// columns in its copy. Such a d stays off the wgmma route, whose TMA store
// of out (d wide) needs whole 16-byte rows.
//
// Routes, picked from the dtype and d alone:
//
// - bf16, 8 <= d <= 256, d % 8 == 0 (every main-path shape, the public
//   LMs' 80, 96 and 256, and the drafts' 8-48 at 64): flash_fwd_wgmma_kernel
//   at D 64, 128 or 256. One
//   block per (q-tile, head, batch) of a producer warpgroup and NC consumer
//   warpgroups of 64 query rows each: at D 64 NC = 3 (192-row q-tiles) when
//   that still gives four waves of blocks, NC = 1 (64-row q-tiles, twice
//   the blocks of NC = 2, two blocks an SM) where two-consumer blocks would
//   fill less than one wave (the drafts' small prefills), else 2 (128-row
//   q-tiles; always at D 128 and 256). One thread of warpgroup 0 is the producer: it loads the Q
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
//   three consumers, 216 and 40 with one). D = 128 is two 64-column sub-tiles per tile (a
//   128-byte swizzle row holds 64 bf16): S steps its descriptors across
//   them, P V issues one 64-column product per sub-tile. D = 256 is four,
//   over k-tiles of 64 keys (S m64n64), so that Q (64 KB) and two stages
//   of K and V (32 KB each) fit one block: there the first consumer skips
//   the causal k-tile wholly past its rows.
// - bf16, d % 8 != 0: flash_fwd_mma_kernel<D>, the first Hopper
//   version: one block of 4 warps per 64-row q-tile, synchronous tile
//   loads, mma.sync m16n8k16 with S, P and O in registers, V transposed in
//   shared memory. Q's fragments stay in registers up to D 128; at D 256
//   the O accumulator takes 128 registers a thread, so they are read from
//   the shared Q tile at each step instead. dml_flash_fwd's route MMA_SYNC
//   runs it at any d up to 256 so one card can time it beside the wgmma route.
// - float32: flash_fwd_tf32_kernel<D>, the mma.sync kernel's plan with
//   every product in split TF32 (hopper.cuh: three m16n8k8 TF32 products
//   a float32 one, held to the JAX package's float32 bars): 64-row
//   q-tiles, K and V in two stages by cp.async (the next k-tile's copy in
//   flight during this one's products), S and O in registers, P taken
//   straight from the S accumulator as A fragments (its columns in the
//   order 0, 2, 4, 6, 1, 3, 5, 7, with V's rows read in the same order, so
//   no transpose and no shuffle). k-tiles of 64 keys, 32 at D 256 (O takes
//   128 registers a thread there). Bound: the split's three products at
//   495 TFLOP/s (165 TFLOP/s of float32 work; the published dense rates of
//   an NVIDIA H100 80GB HBM3 at 700.00 W); the splits (integer rounding
//   and a subtraction an operand element, every warp splitting the K and
//   V fragments it reads) and the softmax's expf share the warps' issue
//   slots with the mma.sync. There: ShardLM's [4,300,4,96] 0.03873 ms,
//   4.3% of that bound, 0.38x SDPA; 0.2220 ms on the FMA kernel this
//   replaced (PERF.md §6).
// - d > 256: the chunked routes, d at run time: a grid axis over 256-column
//   chunks of the output, each block reducing S over all of d. bf16 on
//   wg::flash_fwd_wgmma_wide_kernel<CS> (wgmma + TMA, Q and K streamed in
//   64-column sub-tiles, a thread-block cluster of CS blocks splitting a
//   block's k-tiles where the grid is small; "bf16, D > 256" below), float32
//   on flash_fwd_tf32_wide_kernel ("f32, D > 256").
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
// The Hopper building blocks (mbarriers, TMA, wgmma descriptors and forms,
// tensor maps, clusters, the head dims) live in hopper.cuh, shared with
// the backward's sources.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;        // query rows per block (mma.sync)
constexpr int BK = 64;        // key rows per k-tile (mma.sync)
constexpr int THREADS = 128;  // 4 warps; warp w owns query rows [16w, 16w + 16)
constexpr float NEG_INF = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;
  int H, G, Tq, Tk;
  int d;  // the head dim; the kernel's D is the native width >= d
  long long qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh;
  float scale;
  int causal;
};

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

// This warp's A fragment of columns [16 kk, 16 kk + 16) of a row-major
// shared tile whose 16 rows start at `rows` (row stride `ld`).
__device__ __forceinline__ void a_frag(uint32_t* a, const __nv_bfloat16* rows, int ld, int kk, int g,
                                       int t) {
  const __nv_bfloat16* base = rows + 16 * kk + 2 * t;
  a[0] = ld32(base + g * ld);
  a[1] = ld32(base + (g + 8) * ld);
  a[2] = ld32(base + g * ld + 8);
  a[3] = ld32(base + (g + 8) * ld + 8);
}

template <int D>
struct MmaLayout {
  static constexpr int LDK = D + 8;   // Q and K tiles, row-major
  static constexpr int LDV = BK + 8;  // V tile transposed: [D, 64]
  static constexpr size_t bytes = sizeof(__nv_bfloat16) * (size_t)(BQ * LDK + BK * LDK + D * LDV);
};

// W columns of V's k-tile at k0 (from vp, row stride vst; columns at d
// and beyond and rows at Tk and beyond zero), transposed into Vt [W, 64]
// (row stride LDV): thread i takes key i % 64 and 8 consecutive columns.
template <int W, int LDV>
__device__ __forceinline__ void load_vt(__nv_bfloat16* Vt, const __nv_bfloat16* vp, long long vst, int k0,
                                        int Tk, int d) {
  for (int i = threadIdx.x; i < BK * (W / 8); i += THREADS) {
    const int key = i % BK, c = (i / BK) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (k0 + key < Tk && c < d) val = *reinterpret_cast<const uint4*>(vp + (long long)(k0 + key) * vst + c);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
    for (int j = 0; j < 8; ++j) Vt[(c + j) * LDV + key] = e[j];
  }
}

// The online softmax on this warp's S tile (16 rows x BN keys from k0):
// scale, mask, the row max over the 4 threads of a row, p = exp(s - m_new)
// left in s, l = l * alpha + sum p, and O's W columns rescaled by alpha.
template <int W, int BN = BK>
__device__ __forceinline__ void online_softmax(float (*s)[4], float (*o)[4], float* m, float* l,
                                               const int* row, int k0, int t, const Args& a) {
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int nt = 0; nt < BN / 8; ++nt) {
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
  for (int nt = 0; nt < BN / 8; ++nt) {
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
  for (int j = 0; j < W / 8; ++j) {
    o[j][0] *= alpha[0];
    o[j][1] *= alpha[0];
    o[j][2] *= alpha[1];
    o[j][3] *= alpha[1];
  }
}

// O += P V over W columns: P (bf16, as the TPU kernel casts it) straight
// from the S accumulators into A fragments, 16 keys at a time, V^T from Vt.
template <int W, int LDV>
__device__ __forceinline__ void pv_product(float (*o)[4], const float (*s)[4], const __nv_bfloat16* Vt, int g,
                                           int t) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint32_t pa[4] = {
        pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
        pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
        pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
    for (int j = 0; j < W / 8; ++j) {
      const __nv_bfloat16* vr = Vt + (8 * j + g) * LDV + 16 * kk + 2 * t;
      mma16816(o[j], pa, ld32(vr), ld32(vr + 8));
    }
  }
}

// O / l into columns [c0, c0 + W) of this thread's two rows (none at d and
// beyond) of out in T, and the lse where c0 is 0.
template <int W, typename T = __nv_bfloat16>
__device__ __forceinline__ void store_rows(const float (*o)[4], const float* m, const float* l, const int* row,
                                           int c0, int b, int h, int t, const Args& a) {
  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= a.Tq) continue;
    const float inv_l = 1.f / fmaxf(l[r], 1e-30f);
    T* orow = out + (((long long)b * a.Tq + row[r]) * a.H + h) * a.d;
#pragma unroll
    for (int j = 0; j < W / 8; ++j)
      hopper::store_pair(orow, c0 + 8 * j + 2 * t, a.d, o[j][2 * r] * inv_l, o[j][2 * r + 1] * inv_l);
    if (t == 0 && c0 == 0) a.lse[((long long)b * a.H + h) * a.Tq + row[r]] = m[r] + logf(fmaxf(l[r], 1e-30f));
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_mma_kernel(Args a) {
  using L = MmaLayout<D>;
  using bf16 = __nv_bfloat16;
  // Q's fragments in registers up to D 128; at D 256 O takes 128 registers
  // a thread and the fragments are read from the shared Q tile
  constexpr bool QREG = D <= 128;
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

  load_tile<bf16, D, BQ>(Qs, L::LDK, qp, a.qst, q0, a.Tq, a.d);
  __syncthreads();
  const bf16* qrows = Qs + 16 * warp * L::LDK;
  uint32_t qf[QREG ? D / 16 : 1][4];  // this warp's 16 query rows as A fragments
  if constexpr (QREG) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) a_frag(qf[kk], qrows, L::LDK, kk, g, t);
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
    load_tile<bf16, D, BK>(Ks, L::LDK, kp, a.kst, k0, a.Tk, a.d);
    load_vt<D, L::LDV>(Vt, vp, a.vst, k0, a.Tk, a.d);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys: 8 tiles of 16x8
    float s[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4];
      if constexpr (QREG) {
        qa[0] = qf[kk][0], qa[1] = qf[kk][1], qa[2] = qf[kk][2], qa[3] = qf[kk][3];
      } else {
        a_frag(qa, qrows, L::LDK, kk, g, t);
      }
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
        const bf16* kr = Ks + (8 * nt + g) * L::LDK + 16 * kk + 2 * t;
        mma16816(s[nt], qa, ld32(kr), ld32(kr + 8));
      }
    }
    online_softmax<D>(s, o, m, l, row, k0, t, a);
    pv_product<D, L::LDV>(o, s, Vt, g, t);
  }
  store_rows<D>(o, m, l, row, 0, b, h, t, a);
}

// ---------------------------------------------------- f32: split TF32

// The float32 kernel at width D: 64 query rows a block (4 warps of 16),
// k-tiles of BN keys in two stages, rows of D + 4 floats (hopper.cuh's
// split-TF32 section). At D 256 the O accumulator takes 128 registers a
// thread, so the k-tiles are 32 keys (S in 16) and Q with two stages of K
// and V is 200 KB.
template <int D>
struct Tf32Layout {
  static constexpr int BN = D > 128 ? 32 : 64;
  static constexpr int LD = D + 4;
  static constexpr size_t bytes = sizeof(float) * (size_t)(BQ + 2 * 2 * BN) * LD;  // Q; K and V a stage
};
static_assert(Tf32Layout<256>::bytes <= hopper::SMEM_PER_BLOCK && Tf32Layout<128>::bytes <= hopper::SMEM_PER_BLOCK,
              "a float32 forward block passes 227 KB");

// K's and V's k-tile at k0 into one stage (K, then V, BN rows each).
template <int D, int BN>
__device__ __forceinline__ void load_kv_f32(float* stage, const float* kp, const float* vp, int k0, const Args& a) {
  constexpr int LD = D + 4;
  hopper::load_f32_async<BN, D, THREADS>(stage, LD, kp, a.kst, k0, a.Tk, a.d);
  hopper::load_f32_async<BN, D, THREADS>(stage + BN * LD, LD, vp, a.vst, k0, a.Tk, a.d);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1) flash_fwd_tf32_kernel(Args a) {
  using L = Tf32Layout<D>;
  constexpr int BN = L::BN, LD = L::LD;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* stages = Qs + BQ * LD;  // stage s: K at stages + 2 s BN LD, V BN LD after it

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / a.G;
  const int q0 = qt * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const float* qp = static_cast<const float*>(a.q) + b * a.qsb + h * a.qsh;
  const float* kp = static_cast<const float*>(a.k) + b * a.ksb + kvh * a.ksh;
  const float* vp = static_cast<const float*>(a.v) + b * a.vsb + kvh * a.vsh;

  int n_tiles = (a.Tk + BN - 1) / BN;
  if (a.causal) n_tiles = min(n_tiles, (q0 + BQ - 1) / BN + 1);  // skip tiles above the diagonal

  hopper::load_f32_async<BQ, D, THREADS>(Qs, LD, qp, a.qst, q0, a.Tq, a.d);
  if (n_tiles > 0) load_kv_f32<D, BN>(stages, kp, vp, 0, a);
  hopper::cp_async_commit();

  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const int row[2] = {q0 + 16 * warp + g, q0 + 16 * warp + g + 8};

  for (int kt = 0; kt < n_tiles; ++kt) {
    // the next k-tile's copy in flight during this one's products
    if (kt + 1 < n_tiles) load_kv_f32<D, BN>(stages + ((kt + 1) & 1) * 2 * BN * LD, kp, vp, (kt + 1) * BN, a);
    hopper::cp_async_commit();
    hopper::cp_async_wait<1>();
    __syncthreads();
    const float* Ks = stages + (kt & 1) * 2 * BN * LD;
    float s[BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    hopper::product_abt<D, BN>(s, Qs + 16 * warp * LD, LD, Ks, LD, g, t);
    online_softmax<D, BN>(s, o, m, l, row, kt * BN, t, a);
    hopper::product_cb<D, BN>(o, s, Ks + BN * LD, LD, g, t);  // O += P V, P in float32
    __syncthreads();  // every warp is done with this stage before k-tile kt + 2 lands in it
  }
  hopper::cp_async_wait<0>();
  store_rows<D, float>(o, m, l, row, 0, b, h, t, a);
}

// The mma.sync kernel (bf16) or the split-TF32 kernel (float32) at native
// width D, one block a 64-row q-tile.
template <int D>
int launch(const Args& a, int B, int is_bf16, cudaStream_t stream) {
  auto kernel = is_bf16 ? flash_fwd_mma_kernel<D> : flash_fwd_tf32_kernel<D>;
  const size_t bytes = is_bf16 ? MmaLayout<D>::bytes : Tf32Layout<D>::bytes;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.Tq + BQ - 1) / BQ, a.H, B);
  kernel<<<grid, THREADS, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// ------------------------------------------------ f32, D > 256: column chunks
//
// Past the widest native width no block holds a whole row of D: the O
// accumulator alone would be D / 2 float32 registers a thread (mma.sync)
// and a 64-row f32 tile at D 1024 is 256 KB. A grid axis splits the
// output's columns into chunks of CHUNK = 256 (the last cut at d); the
// block of chunk j reduces S = Q K^T over the whole of d in column slices
// of Q and K staged through shared memory (so shared memory is bounded at
// every d), runs the online softmax on it and P V over its own chunk of
// V's columns only. Every chunk of a q-tile computes S, m and l with the
// same arithmetic in the same order, so they agree bit for bit; the first
// chunk writes the lse. The cost is S computed once per chunk. bf16 takes
// the same plan on wgmma + TMA (wg::flash_fwd_wgmma_wide_kernel below).

constexpr int CHUNK = 256;      // output columns a block of the chunked routes owns

// Float32, d > 256: split TF32 (hopper.cuh):
// S over d in slices of TF32_SLICE columns of Q and K, each slice's S
// added in float32 (hopper.cuh::slice_product: chained over all of d, out
// and lse at d 1000 came within 10% of the 2e-5 bar), two stages, the
// next slice's copy in flight during a slice's products; the block's
// chunk of the V tile lands during S. k-tiles of 16 keys: O takes 128
// registers a thread, and ptxas spilled at 32 and 64 keys (as it did with
// __maxnreg__(255), a fence between the products or a partial unroll).
struct Tf32WideLayout {
  static constexpr int BN = 16;  // keys a k-tile: S in 8 registers beside O's 128
  static constexpr int SLICES = hopper::tf32_slice_floats<BN, 1>();
  static constexpr int LDV = CHUNK + 4;  // the block's chunk of the V tile
  static constexpr size_t bytes = sizeof(float) * (size_t)(SLICES + BN * LDV);
};
static_assert(Tf32WideLayout::bytes <= hopper::SMEM_PER_BLOCK, "one block of the chunked route at every d");

__global__ void __launch_bounds__(THREADS, 1) flash_fwd_tf32_wide_kernel(Args a) {
  using L = Tf32WideLayout;
  extern __shared__ __align__(128) unsigned char smem[];
  float* slices = reinterpret_cast<float*>(smem);
  float* Vs = slices + L::SLICES;

  const int n_cc = (a.d + CHUNK - 1) / CHUNK;
  const int qt = blockIdx.x / n_cc, c0 = (blockIdx.x % n_cc) * CHUNK;  // output columns [c0, c0 + CHUNK)
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / a.G;
  const int q0 = qt * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const float* qp = static_cast<const float*>(a.q) + b * a.qsb + h * a.qsh;
  const float* kp = static_cast<const float*>(a.k) + b * a.ksb + kvh * a.ksh;
  const float* vp = static_cast<const float*>(a.v) + b * a.vsb + kvh * a.vsh;

  float o[CHUNK / 8][4];
#pragma unroll
  for (int j = 0; j < CHUNK / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const int row[2] = {q0 + 16 * warp + g, q0 + 16 * warp + g + 8};

  constexpr int BN = L::BN;
  int n_tiles = (a.Tk + BN - 1) / BN;
  if (a.causal) n_tiles = min(n_tiles, (q0 + BQ - 1) / BN + 1);  // skip tiles above the diagonal

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();  // every warp is done with the previous tile's V
    hopper::load_f32_async<BN, CHUNK, THREADS>(Vs, L::LDV, vp + c0, a.vst, k0, a.Tk, a.d - c0);
    hopper::cp_async_commit();
    float s[BN / 8][4];
    hopper::tf32_products_by_slices<BN, 1, THREADS>(s, nullptr, slices, qp, nullptr, a.qst, 0, q0, a.Tq, kp,
                                                    nullptr, a.kst, 0, k0, a.Tk, a.d, warp, g, t);
    online_softmax<CHUNK, BN>(s, o, m, l, row, k0, t, a);
    hopper::product_cb<CHUNK, BN>(o, s, Vs, L::LDV, g, t);  // over this block's chunk
  }
  store_rows<CHUNK, float>(o, m, l, row, c0, b, h, t, a);
}

// The float32 chunked route: one launch, ceil(d / CHUNK) blocks a q-tile.
int launch_wide(const Args& a, int B, cudaStream_t stream) {
  auto kernel = flash_fwd_tf32_wide_kernel;
  const size_t bytes = Tf32WideLayout::bytes;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.Tq + BQ - 1) / BQ * ((a.d + CHUNK - 1) / CHUNK), a.H, B);
  kernel<<<grid, THREADS, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// ------------------------------------- bf16, D 8 to 256: wgmma + TMA

namespace wg {

using namespace hopper;

// Shape of one block at width D (64, 128 or 256; a head dim d runs on the
// least of them >= d, the tensor maps' innermost extent d, so the columns
// past d arrive as zeros and TMA stores clip at d) with NC consumer
// warpgroups of 64 query rows each (warpgroup 0 produces). NC = 3 puts
// three consumer warps on each SM sub-partition, which hides more of the
// softmax's latency than two, but makes 192-row q-tiles: fewer blocks, so
// a short grid ends in a ragged wave. NC = 1 (D 64 only) makes 64-row
// q-tiles, twice NC = 2's blocks, for grids that fill less than one wave
// of two-consumer blocks: there a consumer has the SM's exponential units
// to itself. D = 128 and 256 take NC = 2 (their O accumulators need the
// registers). Registers after setmaxnreg: 128 * P + 128 * NC * C <= the
// block's at entry, 65536 (one block an SM) at NC 2 and 3; NC = 1 is
// compiled for two blocks an SM (MIN_BLOCKS), 128 registers a thread at
// entry, so 128 * P + 128 * C <= 32768, which leaves a consumer more than
// NC = 3's 160 (its shared memory, 105 KB, also fits twice in an SM's 228).
template <int D, int NC>
struct Smem {
  static_assert(NC == 2 || (D == 64 && (NC == 1 || NC == 3)), "NC 1 and 3 are D 64's forms");
  static constexpr int BQ = 64 * NC;  // query rows per block
  // key rows per k-tile: 128, but 64 at D 256, where K and V tiles of 128
  // rows (64 KB each a stage) beside Q's 64 KB would pass 227 KB at two
  // stages; S is then m64n64 (32 registers) and P 16 packed
  static constexpr int BK = D == 256 ? 64 : 128;
  static constexpr int THREADS = 128 * (NC + 1);
  static constexpr int MIN_BLOCKS = NC == 1 ? 2 : 1;  // __launch_bounds__'s blocks an SM
  static constexpr int PRODUCER_REGS = NC == 3 ? 32 : 40;
  static constexpr int CONSUMER_REGS = NC == 3 ? 160 : NC == 1 ? 216 : 232;
  // K/V ring depth: 3 at D = 64 (96 KB of tiles), 2 at D = 128 (128 KB;
  // a third stage there fits but timed slower on the H100) and at 256
  static constexpr int STAGES = D == 64 ? 3 : 2;
  static constexpr int SUBS = D / 64;            // 64-column sub-tiles per tile
  static constexpr int KSUB = BK * ROW_BYTES;    // one K/V sub-tile: BK rows of 64 bf16 (128 B)
  static constexpr int TILE = SUBS * KSUB;       // one K or V tile
  static constexpr int QSUB = BQ * ROW_BYTES;    // one 64-column sub-tile of Q
  static constexpr int Q = 0;
  static constexpr int K = Q + SUBS * QSUB;      // + stage * TILE
  static constexpr int V = K + STAGES * TILE;    // + stage * TILE
  static constexpr int BAR = V + STAGES * TILE;  // mbarriers: q, k[S], v[S], empty[S]
  static constexpr int bytes = BAR + 8 * (1 + 3 * STAGES) + 1024;  // + slack for 1024-B alignment
};

// D 256: Q 64 KB + K and V 2 x 32 KB each = 192 KB of tiles (197,688 bytes
// with the barriers and the alignment slack); a consumer holds O in 128
// f32 registers (four m64n64 accumulators), S in 32 and P in 16.
static_assert(Smem<256, 2>::bytes <= SMEM_PER_BLOCK, "the D-256 forward block passes 227 KB");
static_assert(Smem<128, 2>::bytes <= SMEM_PER_BLOCK && Smem<64, 3>::bytes <= SMEM_PER_BLOCK,
              "a forward block passes 227 KB");
// NC = 1: Q 8 KB + K and V 3 x 16 KB each = 104 KB (107,600 bytes with the
// barriers and the slack), twice in an SM's 228 KB with 1 KB reserved a block
static_assert(2 * (Smem<64, 1>::bytes + 1024) <= 228 * 1024, "two one-consumer blocks pass an SM");
static_assert(128 * (Smem<64, 1>::PRODUCER_REGS + Smem<64, 1>::CONSUMER_REGS) <=
                  65536 / Smem<64, 1>::MIN_BLOCKS,
              "the one-consumer split passes the registers a block holds at entry");

struct Params {
  float* lse;
  int H, G, Tq, Tk, n_qt;
  float scale_log2;  // scale * log2(e)
  int causal;
};

// S = Q K^T for one k-tile of BK keys: D / 16 steps of m64nBKk16, stepping
// across the 64-column sub-tiles (K's KSUB bytes apart); one commit group
// (the caller fences and waits).
template <int D, int QSUB, int BK>
__device__ __forceinline__ void issue_qk(float* s, uint32_t q_addr, uint32_t k_addr) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t step = (kk % 4) * 32;
    const uint64_t da = kmajor_desc(q_addr + (kk / 4) * QSUB + step);
    const uint64_t db = kmajor_desc(k_addr + (kk / 4) * BK * ROW_BYTES + step);
    if constexpr (BK == 128) {
      wgmma_ss_m64n128(s, da, db, kk > 0);
    } else {
      wgmma_ss_m64n64(s, da, db, kk > 0);
    }
  }
  wgmma_commit();
}

// O += P V for one k-tile: V MN-major as TMA left it, 16 keys (2048 B)
// a step, one m64n64 product per 64-column sub-tile, the first `subs` of
// them (a chunk past d holds fewer); one commit group.
template <int SUBS, int BK>
__device__ __forceinline__ void issue_pv(float (*o)[32], const uint32_t (*pa)[4], uint32_t v_addr,
                                         int subs = SUBS) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int j = 0; j < SUBS; ++j)
      if (j < subs)
        wgmma_rs_m64n64_tb(o[j], pa[kk], mnmajor_desc(v_addr + j * BK * ROW_BYTES + kk * 16 * ROW_BYTES));
  wgmma_commit();
}

// The online softmax on one S tile of BK keys, in the log2 domain: mask
// (only when asked), the row max over the 4 threads of a row, alpha =
// exp2(m - m_new), p = exp2(s * scale * log2(e) - m_new) left in s (one FMA
// and one exp2 per element), l = l * alpha + this thread's sum of p.
template <int BK, typename P>
__device__ __forceinline__ void softmax_tile(float* s, float* m, float* l, float* alpha, bool masked,
                                             int k0, int row0, int t, const P& a) {
  if (masked) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * j + 2 * t + (e & 1);
        if (key >= a.Tk || (a.causal && key > row0 + 8 * (e >> 1))) s[4 * j + e] = -INFINITY;
      }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
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
  for (int j = 0; j < BK / 8; ++j)
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
template <int BK>
__device__ __forceinline__ void pack_p(uint32_t (*pa)[4], const float* s) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

template <int D, int NC>
__global__ void __launch_bounds__(Smem<D, NC>::THREADS, Smem<D, NC>::MIN_BLOCKS)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_o, const Params a) {
  using L = Smem<D, NC>;
  constexpr int BK = L::BK;
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
          tma_load(base + L::K + s * L::TILE + j * L::KSUB, &tm_k, bar_k + 8 * s, 64 * j, kvh, k0, b);
        mbar_expect_tx(bar_v + 8 * s, L::TILE);
#pragma unroll
        for (int j = 0; j < L::SUBS; ++j)
          tma_load(base + L::V + s * L::TILE + j * L::KSUB, &tm_v, bar_v + 8 * s, 64 * j, kvh, k0, b);
      }
    }
  } else {
    // ------------------------------------------------------------ consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(L::CONSUMER_REGS));
    const int c = tid / 128 - 1;  // rows [64c, 64c + 64) of the q-tile
    const int tw = tid % 128, warp = tw / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
    const int first = q0 + 64 * c;             // this consumer's first row
    const int row0 = first + 16 * warp + g;  // this thread's rows: row0, row0 + 8
    const uint32_t q_addr = base + L::Q + c * 64 * ROW_BYTES;

    float o[L::SUBS][32];  // O, one m64n64 accumulator per 64-column sub-tile
    float s[BK / 2];       // S, then P: one m64nBK accumulator
#pragma unroll
    for (int j = 0; j < L::SUBS; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[j][i] = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
    float m[2] = {NEG_INF, NEG_INF};  // running max, log2 domain
    float l[2] = {0.f, 0.f};          // this thread's share of the row sums

    // Per k-tile: S = Q K^T, the softmax, O += P V. The consumers drift
    // apart, so one's softmax overlaps another's products. With three
    // consumers, one whose rows all lie past Tq (in the last q-tile) only
    // releases the stages. With two, such a consumer (Tq <= 64 past the
    // last q0) computes on zero rows that the store clips: the NC == 3
    // tests compile away there, as they slowed its loop. With 64-key
    // tiles (D 256) the first consumer skips the causal tile wholly past
    // its rows; the second, which reads it, keeps the stage until V landed.
    const bool active = NC == 2 || first < a.Tq;
    mbar_wait(bar_q, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % L::STAGES;
      const uint32_t parity = (i / L::STAGES) & 1;
      mbar_wait(bar_k + 8 * st, parity);
      if (!active || (BK < 128 && a.causal && i * BK > first + 63)) {
        mbar_arrive(bar_e + 8 * st);
        continue;
      }
      fence_regs<BK / 2>(s);
      wgmma_fence();
      issue_qk<D, L::QSUB, BK>(s, q_addr, base + L::K + st * L::TILE);
      wgmma_wait<0>();
      fence_regs<BK / 2>(s);
      // a mask where some key passes this consumer's first row, or past
      // Tk; with 128-row q-tiles of 128-key tiles only the last k-tile
      // can need one
      const bool last = i == n_tiles - 1;
      const bool masked = NC == 2 && BK == 128 ? (a.causal || ragged) && last
                                               : (a.causal && i * BK + BK - 1 > first) || (ragged && last);
      float alpha[2];
      softmax_tile<BK>(s, m, l, alpha, masked, i * BK, row0, t, a);
      rescale<L::SUBS>(o, alpha);
      uint32_t pa[BK / 16][4];
      pack_p<BK>(pa, s);
      mbar_wait(bar_v + 8 * st, parity);
#pragma unroll
      for (int j = 0; j < L::SUBS; ++j) fence_regs<32>(o[j]);
      wgmma_fence();  // P and the rescaled O were written since the last products
      issue_pv<L::SUBS, BK>(o, pa, base + L::V + st * L::TILE);
      wgmma_wait<0>();
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

template <int D, int NC>
int launch(const Args& a, int B, cudaStream_t stream) {
  using L = Smem<D, NC>;
  CUtensorMap tq, tk, tv, to;
  const int KV = a.H / a.G;
  int err;
  // every map's innermost extent is d: a box's columns past it arrive as
  // zeros (and count toward the expected bytes), a store stops at it
  const int d = a.d;
  if ((err = encode_map(&tq, a.q, d, a.H, a.Tq, B, a.qsh, a.qst, a.qsb, L::BQ))) return err;
  if ((err = encode_map(&tk, a.k, d, KV, a.Tk, B, a.ksh, a.kst, a.ksb, L::BK))) return err;
  if ((err = encode_map(&tv, a.v, d, KV, a.Tk, B, a.vsh, a.vst, a.vsb, L::BK))) return err;
  // out is contiguous [B, Tq, H, d]; each consumer stores its 64 rows
  if ((err = encode_map(&to, a.out, d, a.H, a.Tq, B, d, (long long)a.H * d, (long long)a.Tq * a.H * d, 64)))
    return err;
  const int n_qt = (a.Tq + L::BQ - 1) / L::BQ;
  const Params p{a.lse, a.H, a.G, a.Tq, a.Tk, n_qt, a.scale * LOG2E, a.causal};
  auto kernel = flash_fwd_wgmma_kernel<D, NC>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes);
  if (e != cudaSuccess) return (int)e;
  if (L::MIN_BLOCKS > 1 &&  // the shared memory of two blocks an SM
      (e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                (int)cudaSharedmemCarveoutMaxShared)) != cudaSuccess)
    return (int)e;
  kernel<<<dim3(a.H, B, n_qt), L::THREADS, L::bytes, stream>>>(tq, tk, tv, to, p);
  return (int)cudaGetLastError();
}

// D = 64 takes three consumers when their 192-row q-tiles still give at
// least four waves of blocks (the B = 8 prefill: 1408 blocks on 132 SMs,
// 5% faster than two consumers); one where two-consumer blocks would fill
// less than one wave (a draft's prefill: ShardLM's [4, 300, 4] leaves 48
// blocks of two, 80 of one), else two (B = 1: three would leave 176
// blocks, 1.33 waves, and ran 10% slower). `nc` > 0 forces that form (to
// time the forms side by side; ops/flash_attention.py::wgmma_fwd_plan
// mirrors the rule).
int launch_d64(const Args& a, int B, cudaStream_t stream, int nc) {
  const int sms = sm_count();
  if (sms == 0) return (int)cudaErrorInvalidDevice;
  if (nc == 0) {
    const long long three = (long long)((a.Tq + 191) / 192) * a.H * B;
    const long long two = (long long)((a.Tq + 127) / 128) * a.H * B;
    nc = three >= 4ll * sms ? 3 : two < sms ? 1 : 2;
  }
  switch (nc) {
    case 1: return launch<64, 1>(a, B, stream);
    case 2: return launch<64, 2>(a, B, stream);
    case 3: return launch<64, 3>(a, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------- bf16, D > 256: wgmma + TMA, column chunks
//
// The chunked plan above (CHUNK = 256 output columns a block, S reduced
// over all of d by every chunk's block, the first chunk writing the lse)
// on the <256, 2> kernel's machinery: a block is one 128-row q-tile over
// two consumer warpgroups of 64 rows, one chunk of 4 64-column output
// sub-tiles (O in 4 m64n64 accumulators, 128 registers a consumer thread),
// one head and one batch, plus a TMA producer warpgroup. For each k-tile
// of the block (64 keys: S is m64n64) the producer streams the 64-column
// sub-tiles of Q (both consumers' rows) and K through a ring of
// WIDE_STAGES stages, and the k-tile's chunk of V (the block's 4
// sub-tiles) into one of two buffers. Each consumer chains S over d's
// sub-tiles (hopper.cuh::reduce_over_d), runs the online softmax in
// registers (softmax_tile) and adds P V with P from registers and V read
// MN-major, as the <256, 2> kernel does. Every chunk of a q-tile computes
// S, m and l by the same instructions in the same order, so they agree
// bit for bit. Tensor maps {d, heads, T, B} over the tensors' strides
// (GQA reads kv head h / G; rows past T and columns past d arrive as
// zeros).
//
// What bounds it: no q-tile's rows stay in shared memory (128 rows at d
// 576 are 147 KB), so every k-tile streams the q-tile's Q and the
// k-tile's K over all of d from L2 again (at MLA's D 576 about 250 KB and
// 13.6 M operations a 128 x 64 tile, 54 a byte: the tensor cores' 989
// TFLOP/s would need ~18 TB/s from L2): L2's rate, not the tensor cores',
// bounds it once the card is full, and the ring holds as many stages as
// fit beside V's buffers. S is computed once a chunk,
// (ceil(d / 256) + 1) / 2 of the minimum's operations.
//
// Small grids: where (q-tiles x chunks x heads x batch) is under
// TARGET_BLOCKS blocks, the k-tiles of a block are split over the CS
// blocks of a thread-block cluster (CS 2, 4 or 8; rank r takes k-tiles r,
// r + CS, ...; hopper.cuh::cluster_size, the busiest q-tile walking every
// k-tile; ops/flash_attention.py::wide_fwd_plan mirrors the launch). Each rank
// ends with its own (m, l, O), and they meet in distributed shared memory:
// rank r owns 128 / CS of every consumer thread's O slots, every rank
// writes those slots and its m and l into the owner's shared memory, and
// the owner rescales and adds the CS partials in rank order (no atomics:
// two runs are bit-equal). A rank with no k-tile (early causal q-tiles)
// holds m = NEG_INF, l = 0, O = 0, so its factor exp2(m - max) is 0 (or 1
// on zero sums, where no rank saw a key) and the sum stays finite. The
// first consumer skips a causal k-tile wholly past its rows (it only
// releases the stages). Out goes from registers as bf16 pairs
// (hopper.cuh::store_pair; nothing past Tq or d), so an odd d needs no
// store map; its loads read the wrapper's zero-padded copy.

constexpr int WIDE_NC = 2;                          // consumer warpgroups
constexpr int WIDE_THREADS = 128 * (WIDE_NC + 1);   // + the producer warpgroup
constexpr int WIDE_BQ = 64 * WIDE_NC;               // query rows a block
constexpr int WIDE_BK = 64;                         // keys a k-tile
constexpr int WIDE_SUBS = CHUNK / 64;               // output sub-tiles a block owns
constexpr int WIDE_STAGES = 6;                      // the ring: as many as fit beside V's two buffers

// Shared memory, in bytes from the 1024-aligned base: the ring (a stage is
// one sub-tile of Q's 128 rows and of K's 64), V's two chunk buffers and
// the mbarriers. A cluster's partials reuse the start once every rank is
// past its k-tiles.
struct WideSmem {
  static constexpr int QSUB = WIDE_BQ * ROW_BYTES;  // 16 KB
  static constexpr int KSUB = WIDE_BK * ROW_BYTES;  // 8 KB, and a V sub-tile
  static constexpr int STAGE = QSUB + KSUB;
  static constexpr int VBUF = WIDE_SUBS * KSUB;     // V's chunk of one k-tile: 32 KB
  static constexpr int RING = 0;                    // + stage * STAGE
  static constexpr int V = RING + WIDE_STAGES * STAGE;  // + buffer * VBUF
  static constexpr int BAR = V + 2 * VBUF;          // mbarriers: full[S], empty[S], vfull[2], vempty[2]
  static constexpr int bytes = BAR + 8 * (2 * WIDE_STAGES + 4) + 1024;  // + slack for the alignment
};
static_assert(WideSmem::bytes <= SMEM_PER_BLOCK, "the chunked wgmma forward block passes 227 KB");

// A cluster's partials in an owner's shared memory: CS ranks x 2 consumers
// x (128 / CS O slots, then m and l: 128 / CS / 4 + 1 float4) x 128 threads
constexpr int wide_partial_bytes(int cs) { return cs * WIDE_NC * (128 / cs / 4 + 1) * 128 * 16; }
static_assert(wide_partial_bytes(2) <= WideSmem::BAR && wide_partial_bytes(4) <= WideSmem::BAR &&
                  wide_partial_bytes(8) <= WideSmem::BAR,
              "a cluster's partials past the free shared memory");

struct WideParams {
  __nv_bfloat16* out;  // contiguous [B, Tq, H, d]
  float* lse;
  int H, G, Tq, Tk, d;
  int nsub;          // 64-column sub-tiles of d
  int n_cc;          // column chunks of WIDE_SUBS sub-tiles
  int n_qt;          // q-tiles of WIDE_BQ rows
  float scale_log2;  // scale * log2(e)
  int causal;
};

// Columns (col, col + 1) of rows `row` and `row + 8` of out, O / l in bf16;
// nothing past Tq or d.
__device__ __forceinline__ void store_rows2(const WideParams& a, int b, int h, int row, int col,
                                            float x0, float x1, float y0, float y1) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = row + 8 * r;
    if (rr < a.Tq)
      store_pair(a.out + (((long long)b * a.Tq + rr) * a.H + h) * a.d, col, a.d, r ? y0 : x0, r ? y1 : x1);
  }
}

template <int CS>
__global__ void __launch_bounds__(WIDE_THREADS, 1)
    flash_fwd_wgmma_wide_kernel(const __grid_constant__ CUtensorMap tm_q,
                                const __grid_constant__ CUtensorMap tm_k,
                                const __grid_constant__ CUtensorMap tm_v, const WideParams a) {
  using L = WideSmem;
  constexpr int STAGES = WIDE_STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzled tiles need 1024-B alignment
  const uint32_t bar_full = base + L::BAR, bar_empty = bar_full + 8 * STAGES;
  const uint32_t bar_vfull = bar_empty + 8 * STAGES, bar_vempty = bar_vfull + 16;  // + 8 * buffer

  const int rank = CS > 1 ? (int)cluster_ctarank() : 0;
  const int bx = blockIdx.x / CS;
  const int cc = bx % a.n_cc, h = bx / a.n_cc, b = blockIdx.y;
  const int q0 = (a.n_qt - 1 - blockIdx.z) * WIDE_BQ;  // longest causal q-tiles first
  const int kvh = h / a.G;
  int n_kt = (a.Tk + WIDE_BK - 1) / WIDE_BK;
  if (a.causal) n_kt = min(n_kt, (q0 + WIDE_BQ - 1) / WIDE_BK + 1);  // past the diagonal: never
  const int n_items = n_kt > rank ? (n_kt - 1 - rank) / CS + 1 : 0;
  const int cs0 = cc * WIDE_SUBS, csubs = min(WIDE_SUBS, a.nsub - cs0);

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, WIDE_NC * 128);  // every consumer thread releases a stage
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(bar_vfull + 8 * s, 1);
      mbar_init(bar_vempty + 8 * s, WIDE_NC * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(Smem<256, 2>::PRODUCER_REGS));
    if (tid == 0) {
      int i = 0;
      for (int n = 0; n < n_items; ++n) {
        const int k0 = (rank + n * CS) * WIDE_BK;
        for (int j = 0; j < a.nsub; ++j, ++i) {
          const int st = i % STAGES;
          if (i >= STAGES) mbar_wait(bar_empty + 8 * st, ((i / STAGES) - 1) & 1);
          const uint32_t stage = base + L::RING + st * L::STAGE, full = bar_full + 8 * st;
          mbar_expect_tx(full, L::STAGE);
          tma_load(stage, &tm_q, full, 64 * j, h, q0, b);
          tma_load(stage + L::QSUB, &tm_k, full, 64 * j, kvh, k0, b);
          if (j == 0) {
            // the k-tile's chunk of V, behind its first sub-tiles, into buffer
            // n % 2 once the consumers' P V of item n - 2 is done
            const int vb = n & 1;
            if (n >= 2) mbar_wait(bar_vempty + 8 * vb, ((n >> 1) - 1) & 1);
            mbar_expect_tx(bar_vfull + 8 * vb, csubs * L::KSUB);
            for (int s = 0; s < csubs; ++s)
              tma_load(base + L::V + vb * L::VBUF + s * L::KSUB, &tm_v, bar_vfull + 8 * vb, 64 * (cs0 + s), kvh,
                       k0, b);
          }
        }
      }
    }
    return;
  }
  // -------------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(Smem<256, 2>::CONSUMER_REGS));
  const int c = tid / 128 - 1;  // rows [64c, 64c + 64) of the q-tile
  const int tw = tid % 128, warp = tw / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  const int first = q0 + 64 * c;             // this consumer's first row
  const int row0 = first + 16 * warp + g;  // this thread's rows: row0, row0 + 8
  float o[WIDE_SUBS][32];  // O, one m64n64 accumulator per 64-column sub-tile of the chunk
  float s[32];             // S, then P: one m64n64 accumulator
#pragma unroll
  for (int j = 0; j < WIDE_SUBS; ++j)
#pragma unroll
    for (int r = 0; r < 32; ++r) o[j][r] = 0.f;
#pragma unroll
  for (int r = 0; r < 32; ++r) s[r] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};  // running max, log2 domain
  float l[2] = {0.f, 0.f};          // this thread's share of the row sums

  int i = 0;
  for (int n = 0; n < n_items; ++n) {
    const int k0 = (rank + n * CS) * WIDE_BK;
    const int vb = n & 1;
    const uint32_t vparity = (n >> 1) & 1;
    if (a.causal && k0 > first + 63) {
      // wholly past this consumer's rows: only release what the producer brought
      for (int j = 0; j < a.nsub; ++j, ++i) {
        const int st = i % STAGES;
        mbar_wait(bar_full + 8 * st, (i / STAGES) & 1);
        mbar_arrive(bar_empty + 8 * st);
      }
      mbar_wait(bar_vfull + 8 * vb, vparity);
      mbar_arrive(bar_vempty + 8 * vb);
      continue;
    }
    reduce_over_d<STAGES, L::STAGE>(s, base + L::RING, bar_full, bar_empty, c * 64 * ROW_BYTES, L::QSUB,
                                    a.nsub, i);
    // a mask where some key passes this consumer's first row, or past Tk
    const bool masked = (a.causal && k0 + WIDE_BK - 1 > first) || k0 + WIDE_BK > a.Tk;
    float alpha[2];
    softmax_tile<WIDE_BK>(s, m, l, alpha, masked, k0, row0, t, a);
    rescale<WIDE_SUBS>(o, alpha);
    uint32_t pa[WIDE_BK / 16][4];
    pack_p<WIDE_BK>(pa, s);
    mbar_wait(bar_vfull + 8 * vb, vparity);
#pragma unroll
    for (int j = 0; j < WIDE_SUBS; ++j) fence_regs<32>(o[j]);
    wgmma_fence();  // P and the rescaled O were written since the last products
    issue_pv<WIDE_SUBS, WIDE_BK>(o, pa, base + L::V + vb * L::VBUF, csubs);
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < WIDE_SUBS; ++j) fence_regs<32>(o[j]);
    mbar_arrive(bar_vempty + 8 * vb);
  }

  // A thread's O slot e (sub-tile e / 32, register r = e % 32 = 4 i2 + 2 hi
  // + lo) is row row0 + 8 hi, column 64 (cs0 + e / 32) + 8 i2 + 2t + lo.
  const bool lse_writer = cc == 0 && rank == 0 && t == 0;
  const long long lse_row = ((long long)b * a.H + h) * a.Tq;
  if constexpr (CS == 1) {
    float inv_l[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv_l[r] = 1.f / fmaxf(l[r], 1e-30f);
    }
#pragma unroll
    for (int j = 0; j < WIDE_SUBS; ++j) {
      if (j >= csubs) continue;
#pragma unroll
      for (int i2 = 0; i2 < 8; ++i2)
        store_rows2(a, b, h, row0, 64 * (cs0 + j) + 8 * i2 + 2 * t, o[j][4 * i2] * inv_l[0],
                    o[j][4 * i2 + 1] * inv_l[0], o[j][4 * i2 + 2] * inv_l[1], o[j][4 * i2 + 3] * inv_l[1]);
    }
    if (lse_writer) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (row0 + 8 * r < a.Tq) a.lse[lse_row + row0 + 8 * r] = (m[r] + log2f(fmaxf(l[r], 1e-30f))) * LN2;
    }
  } else {
    constexpr int E = 128 / CS;     // O slots a rank owns: 64, 32 or 16
    constexpr int PER = E / 4 + 1;  // float4 a (rank, consumer, thread): its O slots, then m and l
    // float4 k of rank r's partial for consumer c, thread tw: ((r NC + c) PER + k) 128 + tw
    cluster_sync();  // every rank is past its k-tiles: its shared memory is free
    uint32_t dst[CS];
#pragma unroll
    for (int ow = 0; ow < CS; ++ow) dst[ow] = map_shared_rank(base, ow);
#pragma unroll
    for (int e = 0; e < 128; e += 4) {
      const int j = e / 32, r = e % 32, ow = e / E, k4 = (e % E) / 4;
      st_cluster_v4(dst[ow] + ((((rank * WIDE_NC + c) * PER + k4) * 128 + tw) << 4), o[j][r], o[j][r + 1],
                    o[j][r + 2], o[j][r + 3]);
    }
#pragma unroll
    for (int ow = 0; ow < CS; ++ow)
      st_cluster_v4(dst[ow] + ((((rank * WIDE_NC + c) * PER + E / 4) * 128 + tw) << 4), m[0], m[1], l[0], l[1]);
    cluster_sync();
    const float4* part = reinterpret_cast<const float4*>(smem_raw + (base - raw));
    // the row max over the ranks, each rank's factor, the row sums in rank order
    float4 ml[CS];
#pragma unroll
    for (int r = 0; r < CS; ++r) ml[r] = part[((r * WIDE_NC + c) * PER + E / 4) * 128 + tw];
    float mx[2] = {ml[0].x, ml[0].y};
#pragma unroll
    for (int r = 1; r < CS; ++r) mx[0] = fmaxf(mx[0], ml[r].x), mx[1] = fmaxf(mx[1], ml[r].y);
    float f[CS][2], ls[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < CS; ++r) {
      f[r][0] = ex2(ml[r].x - mx[0]);
      f[r][1] = ex2(ml[r].y - mx[1]);
      ls[0] += f[r][0] * ml[r].z;
      ls[1] += f[r][1] * ml[r].w;
    }
    float inv_l[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      ls[r] += __shfl_xor_sync(0xffffffffu, ls[r], 1);
      ls[r] += __shfl_xor_sync(0xffffffffu, ls[r], 2);
      inv_l[r] = 1.f / fmaxf(ls[r], 1e-30f);
    }
#pragma unroll
    for (int k4 = 0; k4 < E / 4; ++k4) {
      const int e = rank * E + 4 * k4, j = e / 32, i2 = (e % 32) / 4;
      float4 sum = part[(c * PER + k4) * 128 + tw];
      sum.x *= f[0][0], sum.y *= f[0][0], sum.z *= f[0][1], sum.w *= f[0][1];
#pragma unroll
      for (int r = 1; r < CS; ++r) {
        const float4 p = part[((r * WIDE_NC + c) * PER + k4) * 128 + tw];
        sum.x += f[r][0] * p.x, sum.y += f[r][0] * p.y, sum.z += f[r][1] * p.z, sum.w += f[r][1] * p.w;
      }
      if (j < csubs)
        store_rows2(a, b, h, row0, 64 * (cs0 + j) + 8 * i2 + 2 * t, sum.x * inv_l[0], sum.y * inv_l[0],
                    sum.z * inv_l[1], sum.w * inv_l[1]);
    }
    if (lse_writer) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (row0 + 8 * r < a.Tq) a.lse[lse_row + row0 + 8 * r] = (mx[r] + log2f(fmaxf(ls[r], 1e-30f))) * LN2;
    }
  }
}

// bf16 at d > 256: one launch, grid (CS x chunks x H, B, q-tiles).
int launch_wgmma_wide(const Args& a, int B, cudaStream_t stream) {
  const int KV = a.H / a.G;
  const int nsub = (a.d + 63) / 64, n_cc = (nsub + WIDE_SUBS - 1) / WIDE_SUBS;
  const int n_qt = (a.Tq + WIDE_BQ - 1) / WIDE_BQ, n_kt = (a.Tk + WIDE_BK - 1) / WIDE_BK;
  int err;
  CUtensorMap tq, tk, tv;
  // every map's innermost extent is d: a box's columns past it arrive as
  // zeros (and count toward the expected bytes)
  if ((err = encode_map(&tq, a.q, a.d, a.H, a.Tq, B, a.qsh, a.qst, a.qsb, WIDE_BQ))) return err;
  if ((err = encode_map(&tk, a.k, a.d, KV, a.Tk, B, a.ksh, a.kst, a.ksb, WIDE_BK))) return err;
  if ((err = encode_map(&tv, a.v, a.d, KV, a.Tk, B, a.vsh, a.vst, a.vsb, WIDE_BK))) return err;
  const WideParams p{static_cast<__nv_bfloat16*>(a.out), a.lse, a.H, a.G, a.Tq, a.Tk, a.d, nsub, n_cc, n_qt,
                     a.scale * LOG2E, a.causal};
  // the busiest q-tile walks every k-tile
  const int cs = cluster_size((long long)n_qt * n_cc * a.H * B, n_kt);
  const dim3 grid(cs * n_cc * a.H, B, n_qt);  // a cluster: the cs consecutive blocks of one (chunk, head)
  constexpr int T = WIDE_THREADS, M = WideSmem::bytes;
  switch (cs) {
    case 1: return launch_cluster(flash_fwd_wgmma_wide_kernel<1>, 1, grid, T, M, stream, tq, tk, tv, p);
    case 2: return launch_cluster(flash_fwd_wgmma_wide_kernel<2>, 2, grid, T, M, stream, tq, tk, tv, p);
    case 4: return launch_cluster(flash_fwd_wgmma_wide_kernel<4>, 4, grid, T, M, stream, tq, tk, tv, p);
    default: return launch_cluster(flash_fwd_wgmma_wide_kernel<8>, 8, grid, T, M, stream, tq, tk, tv, p);
  }
}

}  // namespace wg

// route: AUTO (the rule above, the wrappers' only route), MMA_SYNC (the
// mma.sync kernel at every bf16 d <= 256) or n > 0 (the width-64 wgmma
// kernel with n consumer warpgroups whatever the grid): the last two let
// one card time a route or a form beside the one the rule picks.
constexpr int MMA_SYNC = -1, AUTO = 0;

int dispatch(const Args& a, int B, int is_bf16, int route, cudaStream_t s) {
  if (route < MMA_SYNC || (route > AUTO && (!is_bf16 || hopper::wgmma_head_dim(a.d) != 64)))
    return (int)cudaErrorInvalidValue;
  if (is_bf16 && a.d > hopper::WIDEST_NATIVE)  // the chunked wgmma kernel, no other form
    return route == AUTO ? wg::launch_wgmma_wide(a, B, s) : (int)cudaErrorInvalidValue;
  if (is_bf16 && route != MMA_SYNC) {
    switch (hopper::wgmma_head_dim(a.d)) {
      case 64: return wg::launch_d64(a, B, s, route);
      case 128: return wg::launch<128, 2>(a, B, s);
      case 256: return wg::launch<256, 2>(a, B, s);
      default: break;  // d % 8 != 0
    }
  }
  switch (hopper::native_head_dim(a.d)) {
    case 16: return launch<16>(a, B, is_bf16, s);
    case 32: return launch<32>(a, B, is_bf16, s);
    case 48: return launch<48>(a, B, is_bf16, s);
    case 64: return launch<64>(a, B, is_bf16, s);
    case 80: return launch<80>(a, B, is_bf16, s);
    case 96: return launch<96>(a, B, is_bf16, s);
    case 128: return launch<128>(a, B, is_bf16, s);
    case 256: return launch<256>(a, B, is_bf16, s);
    default: return a.d > hopper::WIDEST_NATIVE ? launch_wide(a, B, s)  // float32
                                                : (int)cudaErrorInvalidValue;  // d < 1
  }
}

}  // namespace

// The kernel for (dtype, D): wgmma + TMA for bf16 at 8 <= D <= 256 with D
// a multiple of 8, as the TMA store of out needs rows of whole 16-byte
// units (at width 64, 128 or 256, the least >= D), mma.sync for bf16 at
// every other D up to 256, split TF32 for float32, each at the native
// width >= D up to 256, and past it the chunked routes (bf16 on wgmma +
// TMA, AUTO only); `route` as dispatch takes it, AUTO on the wrappers'
// path (cudaErrorInvalidValue at D < 1, or a route the dtype and D do not
// take).
extern "C" int dml_flash_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                             int is_bf16, int B, int H, int G, int Tq, int Tk, int D,
                             long long qsb, long long qst, long long qsh,
                             long long ksb, long long kst, long long ksh,
                             long long vsb, long long vst, long long vsh,
                             float scale, int causal, void* stream, int route) {
  if (B <= 0 || Tq <= 0) return 0;
  Args a{q, k, v, out, static_cast<float*>(lse), H, G, Tq, Tk, D,
         qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh, scale, causal};
  return dispatch(a, B, is_bf16, route, static_cast<cudaStream_t>(stream));
}
