// Decode-step attention over the KV cache: the Hopper counterpart of the
// TPU kernel dml_tpu/ops/decode_attention.py::_decode_kernel.
//
// q [B, 1, H, D] (f32 or bf16, contiguous)
// attends the head-major cache [B, KV, T, D] (bf16, f32, or int8 with f32
// scales [B, KV, 1, T]); slot b sees cache rows t <= pos[b]. H = KV * G
// with kv-major head order (head h = kv * G + g). Output f32 [B, 1, H, D].
// Every head dim D >= 1 and every group G, as the TPU kernel takes them (it
// asks only that KV divide H); past a row of 256, decode_wide_kernel
// (below).
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
// A decode step is a pure stream, so what sets its speed is how many
// bytes are in flight from the first cycle, and how few launches it takes.
//
// decode_kernel, one launch per step (dml_decode_attention):
//
// - Work split. The TPU kernel folds every kv head of a slot into one
//   program; on an H100 B * KV programs (32 at B=8, GQA-4) would leave
//   most of the 132 SMs idle, so T is split as well, and the G query heads
//   of a kv head are cut into n_hc chunks of at most 16 (gc heads each,
//   the last one fewer): block (split, kv * n_hc + chunk, b) owns rows
//   [split * chunk_rows, min((split + 1) * chunk_rows, pos[b] + 1)) of its
//   (b, kv) plane for its chunk's heads: n contiguous rows of K and of V.
//   The chunks of one plane read the same rows, the first from memory, the
//   others mostly from L2. The wrapper sizes the row chunk by bytes (at
//   most 64 KB of K + V, a multiple of SUB = 32 rows) and the grid so that
//   every block is resident at once where the step's bytes fit the SMs'
//   shared memory (ops/decode_attention.py::split_plan). Blocks wholly past
//   pos[b] return before they load anything.
// - Loads. Where a cache row is a multiple of 16 bytes (D * itemsize;
//   every f32 D % 4 == 0, bf16 D % 8 == 0 and int8 D % 16 == 0), thread 0
//   initialises one mbarrier per K and per V sub-tile of 32 rows and issues
//   each sub-tile as a 1-D bulk copy (cp.async.bulk, completing on the
//   sub-tile's barrier by its byte count) into its own slot of shared
//   memory: the first `ahead` (2 from the wrapper) at block start, then
//   sub-tile j + ahead before the block waits on sub-tile j, so no thread
//   waits on a load before asking for the next. Two sub-tiles in flight per
//   block (32 KB of K + V at bf16 D 64) rather than the whole chunk at
//   once: an SM serves its copies in issue order, so with everything issued
//   at block start the last resident block gets its first rows only after
//   the others' last ones and computes its whole chunk after the stream has
//   ended (an `ahead` as large as a chunk, which issues it all at once,
//   measured slower: PERF.md). The last sub-tile is sized by n, so no row
//   past pos[b] is ever read. Other rows (an odd D, int8 at D 8 or 40) make
//   spans that start and end inside a 16-byte unit, which a bulk copy
//   cannot take: there the block's threads copy its span before they
//   compute, in 16-byte words over its aligned interior and bytes at its
//   two ends, into shared memory at the same offset modulo 16 (`pre`).
//   int8 scale rows (4 bytes each) are bulk-copied over their
//   16-byte-aligned interior at block start; the at most three rows at
//   either ragged end are loaded by hand.
// - Math. A cache row is read at its native width DP = 16, 32, 64, 128 or
//   256 (the least power of two >= D), by one of two kernels sharing one
//   body: decode_kernel<DP> where D = DP >= 64, with D and the row's bytes
//   at compile time (the main path's D 64), and decode_general_kernel<DP>
//   for any other D, decided at run time, whose general code would
//   otherwise cost the first one registers and its speed: LPR lanes split
//   it into slices of LEL elements (16 bytes of f32 or bf16, 8 of int8, or
//   two such vectors at f32 DP 256), and the lanes or elements past D read
//   element 0 of the row with a zero q, so they add nothing to a score and
//   write no output. Rows whose D is not a multiple of the vector are read
//   element by element. The four warps split into ceil(gn / GT) head
//   groups of GT = 32 / LEL query heads (8 for f32 up to DP 128, 4
//   otherwise); the warps of a group take turns over the passes of NRP =
//   32 / LPR rows through the chunk. In a pass, each lane holds its slice
//   of the GT query rows in registers, pre-scaled by scale * log2(e).
//   Scores: per-lane partial dots reduced by __shfl_xor_sync over the
//   row's lanes. Softmax: online and per lane, in log2 units (ex2), over
//   the rows that lane's row group sees, two rows at a time, with lazy
//   rescaling: the running max moves only when a score passes it by more
//   than RESCALE = 8, so p <= 2^8 and the accumulator is rarely rescaled.
//   P V: each lane accumulates its slice of its heads' output rows from V
//   vectors. Rows past n read row 0 and are masked, so the loop has no
//   branch around its shuffles (the warp index is broadcast from lane 0 so
//   the compiler knows it is uniform). A warp waits only on the sub-tile it
//   needs next while the later ones are still landing. At the end the row
//   groups of a warp merge by shuffles and the warps of a head group once
//   through shared memory.
// - Merge folded in. With one split of valid rows the block writes out
//   directly. Otherwise it writes its partial (o, m, l) and thread 0 takes
//   a ticket from its (b, kv, head chunk) counter (an acq_rel atomic: it
//   releases the block's partial and acquires the others'); the block that
//   draws the last ticket (only splits holding rows <= pos[b] take one)
//   merges the partials in split order, so the result does not depend on
//   the order blocks finish in, writes out, and resets the counter to 0 for
//   the next call. Partials merge by the online-softmax rule, folded one
//   split at a time (8 splits' loads in flight per thread): M = max m_s,
//   L = sum l_s 2^(m_s - M), out = sum o_s 2^(m_s - M) / max(L, 1e-30).
//   A partial is [gc, DPAD] floats (DPAD = D rounded up to 4, so it is read
//   as float4s); the plan keeps a chunk's partials within 64 KB, which that
//   one block reads.
//
// Plain C interface for ctypes; launches on the caller's stream and
// returns cudaGetLastError() so a refused launch raises in the wrapper.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int MAX_HC = 16;     // query heads per head chunk (one block's heads)
constexpr int MAX_ROW = 256;   // the widest row decode_kernel reads; past it, decode_wide_kernel
constexpr float NEG_INF = -1e30f;

// ---------------------------------------------------------------------------
// decode_kernel: one launch, bulk async loads, the merge folded in
// ---------------------------------------------------------------------------

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int SUB = 32;           // rows per bulk sub-tile
constexpr int MAX_CHUNK = 1024;   // rows per block at most (32 sub-tiles)
constexpr float RESCALE = 8.f;    // log2 units a score may pass the running max by

// Cache elements a vector load reads, their widening into floats, and one
// element alone.
template <typename TC>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int EL = 4;
  __device__ static void load(const unsigned char* p, float* f) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    f[0] = u.x, f[1] = u.y, f[2] = u.z, f[3] = u.w;
  }
  __device__ static float one(const unsigned char* p) { return *reinterpret_cast<const float*>(p); }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int EL = 8;
  __device__ static void load(const unsigned char* p, float* f) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 x = __bfloat1622float2(h[j]);
      f[2 * j] = x.x, f[2 * j + 1] = x.y;
    }
  }
  __device__ static float one(const unsigned char* p) {
    return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(p));
  }
};
template <>
struct Vec<int8_t> {
  static constexpr int EL = 8;
  __device__ static void load(const unsigned char* p, float* f) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      f[j] = static_cast<float>(static_cast<int8_t>((j < 4 ? u.x : u.y) >> (8 * (j % 4))));
  }
  __device__ static float one(const unsigned char* p) { return static_cast<float>(*reinterpret_cast<const int8_t*>(p)); }
};

// the least power of two >= d, at least 16: the row width an instance reads
__host__ __device__ constexpr int row_width(int d) {
  return d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64 : d <= 128 ? 128 : d <= 256 ? 256 : 512;
}
// elements a lane holds of a row of DP: one vector, or two at f32 DP 256
__host__ __device__ constexpr int lane_elems(int itemsize, int dp) {
  return (itemsize == 4 ? 4 : 8) > dp / 32 ? (itemsize == 4 ? 4 : 8) : dp / 32;
}
// query heads per warp: 32 floats of q and 32 of o per lane
__host__ __device__ constexpr int group_heads(int itemsize, int dp) { return 32 / lane_elems(itemsize, dp); }

// Byte offsets into the block's dynamic shared memory; every region is a
// multiple of 16 bytes. The wrapper's smem_bytes mirrors `total`.
struct Layout {
  int k, v, ks, vs, red_o, red_m, red_l, mw, red4, flag, bars, total;
};

__host__ __device__ inline Layout layout(int chunk, int D, int itemsize, bool quant) {
  const int dp = row_width(D);
  const int gt = group_heads(itemsize, dp);
  // K and V spans 128-byte aligned (a warp's row vectors then cover the
  // fewest 128-byte lines); + pre (< 16) where rows are not 16-byte units
  const int bytes = chunk * D * itemsize;
  const int span = (bytes + (D * itemsize % 16 == 0 ? 0 : 16) + 127) / 128 * 128;
  Layout L{};
  int off = 0;
  L.k = off, off += span;
  L.v = off, off += span;
  L.ks = off, off += quant ? (chunk + 4) * 4 : 0;
  L.vs = off, off += quant ? (chunk + 4) * 4 : 0;
  L.red_o = off, off += WARPS * gt * dp * 4;
  L.red_m = off, off += WARPS * gt * 4;
  L.red_l = off, off += WARPS * gt * 4;
  L.mw = off, off += THREADS * 8;  // the merge's (m, l) per thread
  L.red4 = off, off += THREADS * 16;
  L.flag = off, off += 16;
  L.bars = off, off += (chunk / SUB + 1) * 16;
  L.total = off;
  return L;
}

struct Args {
  const void* q;
  const unsigned char* k;
  const unsigned char* v;
  const float* ks;  // [B, KV, 1, T] or null
  const float* vs;
  const int* pos;   // [B]
  float* o_part;    // [B, KV, n_hc, n_split, gc, DPAD]
  float* m_part;    // [B, KV, n_hc, n_split, gc], log2 units
  float* l_part;
  int* counters;    // [B * KV * n_hc], 0 between calls
  float* out;       // [B, 1, H, D]
  int KV, G, T, D, chunk, n_split, q_is_bf16;
  int n_hc, gc;     // head chunks per kv head, heads per chunk
  int ahead;        // sub-tiles of K and V a block keeps in flight
  float scale;
};

// A running merge of partials (m in log2 units, l, o): folding (m_s, l_s,
// o_s) rescales what is held to the larger max, as the online softmax does.
struct Merge {
  float m = NEG_INF, l = 0.f;
  float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
  __device__ __forceinline__ void fold(float ms, float ls, float4 os) {
    const float mn = fmaxf(m, ms);
    const float fa = hopper::ex2(m - mn), fb = hopper::ex2(ms - mn);
    l = l * fa + ls * fb;
    o.x = o.x * fa + os.x * fb, o.y = o.y * fa + os.y * fb;
    o.z = o.z * fa + os.z * fb, o.w = o.w * fa + os.w * fb;
    m = mn;
  }
};

// atomicAdd(counter, 1) with release (what this block wrote before it)
// and acquire (what the blocks before it wrote) at device scope
__device__ __forceinline__ int ticket(int* counter) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n" : "=r"(old) : "l"(counter) : "memory");
  return old;
}

// A lane's LEL elements of one cache row, widened to floats: `row` is the
// row's start + off[0]; vectors at off[u] (vec), else element by element,
// those past D read at element 0.
template <typename TC, int LEL>
__device__ __forceinline__ void load_row(const unsigned char* row, float* f, bool vec, const int* off,
                                         int e0, int D) {
  constexpr int EL = Vec<TC>::EL;
  if (vec) {
#pragma unroll
    for (int u = 0; u < LEL / EL; ++u) Vec<TC>::load(row + (off[u] - off[0]), f + u * EL);
  } else {
#pragma unroll
    for (int e = 0; e < LEL; ++e) f[e] = Vec<TC>::one(row - off[0] + (e0 + e < D ? e0 + e : 0) * sizeof(TC));
  }
}

// Copy the bytes [src, src + n) of global memory to dst (dst and src
// equal modulo 16) with the block's threads: 16-byte words over the
// aligned interior, bytes at the two ends.
__device__ __forceinline__ void copy_span(unsigned char* dst, const unsigned char* src, long long n) {
  const long long lo = (16 - (reinterpret_cast<uintptr_t>(src) & 15)) & 15;  // bytes before the interior
  const long long head = lo < n ? lo : n;
  const long long words = (n - head) / 16;
  for (long long i = threadIdx.x; i < words; i += THREADS)
    reinterpret_cast<uint4*>(dst + head)[i] = reinterpret_cast<const uint4*>(src + head)[i];
  const long long tail = head + 16 * words;
  for (long long i = threadIdx.x; i < head + (n - tail); i += THREADS) {
    const long long j = i < head ? i : tail + (i - head);
    dst[j] = src[j];
  }
}

// The kernel's body. FULL = 1 (decode_kernel): D is the row width DP (D
// 64, 128, 256): every lane live, rows read in vectors and bulk-copied, D
// and the row's bytes known at compile time. FULL = 0
// (decode_general_kernel): any other D, decided at run time; its own
// kernel, so that the general code costs the first one no registers.
template <typename TC, int DP, int FULL>
__device__ __forceinline__ void decode_body(const Args& a) {
  using hopper::smem_u32;
  constexpr int EL = Vec<TC>::EL;                       // elements a vector load reads
  constexpr int LEL = lane_elems(sizeof(TC), DP);       // elements a lane holds
  constexpr int NV = LEL / EL;                          // vectors a lane reads
  constexpr int LPR = DP / LEL;                         // lanes per cache row
  constexpr int NRP = 32 / LPR;                         // rows per warp pass
  constexpr int NP = SUB / NRP;                         // passes per sub-tile
  constexpr int GT = group_heads(sizeof(TC), DP);
  constexpr float LOG2E = 1.4426950408889634f;
  static_assert(LPR >= 1 && LPR <= 32 && SUB % NRP == 0 && LPR * LEL == DP && NV * EL == LEL, "row split");
  extern __shared__ __align__(128) unsigned char smem[];

  const int D = FULL ? DP : a.D;
  const int RB = D * sizeof(TC);                 // bytes per cache row
  const bool vec = FULL || D % EL == 0;          // rows read in vectors, else element by element
  const bool bulk = FULL || RB % 16 == 0;        // spans bulk-copied, else copied by the threads
  const int split = blockIdx.x, b = blockIdx.z;
  const int kv = blockIdx.y / a.n_hc, hc = blockIdx.y % a.n_hc;
  const int tid = threadIdx.x, lane = tid & 31;
  // the warp index broadcast from lane 0, so the compiler knows it is
  // warp-uniform and emits plain shuffles in the loops that depend on it
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int G = a.G;
  const int h0 = hc * a.gc;                     // the chunk's first head within the kv head
  const int gn = min(a.gc, G - h0);             // the chunk's heads
  const int plane = b * a.KV + kv;              // the cache plane
  const int cplane = plane * a.n_hc + hc;       // the chunk's counter and partials
  const int t0 = split * a.chunk;
  // warps split into ng head groups of GT heads, wg warps (pass owners) each
  const int ng = (gn + GT - 1) / GT, wg = WARPS / ng;
  const int hg = warp / wg, wi = warp % wg;
  const bool active = hg < ng;  // gn = 3 * GT leaves one warp idle
  const int g0 = hg * GT, gcnt = active ? min(GT, gn - g0) : 0;
  const int rr = lane / LPR, c = lane % LPR;  // row in the pass, slice
  const int e0 = c * LEL;                      // the slice's first element
  const bool live = e0 < D;
  // byte offsets in a row of this lane's vectors (vec) or elements, those
  // past D at element 0; the sub-tile pointers below start at off[0]
  int off[NV];
#pragma unroll
  for (int u = 0; u < NV; ++u) off[u] = (e0 + u * EL < D ? e0 + u * EL : 0) * (int)sizeof(TC);
  // q slice of this warp's heads, pre-scaled so that scores come in log2
  // units, zero past D; loaded before pos[b] is known, so the loads overlap
  const float qscale = a.scale * LOG2E;
  float q[GT][LEL], o[GT][LEL], m[GT], l[GT];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    const long long qo = ((long long)plane * G + h0 + min(g0 + g, gn - 1)) * D;
    if constexpr (FULL) {  // vector loads (q is 16-byte aligned), all issued before any is used
#pragma unroll
      for (int u = 0; u < NV; ++u) {
        const long long qe = qo + e0 + u * EL;
        float* f = &q[g][u * EL];
        if (a.q_is_bf16) {
          const unsigned char* qp = static_cast<const unsigned char*>(a.q) + 2 * qe;
          if constexpr (EL == 8) {
            Vec<__nv_bfloat16>::load(qp, f);
          } else {  // an f32 cache: 4 bf16 of q, 8 bytes
            const uint2 w = *reinterpret_cast<const uint2*>(qp);
            const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.x));
            const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.y));
            f[0] = x.x, f[1] = x.y, f[2] = y.x, f[3] = y.y;
          }
        } else {
#pragma unroll
          for (int e = 0; e < EL; e += 4)
            Vec<float>::load(static_cast<const unsigned char*>(a.q) + 4 * (qe + e), f + e);
        }
      }
    } else {
#pragma unroll
      for (int e = 0; e < LEL; ++e) {
        const long long i = qo + (e0 + e < D ? e0 + e : 0);
        q[g][e] = a.q_is_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.q)[i])
                              : static_cast<const float*>(a.q)[i];
      }
    }
  }
#pragma unroll
  for (int g = 0; g < GT; ++g) {
#pragma unroll
    for (int e = 0; e < LEL; ++e) q[g][e] = g < gcnt && e0 + e < D ? q[g][e] * qscale : 0.f, o[g][e] = 0.f;
    m[g] = NEG_INF;
    l[g] = 0.f;
  }
  const int seen = min(a.pos[b] + 1, a.T);  // rows slot b attends
  const int n = min(t0 + a.chunk, seen) - t0;
  const int nvs = seen > 0 ? (seen + a.chunk - 1) / a.chunk : 0;  // splits holding rows
  float* out = a.out + ((long long)plane * G + h0) * D;
  if (n <= 0) {  // every row of this split is past pos[b]: nothing to load
    if (nvs == 0 && split == 0)
      for (int i = tid; i < gn * D; i += THREADS) out[i] = 0.f;
    return;
  }

  const bool quant = a.ks != nullptr;
  const Layout L = layout(a.chunk, D, sizeof(TC), quant);
  const long long row0 = (long long)plane * a.T + t0;  // cache row of (b, kv, t0)
  const int pre = static_cast<int>((row0 * RB) & 15);   // 0 where bulk
  unsigned char* Ks = smem + L.k + pre;
  unsigned char* Vs = smem + L.v + pre;
  float* sks = reinterpret_cast<float*>(smem + L.ks);
  float* svs = reinterpret_cast<float*>(smem + L.vs);
  const uint32_t bars = smem_u32(smem + L.bars);  // K_j at 16 j, V_j at 16 j + 8, scales last
  const int nsub = (n + SUB - 1) / SUB;
  const uint32_t bar_s = bars + 16 * nsub;

  // int8 scales: smem index soff + i holds row t0 + i, so a 16-byte
  // aligned global address lands on a 16-byte aligned smem address
  const int soff = static_cast<int>(row0 & 3);
  int s_lo = 0, s_hi = 0;  // the bulk-copied interior, rows [s_lo, s_hi)
  if (quant) {
    const long long lo = (row0 + 3) & ~3ll, hi = (row0 + n) & ~3ll;
    if (hi > lo) s_lo = static_cast<int>(lo - row0), s_hi = static_cast<int>(hi - row0);
  }

  auto issue = [&](int j) {  // sub-tile j of K and of V, one bulk copy each
    const uint32_t bytes = static_cast<uint32_t>(min(SUB, n - j * SUB) * RB);
    const long long src = (row0 + j * SUB) * RB;
    hopper::mbar_expect_tx(bars + 16 * j, bytes);
    hopper::bulk_load(smem_u32(Ks + j * SUB * RB), a.k + src, bytes, bars + 16 * j);
    hopper::mbar_expect_tx(bars + 16 * j + 8, bytes);
    hopper::bulk_load(smem_u32(Vs + j * SUB * RB), a.v + src, bytes, bars + 16 * j + 8);
  };
  if (tid == 0) {
    if (bulk) {
      for (int j = 0; j < nsub; ++j) {
        hopper::mbar_init(bars + 16 * j, 1);
        hopper::mbar_init(bars + 16 * j + 8, 1);
      }
    }
    hopper::mbar_init(bar_s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // the first `ahead` sub-tiles, K_j before V_j in the order they are
    // used; the rest as the block works through them (below)
    if (bulk)
      for (int j = 0; j < min(nsub, a.ahead); ++j) issue(j);
    if (s_hi > s_lo) {
      const uint32_t bytes = static_cast<uint32_t>((s_hi - s_lo) * 4);
      hopper::mbar_expect_tx(bar_s, 2 * bytes);
      hopper::bulk_load(smem_u32(sks + soff + s_lo), a.ks + row0 + s_lo, bytes, bar_s);
      hopper::bulk_load(smem_u32(svs + soff + s_lo), a.vs + row0 + s_lo, bytes, bar_s);
    }
  }
  if (!bulk) {  // the whole span by the threads, before anyone computes
    copy_span(Ks, a.k + row0 * RB, (long long)n * RB);
    copy_span(Vs, a.v + row0 * RB, (long long)n * RB);
  }
  if (quant) {  // the ragged ends by hand (every row if there is no interior)
    const int head = s_hi > s_lo ? s_lo : n;
    for (int i = tid; i < head; i += THREADS) sks[soff + i] = a.ks[row0 + i], svs[soff + i] = a.vs[row0 + i];
    for (int i = s_hi + tid; s_hi > s_lo && i < n; i += THREADS)
      sks[soff + i] = a.ks[row0 + i], svs[soff + i] = a.vs[row0 + i];
  }

  __syncthreads();  // barriers initialised, hand-loaded scales (and rows) written
  if (s_hi > s_lo) hopper::mbar_wait(bar_s, 0);

  for (int j = 0; active && j < nsub; ++j) {
    if (bulk && tid == 0 && j + a.ahead < nsub) issue(j + a.ahead);  // before waiting on j
    const int nr = min(SUB, n - j * SUB);
    const int np = (nr + NRP - 1) / NRP;                          // passes in sub-tile j
    const int first = (wi - (j * NP) % wg + wg) % wg;             // this warp's first pass
    if (first >= np) continue;  // warp-uniform: no pass of sub-tile j is this warp's
    const unsigned char* Kt = Ks + j * SUB * RB + off[0];
    const unsigned char* Vt = Vs + j * SUB * RB + off[0];
    const float* kst = sks + soff + j * SUB;
    const float* vst = svs + soff + j * SUB;
    if (bulk) {
      hopper::mbar_wait(bars + 16 * j, 0);
      hopper::mbar_wait(bars + 16 * j + 8, 0);
    }
    // two passes at a time: rows r0 and r1 of this lane's row group. A
    // row past nr reads row 0 instead (always loaded, so finite) and is
    // masked below: no branch, so the shuffles stay convergent
    for (int p = first; p < np; p += 2 * wg) {
      const int r0 = p * NRP + rr, r1 = (p + wg) * NRP + rr;
      const bool ok0 = r0 < nr, ok1 = p + wg < np && r1 < nr;
      const int i0 = ok0 ? r0 : 0, i1 = ok1 ? r1 : 0;
      float k0[LEL], k1[LEL], s0[GT], s1[GT];
      load_row<TC, LEL>(Kt + i0 * RB, k0, vec, off, e0, D);
      load_row<TC, LEL>(Kt + i1 * RB, k1, vec, off, e0, D);
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        s0[g] = 0.f, s1[g] = 0.f;
#pragma unroll
        for (int e = 0; e < LEL; ++e) s0[g] = fmaf(q[g][e], k0[e], s0[g]), s1[g] = fmaf(q[g][e], k1[e], s1[g]);
      }
#pragma unroll
      for (int sh = LPR / 2; sh > 0; sh >>= 1)
#pragma unroll
        for (int g = 0; g < GT; ++g) {
          s0[g] += __shfl_xor_sync(0xffffffffu, s0[g], sh);
          s1[g] += __shfl_xor_sync(0xffffffffu, s1[g], sh);
        }
      // per-lane online softmax over the rows this lane's group sees
      const float ks0 = quant ? kst[i0] : 1.f, ks1 = quant ? kst[i1] : 1.f;
      const float vs0 = quant ? vst[i0] : 1.f, vs1 = quant ? vst[i1] : 1.f;
      float v0[LEL], v1[LEL];
      load_row<TC, LEL>(Vt + i0 * RB, v0, vec, off, e0, D);
      load_row<TC, LEL>(Vt + i1 * RB, v1, vec, off, e0, D);
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        const float x0 = ok0 ? s0[g] * ks0 : NEG_INF, x1 = ok1 ? s1[g] * ks1 : NEG_INF;
        // lazy rescaling: the running max moves only when a score passes
        // it by more than RESCALE (log2 units), so p <= 2^RESCALE and o is
        // rescaled rarely; the result is the same sum either way
        const float m_new = fmaxf(x0, x1);
        if (m_new > m[g] + RESCALE) {
          const float corr = hopper::ex2(m[g] - m_new);
          l[g] *= corr;
#pragma unroll
          for (int e = 0; e < LEL; ++e) o[g][e] *= corr;
          m[g] = m_new;
        }
        const float p0 = ok0 ? hopper::ex2(x0 - m[g]) : 0.f, p1 = ok1 ? hopper::ex2(x1 - m[g]) : 0.f;
        l[g] += p0 + p1;  // the denominator before the V scale
        const float w0 = p0 * vs0, w1 = p1 * vs1;
#pragma unroll
        for (int e = 0; e < LEL; ++e) o[g][e] = fmaf(w1, v1[e], fmaf(w0, v0[e], o[g][e]));
      }
    }
  }

  // the warp's row groups: merge (m, l, o) across lanes of equal slice
#pragma unroll
  for (int sh = 16; sh >= LPR; sh >>= 1) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], sh);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], sh);
      const float m_new = fmaxf(m[g], mo);
      const float fa = hopper::ex2(m[g] - m_new), fb = hopper::ex2(mo - m_new);
      l[g] = l[g] * fa + lo * fb;
      m[g] = m_new;
#pragma unroll
      for (int e = 0; e < LEL; ++e) o[g][e] = o[g][e] * fa + __shfl_xor_sync(0xffffffffu, o[g][e], sh) * fb;
    }
  }
  float* red_o = reinterpret_cast<float*>(smem + L.red_o);  // [WARPS, GT, D]
  float* red_m = reinterpret_cast<float*>(smem + L.red_m);  // [WARPS, GT]
  float* red_l = reinterpret_cast<float*>(smem + L.red_l);
  if (lane < LPR && live) {
#pragma unroll
    for (int g = 0; g < GT; ++g)
#pragma unroll
      for (int e = 0; e < LEL; ++e)
        if (e0 + e < D) red_o[(warp * GT + g) * D + e0 + e] = o[g][e];
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GT; ++g) red_m[warp * GT + g] = m[g], red_l[warp * GT + g] = l[g];
  }
  __syncthreads();
  // the block's partial: head g merges the wg warps of its group
  const int DPAD = (D + 3) & ~3;  // a partial's row, a whole number of float4s
  const long long part = (long long)cplane * a.n_split + split;
  for (int i = tid; i < gn * D; i += THREADS) {
    const int g = i / D, d = i % D;
    const int w0 = (g / GT) * wg, gl = g % GT;
    float M = NEG_INF;
    for (int w = w0; w < w0 + wg; ++w) M = fmaxf(M, red_m[w * GT + gl]);
    float Lsum = 0.f, O = 0.f;
    for (int w = w0; w < w0 + wg; ++w) {
      const float f = hopper::ex2(red_m[w * GT + gl] - M);
      Lsum = fmaf(red_l[w * GT + gl], f, Lsum);
      O = fmaf(red_o[(w * GT + gl) * D + d], f, O);
    }
    if (nvs == 1) {
      out[i] = O / fmaxf(Lsum, 1e-30f);
    } else {
      a.o_part[(part * a.gc + g) * DPAD + d] = O;
      if (d == 0) a.m_part[part * a.gc + g] = M, a.l_part[part * a.gc + g] = Lsum;
    }
  }
  if (nvs == 1) return;

  // ticket: the last of the chunk's nvs blocks merges
  // (the barrier orders the block's partial before thread 0's release; its
  // acquire, and the barrier after it, order the other blocks' partials
  // before the reads below)
  int* last = reinterpret_cast<int*>(smem + L.flag);
  __syncthreads();
  if (tid == 0) *last = ticket(a.counters + cplane) == nvs - 1;
  __syncthreads();
  if (!*last) return;

  // one pass over the chunk's partials, in split order: thread (grp, v)
  // folds splits grp, grp + groups, ... of float4 v into a running
  // (M, L, O); the groups then fold in order. Padding columns (D..DPAD)
  // are folded but never written.
  const int GD4 = gn * DPAD / 4;   // float4s of one partial's gn heads
  const int PD4 = a.gc * DPAD / 4;  // float4s between two splits' partials
  const long long pbase = (long long)cplane * a.n_split;
  const float4* op = reinterpret_cast<const float4*>(a.o_part) + pbase * PD4;
  const float* mp = a.m_part + pbase * a.gc;
  const float* lp = a.l_part + pbase * a.gc;
  const int groups = GD4 >= THREADS ? 1 : THREADS / GD4;
  float4* red_o4 = reinterpret_cast<float4*>(smem + L.red4);  // [groups, GD4]
  float* red_ml = reinterpret_cast<float*>(smem + L.mw);      // [groups, GD4, 2]
  for (int v0 = 0; v0 < GD4; v0 += THREADS) {
    const int v = groups == 1 ? v0 + tid : tid % GD4, grp = groups == 1 ? 0 : tid / GD4;
    const bool mine = v < GD4 && grp < groups;
    const int g = v * 4 / DPAD;
    Merge acc;
    for (int s0 = grp; mine && s0 < nvs; s0 += 8 * groups) {  // 8 splits' loads in flight
      float ms[8], ls[8];
      float4 os[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int s = min(s0 + u * groups, nvs - 1);
        ms[u] = __ldcg(mp + s * a.gc + g), ls[u] = __ldcg(lp + s * a.gc + g);
        os[u] = __ldcg(op + (long long)s * PD4 + v);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (s0 + u * groups < nvs) acc.fold(ms[u], ls[u], os[u]);
    }
    int vo = v;  // the float4 this thread writes
    if (groups > 1) {
      if (mine) {
        red_o4[grp * GD4 + v] = acc.o;
        red_ml[2 * (grp * GD4 + v)] = acc.m, red_ml[2 * (grp * GD4 + v) + 1] = acc.l;
      }
      __syncthreads();
      if (tid >= GD4) break;
      acc = Merge();
      for (int r = 0; r < groups; ++r)
        acc.fold(red_ml[2 * (r * GD4 + tid)], red_ml[2 * (r * GD4 + tid) + 1], red_o4[r * GD4 + tid]);
      vo = tid;
    }
    if (mine || groups > 1) {
      const float inv = 1.f / fmaxf(acc.l, 1e-30f);
      const float ov[4] = {acc.o.x, acc.o.y, acc.o.z, acc.o.w};
      const int gg = vo * 4 / DPAD, d0 = vo * 4 % DPAD;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (d0 + e < D) out[gg * D + d0 + e] = ov[e] * inv;
    }
  }
  if (tid == 0) a.counters[cplane] = 0;  // ready for the next call
}

template <typename TC, int DP>
__global__ void __launch_bounds__(THREADS) decode_kernel(Args a) {
  decode_body<TC, DP, 1>(a);
}

// ptxas holds a kernel without a register limit to 128 registers a thread
// here and spills the general body's few extra values; 168 keeps them in
// registers (3 blocks of 128 threads an SM, as many as shared memory
// allows at the plan's largest chunks)
template <typename TC, int DP>
__global__ void __maxnreg__(168) decode_general_kernel(Args a) {
  decode_body<TC, DP, 0>(a);
}

// ---------------------------------------------------------------------------
// decode_wide_kernel: D > 256
// ---------------------------------------------------------------------------
//
// Past a row width of 256 a lane's share of q and o no longer fits in
// registers, so the row is taken in D-slices. The grid and the block's rows
// are decode_kernel's (block (split, kv * n_hc + chunk, b) owns rows
// [t0, t0 + n) of its plane for the chunk's gn <= 16 heads), and so is the
// merge by ticket. The block works in two passes over its rows:
//   scores: for each slice of WIDE_SLICE columns, the chunk's q slice goes
//     into shared memory (pre-scaled into log2 units, zero past gn heads);
//     warp w takes rows w, w + 4, ...: each lane reads the row's elements
//     lane, lane + 32, ... (8 loads in flight) and keeps 16 partial dots, which one transposing
//     butterfly (16 shuffles) sums so that lanes 2g and 2g + 1 hold head g's;
//     the row's score adds into s[row][g] in shared memory;
//   softmax: warp w takes heads w, w + 4, ...: the int8 K scale, the max m
//     over the block's rows, p = 2^(s - m), l = sum p, and p times the int8
//     V scale (the denominator sums p before the V scale, as decode_kernel);
//   P V: thread i takes columns i, i + 128, ... and sums p[row][g] V[row]
//     over the rows for the 16 heads in registers (p read as float4s; 8
//     rows' loads in flight).
// Shared memory: the q slice (16 x WIDE_SLICE floats), the scores (rows x
// 16 floats, rows <= WIDE_MAX_CHUNK) and a few words: bounded at every D.
// The block's (o, m, l) is a partial as decode_kernel's, merged by the
// block that draws the last ticket with decode_kernel's rule (Merge),
// folded in split order, one float4 of the chunk's heads a thread.

constexpr int WIDE_SLICE = 512;       // columns of q a block holds at a time
constexpr int WIDE_MAX_CHUNK = 512;   // rows a block at most: its scores stay in shared memory
constexpr int LOADS = 8;              // cache elements a thread keeps in flight (decode_wide_kernel)

struct WideLayout {
  int qs, p, ml, flag, total;
};

__host__ __device__ constexpr WideLayout wide_layout(int chunk) {
  WideLayout L{};
  int off = 0;
  L.qs = off, off += MAX_HC * WIDE_SLICE * 4;  // the q slice [16, WIDE_SLICE]
  L.p = off, off += chunk * MAX_HC * 4;        // scores, then p [chunk, 16]
  L.ml = off, off += 2 * MAX_HC * 4;           // m and l of each head
  L.flag = off, off += 16;
  L.total = off;
  return L;
}
// the largest block a plan makes (split_plan caps its rows at WIDE_MAX_CHUNK)
static_assert(wide_layout(WIDE_MAX_CHUNK).total <= hopper::SMEM_PER_BLOCK, "one block of decode_wide_kernel at every d");

template <typename TC>
__global__ void __launch_bounds__(THREADS) decode_wide_kernel(Args a) {
  constexpr float LOG2E = 1.4426950408889634f;
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = a.D;
  const long long RB = (long long)D * sizeof(TC);  // bytes per cache row
  const int split = blockIdx.x, b = blockIdx.z;
  const int kv = blockIdx.y / a.n_hc, hc = blockIdx.y % a.n_hc;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = a.G;
  const int h0 = hc * a.gc;
  const int gn = min(a.gc, G - h0);
  const int plane = b * a.KV + kv;
  const int cplane = plane * a.n_hc + hc;
  const int t0 = split * a.chunk;
  const int seen = min(a.pos[b] + 1, a.T);
  const int n = min(t0 + a.chunk, seen) - t0;
  const int nvs = seen > 0 ? (seen + a.chunk - 1) / a.chunk : 0;
  float* out = a.out + ((long long)plane * G + h0) * D;
  if (n <= 0) {
    if (nvs == 0 && split == 0)
      for (int i = tid; i < gn * D; i += THREADS) out[i] = 0.f;
    return;
  }

  const WideLayout L = wide_layout(a.chunk);
  float* qs = reinterpret_cast<float*>(smem + L.qs);
  float* ps = reinterpret_cast<float*>(smem + L.p);
  float* ms = reinterpret_cast<float*>(smem + L.ml);
  float* ls = ms + MAX_HC;
  const bool quant = a.ks != nullptr;
  const long long row0 = (long long)plane * a.T + t0;  // cache row of (b, kv, t0)
  const unsigned char* Kp = a.k + row0 * RB;
  const unsigned char* Vp = a.v + row0 * RB;
  const long long qbase = ((long long)plane * G + h0) * D;
  const float qscale = a.scale * LOG2E;
  const int ngq = (gn + 3) / 4;  // live groups of 4 heads

  for (int s0 = 0; s0 < D; s0 += WIDE_SLICE) {
    const int sw = min(WIDE_SLICE, D - s0);
    __syncthreads();  // the last slice's q is consumed
    for (int i = tid; i < MAX_HC * WIDE_SLICE; i += THREADS) {
      const int g = i / WIDE_SLICE, e = i % WIDE_SLICE;
      float x = 0.f;
      if (g < gn && e < sw) {
        const long long qi = qbase + (long long)g * D + s0 + e;
        x = (a.q_is_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.q)[qi])
                         : static_cast<const float*>(a.q)[qi]) * qscale;
      }
      qs[i] = x;
    }
    __syncthreads();
    for (int r = warp; r < n; r += WARPS) {
      const unsigned char* krow = Kp + r * RB + (long long)s0 * sizeof(TC);
      float acc[MAX_HC];
#pragma unroll
      for (int g = 0; g < MAX_HC; ++g) acc[g] = 0.f;
      // LOADS elements of the row in flight a lane; an element past the
      // slice reads as 0 against q's last (finite) column
      for (int e0 = lane; e0 < sw; e0 += 32 * LOADS) {
        float kx[LOADS];
#pragma unroll
        for (int u = 0; u < LOADS; ++u) {
          const int e = e0 + 32 * u;
          kx[u] = e < sw ? Vec<TC>::one(krow + e * sizeof(TC)) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < LOADS; ++u) {
          const int e = min(e0 + 32 * u, WIDE_SLICE - 1);
#pragma unroll
          for (int gq = 0; gq < MAX_HC / 4; ++gq)
            if (gq < ngq) {
#pragma unroll
              for (int w = 0; w < 4; ++w)
                acc[4 * gq + w] = fmaf(qs[(4 * gq + w) * WIDE_SLICE + e], kx[u], acc[4 * gq + w]);
            }
        }
      }
      // transposing butterfly: at step `w` a lane keeps the half of its
      // values its lane bit selects and adds its partner's; after 16 -> 1
      // values, lanes 2g and 2g + 1 hold head g's whole dot
#pragma unroll
      for (int w = 8, bit = 16; w >= 1; w >>= 1, bit >>= 1) {
        const bool hi = lane & bit;
#pragma unroll
        for (int i = 0; i < w; ++i) {
          const float send = hi ? acc[i] : acc[i + w];
          const float keep = hi ? acc[i + w] : acc[i];
          acc[i] = keep + __shfl_xor_sync(0xffffffffu, send, bit);
        }
      }
      acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], 1);
      const int g = lane >> 1;
      if ((lane & 1) == 0 && g < gn) {
        float* sp = ps + r * MAX_HC + g;
        *sp = s0 == 0 ? acc[0] : *sp + acc[0];
      }
    }
  }
  __syncthreads();

  for (int g = warp; g < gn; g += WARPS) {
    float mx = NEG_INF;
    for (int r = lane; r < n; r += 32) {
      const float x = ps[r * MAX_HC + g] * (quant ? a.ks[row0 + r] : 1.f);
      ps[r * MAX_HC + g] = x;
      mx = fmaxf(mx, x);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int r = lane; r < n; r += 32) {
      const float p = hopper::ex2(ps[r * MAX_HC + g] - mx);
      sum += p;
      ps[r * MAX_HC + g] = p * (quant ? a.vs[row0 + r] : 1.f);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) ms[g] = mx, ls[g] = sum;
  }
  __syncthreads();

  const int DPAD = (D + 3) & ~3;
  const long long part = (long long)cplane * a.n_split + split;
  for (int e = tid; e < D; e += THREADS) {
    float acc[MAX_HC];
#pragma unroll
    for (int g = 0; g < MAX_HC; ++g) acc[g] = 0.f;
    const unsigned char* vcol = Vp + e * sizeof(TC);
    for (int r0 = 0; r0 < n; r0 += LOADS) {  // LOADS rows' elements in flight
      float vx[LOADS];
#pragma unroll
      for (int u = 0; u < LOADS; ++u) vx[u] = r0 + u < n ? Vec<TC>::one(vcol + (r0 + u) * RB) : 0.f;
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        const float4* pr = reinterpret_cast<const float4*>(ps + (r0 + u) * MAX_HC);
#pragma unroll
        for (int gq = 0; gq < MAX_HC / 4; ++gq)
          if (gq < ngq && r0 + u < n) {
            const float4 p = pr[gq];
            acc[4 * gq] = fmaf(p.x, vx[u], acc[4 * gq]);
            acc[4 * gq + 1] = fmaf(p.y, vx[u], acc[4 * gq + 1]);
            acc[4 * gq + 2] = fmaf(p.z, vx[u], acc[4 * gq + 2]);
            acc[4 * gq + 3] = fmaf(p.w, vx[u], acc[4 * gq + 3]);
          }
      }
    }
#pragma unroll
    for (int g = 0; g < MAX_HC; ++g) {
      if (g < gn) {
        if (nvs == 1) out[(long long)g * D + e] = acc[g] / fmaxf(ls[g], 1e-30f);
        else a.o_part[(part * a.gc + g) * DPAD + e] = acc[g];
      }
    }
  }
  if (nvs == 1) return;
  if (tid < gn) a.m_part[part * a.gc + tid] = ms[tid], a.l_part[part * a.gc + tid] = ls[tid];

  // ticket: the last of the chunk's nvs blocks merges (ordering as in
  // decode_body)
  int* last = reinterpret_cast<int*>(smem + L.flag);
  __syncthreads();
  if (tid == 0) *last = ticket(a.counters + cplane) == nvs - 1;
  __syncthreads();
  if (!*last) return;
  // thread v folds float4 v of every split's partial, in split order, 8
  // splits' loads in flight (decode_body's fold, without its thread groups)
  const long long pbase = (long long)cplane * a.n_split;
  const int GD4 = gn * DPAD / 4, PD4 = a.gc * DPAD / 4;
  const float4* op = reinterpret_cast<const float4*>(a.o_part) + pbase * PD4;
  const float* mp = a.m_part + pbase * a.gc;
  const float* lp = a.l_part + pbase * a.gc;
  for (int v = tid; v < GD4; v += THREADS) {
    const int g = v * 4 / DPAD, d0 = v * 4 % DPAD;
    Merge acc;
    for (int s0 = 0; s0 < nvs; s0 += 8) {
      float msu[8], lsu[8];
      float4 osu[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int s = min(s0 + u, nvs - 1);
        msu[u] = __ldcg(mp + s * a.gc + g), lsu[u] = __ldcg(lp + s * a.gc + g);
        osu[u] = __ldcg(op + (long long)s * PD4 + v);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (s0 + u < nvs) acc.fold(msu[u], lsu[u], osu[u]);
    }
    const float inv = 1.f / fmaxf(acc.l, 1e-30f);
    const float ov[4] = {acc.o.x, acc.o.y, acc.o.z, acc.o.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (d0 + e < D) out[(long long)g * D + d0 + e] = ov[e] * inv;
  }
  if (tid == 0) a.counters[cplane] = 0;  // ready for the next call
}

template <typename TC>
int launch_wide(const Args& a, int B, cudaStream_t stream) {
  const WideLayout L = wide_layout(a.chunk);
  auto kernel = decode_wide_kernel<TC>;
  constexpr int MAX_DEVICES = 64;
  static int attr_bytes[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (L.total > 48 * 1024 && (dev >= MAX_DEVICES || L.total > attr_bytes[dev])) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
    if (err != cudaSuccess) return (int)err;
    if (dev < MAX_DEVICES) attr_bytes[dev] = L.total;
  }
  kernel<<<dim3(a.n_split, a.KV * a.n_hc, B), THREADS, L.total, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename TC, int DP, int FULL>
int launch_one(const Args& a, int B, cudaStream_t stream) {
  const Layout L = layout(a.chunk, a.D, sizeof(TC), a.ks != nullptr);
  auto kernel = FULL ? decode_kernel<TC, DP> : decode_general_kernel<TC, DP>;
  // the most this instantiation was allowed so far, per device (the
  // attribute is set per device)
  constexpr int MAX_DEVICES = 64;
  static int attr_bytes[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (L.total > 48 * 1024 && (dev >= MAX_DEVICES || L.total > attr_bytes[dev])) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
    if (err != cudaSuccess) return (int)err;
    if (dev < MAX_DEVICES) attr_bytes[dev] = L.total;
  }
  kernel<<<dim3(a.n_split, a.KV * a.n_hc, B), THREADS, L.total, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename TC>
int launch_d(const Args& a, int B, cudaStream_t s) {
  // D 16 and 32 take the general kernel too: no path runs them, and two
  // instances fewer per cache type shorten the build
  const bool full = a.D == row_width(a.D);
  switch (row_width(a.D)) {
    case 16: return launch_one<TC, 16, 0>(a, B, s);
    case 32: return launch_one<TC, 32, 0>(a, B, s);
    case 64: return full ? launch_one<TC, 64, 1>(a, B, s) : launch_one<TC, 64, 0>(a, B, s);
    case 128: return full ? launch_one<TC, 128, 1>(a, B, s) : launch_one<TC, 128, 0>(a, B, s);
    case 256: return full ? launch_one<TC, 256, 1>(a, B, s) : launch_one<TC, 256, 0>(a, B, s);
    default: return launch_wide<TC>(a, B, s);  // D > 256
  }
}

}  // namespace

// cache_kind: 0 = f32, 1 = bf16, 2 = int8 (ks and vs required). q is
// contiguous. D >= 1 (past 256 decode_wide_kernel, chunk <= WIDE_MAX_CHUNK); the G heads of a kv head in n_hc chunks of gc
// <= 16 (n_hc * gc >= G > (n_hc - 1) * gc). `ahead`: K and V sub-tiles a
// block keeps in flight (>= 1). One launch of decode_kernel; `counters`
// holds B * KV * n_hc zeros and is left so.
extern "C" int dml_decode_attention(const void* q, const void* k, const void* v,
                                    const void* ks, const void* vs, const void* pos,
                                    void* o_part, void* m_part, void* l_part, void* counters,
                                    void* out, int cache_kind, int q_is_bf16, int B, int KV,
                                    int G, int T, int D, int chunk, int n_split, int n_hc, int gc,
                                    int ahead, float scale, void* stream) {
  if (B <= 0) return 0;
  if (G < 1 || D < 1 || gc < 1 || gc > MAX_HC || n_hc < 1 || (long long)n_hc * gc < G ||
      (long long)(n_hc - 1) * gc >= G || chunk < SUB || chunk > (D > MAX_ROW ? WIDE_MAX_CHUNK : MAX_CHUNK) ||
      chunk % SUB || (long long)chunk * n_split < T || ahead < 1)
    return (int)cudaErrorInvalidValue;
  Args a{q, static_cast<const unsigned char*>(k), static_cast<const unsigned char*>(v),
         static_cast<const float*>(ks), static_cast<const float*>(vs),
         static_cast<const int*>(pos), static_cast<float*>(o_part),
         static_cast<float*>(m_part), static_cast<float*>(l_part),
         static_cast<int*>(counters), static_cast<float*>(out),
         KV, G, T, D, chunk, n_split, q_is_bf16, n_hc, gc, ahead, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cache_kind) {
    case 0: a.ks = a.vs = nullptr; return launch_d<float>(a, B, s);
    case 1: a.ks = a.vs = nullptr; return launch_d<__nv_bfloat16>(a, B, s);
    case 2:
      if (!a.ks || !a.vs) return (int)cudaErrorInvalidValue;
      return launch_d<int8_t>(a, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
