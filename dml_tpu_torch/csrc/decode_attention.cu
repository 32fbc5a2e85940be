// Decode-step attention over the KV cache: the Hopper counterpart of the
// TPU kernel dml_tpu/ops/decode_attention.py::_decode_kernel.
//
// q [B, 1, H, D] (f32 or bf16, contiguous)
// attends the head-major cache [B, KV, T, D] (bf16, f32, or int8 with f32
// scales [B, KV, 1, T]); slot b sees cache rows t <= pos[b]. H = KV * G
// with kv-major head order (head h = kv * G + g). Output f32 [B, 1, H, D].
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
//   most of the 132 SMs idle, so T is split as well. Block (split, kv, b)
//   owns rows [split * chunk, min((split + 1) * chunk, pos[b] + 1)) of its
//   (b, kv) plane: n contiguous rows of K and of V. The wrapper sizes the
//   chunk by bytes (at most 64 KB of K + V, a multiple of SUB = 32 rows)
//   and the grid so that every block is resident at once where the step's
//   bytes fit the SMs' shared memory (ops/decode_attention.py::split_plan).
//   Blocks wholly past pos[b] return before they load anything.
// - Loads. Thread 0 initialises one mbarrier per K and per V sub-tile of
//   32 rows and issues each sub-tile as a 1-D bulk copy (cp.async.bulk,
//   completing on the sub-tile's barrier by its byte count) into its own
//   slot of shared memory: the first `ahead` (2 from the wrapper) at block
//   start, then sub-tile j + ahead before the block waits on sub-tile j, so
//   no thread waits on a load before asking for the next. Two sub-tiles in
//   flight per block (32 KB of K + V at bf16 D 64) rather than the whole
//   chunk at once: an SM serves its copies in issue order, so with
//   everything issued at block start the last resident block gets its
//   first rows only after the others' last ones and computes its whole
//   chunk after the stream has ended. chip_smoke.py times both in turns
//   (`ahead` as large as a chunk issues it all at once). The last sub-tile
//   is sized by n, so no row past pos[b] is ever
//   read. Cache rows are D * itemsize >= 16 bytes and the cache is 16-byte
//   aligned, so every K and V copy is aligned. int8 scale rows (4 bytes
//   each) are bulk-copied over their 16-byte-aligned interior at block
//   start; the at most three rows at either ragged end are loaded by hand.
// - Math. The four warps split into ceil(G / GT) head groups of GT query
//   heads (8 for f32, 4 otherwise); the warps of a group take turns over
//   the passes of NRP rows through the chunk. In a pass, LPR = D / EL
//   lanes split a row's D into vectors of EL elements (16 bytes of f32 or
//   bf16, 8 of int8) and hold their slice of the GT query rows in
//   registers, pre-scaled by scale * log2(e). Scores: per-lane partial
//   dots reduced by __shfl_xor_sync over the row's lanes. Softmax: online
//   and per lane, in log2 units (ex2), over the rows that lane's row group
//   sees, two rows at a time, with lazy rescaling: the running max moves
//   only when a score passes it by more than RESCALE = 8, so p <= 2^8 and
//   the accumulator is rarely rescaled. P V: each lane accumulates its
//   D-slice of its heads' output rows from V vectors. Rows past n read
//   row 0 and are masked, so the loop has no branch around its shuffles
//   (the warp index is broadcast from lane 0 so the compiler knows it is
//   uniform). A warp waits only on the sub-tile it needs next while the
//   later ones are still landing. At the end the row groups of a warp
//   merge by shuffles and the warps of a head group once through shared
//   memory.
// - Merge folded in. With one split of valid rows the block writes out
//   directly. Otherwise it writes its partial (o, m, l) and thread 0 takes
//   a ticket from the plane's counter (an acq_rel atomic: it releases the
//   block's partial and acquires the others'); the block that draws the last
//   ticket (only splits holding rows <= pos[b] take one) merges the
//   plane's partials in split order, so the result does not depend on the
//   order blocks finish in, writes out, and resets the counter to 0 for
//   the next call. Partials merge by the online-softmax rule, folded one
//   split at a time (8 splits' loads in flight per thread): M = max m_s,
//   L = sum l_s 2^(m_s - M), out = sum o_s 2^(m_s - M) / max(L, 1e-30).
//   The plan keeps a plane's partials within 64 KB, which that one block
//   reads.
//
// decode_split_kernel + decode_merge_kernel (dml_decode_attention_split):
// the first Hopper version, kept so one card can time both in turns. At
// most 128 rows a block, copied into shared memory with 16-byte loads
// before any compute, thread r scoring row r, the merge a second launch.
//
// Plain C interface for ctypes; launches on the caller's stream and
// returns cudaGetLastError() so a refused launch raises in the wrapper.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int MAX_G = 16;  // query heads per kv head
constexpr float NEG_INF = -1e30f;

// ---------------------------------------------------------------------------
// decode_kernel: one launch, bulk async loads, the merge folded in
// ---------------------------------------------------------------------------

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int SUB = 32;           // rows per bulk sub-tile
constexpr int MAX_CHUNK = 1024;   // rows per block at most (32 sub-tiles)
constexpr float RESCALE = 8.f;    // log2 units a score may pass the running max by

// Cache elements a lane reads at once, and their widening into floats.
template <typename TC>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int EL = 4;
  __device__ static void load(const unsigned char* p, float* f) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    f[0] = u.x, f[1] = u.y, f[2] = u.z, f[3] = u.w;
  }
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
};

// query heads per warp: 32 floats of q and 32 of o per lane
__host__ __device__ constexpr int group_heads(int itemsize) { return itemsize == 4 ? 8 : 4; }

// Byte offsets into the block's dynamic shared memory; every region is a
// multiple of 16 bytes. The wrapper's smem_bytes mirrors `total`.
struct Layout {
  int k, v, ks, vs, red_o, red_m, red_l, mw, red4, flag, bars, total;
};

__host__ __device__ inline Layout layout(int chunk, int D, int itemsize, bool quant) {
  const int gt = group_heads(itemsize);
  Layout L{};
  int off = 0;
  L.k = off, off += chunk * D * itemsize;
  L.v = off, off += chunk * D * itemsize;
  L.ks = off, off += quant ? (chunk + 4) * 4 : 0;
  L.vs = off, off += quant ? (chunk + 4) * 4 : 0;
  L.red_o = off, off += WARPS * gt * D * 4;
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
  float* o_part;    // [B, KV, n_split, G, D]
  float* m_part;    // [B, KV, n_split, G], log2 units
  float* l_part;
  int* counters;    // [B * KV], 0 between calls
  float* out;       // [B, 1, H, D]
  int KV, G, T, chunk, n_split, q_is_bf16;
  int ahead;        // sub-tiles of K and V a block keeps in flight
  float scale;
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

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

__device__ __forceinline__ float4 div4(float4 x, float d) {
  return make_float4(x.x / d, x.y / d, x.z / d, x.w / d);
}

template <typename TC, int D>
__global__ void __launch_bounds__(THREADS) decode_kernel(Args a) {
  using hopper::smem_u32;
  constexpr int EL = Vec<TC>::EL;
  constexpr int LPR = D / EL;    // lanes per cache row
  constexpr int NRP = 32 / LPR;  // rows per warp pass
  constexpr int NP = SUB / NRP;  // passes per sub-tile
  constexpr int GT = group_heads(sizeof(TC));
  constexpr int RB = D * sizeof(TC);  // bytes per cache row
  constexpr float LOG2E = 1.4426950408889634f;
  static_assert(LPR >= 1 && LPR <= 32 && SUB % NRP == 0, "row split");
  static_assert(EL == 4 || EL == 8, "q is read 4 or 8 elements at a time");
  extern __shared__ __align__(128) unsigned char smem[];

  const int split = blockIdx.x, kv = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31;
  // the warp index broadcast from lane 0, so the compiler knows it is
  // warp-uniform and emits plain shuffles in the loops that depend on it
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int G = a.G;
  const int plane = b * a.KV + kv;
  const int t0 = split * a.chunk;
  // warps split into ng head groups of GT heads, wg warps (pass owners) each
  const int ng = (G + GT - 1) / GT, wg = WARPS / ng;
  const int hg = warp / wg, wi = warp % wg;
  const bool active = hg < ng;  // G = 3 * GT leaves one warp idle
  const int g0 = hg * GT, gc = active ? min(GT, G - g0) : 0;
  const int rr = lane / LPR, c = lane % LPR;  // row in the pass, D-slice
  // q slice of this warp's heads, pre-scaled so that scores come in log2
  // units; loaded before pos[b] is known, so the two loads overlap
  const float qscale = a.scale * LOG2E;
  float q[GT][EL], o[GT][EL], m[GT], l[GT];
#pragma unroll
  for (int g = 0; g < GT; ++g) {  // vector loads, all issued before any is used
    const long long qo = ((long long)b * a.KV * G + kv * G + min(g0 + g, G - 1)) * D + c * EL;
    if (a.q_is_bf16) {
      const unsigned char* qp = static_cast<const unsigned char*>(a.q) + 2 * qo;
      if constexpr (EL == 8) {
        Vec<__nv_bfloat16>::load(qp, q[g]);
      } else {  // an f32 cache: 4 bf16 of q, 8 bytes
        const uint2 u = *reinterpret_cast<const uint2*>(qp);
        const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
        const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
        q[g][0] = x.x, q[g][1] = x.y, q[g][2] = y.x, q[g][3] = y.y;
      }
    } else {
#pragma unroll
      for (int e = 0; e < EL; e += 4)
        Vec<float>::load(static_cast<const unsigned char*>(a.q) + 4 * (qo + e), &q[g][e]);
    }
  }
#pragma unroll
  for (int g = 0; g < GT; ++g) {
#pragma unroll
    for (int e = 0; e < EL; ++e) q[g][e] = g < gc ? q[g][e] * qscale : 0.f, o[g][e] = 0.f;
    m[g] = NEG_INF;
    l[g] = 0.f;
  }
  const int seen = min(a.pos[b] + 1, a.T);  // rows slot b attends
  const int n = min(t0 + a.chunk, seen) - t0;
  const int nvs = seen > 0 ? (seen + a.chunk - 1) / a.chunk : 0;  // splits holding rows
  float* out = a.out + ((long long)b * a.KV + kv) * G * D;
  if (n <= 0) {  // every row of this split is past pos[b]: nothing to load
    if (nvs == 0 && split == 0)
      for (int i = tid; i < G * D; i += THREADS) out[i] = 0.f;
    return;
  }

  const bool quant = a.ks != nullptr;
  const Layout L = layout(a.chunk, D, sizeof(TC), quant);
  unsigned char* Ks = smem + L.k;
  unsigned char* Vs = smem + L.v;
  float* sks = reinterpret_cast<float*>(smem + L.ks);
  float* svs = reinterpret_cast<float*>(smem + L.vs);
  const uint32_t bars = smem_u32(smem + L.bars);  // K_j at 16 j, V_j at 16 j + 8, scales last
  const int nsub = (n + SUB - 1) / SUB;
  const uint32_t bar_s = bars + 16 * nsub;
  const long long row0 = (long long)plane * a.T + t0;  // cache row of (b, kv, t0)

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
    for (int j = 0; j < nsub; ++j) {
      hopper::mbar_init(bars + 16 * j, 1);
      hopper::mbar_init(bars + 16 * j + 8, 1);
    }
    hopper::mbar_init(bar_s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // the first `ahead` sub-tiles, K_j before V_j in the order they are
    // used; the rest as the block works through them (below)
    for (int j = 0; j < min(nsub, a.ahead); ++j) issue(j);
    if (s_hi > s_lo) {
      const uint32_t bytes = static_cast<uint32_t>((s_hi - s_lo) * 4);
      hopper::mbar_expect_tx(bar_s, 2 * bytes);
      hopper::bulk_load(smem_u32(sks + soff + s_lo), a.ks + row0 + s_lo, bytes, bar_s);
      hopper::bulk_load(smem_u32(svs + soff + s_lo), a.vs + row0 + s_lo, bytes, bar_s);
    }
  }
  if (quant) {  // the ragged ends by hand (every row if there is no interior)
    const int head = s_hi > s_lo ? s_lo : n;
    for (int i = tid; i < head; i += THREADS) sks[soff + i] = a.ks[row0 + i], svs[soff + i] = a.vs[row0 + i];
    for (int i = s_hi + tid; s_hi > s_lo && i < n; i += THREADS)
      sks[soff + i] = a.ks[row0 + i], svs[soff + i] = a.vs[row0 + i];
  }

  __syncthreads();  // barriers initialised, hand-loaded scales written
  if (s_hi > s_lo) hopper::mbar_wait(bar_s, 0);

  for (int j = 0; active && j < nsub; ++j) {
    if (tid == 0 && j + a.ahead < nsub) issue(j + a.ahead);  // before waiting on j
    const int nr = min(SUB, n - j * SUB);
    const int np = (nr + NRP - 1) / NRP;                          // passes in sub-tile j
    const int first = (wi - (j * NP) % wg + wg) % wg;             // this warp's first pass
    if (first >= np) continue;  // warp-uniform: no pass of sub-tile j is this warp's
    const unsigned char* Kt = Ks + j * SUB * RB + c * EL * sizeof(TC);
    const unsigned char* Vt = Vs + j * SUB * RB + c * EL * sizeof(TC);
    const float* kst = sks + soff + j * SUB;
    const float* vst = svs + soff + j * SUB;
    hopper::mbar_wait(bars + 16 * j, 0);
    hopper::mbar_wait(bars + 16 * j + 8, 0);
    // two passes at a time: rows r0 and r1 of this lane's row group. A
    // row past nr reads row 0 instead (always loaded, so finite) and is
    // masked below: no branch, so the shuffles stay convergent
    for (int p = first; p < np; p += 2 * wg) {
      const int r0 = p * NRP + rr, r1 = (p + wg) * NRP + rr;
      const bool ok0 = r0 < nr, ok1 = p + wg < np && r1 < nr;
      const int i0 = ok0 ? r0 : 0, i1 = ok1 ? r1 : 0;
      float k0[EL], k1[EL], s0[GT], s1[GT];
      Vec<TC>::load(Kt + i0 * RB, k0);
      Vec<TC>::load(Kt + i1 * RB, k1);
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        s0[g] = 0.f, s1[g] = 0.f;
#pragma unroll
        for (int e = 0; e < EL; ++e) s0[g] = fmaf(q[g][e], k0[e], s0[g]), s1[g] = fmaf(q[g][e], k1[e], s1[g]);
      }
#pragma unroll
      for (int off = LPR / 2; off > 0; off >>= 1)
#pragma unroll
        for (int g = 0; g < GT; ++g) {
          s0[g] += __shfl_xor_sync(0xffffffffu, s0[g], off);
          s1[g] += __shfl_xor_sync(0xffffffffu, s1[g], off);
        }
      // per-lane online softmax over the rows this lane's group sees
      const float ks0 = quant ? kst[i0] : 1.f, ks1 = quant ? kst[i1] : 1.f;
      const float vs0 = quant ? vst[i0] : 1.f, vs1 = quant ? vst[i1] : 1.f;
      float v0[EL], v1[EL];
      Vec<TC>::load(Vt + i0 * RB, v0);
      Vec<TC>::load(Vt + i1 * RB, v1);
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
          for (int e = 0; e < EL; ++e) o[g][e] *= corr;
          m[g] = m_new;
        }
        const float p0 = ok0 ? hopper::ex2(x0 - m[g]) : 0.f, p1 = ok1 ? hopper::ex2(x1 - m[g]) : 0.f;
        l[g] += p0 + p1;  // the denominator before the V scale
        const float w0 = p0 * vs0, w1 = p1 * vs1;
#pragma unroll
        for (int e = 0; e < EL; ++e) o[g][e] = fmaf(w1, v1[e], fmaf(w0, v0[e], o[g][e]));
      }
    }
  }

  // the warp's row groups: merge (m, l, o) across lanes of equal D-slice
#pragma unroll
  for (int off = 16; off >= LPR; off >>= 1) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float m_new = fmaxf(m[g], mo);
      const float fa = hopper::ex2(m[g] - m_new), fb = hopper::ex2(mo - m_new);
      l[g] = l[g] * fa + lo * fb;
      m[g] = m_new;
#pragma unroll
      for (int e = 0; e < EL; ++e) o[g][e] = o[g][e] * fa + __shfl_xor_sync(0xffffffffu, o[g][e], off) * fb;
    }
  }
  float* red_o = reinterpret_cast<float*>(smem + L.red_o);  // [WARPS, GT, D]
  float* red_m = reinterpret_cast<float*>(smem + L.red_m);  // [WARPS, GT]
  float* red_l = reinterpret_cast<float*>(smem + L.red_l);
  if (lane < LPR) {
#pragma unroll
    for (int g = 0; g < GT; ++g)
#pragma unroll
      for (int e = 0; e < EL; ++e) red_o[(warp * GT + g) * D + c * EL + e] = o[g][e];
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GT; ++g) red_m[warp * GT + g] = m[g], red_l[warp * GT + g] = l[g];
  }
  __syncthreads();
  // the block's partial: head g merges the wg warps of its group
  const long long part = (long long)plane * a.n_split + split;
  for (int i = tid; i < G * D; i += THREADS) {
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
      a.o_part[part * G * D + i] = O;
      if (d == 0) a.m_part[part * G + g] = M, a.l_part[part * G + g] = Lsum;
    }
  }
  if (nvs == 1) return;

  // ticket: the last of the plane's nvs blocks merges
  // (the barrier orders the block's partial before thread 0's release; its
  // acquire, and the barrier after it, order the other blocks' partials
  // before the reads below)
  int* last = reinterpret_cast<int*>(smem + L.flag);
  __syncthreads();
  if (tid == 0) *last = ticket(a.counters + plane) == nvs - 1;
  __syncthreads();
  if (!*last) return;

  // one pass over the plane's partials, in split order: thread (grp, v)
  // folds splits grp, grp + groups, ... of float4 v into a running
  // (M, L, O); the groups then fold in order
  const int GD4 = G * D / 4;  // float4s of one partial
  const long long pbase = (long long)plane * a.n_split;
  const float4* op = reinterpret_cast<const float4*>(a.o_part) + pbase * GD4;
  const float* mp = a.m_part + pbase * G;
  const float* lp = a.l_part + pbase * G;
  float4* out4 = reinterpret_cast<float4*>(out);
  const int groups = GD4 >= THREADS ? 1 : THREADS / GD4;
  float4* red_o4 = reinterpret_cast<float4*>(smem + L.red4);  // [groups, GD4]
  float* red_ml = reinterpret_cast<float*>(smem + L.mw);      // [groups, GD4, 2]
  for (int v0 = 0; v0 < GD4; v0 += THREADS) {
    const int v = groups == 1 ? v0 + tid : tid % GD4, grp = groups == 1 ? 0 : tid / GD4;
    const bool mine = v < GD4 && grp < groups;
    const int g = v * 4 / D;
    Merge acc;
    for (int s0 = grp; mine && s0 < nvs; s0 += 8 * groups) {  // 8 splits' loads in flight
      float ms[8], ls[8];
      float4 os[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int s = min(s0 + u * groups, nvs - 1);
        ms[u] = __ldcg(mp + s * G + g), ls[u] = __ldcg(lp + s * G + g);
        os[u] = __ldcg(op + (long long)s * GD4 + v);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (s0 + u * groups < nvs) acc.fold(ms[u], ls[u], os[u]);
    }
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
    }
    if (mine || groups > 1) out4[v] = div4(acc.o, fmaxf(acc.l, 1e-30f));
  }
  if (tid == 0) a.counters[plane] = 0;  // ready for the next call
}

template <typename TC, int D>
int launch_one(const Args& a, int B, cudaStream_t stream) {
  const Layout L = layout(a.chunk, D, sizeof(TC), a.ks != nullptr);
  auto kernel = decode_kernel<TC, D>;
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
  kernel<<<dim3(a.n_split, a.KV, B), THREADS, L.total, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename TC>
int launch_d(const Args& a, int B, int D, cudaStream_t s) {
  switch (D) {
    case 16: return launch_one<TC, 16>(a, B, s);
    case 32: return launch_one<TC, 32>(a, B, s);
    case 64: return launch_one<TC, 64>(a, B, s);
    case 128: return launch_one<TC, 128>(a, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// The first version: split kernel + merge kernel, two launches
// ---------------------------------------------------------------------------

namespace split_pair {

constexpr int ROWS = 128;  // cache rows per block at most

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

struct SplitArgs {
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
__global__ void __launch_bounds__(THREADS) decode_split_kernel(SplitArgs a) {
  constexpr int EPV = 16 / sizeof(TC);  // cache elements per 16 bytes
  extern __shared__ __align__(128) unsigned char smem_pair[];
  const int G = a.G, D = a.D;
  const int rb = row_bytes(D, sizeof(TC));
  const int vecs = D / EPV;  // 16-byte vectors per cache row
  unsigned char* Ks = smem_pair;                                  // [ROWS] padded rows
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
    mx = warp_max(mx);
    float sum = 0.f;
    for (int i = lane; i < n; i += 32) {
      const float p = expf(srow[i] - mx);
      sum += p;
      srow[i] = a.vs ? p * a.vs[plane + t0 + i] : p;  // fold the V scale into P
    }
    sum = warp_sum(sum);
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
int launch(const SplitArgs& a, int B, float* out, cudaStream_t stream) {
  const size_t bytes = 2 * (size_t)ROWS * row_bytes(a.D, sizeof(TC)) +
                       sizeof(float) * ((size_t)a.G * a.D + (size_t)a.G * ROWS +
                                        (size_t)THREADS * a.G);
  auto kernel = decode_split_kernel<TC>;
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

}  // namespace split_pair

bool valid_shape(int G, int D) {
  return G >= 1 && G <= MAX_G && (D == 16 || D == 32 || D == 64 || D == 128);
}

}  // namespace

// cache_kind: 0 = f32, 1 = bf16, 2 = int8 (ks and vs required). q is
// contiguous and 16-byte aligned. `ahead`: K and V sub-tiles a block keeps
// in flight (>= 1). One launch of decode_kernel; `counters` holds B * KV
// zeros and is left so.
extern "C" int dml_decode_attention(const void* q, const void* k, const void* v,
                                    const void* ks, const void* vs, const void* pos,
                                    void* o_part, void* m_part, void* l_part, void* counters,
                                    void* out, int cache_kind, int q_is_bf16, int B, int KV,
                                    int G, int T, int D, int chunk, int n_split, int ahead,
                                    float scale, void* stream) {
  if (B <= 0) return 0;
  if (!valid_shape(G, D) || chunk < SUB || chunk > MAX_CHUNK || chunk % SUB ||
      (long long)chunk * n_split < T || ahead < 1)
    return (int)cudaErrorInvalidValue;
  Args a{q, static_cast<const unsigned char*>(k), static_cast<const unsigned char*>(v),
         static_cast<const float*>(ks), static_cast<const float*>(vs),
         static_cast<const int*>(pos), static_cast<float*>(o_part),
         static_cast<float*>(m_part), static_cast<float*>(l_part),
         static_cast<int*>(counters), static_cast<float*>(out),
         KV, G, T, chunk, n_split, q_is_bf16, ahead, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cache_kind) {
    case 0: a.ks = a.vs = nullptr; return launch_d<float>(a, B, D, s);
    case 1: a.ks = a.vs = nullptr; return launch_d<__nv_bfloat16>(a, B, D, s);
    case 2:
      if (!a.ks || !a.vs) return (int)cudaErrorInvalidValue;
      return launch_d<int8_t>(a, B, D, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The first version, two launches: split kernel, then merge kernel. q
// contiguous. Only for timing beside dml_decode_attention.
extern "C" int dml_decode_attention_split(const void* q, const void* k, const void* v,
                                          const void* ks, const void* vs, const void* pos,
                                          void* o_part, void* m_part, void* l_part, void* out,
                                          int cache_kind, int q_is_bf16, int B, int KV, int G,
                                          int T, int D, int chunk, int n_split, float scale,
                                          void* stream) {
  using namespace split_pair;
  if (B <= 0) return 0;
  if (!valid_shape(G, D) || chunk < 1 || chunk > ROWS) return (int)cudaErrorInvalidValue;
  SplitArgs a{q, k, v, static_cast<const float*>(ks), static_cast<const float*>(vs),
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
