// Hopper building blocks shared by the flash attention kernels
// (flash_attention.cu, the forward, and flash_attention_bwd.cu, the
// backward): mbarriers, TMA loads and stores, wgmma shared-memory
// descriptors in the 128-byte swizzle that TMA writes, the wgmma forms
// the kernels issue, the tensor maps over BTHD tensors, and the head dims
// the kernels are built for, cp.async tile copies and the split-TF32
// products of the float32 kernels. decode_attention.cu takes the mbarrier
// and bulk-copy pieces.
//
// Everything here sits in the including file's unnamed namespace: each
// source is its own library, so nothing is exported twice.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {
namespace hopper {

constexpr int ROW_BYTES = 128;  // one swizzle row: 64 bf16
constexpr size_t SMEM_PER_BLOCK = 227 * 1024;  // an H100 block's dynamic shared memory at most
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// The head dims the flash kernels are instantiated at. A head dim d runs
// on the least of them at or above d: its columns past d are read as zeros
// (zero columns change neither Q K^T nor P V) and never written. Past
// WIDEST_NATIVE native_head_dim is 0: no block holds a whole row of d
// there (the forward's O accumulator alone would be d / 2 float32
// registers a thread for 64 query rows on 128 threads), so such a d takes
// the chunked routes (in flash_attention.cu, float32's launch_wide and
// bf16's wg::launch_wgmma_wide; float32's backward in
// flash_attention_bwd_tf32.cu, bf16's in flash_attention_bwd_wide.cu), d a
// run-time argument.
constexpr int WIDEST_NATIVE = 256;
__host__ __device__ constexpr int native_head_dim(int d) {
  return d < 1 ? 0 : d <= 16 ? 16 : d <= 32 ? 32 : d <= 48 ? 48 : d <= 64 ? 64 : d <= 80 ? 80
       : d <= 96 ? 96 : d <= 128 ? 128 : d <= WIDEST_NATIVE ? WIDEST_NATIVE : 0;
}

// The width of the wgmma + TMA kernels (bf16) for a head dim d: the least
// of 64, 128 and 256 at or above d for 8 <= d <= 256 with d % 8 == 0, the
// tensor maps' innermost extent d (a box's columns past d arrive as zeros;
// a store stops at d); 0 at other d, which take the mma.sync kernels (d %
// 8 != 0: a TMA row stride must be whole 16-byte units, and out, dq, dk
// and dv are d wide) or the chunked route. The drafts' d 8-48 run at 64:
// there one exponential a score sets the pace whatever d is, so the zero
// columns cost tensor-core instructions, not time.
__host__ __device__ constexpr int wgmma_head_dim(int d) {
  return d < 8 || d > WIDEST_NATIVE || d % 8 ? 0 : d <= 64 ? 64 : d <= 128 ? 128 : 256;
}

// Columns c and c + 1 of a bf16 output row of d columns: the pair as one
// 4-byte store where d is even (c is even, so the pair is aligned), else
// each column apart; columns at d and beyond are not written.
__device__ __forceinline__ void store_pair(__nv_bfloat16* row, int c, int d, float lo, float hi) {
  if ((d & 1) == 0) {
    if (c < d) *reinterpret_cast<__nv_bfloat162*>(row + c) = __floats2bfloat162_rn(lo, hi);
  } else {
    if (c < d) row[c] = __float2bfloat16_rn(lo);
    if (c + 1 < d) row[c + 1] = __float2bfloat16_rn(hi);
  }
}

// The same for a float32 row: the pair as one 8-byte store where d is even.
__device__ __forceinline__ void store_pair(float* row, int c, int d, float lo, float hi) {
  if ((d & 1) == 0) {
    if (c < d) *reinterpret_cast<float2*>(row + c) = make_float2(lo, hi);
  } else {
    if (c < d) row[c] = lo;
    if (c + 1 < d) row[c + 1] = hi;
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Thread-block clusters: this block's rank, a barrier over every thread of
// the cluster that has not exited (release, then acquire), the address in
// block `rank`'s shared memory of a local shared address, and a 16-byte
// store there.
__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\nbarrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t map_shared_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ void st_cluster_v4(uint32_t addr, float a, float b, float c, float d) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "f"(a), "f"(b), "f"(c), "f"(d)
               : "memory");
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

// `bytes` contiguous bytes from global memory into shared memory,
// completing on `bar` (both addresses 16-byte aligned, bytes a multiple
// of 16).
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          dst),
      "l"(src), "r"(bytes), "r"(bar)
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

// MN-major (a row-major [sequence, D] tile read as the B operand with the
// sequence as K and D as N, contiguous: V in P V, K in dS K, dO in P^T dO,
// Q in dS^T Q): groups of 8 rows 1024 B apart. Each product covers one
// 64-column sub-tile, a single swizzle atom along N, so the offset between
// atoms along N is never stepped; both offsets are 1024.
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t addr) { return sw128_desc(addr, 1024, 1024); }

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N commit groups are pending (they complete in order).
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
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

// d[16] (+)= A B for one k16 step, m64n32k16 bf16 -> f32, A and B both
// K-major in shared memory; scale_d = 0 starts the sum from zero.
__device__ __forceinline__ void wgmma_ss_m64n32(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[32] (+)= A B for one k16 step, m64n64k16 bf16 -> f32, A and B both
// K-major in shared memory; scale_d = 0 starts the sum from zero.
__device__ __forceinline__ void wgmma_ss_m64n64(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
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

// acc (+)= A B^T over one 64-column sub-tile: 64 rows of A and 64 of B,
// both K-major in the swizzle TMA wrote; `first` starts the sum from zero.
// One commit group.
__device__ __forceinline__ void issue_sub(float* acc, uint32_t a, uint32_t b, bool first) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss_m64n64(acc, kmajor_desc(a + 32 * kk), kmajor_desc(b + 32 * kk), !(first && kk == 0));
  wgmma_commit();
}

// x = A B^T over all of d (the chunked routes' S, and dP), chained over the
// nsub sub-tiles that a ring of STAGES stages of STAGE_BYTES each brings:
// operand A at byte `opa` of a stage, B at `opb`. Each stage is released
// (`bar_empty`) once the products that read it are done. i counts the
// ring's stages over the block's items.
template <int STAGES, int STAGE_BYTES>
__device__ __forceinline__ void reduce_over_d(float* x, uint32_t ring, uint32_t bar_full, uint32_t bar_empty,
                                              int opa, int opb, int nsub, int& i) {
  fence_regs<32>(x);
  wgmma_fence();
  int prev = 0;
  for (int j = 0; j < nsub; ++j, ++i) {
    const int st = i % STAGES;
    mbar_wait(bar_full + 8 * st, (i / STAGES) & 1);
    const uint32_t stage = ring + st * STAGE_BYTES;
    issue_sub(x, stage + opa, stage + opb, j == 0);
    if (j > 0) {
      wgmma_wait<1>();  // the previous sub-tile's products are done: its stage is free
      mbar_arrive(bar_empty + 8 * prev);
    }
    prev = st;
  }
  wgmma_wait<0>();
  fence_regs<32>(x);
  mbar_arrive(bar_empty + 8 * prev);
}

// The chunked routes' thread-block clusters: a grid of `blocks` blocks
// whose busiest block has `items` items (k-tiles, or (query head, q-tile)
// pairs) splits each block's items over a cluster of CS blocks, CS doubled
// from 1 while the grid has fewer than TARGET_BLOCKS blocks (2 an SM of
// 132), up to MAX_CLUSTER (the portable size) and as long as each rank of
// the busiest block keeps an item (ops/flash_attention.py::_wide_cluster
// says the same).
constexpr int MAX_CLUSTER = 8;
constexpr int TARGET_BLOCKS = 256;
inline int cluster_size(long long blocks, int items) {
  int cs = 1;
  while (cs < MAX_CLUSTER && blocks * cs < TARGET_BLOCKS && 2 * cs <= items) cs *= 2;
  return cs;
}

// Launch `kernel` over `grid` with `bytes` of dynamic shared memory, in
// clusters of the cs consecutive blocks along x (a plain launch at cs 1);
// returns the launch's error.
template <typename K, typename... A>
int launch_cluster(K kernel, int cs, dim3 grid, int threads, int bytes, cudaStream_t stream, const A&... args) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  if (cs == 1) {
    kernel<<<grid, threads, bytes, stream>>>(args...);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = cs;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  if ((e = cudaLaunchKernelEx(&cfg, kernel, args...)) != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The card's SM count (read once), or 0 where the runtime cannot say.
inline int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 0;
  }
  return sms;
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
  // a legal one (a multiple of 16 B, not 0): the span of the dims inside,
  // a row's d * 2 bytes rounded up to 16 (an odd d's padded copy: a single
  // head at d 300 has rows of 608 bytes, and 600 is refused)
  cuuint64_t span = ((cuuint64_t)d * 2 + 15) / 16 * 16;
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

// cp.async: 16 bytes from global into shared memory, or 16 zero bytes
// where !valid (a source size of 0 reads nothing).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
// Wait until at most N of this thread's commit groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [row0, row0 + R) x columns [0, C) of one head's float32 rows (row
// stride `stride` elements) into a shared tile of row stride `ld` by
// cp.async, 16 bytes a thread a step over NT threads; rows at n_rows and
// beyond and columns at d and beyond arrive as zeros. A row holds whole
// 16-byte chunks (the wrapper pads it so).
template <int R, int C, int NT>
__device__ __forceinline__ void load_f32_async(float* dst, int ld, const float* src, long long stride, int row0,
                                               int n_rows, int d) {
  constexpr int CH = C / 4;
  for (int i = threadIdx.x; i < R * CH; i += NT) {
    const int r = i / CH, c = (i % CH) * 4;
    const bool ok = row0 + r < n_rows && c < d;
    cp_async16(dst + r * ld + c, ok ? src + (long long)(row0 + r) * stride + c : src, ok);
  }
}

// ------------------------------------------------ split TF32 (float32)
//
// Float32 products on the tensor cores: x = hi + lo with hi = tf32(x) and
// lo = tf32(x - hi) (rounded as cvt.rna.tf32.f32 rounds: to nearest, ties
// away from zero), and a b as
// hi_a lo_b + lo_a hi_b + hi_a hi_b, three mma.sync m16n8k8 TF32 products
// into one float32 accumulator, the small terms first (long sums: from
// zero, then added in float32, product_cb_rn and slice_product). A TF32
// product is exact in float32; what is dropped (lo_a lo_b, and lo's own rounding) is
// about 2^-22 of a b, float32's own order, where one TF32 product alone is
// off by about 2^-11 (5e-4, past the JAX package's float32 bars of 2e-5).
// Three TF32 products a float32 one: 495 / 3 = 165 TFLOP/s dense, against
// 67 TFLOP/s of float32 FMAs (an NVIDIA H100 80GB HBM3 at 700.00 W,
// published rates). mma.sync, not wgmma: wgmma's
// tf32 form reads B from shared memory K-major only, so P V, dS K, P^T dO
// and dS^T Q would each need a transposed copy, and hi and lo copies of
// every operand; here the threads load and split their B fragments
// themselves, in any layout. Tiles are rows of D + 4 floats: both fragment
// patterns below (along a row; down rows 2t and 2t + 1) are free of bank
// conflicts at every D that is a multiple of 16.

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it: the bits plus half a
// TF32 ulp (0x1000), the low 13 cleared. Two integer operations: ptxas
// expands the cvt into a longer sequence with NaN tests (FSETP, SEL), and
// with it the splits of the B fragments that every warp reads, not the
// mma.sync, bound the kernels.
__device__ __forceinline__ uint32_t tf32_rna(float x) { return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u; }

// hi and lo of x. lo = tf32(x - hi) with the low 13 bits of lo's sum left
// in place: the tensor cores read only a TF32 operand's top 19 bits.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

struct SplitA {
  uint32_t hi[4], lo[4];
};
struct SplitB {
  uint32_t hi[2], lo[2];
};

// c[16x8] += a[16x8] b[8x8], tf32 in, f32 accumulate. Fragments (lane =
// 4 g + t): a = {(g, t), (g+8, t), (g, t+4), (g+8, t+4)}, b = {(t, g),
// (t+4, g)}, c = {(g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)}.
__device__ __forceinline__ void mma1688(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d[16x8] = a[16x8] b[8x8] from zero.
__device__ __forceinline__ void mma1688_zero(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
}

// c += a b in split TF32, the three products chained into c.
__device__ __forceinline__ void mma_tf32x3(float* c, const SplitA& a, const SplitB& b) {
  mma1688(c, a.hi, b.lo);
  mma1688(c, a.lo, b.hi);
  mma1688(c, a.hi, b.hi);
}

// The A fragment of 16 rows (from `rows`, row stride ld) x columns [c, c + 8).
__device__ __forceinline__ SplitA a_split(const float* rows, int ld, int c, int g, int t) {
  SplitA a;
  const float* p = rows + g * ld + c + t;
  split_tf32(p[0], a.hi[0], a.lo[0]);
  split_tf32(p[8 * ld], a.hi[1], a.lo[1]);
  split_tf32(p[4], a.hi[2], a.lo[2]);
  split_tf32(p[8 * ld + 4], a.hi[3], a.lo[3]);
  return a;
}

// The B fragment B[k][n] = rows[n][c + k]: n over 8 rows from `rows` (row
// stride ld), k over columns [c, c + 8) (a product along both rows).
__device__ __forceinline__ SplitB b_split_t(const float* rows, int ld, int c, int g, int t) {
  SplitB b;
  const float* p = rows + g * ld + c + t;
  split_tf32(p[0], b.hi[0], b.lo[0]);
  split_tf32(p[4], b.hi[1], b.lo[1]);
  return b;
}

// An accumulator's 16 x 8 tile as the A fragment of a k8 step, its 8
// columns taken in the order 0, 2, 4, 6, 1, 3, 5, 7 (slot t is column 2t,
// slot t + 4 column 2t + 1), so that each thread's own values fill its own
// slots with no shuffle; b_split_pk reads B's rows in the same order.
__device__ __forceinline__ SplitA c_split(const float* c) {
  SplitA a;
  split_tf32(c[0], a.hi[0], a.lo[0]);
  split_tf32(c[2], a.hi[1], a.lo[1]);
  split_tf32(c[1], a.hi[2], a.lo[2]);
  split_tf32(c[3], a.hi[3], a.lo[3]);
  return a;
}

// The B fragment of 8 rows x 8 columns of a row-major tile at p (row
// stride ld), rows in c_split's order: slot t is row 2t, slot t + 4 row 2t + 1.
__device__ __forceinline__ SplitB b_split_pk(const float* p, int ld, int g, int t) {
  SplitB b;
  const float* r = p + 2 * t * ld + g;
  split_tf32(r[0], b.hi[0], b.lo[0]);
  split_tf32(r[ld], b.hi[1], b.lo[1]);
  return b;
}

// acc += A B^T for this warp's 16 rows of A (`arows`, row stride lda) and
// NB rows of B (`brows`, row stride ldb), over W columns of both: S = Q
// K^T, dP = dO V^T, S^T = K Q^T, dP^T = V dO^T. acc is NB / 8 tiles.
template <int W, int NB>
__device__ __forceinline__ void product_abt(float (*acc)[4], const float* arows, int lda, const float* brows,
                                            int ldb, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < W / 8; ++kk) {
    const SplitA a = a_split(arows, lda, 8 * kk, g, t);
#pragma unroll
    for (int n = 0; n < NB / 8; ++n) mma_tf32x3(acc[n], a, b_split_t(brows + 8 * n * ldb, ldb, 8 * kk, g, t));
  }
}

// acc += C B for C an accumulator of this warp's 16 rows x K columns (K / 8
// tiles: P, dS, P^T, dS^T) and B the K rows of a row-major tile at `b` (row
// stride ldb), W columns: O += P V, dQ += dS K, dV += P^T dO, dK += dS^T Q;
// the products chained into acc.
template <int W, int K>
__device__ __forceinline__ void product_cb(float (*acc)[4], const float (*c)[4], const float* b, int ldb, int g,
                                           int t) {
#pragma unroll
  for (int j = 0; j < K / 8; ++j) {
    const SplitA a = c_split(c[j]);
#pragma unroll
    for (int n = 0; n < W / 8; ++n) mma_tf32x3(acc[n], a, b_split_pk(b + 8 * j * ldb + 8 * n, ldb, g, t));
  }
}

// The backward's long sums (dQ over k-tiles, dK and dV over a group's
// heads and q-tiles) are not chained: the tensor cores' own sums align
// their addends to the largest by truncation, an error that leans one
// way, and chained into an accumulator that outgrows each product it
// grows with the chain, past the float32 bars at 4 heads x 1000 queries a
// kv head. So each column tile's products of a step are summed from zero
// (tile_sum), then added to the accumulator in float32, rounded to nearest.

// d = column tile n of C B (as product_cb), summed from zero over the K rows.
template <int K>
__device__ __forceinline__ void tile_sum(float* d, const float (*c)[4], const float* b, int ldb, int n, int g,
                                         int t) {
#pragma unroll
  for (int j = 0; j < K / 8; ++j) {
    const SplitA a = c_split(c[j]);  // the same for every n: made once
    const SplitB bn = b_split_pk(b + 8 * j * ldb + 8 * n, ldb, g, t);
    if (j == 0) {
      mma1688_zero(d, a.hi, bn.lo);
    } else {
      mma1688(d, a.hi, bn.lo);
    }
    mma1688(d, a.lo, bn.hi);
    mma1688(d, a.hi, bn.hi);
  }
}

// acc += C B, each tile's sum added in float32.
template <int W, int K>
__device__ __forceinline__ void product_cb_rn(float (*acc)[4], const float (*c)[4], const float* b, int ldb, int g,
                                              int t) {
#pragma unroll
  for (int n = 0; n < W / 8; ++n) {
    float d[4];
    tile_sum<K>(d, c, b, ldb, n, g, t);
    acc[n][0] += d[0], acc[n][1] += d[1], acc[n][2] += d[2], acc[n][3] += d[3];
  }
}

// The same with the accumulator in shared memory, where registers run out:
// this thread's 4 floats of tile n at acc_s[n NT + thread].
template <int W, int K, int NT>
__device__ __forceinline__ void product_cb_rn_shared(float4* acc_s, const float (*c)[4], const float* b, int ldb,
                                                     int g, int t) {
#pragma unroll
  for (int n = 0; n < W / 8; ++n) {
    float d[4];
    tile_sum<K>(d, c, b, ldb, n, g, t);
    float4& s = acc_s[n * NT + threadIdx.x];
    const float4 v = s;
    s = make_float4(v.x + d[0], v.y + d[1], v.z + d[2], v.w + d[3]);
  }
}

// The chunked routes' float32 slices: S (and dP) over d in TF32_SLICE
// columns at a time, two stages.
constexpr int TF32_SLICE = 64;
constexpr int TF32_LDS = TF32_SLICE + 4;

// Floats of the two stages of slices for P products of 64 x NB.
template <int NB, int P>
__host__ __device__ constexpr int tf32_slice_floats() { return 2 * P * (64 + NB) * TF32_LDS; }

// One stage of tf32_products_by_slices: slice si's columns of A1 and B1
// (and A2, B2) into stage si % 2 of `bufs`, one commit group.
template <int NB, int P, int NT>
__device__ __forceinline__ void issue_slice(float* bufs, int si, const float* a1, const float* a2, long long sa1,
                                            long long sa2, int row0a, int na, const float* b1, const float* b2,
                                            long long sb1, long long sb2, int row0b, int nb, int d) {
  float* st = bufs + (si & 1) * (P * (64 + NB) * TF32_LDS);
  const int c = si * TF32_SLICE;
  load_f32_async<64, TF32_SLICE, NT>(st, TF32_LDS, a1 + c, sa1, row0a, na, d - c);
  load_f32_async<NB, TF32_SLICE, NT>(st + 64 * TF32_LDS, TF32_LDS, b1 + c, sb1, row0b, nb, d - c);
  if constexpr (P == 2) {
    load_f32_async<64, TF32_SLICE, NT>(st + (64 + NB) * TF32_LDS, TF32_LDS, a2 + c, sa2, row0a, na, d - c);
    load_f32_async<NB, TF32_SLICE, NT>(st + (128 + NB) * TF32_LDS, TF32_LDS, b2 + c, sb2, row0b, nb, d - c);
  }
  cp_async_commit();
}

// acc += one slice's A B^T (product_abt over TF32_SLICE columns), the
// slice's products summed from zero, then added in float32: a chain over
// all of d into one accumulator leans as product_cb_rn says (at d 1000 the
// forward's out and lse came within 10% of the 2e-5 bar).
template <int NB>
__device__ __forceinline__ void slice_product(float (*acc)[4], const float* arows, const float* brows, int g, int t) {
  float ps[NB / 8][4];
#pragma unroll
  for (int n = 0; n < NB / 8; ++n) ps[n][0] = ps[n][1] = ps[n][2] = ps[n][3] = 0.f;
  product_abt<TF32_SLICE, NB>(ps, arows, TF32_LDS, brows, TF32_LDS, g, t);
#pragma unroll
  for (int n = 0; n < NB / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += ps[n][e];
}

// S = A1 B1^T (and dP = A2 B2^T where P is 2) for this warp's 16 of the 64
// rows [row0a, row0a + 64) of A1 (A2) against rows [row0b, row0b + NB) of
// B1 (B2), each with d columns (row strides sa1, ... in elements), over d
// in slices staged through `bufs` by cp.async, the next slice's copy in
// flight during a slice's products. Waits for every cp.async group
// committed before it (the caller's chunk tiles) and ends on
// __syncthreads with both stages free; the caller syncs before it.
template <int NB, int P, int NT>
__device__ __forceinline__ void tf32_products_by_slices(float (*s)[4], float (*dp)[4], float* bufs, const float* a1,
                                                        const float* a2, long long sa1, long long sa2, int row0a,
                                                        int na, const float* b1, const float* b2, long long sb1,
                                                        long long sb2, int row0b, int nb, int d, int warp, int g,
                                                        int t) {
  constexpr int STAGE = P * (64 + NB) * TF32_LDS;
#pragma unroll
  for (int n = 0; n < NB / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[n][e] = 0.f;
      if constexpr (P == 2) dp[n][e] = 0.f;
    }
  const int ns = (d + TF32_SLICE - 1) / TF32_SLICE;
  issue_slice<NB, P, NT>(bufs, 0, a1, a2, sa1, sa2, row0a, na, b1, b2, sb1, sb2, row0b, nb, d);
  for (int si = 0; si < ns; ++si) {
    if (si + 1 < ns) {
      issue_slice<NB, P, NT>(bufs, si + 1, a1, a2, sa1, sa2, row0a, na, b1, b2, sb1, sb2, row0b, nb, d);
    } else {
      cp_async_commit();  // an empty group keeps the count: slice si and all before it land
    }
    cp_async_wait<1>();
    __syncthreads();
    const float* st = bufs + (si & 1) * STAGE;
    slice_product<NB>(s, st + 16 * warp * TF32_LDS, st + 64 * TF32_LDS, g, t);
    if constexpr (P == 2) {
      // the second product's loads after the first's products: interleaved,
      // their fragments spilled the chunked kernels' registers
      asm volatile("" ::: "memory");
      slice_product<NB>(dp, st + (64 + NB + 16 * warp) * TF32_LDS, st + (128 + NB) * TF32_LDS, g, t);
    }
    __syncthreads();  // every warp is done with this stage before slice si + 2 lands in it
  }
}

}  // namespace hopper
}  // namespace
