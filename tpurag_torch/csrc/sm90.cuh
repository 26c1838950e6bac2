// Hopper pieces shared by the TMA + wgmma bodies of K1
// (dense_topk_sm90.cu, bf16), K5 (dense_topk_q8_sm90.cu, int8) and K7
// (dense_topk_co_sm90.cu, bf16) and by
// the bulk-copy staging of K3 (bm25_full.cu), K4 (bm25_combine.cu) and
// K6's row-split ring (ivf_probe.cu): the
// mbarrier, TMA and bulk copy helpers, the staging of an unaligned range,
// the wgmma descriptor of a 128-byte-swizzled K-major box and the fences
// around asynchronous products, and the tensor-map encoder, fetched at run
// time so the library needs no -lcuda.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (the encoder is fetched at run time)
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace sm90 {

constexpr int ALIGN = 1024;       // a 128-byte-swizzle box starts 1024-aligned
constexpr int MAX_SMEM = 232448;  // 227 KB: Hopper's per-block limit

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n"
      ".reg .b64 st;\n"
      "mbarrier.arrive.shared::cta.b64 st, [%0];\n"
      "}\n" ::"r"(smem_u32(bar))
      : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
  }
}

// TMA: the box at (column c0, row c1) of a 2-D tensor map into shared
// memory; completion counts its bytes on the barrier.
__device__ __forceinline__ void tma_load(void* dst, uint64_t map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(map), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// 1-D bulk copy of `bytes` (a multiple of 16; both addresses 16-byte
// aligned) from device memory into shared memory; completion counts its
// bytes on the barrier.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Where src[x0, x0 + n) (4-byte elements) goes in shared memory: element
// x at dst[h + x - x0], h the offset of src + x0 in its 16-byte line, so
// the aligned middle [mid0, mid1) of dst's indices is one bulk copy and
// [h, mid0) and [mid1, h + n) are plain loads.
struct Staged {
  int h, mid0, mid1, end;
};

__device__ __forceinline__ Staged staging(const void* src, int n) {
  Staged s;
  s.h = (int)(((uintptr_t)src >> 2) & 3);
  s.end = s.h + n;
  s.mid0 = (s.h + 3) & ~3;
  s.mid1 = s.end & ~3;
  if (s.mid1 <= s.mid0) s.mid0 = s.mid1 = s.end;  // no aligned middle
  return s;
}

__device__ __forceinline__ uint32_t middle_bytes(const Staged& s) {
  return (uint32_t)(s.mid1 - s.mid0) * 4;
}

// One thread: the bulk copy of the aligned middle, counted on bar.
__device__ __forceinline__ void bulk_middle(void* dst, const void* src,
                                            const Staged& s, uint64_t* bar) {
  if (s.mid1 > s.mid0)
    bulk_load((char*)dst + 4 * s.mid0, (const char*)src + 4 * (s.mid0 - s.h),
              middle_bytes(s), bar);
}

// Threads first, first + step, ...: the unaligned head and tail by plain
// loads.
__device__ __forceinline__ void plain_edges(int* dst, const int* src,
                                            const Staged& s, int first,
                                            int step) {
  for (int o = s.h + first; o < s.mid0; o += step) dst[o] = src[o - s.h];
  for (int o = s.mid1 + first; o < s.end; o += step) dst[o] = src[o - s.h];
}

// Named barrier `id` (1-15; 0 is __syncthreads) over the first `threads`
// threads of the block (a multiple of 32): the warps that take part.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// Make freshly initialised barriers visible to the copy engine.
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Order this thread's earlier shared-memory accesses before later
// asynchronous (bulk copy) writes to the same memory.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// wgmma shared-memory descriptor of a K-major box with 128-byte rows and
// 128-byte swizzle: start address >> 4, leading offset 1 (unused when
// swizzled), stride 1024 bytes between 8-row groups, layout type 1. One
// k-step reads 32 bytes of each row (16 bf16 or 32 int8): +2.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Wait until at most one committed group of products is still running.
__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous products (they are registers the asm statements share).
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API function; the runtime hands out
// its address, so the library needs no link against libcuda.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (rows, cols) row-major matrix of `elem_bytes`-wide elements cut into
// boxes of box_rows rows x 128 bytes with 128-byte swizzle; out-of-bounds
// elements read as zero. The row pitch (cols * elem_bytes) must be a
// multiple of 16 bytes and ptr 16-byte aligned.
inline cudaError_t encode_boxes(CUtensorMap* map, CUtensorMapDataType dtype,
                                int elem_bytes, const void* ptr, int rows,
                                int cols, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  memset(map, 0, sizeof(*map));
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)(128 / elem_bytes),
                             (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, dtype, 2, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

}  // namespace sm90
