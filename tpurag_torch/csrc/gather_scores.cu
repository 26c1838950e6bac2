// K8: candidate rescore dots for Hopper (sm_90a).
//
// Replaces the Pallas kernel tpurag/kernels/quant.py:gather_scores_pallas
// (body _gather_scores_kernel). Same function: out[b, m] = the fp32 dot of
// query b (fp32) with corpus row cand[b, m] (bf16 or fp32 storage); a
// candidate id < 0 (or >= N) writes 0, which the caller masks.
//
// What bounds it: bytes. Each (query, candidate) pair reads one D-row once
// (2 KB at 1024 bf16) and does 2 D flops on it, far below the card's
// operation rate. Design: one warp per (query, candidate); its lanes read
// the row in 16-byte loads (coalesced), multiply by the fp32 query (read
// through L1: every candidate of a query shares it), sum in fp32 and
// reduce with warp shuffles. The TPU kernel fetched an aligned 8-row block
// per candidate and compacted with a matmul, a Mosaic tiling workaround
// that is not carried over.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float dot16(const float* q, uint4 r,
                                       const __nv_bfloat16*) {
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&r);
  const float4 a = __ldg(reinterpret_cast<const float4*>(q));
  const float4 b = __ldg(reinterpret_cast<const float4*>(q) + 1);
  float s = a.x * __bfloat162float(e[0]);
  s = fmaf(a.y, __bfloat162float(e[1]), s);
  s = fmaf(a.z, __bfloat162float(e[2]), s);
  s = fmaf(a.w, __bfloat162float(e[3]), s);
  s = fmaf(b.x, __bfloat162float(e[4]), s);
  s = fmaf(b.y, __bfloat162float(e[5]), s);
  s = fmaf(b.z, __bfloat162float(e[6]), s);
  return fmaf(b.w, __bfloat162float(e[7]), s);
}

__device__ __forceinline__ float dot16(const float* q, uint4 r,
                                       const float*) {
  const float4 e = *reinterpret_cast<const float4*>(&r);
  const float4 a = __ldg(reinterpret_cast<const float4*>(q));
  float s = a.x * e.x;
  s = fmaf(a.y, e.y, s);
  s = fmaf(a.z, e.z, s);
  return fmaf(a.w, e.w, s);
}

__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(float x) { return x; }

// grid cdiv(B * M, WARPS): warp w scores pair (w / M, w % M).
template <typename T>
__global__ void __launch_bounds__(THREADS)
    gather_scores_kernel(const float* __restrict__ q,
                         const T* __restrict__ emb,
                         const int* __restrict__ ids, int B, int M, int N,
                         int D, bool vec, float* __restrict__ out) {
  constexpr int VEC = 16 / sizeof(T);
  const int lane = threadIdx.x & 31;
  const size_t w = (size_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (w >= (size_t)B * M) return;
  const int id = ids[w];
  if (id < 0 || id >= N) {
    if (lane == 0) out[w] = 0.f;
    return;
  }
  const float* qr = q + (w / M) * D;
  const T* row = emb + (size_t)id * D;
  float acc = 0.f;
  if (vec) {  // D * sizeof(T) is a multiple of 16; rows and queries aligned
    for (int c = lane * VEC; c < D; c += 32 * VEC)
      acc += dot16(qr + c,
                   __ldg(reinterpret_cast<const uint4*>(row + c)), row);
  } else {
    for (int c = lane; c < D; c += 32)
      acc = fmaf(__ldg(qr + c), to_float(row[c]), acc);
  }
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) out[w] = acc;
}

template <typename T>
cudaError_t launch(const float* q, const void* emb, const int* ids, int B,
                   int M, int N, int D, float* out, cudaStream_t st) {
  const bool vec = (D * sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(emb) % 16 == 0;
  const size_t pairs = (size_t)B * M;
  const unsigned blocks = (unsigned)((pairs + WARPS - 1) / WARPS);
  gather_scores_kernel<T><<<blocks, THREADS, 0, st>>>(
      q, static_cast<const T*>(emb), ids, B, M, N, D, vec, out);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = fp32 rows, 1 = bf16 rows.
extern "C" int tr_gather_scores(const float* q, const void* emb, int dtype,
                                const int* ids, int B, int M, int N, int D,
                                float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, emb, ids, B, M, N, D, out, st);
  if (dtype == 0) return (int)launch<float>(q, emb, ids, B, M, N, D, out, st);
  return (int)cudaErrorInvalidValue;
}
