// K8: candidate rescore for Hopper (sm_90a): the gathered dots alone
// (gather_scores_kernel), and the whole rescore in one launch
// (rescore_topk_kernel).
//
// Replaces the Pallas kernel tpurag/kernels/quant.py:gather_scores_pallas
// (:213, body _gather_scores_kernel) and the rescore around it,
// tpurag/kernels/quant.py:rescore_topk (:250). gather_scores_kernel is the
// Pallas kernel's function: out[b, m] = the fp32 dot of query b (fp32) with
// corpus row cand[b, m] (bf16 or fp32 storage); a candidate id < 0 (or >=
// N) writes 0, which the caller masks. rescore_topk_kernel is the rescore:
// the same dots, then per query the top-k of its candidates by (score
// descending, smaller id first), where an id < 0 and an id equal to one at
// an earlier lane are no candidate (duplicates score alike, so keeping the
// first lane and keeping the smaller id agree); empty slots come out as
// (NEG_INF, -1). In PyTorch that rescore was a dozen launches around the
// dots (a mask, a stable argsort, gathers, duplicate marking, a sort).
//
// What bounds it: bytes. Each (query, candidate) pair reads one D-row once
// (2 KB at 1024 bf16) and does 2 D flops on it, far below the card's
// operation rate; at the rescore's sizes (32 queries x 32 candidates) that
// is ~0.1 us of device memory time, so a launch's fixed cost and the
// host's enqueue set the time, and one launch in place of a dozen is what
// the rescore gains. Design: one warp per (query, candidate); its lanes
// read the row in 16-byte loads (coalesced), multiply by the fp32 query
// (read through L1: every candidate of a query shares it), sum in fp32 and
// reduce with warp shuffles. The rescore gives each query one block: its
// warps take the query's candidates in turn with the same warp dot, keep
// (score, id) in shared memory, flag each lane's id against the lanes
// before it, and each kept candidate counts the kept ones that sort before
// it (one 64-bit key compare each, csrc/topk.cuh's make_key): that count
// is its slot. Both passes are M^2 / 2 compares a query, ~500 at M = 32.
// The TPU kernel fetched an aligned 8-row block per candidate and
// compacted with a matmul, a Mosaic tiling workaround that is not carried
// over.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "topk.cuh"

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

// The fp32 dot of query qr with corpus row `row` (D values), summed by one
// warp; every lane returns it.
template <typename T>
__device__ __forceinline__ float warp_dot(const float* qr, const T* row,
                                          int D, bool vec) {
  constexpr int VEC = 16 / sizeof(T);
  const int lane = threadIdx.x & 31;
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
    acc += __shfl_xor_sync(tr::kFullMask, acc, off);
  return acc;
}

// grid cdiv(B * M, WARPS): warp w scores pair (w / M, w % M).
template <typename T>
__global__ void __launch_bounds__(THREADS)
    gather_scores_kernel(const float* __restrict__ q,
                         const T* __restrict__ emb,
                         const int* __restrict__ ids, int B, int M, int N,
                         int D, bool vec, float* __restrict__ out) {
  const size_t w = (size_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (w >= (size_t)B * M) return;
  const int id = ids[w];
  const float s = id < 0 || id >= N
                      ? 0.f
                      : warp_dot(q + (w / M) * D, emb + (size_t)id * D, D,
                                 vec);
  if ((threadIdx.x & 31) == 0) out[w] = s;
}

// grid B: block b rescores query b's M candidates into out_v / out_i
// (B, k). Shared memory: M keys (8 bytes) and M ids.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    rescore_topk_kernel(const float* __restrict__ q,
                        const T* __restrict__ emb,
                        const int* __restrict__ ids, int M, int N, int D,
                        bool vec, int k, float* __restrict__ out_v,
                        int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  tr::Key* keys = reinterpret_cast<tr::Key*>(smem);  // 0: no candidate
  int* cid = reinterpret_cast<int*>(keys + M);
  __shared__ int n_kept;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int* row_ids = ids + (size_t)b * M;
  if (tid == 0) n_kept = 0;
  for (int m = tid; m < M; m += THREADS) cid[m] = row_ids[m];
  __syncthreads();

  // The dots, one warp a candidate; a lane whose id is < 0 or repeats an
  // earlier lane's is no candidate (key 0).
  const float* qr = q + (size_t)b * D;
  for (int m = tid >> 5; m < M; m += WARPS) {
    const int id = cid[m];
    bool keep = id >= 0;
    for (int j = tid & 31; keep && j < m; j += 32)
      if (cid[j] == id) keep = false;
    keep = __all_sync(tr::kFullMask, keep);
    float s = 0.f;
    if (keep && id < N) s = warp_dot(qr, emb + (size_t)id * D, D, vec);
    if ((tid & 31) == 0) keys[m] = keep ? tr::make_key(s, id) : 0ull;
  }
  __syncthreads();

  // Each kept candidate's slot: the kept keys above its own (keys are
  // distinct: ids are).
  int kept = 0;
  for (int m = tid; m < M; m += THREADS) {
    const tr::Key key = keys[m];
    if (key == 0ull) continue;
    ++kept;
    int rank = 0;
    for (int j = 0; j < M; ++j) rank += keys[j] > key;
    if (rank < k) {
      out_v[(size_t)b * k + rank] = tr::key_value(key);
      out_i[(size_t)b * k + rank] = tr::key_id(key);
    }
  }
  if (kept) atomicAdd(&n_kept, kept);
  __syncthreads();
  for (int j = n_kept + tid; j < k; j += THREADS) {
    out_v[(size_t)b * k + j] = tr::kNegInf;
    out_i[(size_t)b * k + j] = -1;
  }
}

template <typename T>
bool vec_ok(const float* q, const void* emb, int D) {
  return (D * sizeof(T)) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(emb) % 16 == 0;
}

template <typename T>
cudaError_t launch(const float* q, const void* emb, const int* ids, int B,
                   int M, int N, int D, float* out, cudaStream_t st) {
  const size_t pairs = (size_t)B * M;
  const unsigned blocks = (unsigned)((pairs + WARPS - 1) / WARPS);
  gather_scores_kernel<T><<<blocks, THREADS, 0, st>>>(
      q, static_cast<const T*>(emb), ids, B, M, N, D, vec_ok<T>(q, emb, D),
      out);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_rescore(const float* q, const void* emb, const int* ids,
                           int B, int M, int N, int D, int k, float* out_v,
                           int* out_i, cudaStream_t st) {
  const size_t smem = (size_t)M * (sizeof(tr::Key) + sizeof(int));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rescore_topk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  rescore_topk_kernel<T><<<B, THREADS, smem, st>>>(
      q, static_cast<const T*>(emb), ids, M, N, D, vec_ok<T>(q, emb, D), k,
      out_v, out_i);
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

// The rescore: (B, D) fp32 queries, (N, D) rows, (B, M) int32 ids ->
// (B, k) fp32 scores / int32 ids. dtype as above; B, M, k >= 1 and M * 12
// bytes within a block's shared memory.
extern "C" int tr_rescore_topk(const float* q, const void* emb, int dtype,
                               const int* ids, int B, int M, int N, int D,
                               int k, float* out_v, int* out_i,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || M < 1 || k < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return (int)launch_rescore<__nv_bfloat16>(q, emb, ids, B, M, N, D, k,
                                              out_v, out_i, st);
  if (dtype == 0)
    return (int)launch_rescore<float>(q, emb, ids, B, M, N, D, k, out_v,
                                      out_i, st);
  return (int)cudaErrorInvalidValue;
}
