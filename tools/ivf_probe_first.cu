// K6's first design, kept only to be timed beside the row-split body
// (tools/k6_anatomy.py builds it; chip_smoke.py times it on the main
// path's inputs). It is csrc/ivf_probe.cu as it was before the row split:
// a (B, S) grid of probe slices, S = min(ceil(264 / B), n_probe, 8192 / k),
// and a second kernel that merges each query's S partial lists.
//
// K6: IVF probe-scan for Hopper (sm_90a).
//
// Replaces the Pallas kernel tpurag/kernels/ivf_scan.py:
// ivf_probe_topk_pallas (bodies _ivf_probe_kernel and
// _ivf_probe_kernel_pipelined). Same function: for each query b, score the
// rows of its n_probe clusters (rows starts[b, p] .. + counts[b, p] of the
// cluster-major IVF matrix) and keep the running top-k over IVF-row ids,
// value descending, ties to the smaller id; empty slots (NEG_INF, 2^30).
// Storage: int8 codes (query codes x row codes -> exact int32, times the
// cluster's fp32 scale scales[b, p]; the query scale is the caller's), or
// bf16 / fp32 rows against the query cast to the storage type, with fp32
// accumulation.
//
// What bounds it: bytes. No row is shared between queries, so the work is
// a batch of matrix-vector products: about 2 operations per byte read,
// far below the tensor cores' line. Design: one block per (query, slice of
// its probes), the query staged once in shared memory; each warp takes
// 32-row chunks of the block's clusters in turn, reads 4 rows at a time in
// 16-byte loads (__dp4a for int8, fp32 FMAs otherwise), sums across the
// warp with shuffles and folds its 32 scores into a per-warp running list
// (topk.cuh). The block then merges its warps' lists into one partial
// list per (query, slice), and a small merge kernel takes the top-k of the
// S partial lists of each query.
//
// Not carried over: the TPU kernels' probe-axis chunking (a scalar-memory
// cap), their fixed sub-block DMAs sized by the largest cluster and the
// pipelined BlockSpec variant; any cluster start and size works here, and
// no read goes past a cluster's own rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "topk.cuh"

namespace {

constexpr int THREADS = 256;  // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int RB = 4;  // rows a warp reads at once
constexpr int BIG_ID = 1 << 30;
constexpr int MERGE_THREADS = 128;

template <typename T>
struct Traits;

template <>
struct Traits<int8_t> {
  using Acc = int;
  static __device__ __forceinline__ int dot16(uint4 a, uint4 b, int acc) {
    acc = __dp4a((int)a.x, (int)b.x, acc);
    acc = __dp4a((int)a.y, (int)b.y, acc);
    acc = __dp4a((int)a.z, (int)b.z, acc);
    return __dp4a((int)a.w, (int)b.w, acc);
  }
  static __device__ __forceinline__ int fma1(int8_t a, int8_t b, int acc) {
    return acc + (int)a * (int)b;
  }
  static __device__ __forceinline__ float score(int acc, float scale) {
    return __int2float_rn(acc) * scale;
  }
};

template <>
struct Traits<__nv_bfloat16> {
  using Acc = float;
  static __device__ __forceinline__ float dot16(uint4 a, uint4 b,
                                                float acc) {
    const __nv_bfloat16* x = reinterpret_cast<const __nv_bfloat16*>(&a);
    const __nv_bfloat16* y = reinterpret_cast<const __nv_bfloat16*>(&b);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      acc = fmaf(__bfloat162float(x[i]), __bfloat162float(y[i]), acc);
    return acc;
  }
  static __device__ __forceinline__ float fma1(__nv_bfloat16 a,
                                               __nv_bfloat16 b, float acc) {
    return fmaf(__bfloat162float(a), __bfloat162float(b), acc);
  }
  static __device__ __forceinline__ float score(float acc, float) {
    return acc;
  }
};

template <>
struct Traits<float> {
  using Acc = float;
  static __device__ __forceinline__ float dot16(uint4 a, uint4 b,
                                                float acc) {
    const float4 x = *reinterpret_cast<const float4*>(&a);
    const float4 y = *reinterpret_cast<const float4*>(&b);
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
    acc = fmaf(x.z, y.z, acc);
    return fmaf(x.w, y.w, acc);
  }
  static __device__ __forceinline__ float fma1(float a, float b, float acc) {
    return fmaf(a, b, acc);
  }
  static __device__ __forceinline__ float score(float acc, float) {
    return acc;
  }
};

template <typename A>
__device__ __forceinline__ A warp_sum(A v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(tr::kFullMask, v, off);
  return v;
}

// grid (B, S). Block (b, s) scans probes [s * per, (s + 1) * per) of
// query b and writes its top-k to part[(b * S + s) * k : ... + k].
template <typename T>
__global__ void __launch_bounds__(THREADS)
    ivf_scan_kernel(const T* __restrict__ q, const T* __restrict__ emb,
                    const int* __restrict__ starts,
                    const int* __restrict__ counts,
                    const float* __restrict__ scales, int n_probe, int D,
                    int k, int S, bool vec, float* part_v, int* part_i) {
  using Acc = typename Traits<T>::Acc;
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float red_v[32];
  __shared__ int red_i[32];
  __shared__ int red_p[32];
  const int q_bytes = (int)((D * sizeof(T) + 15) / 16 * 16);
  T* qs = reinterpret_cast<T*>(smem);
  float* all_v = reinterpret_cast<float*>(smem + q_bytes);
  int* all_i = reinterpret_cast<int*>(all_v + WARPS * k);

  const int b = blockIdx.x;
  const int s = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int c = threadIdx.x; c < D; c += THREADS) qs[c] = q[(size_t)b * D + c];
  float* lv = all_v + warp * k;
  int* li = all_i + warp * k;
  tr::warp_list_init(lv, li, k, BIG_ID);
  __syncthreads();

  const int per = (n_probe + S - 1) / S;
  const int p_end = min(n_probe, (s + 1) * per);
  int chunks_before = 0;  // deals chunks to warps across the probes
  for (int p = s * per; p < p_end; ++p) {
    const size_t tp = (size_t)b * n_probe + p;
    const int start = starts[tp];
    const int count = counts[tp];
    const float scale = scales != nullptr ? scales[tp] : 1.f;
    const int n_chunks = (count + 31) / 32;
    const int first = ((warp - chunks_before) % WARPS + WARPS) % WARPS;
    chunks_before += n_chunks;
    for (int c = first; c < n_chunks; c += WARPS) {
      const int base = c * 32;
      float my_v = -INFINITY;
      int my_id = tr::kIntMax;
      bool mine = false;
      for (int i0 = 0; i0 < 32 && base + i0 < count; i0 += RB) {
        const T* rows[RB];
        Acc acc[RB];
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const int off = min(base + i0 + r, count - 1);
          rows[r] = emb + (size_t)(start + off) * D;
          acc[r] = 0;
        }
        if (vec) {  // D * sizeof(T) is a multiple of 16, rows aligned
          for (int cc = lane * VEC; cc < D; cc += 32 * VEC) {
            const uint4 a = *reinterpret_cast<const uint4*>(qs + cc);
            uint4 e[RB];
#pragma unroll
            for (int r = 0; r < RB; ++r)
              e[r] = __ldg(reinterpret_cast<const uint4*>(rows[r] + cc));
#pragma unroll
            for (int r = 0; r < RB; ++r)
              acc[r] = Traits<T>::dot16(a, e[r], acc[r]);
          }
        } else {
          for (int cc = lane; cc < D; cc += 32) {
#pragma unroll
            for (int r = 0; r < RB; ++r)
              acc[r] = Traits<T>::fma1(qs[cc], rows[r][cc], acc[r]);
          }
        }
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const Acc sum = warp_sum(acc[r]);
          if (lane == i0 + r && base + i0 + r < count) {
            my_v = Traits<T>::score(sum, scale);
            my_id = start + base + i0 + r;
            mine = true;
          }
        }
      }
      // Fold the chunk's scores into the warp's list: a lane's score
      // enters only if it beats the list's k-th entry.
      float kv = lv[k - 1];
      int ki = li[k - 1];
      bool cand = mine && tr::lex_gt(my_v, my_id, kv, ki);
      while (__any_sync(tr::kFullMask, cand)) {
        float bv = cand ? my_v : -INFINITY;
        int bi = cand ? my_id : tr::kIntMax;
        int unused = 0;
        tr::warp_lex_max3(bv, bi, unused);
        tr::warp_list_insert(lv, li, k, bv, bi);
        kv = lv[k - 1];
        ki = li[k - 1];
        cand = cand && my_id != bi && tr::lex_gt(my_v, my_id, kv, ki);
      }
    }
  }
  __syncthreads();
  const size_t out = ((size_t)b * S + s) * k;
  tr::block_topk(all_v, all_i, WARPS * k, k, BIG_ID, BIG_ID, part_v + out,
                 part_i + out, red_v, red_i, red_p);
}

// One block per query: the top-k of its S partial lists.
__global__ void __launch_bounds__(MERGE_THREADS)
    ivf_merge_kernel(const float* __restrict__ part_v,
                     const int* __restrict__ part_i, int S, int k,
                     float* out_v, int* out_i) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float red_v[32];
  __shared__ int red_i[32];
  __shared__ int red_p[32];
  const int m = S * k;
  float* cv = reinterpret_cast<float*>(smem);
  int* ci = reinterpret_cast<int*>(cv + m);
  const size_t row = blockIdx.x;
  for (int e = threadIdx.x; e < m; e += blockDim.x) {
    cv[e] = part_v[row * m + e];
    ci[e] = part_i[row * m + e];
  }
  __syncthreads();
  tr::block_topk(cv, ci, m, k, BIG_ID, BIG_ID, out_v + row * k,
                 out_i + row * k, red_v, red_i, red_p);
}

template <typename T>
cudaError_t launch_scan(const void* q, const void* emb, const int* starts,
                        const int* counts, const float* scales, int B,
                        int n_probe, int D, int k, int S, float* part_v,
                        int* part_i, cudaStream_t st) {
  const size_t smem = (D * sizeof(T) + 15) / 16 * 16 +
                      (size_t)WARPS * k * (sizeof(float) + sizeof(int));
  const bool vec = (D * sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(emb) % 16 == 0;
  cudaError_t err = cudaFuncSetAttribute(
      ivf_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  ivf_scan_kernel<T><<<dim3(B, S), THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(emb), starts, counts,
      scales, n_probe, D, k, S, vec, part_v, part_i);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16, 2 = int8 (then scales is (B, n_probe) fp32).
// q (B, D) in the storage type. With S == 1 the scan writes out_v/out_i
// directly and part_v/part_i are not read.
extern "C" int tr_ivf_probe_topk(const void* q, const void* emb, int dtype,
                                 const int* starts, const int* counts,
                                 const float* scales, int B, int n_probe,
                                 int D, int k, int S, float* part_v,
                                 int* part_i, float* out_v, int* out_i,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pv = S == 1 ? out_v : part_v;
  int* pi = S == 1 ? out_i : part_i;
  cudaError_t err;
  if (dtype == 2)
    err = launch_scan<int8_t>(q, emb, starts, counts, scales, B, n_probe, D,
                              k, S, pv, pi, st);
  else if (dtype == 1)
    err = launch_scan<__nv_bfloat16>(q, emb, starts, counts, nullptr, B,
                                     n_probe, D, k, S, pv, pi, st);
  else if (dtype == 0)
    err = launch_scan<float>(q, emb, starts, counts, nullptr, B, n_probe, D,
                             k, S, pv, pi, st);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess || S == 1) return (int)err;
  const size_t merge_smem = (size_t)S * k * (sizeof(float) + sizeof(int));
  err = cudaFuncSetAttribute(ivf_merge_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)merge_smem);
  if (err != cudaSuccess) return (int)err;
  ivf_merge_kernel<<<B, MERGE_THREADS, merge_smem, st>>>(part_v, part_i, S,
                                                         k, out_v, out_i);
  return (int)cudaGetLastError();
}
