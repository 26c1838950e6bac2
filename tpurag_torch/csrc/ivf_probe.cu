// K6: IVF probe-scan for Hopper (sm_90a).
//
// Replaces the Pallas kernel tpurag/kernels/ivf_scan.py:
// ivf_probe_topk_pallas (bodies _ivf_probe_kernel and
// _ivf_probe_kernel_pipelined). Same function: for each query b, score the
// rows of its n_probe clusters (rows starts[b, p] .. + counts[b, p] of the
// cluster-major IVF matrix) and keep the top-k over IVF-row ids, value
// descending, ties to the smaller id; empty slots (NEG_INF, 2^30).
// Storage: int8 codes (query codes x row codes -> exact int32, times the
// cluster's fp32 scale scales[b, p]; the query scale is the caller's), or
// bf16 / fp32 rows against the query cast to the storage type, with fp32
// accumulation.
//
// What bounds it: bytes. No row is shared between queries, so the work is
// a batch of matrix-vector products: about 2 operations per byte read,
// far below the tensor cores' line. Only bytes in flight and balance
// across the SMs matter.
//
// The row-split body (ivf_rows_kernel; rows of a multiple of 16 bytes, up
// to 32 KB, 16-byte aligned matrix and queries). Every query's probed
// rows, query-major then probe, are cut into chunks of R rows (a stage of
// the ring: at most 32 KB, at most 256 rows); a chunk never crosses a
// cluster, and a query's first probe has at least one chunk (an empty one
// when the query has no rows), so every query reaches a block. A grid sized
// to the card (the SMs times the blocks per SM that shared memory allows)
// deals the chunks out in equal shares of whole chunks; each block finds
// its first chunk by a block-wide prefix sum over the (B, n_probe) counts
// table, with no host round trip. One producer warp walks the block's
// chunks and brings each into a ring of STAGES shared-memory stages with one
// 1-D bulk copy (cp.async.bulk, completing on the stage's mbarrier), beside
// a header naming its query, first row id, rows and scale. Eight consumer
// warps score the staged rows against the query (staged in shared memory
// once per query the block meets): __dp4a for int8 (the exact int32 dot,
// then __int2float_rn(acc) * scale as the plain version), fp32 FMAs
// otherwise, a warp sum per row, and fold them into per-warp lists of
// 64-bit (score, id) keys (one key a lane for k <= 32, else in shared
// memory). When the block leaves a query it merges its warp
// lists by rank into one partial list for that query (slot block + query:
// the (block, query) pairs are a staircase, so the slots are distinct),
// and counts the query's chunks it did on a per-query counter; the block
// that completes the count (a fence and atomics, reset for the next launch
// by that block, as K4 does) folds the query's partial lists and writes its
// row of the result. One launch per search. Keys are distinct, so the
// result does not depend on the order in which blocks finish.
//
// The first body (ivf_scan_kernel) takes every other shape: one block per
// query, the query staged in shared memory, each warp takes 32-row chunks of
// the query's clusters in turn, reads 4 rows at a time in 16-byte loads
// (or one element a lane when the rows are not 16-byte aligned), sums
// across the warp with shuffles and folds into a per-warp list; the block
// then takes the top-k of its warps' lists.
//
// Not carried over: the TPU kernels' probe-axis chunking (a scalar-memory
// cap), their fixed sub-block DMAs sized by the largest cluster and the
// pipelined BlockSpec variant; any cluster start and size works here, and
// no read goes past a cluster's own rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"
#include "topk.cuh"

namespace {

constexpr int THREADS = 256;  // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int RB = 4;  // rows a warp reads at once
constexpr int BIG_ID = 1 << 30;

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

// ---------------------------------------------------------------------------
// The first body: one block per query, writing its row of the result.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    ivf_scan_kernel(const T* __restrict__ q, const T* __restrict__ emb,
                    const int* __restrict__ starts,
                    const int* __restrict__ counts,
                    const float* __restrict__ scales, int n_probe, int D,
                    int k, bool vec, float* out_v, int* out_i) {
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
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int c = threadIdx.x; c < D; c += THREADS) qs[c] = q[(size_t)b * D + c];
  float* lv = all_v + warp * k;
  int* li = all_i + warp * k;
  tr::warp_list_init(lv, li, k, BIG_ID);
  __syncthreads();

  int chunks_before = 0;  // deals chunks to warps across the probes
  for (int p = 0; p < n_probe; ++p) {
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
  tr::block_topk(all_v, all_i, WARPS * k, k, BIG_ID, BIG_ID,
                 out_v + (size_t)b * k, out_i + (size_t)b * k, red_v, red_i,
                 red_p);
}

// Let `kernel` take all the dynamic shared memory a block may have beside
// its static shared memory, on the current device. Once per kernel, device
// and process: done[device] remembers it.
constexpr int MAX_DEVICES = 64;

template <typename K>
cudaError_t allow_smem(K kernel, bool* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (done[dev]) return cudaSuccess;
  cudaFuncAttributes a;
  err = cudaFuncGetAttributes(&a, kernel);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               sm90::MAX_SMEM - (int)a.sharedSizeBytes);
  done[dev] = err == cudaSuccess;
  return err;
}

template <typename T>
cudaError_t launch_scan(const void* q, const void* emb, const int* starts,
                        const int* counts, const float* scales, int B,
                        int n_probe, int D, int k, float* out_v, int* out_i,
                        cudaStream_t st) {
  static bool attr[MAX_DEVICES] = {};
  const cudaError_t err = allow_smem(ivf_scan_kernel<T>, attr);
  if (err != cudaSuccess) return err;
  const size_t smem = (D * sizeof(T) + 15) / 16 * 16 +
                      (size_t)WARPS * k * (sizeof(float) + sizeof(int));
  const bool vec = (D * sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(emb) % 16 == 0;
  ivf_scan_kernel<T><<<B, THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(emb), starts, counts,
      scales, n_probe, D, k, vec, out_v, out_i);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The row-split body.
constexpr int CWARPS = 8;                    // consumer warps
constexpr int CTHREADS = CWARPS * 32;
constexpr int ROWS_THREADS = CTHREADS + 32;  // and one producer warp
constexpr int STAGES = 3;
constexpr int STAGE_BYTES = 32768;
constexpr int MAX_CHUNK_ROWS = 256;  // 32 rows per consumer warp
constexpr int REG_K = 32;            // lists of k <= REG_K: one key a lane
constexpr int CONSUMER_BAR = 1;      // named barrier of the consumer warps
// Warp lists live in shared memory up to this many bytes, else in a
// device-memory scratch.
constexpr size_t MAX_SMEM_LISTS = 64 * 1024;

// What the producer put in a stage.
struct StageHdr {
  int b;      // query
  int id0;    // IVF-row id of the stage's first row
  int rows;   // 0 .. R
  float scale;
};

int chunk_rows(int row_bytes) {
  const int r = STAGE_BYTES / row_bytes;
  return r < MAX_CHUNK_ROWS ? r : MAX_CHUNK_ROWS;
}

// Chunks of table entry e (query e / P, probe e % P): its rows in R-row
// chunks; a query's first probe has at least one.
__device__ __forceinline__ int entry_chunks(int count, int e, int P, int R) {
  const int n = count > 0 ? (count + R - 1) / R : 0;
  return e % P == 0 ? max(n, 1) : n;
}

// Exclusive prefix of v over the block's threads in thread order, and the
// block's total. Every thread calls it; scratch: 32 ints.
__device__ int block_exclusive_sum(int v, int* scratch, int& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(tr::kFullMask, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) scratch[warp] = x;
  __syncthreads();
  int before = 0;
  total = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
    const int t = scratch[w];
    if (w < warp) before += t;
    total += t;
  }
  __syncthreads();
  return before + x - v;
}

__device__ __forceinline__ void consumer_sync() {
  sm90::named_sync(CONSUMER_BAR, CTHREADS);
}

// Offer each lane's candidate to the warp's list: one key a lane (reg)
// for k <= REG_K, else the list in memory.
__device__ __forceinline__ void offer(bool has, tr::Key key, tr::Key& reg,
                                      tr::Key* list, int k, tr::Key& kth) {
  if (k <= REG_K)
    tr::warp_reg_offer(has, key, reg, k, kth);
  else
    tr::warp_key_offer(has, key, list, k, kth);
}

// A consumer warp's rows of one stage (rows warp, warp + CWARPS, ...),
// scored against the staged query and offered to the warp's list.
template <typename T>
__device__ __forceinline__ void score_stage(const unsigned char* stage,
                                            const uint4* qv, int n_vec,
                                            const StageHdr& h, tr::Key& reg,
                                            tr::Key* list, int k,
                                            tr::Key& kth) {
  using Acc = typename Traits<T>::Acc;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int mine = h.rows > warp ? (h.rows - warp + CWARPS - 1) / CWARPS : 0;
  float my_v = 0.f;
  int my_id = 0;
  for (int i0 = 0; i0 < mine; i0 += RB) {
    const uint4* rows[RB];
    Acc acc[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const int i = min(i0 + r, mine - 1);
      rows[r] = reinterpret_cast<const uint4*>(stage) +
                (size_t)(warp + i * CWARPS) * n_vec;
      acc[r] = 0;
    }
    for (int v = lane; v < n_vec; v += 32) {
      const uint4 a = qv[v];
#pragma unroll
      for (int r = 0; r < RB; ++r)
        acc[r] = Traits<T>::dot16(a, rows[r][v], acc[r]);
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const Acc sum = warp_sum(acc[r]);
      if (lane == i0 + r && i0 + r < mine) {
        my_v = Traits<T>::score(sum, h.scale);
        my_id = h.id0 + warp + (i0 + r) * CWARPS;
      }
    }
  }
  const bool has = lane < mine;
  offer(has, has ? tr::make_key(my_v, my_id) : 0ull, reg, list, k, kth);
}

template <typename T>
__global__ void __launch_bounds__(ROWS_THREADS, 1)
    ivf_rows_kernel(const T* __restrict__ q, const T* __restrict__ emb,
                    const int* __restrict__ starts,
                    const int* __restrict__ counts,
                    const float* __restrict__ scales, int B, int P, int D,
                    int k, int R, tr::Key* part, unsigned* state,
                    tr::Key* glists, float* out_v, int* out_i) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint64_t full[STAGES], empty[STAGES];
  __shared__ StageHdr hdr[STAGES];
  __shared__ int scratch[32];
  __shared__ int s_e0, s_j0, s_last, s_first_g, s_last_g;
  const int row_bytes = D * (int)sizeof(T);
  const int n_vec = row_bytes / 16;
  const int stage_bytes = R * row_bytes;
  unsigned char* ring = smem;
  uint4* qv = reinterpret_cast<uint4*>(smem + STAGES * stage_bytes);
  tr::Key* lists =
      glists != nullptr
          ? glists + (size_t)blockIdx.x * CWARPS * k
          : reinterpret_cast<tr::Key*>(smem + STAGES * stage_bytes + row_bytes);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n_ent = B * P;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], CWARPS);
    }
    sm90::fence_mbar_init();
  }
  // Every chunk, then this block's share [c0, c1) of them: thread tid
  // sums the chunks of its run of table entries [e_lo, e_hi), and one
  // block-wide prefix sum places the runs.
  const int per = (n_ent + ROWS_THREADS - 1) / ROWS_THREADS;
  const int e_lo = min(n_ent, tid * per);
  const int e_hi = min(n_ent, e_lo + per);
  int mine = 0;
#pragma unroll 8
  for (int e = e_lo; e < e_hi; ++e)
    mine += entry_chunks(__ldg(counts + e), e, P, R);
  int n_chunks;
  int pre = block_exclusive_sum(mine, scratch, n_chunks);
  const int G = min((int)gridDim.x, n_chunks);
  const int g = blockIdx.x;
  if (g >= G) return;
  const int c0 = (int)((long long)g * n_chunks / G);
  const int c1 = (int)((long long)(g + 1) * n_chunks / G);
  // The entry holding chunk c0, and c0's chunk within it: the thread whose
  // run holds c0 walks it again.
  if (c0 >= pre && c0 < pre + mine) {
    for (int e = e_lo;; ++e) {
      const int n = entry_chunks(__ldg(counts + e), e, P, R);
      if (c0 < pre + n) {
        s_e0 = e;
        s_j0 = c0 - pre;
        break;
      }
      pre += n;
    }
  }
  __syncthreads();

  if (warp == CWARPS) {
    // The producer: the block's chunks in order, one bulk copy each, with
    // the table read 32 entries at a time.
    int e = s_e0, j = s_j0, c = c0, n = 0;
    while (c < c1) {
      int st = 0, cnt = 0;
      float sc = 1.f;
      if (e + lane < n_ent) {
        st = __ldg(starts + e + lane);
        cnt = __ldg(counts + e + lane);
        if (scales != nullptr) sc = __ldg(scales + e + lane);
      }
      for (int w = 0; w < 32 && c < c1; ++w) {
        const int st_w = __shfl_sync(tr::kFullMask, st, w);
        const int cnt_w = __shfl_sync(tr::kFullMask, cnt, w);
        const float sc_w = __shfl_sync(tr::kFullMask, sc, w);
        const int n_w = e + w < n_ent ? entry_chunks(cnt_w, e + w, P, R) : 0;
        for (; j < n_w && c < c1; ++j, ++c, ++n) {
          const int s = n % STAGES;
          if (n >= STAGES) sm90::mbar_wait(&empty[s], (n / STAGES - 1) & 1);
          if (lane == 0) {
            const int rows = max(0, min(R, cnt_w - j * R));
            hdr[s] = StageHdr{(e + w) / P, st_w + j * R, rows, sc_w};
            if (rows > 0) {
              const uint32_t bytes = (uint32_t)(rows * row_bytes);
              sm90::mbar_expect_tx(&full[s], bytes);
              sm90::bulk_load(
                  ring + (size_t)s * stage_bytes,
                  reinterpret_cast<const unsigned char*>(emb) +
                      ((size_t)st_w + (size_t)j * R) * row_bytes,
                  bytes, &full[s]);
            } else {
              sm90::mbar_arrive(&full[s]);
            }
          }
          __syncwarp();
        }
        j = 0;
      }
      e += 32;
    }
    return;
  }

  // The consumers: the block's chunks in order, and one pass past the
  // last that leaves the last query.
  tr::Key* my_list = lists + warp * k;
  tr::Key kth = 0, reg = 0;  // reg: the lane's entry of a k <= REG_K list
  int cur_b = -1, b_chunks = 0;
  for (int i = tid; i < CWARPS * k; i += CTHREADS) lists[i] = 0;
  for (int c = c0, n = 0;; ++c, ++n) {
    const int s = n % STAGES;
    StageHdr h;
    h.b = -1;
    if (c < c1) {
      sm90::mbar_wait(&full[s], (n / STAGES) & 1);
      h = hdr[s];
    }
    if (h.b != cur_b) {
      if (cur_b >= 0) {
        // Leave query cur_b: its partial list, its count, and its row of
        // the result if this block completes it.
        if (k <= REG_K && lane < k) my_list[lane] = reg;
        consumer_sync();  // every warp list is final
        tr::Key* dst = part + (size_t)(g + cur_b) * k;
        tr::merge_key_lists(lists, CWARPS, k, tid, CTHREADS,
                            [&](int pl, tr::Key key) { dst[pl] = key; });
        __threadfence();
        int total = 0;  // the query's chunks
        if (warp == 0) {
          for (int p = lane; p < P; p += 32)
            total += entry_chunks(__ldg(counts + cur_b * P + p),
                                  cur_b * P + p, P, R);
          total = warp_sum(total);
        }
        consumer_sync();
        if (tid == 0) {
          unsigned* st = state + 4 * (size_t)cur_b;
          atomicMax(st + 1, (unsigned)(G - g));
          atomicMax(st + 2, (unsigned)(g + 1));
          __threadfence();
          const unsigned prev = atomicAdd(st, (unsigned)b_chunks);
          s_last = prev + b_chunks == (unsigned)total;
          if (s_last) {  // no other block of the query is left
            __threadfence();
            s_first_g = G - (int)atomicExch(st + 1, 0u);
            s_last_g = (int)atomicExch(st + 2, 0u) - 1;
            atomicExch(st, 0u);
          }
        }
        for (int i = tid; i < CWARPS * k; i += CTHREADS) lists[i] = 0;
        reg = 0;
        consumer_sync();
        if (s_last) {
          // Fold the query's partial lists, blocks first_g .. last_g,
          // each descending: once a 32-entry piece ends at or below the
          // warp's k-th, nothing after it enters. The first pieces of
          // four lists are read at once.
          kth = 0;
          const int g_end = s_last_g;
          for (int g2 = s_first_g + warp; g2 <= g_end; g2 += 4 * CWARPS) {
            tr::Key head[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int gu = g2 + u * CWARPS;
              head[u] = gu <= g_end && lane < k
                            ? __ldcg(part + (size_t)(gu + cur_b) * k + lane)
                            : 0ull;
            }
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int gu = g2 + u * CWARPS;
              const tr::Key* src = part + (size_t)(gu + cur_b) * k;
              tr::Key key = head[u];
              for (int base = 0; gu <= g_end;) {
                offer(key != 0, key, reg, my_list, k, kth);
                base += 32;
                if (base >= k || __shfl_sync(tr::kFullMask, key, 31) <= kth)
                  break;
                key = base + lane < k ? __ldcg(src + base + lane) : 0ull;
              }
            }
          }
          if (k <= REG_K && lane < k) my_list[lane] = reg;
          consumer_sync();
          float* ov = out_v + (size_t)cur_b * k;
          int* oi = out_i + (size_t)cur_b * k;
          tr::merge_key_lists(lists, CWARPS, k, tid, CTHREADS,
                              [&](int pl, tr::Key key) {
                                ov[pl] = key ? tr::key_value(key)
                                             : tr::kNegInf;
                                oi[pl] = key ? tr::key_id(key) : BIG_ID;
                              });
          consumer_sync();
          for (int i = tid; i < CWARPS * k; i += CTHREADS) lists[i] = 0;
          reg = 0;
          consumer_sync();
        }
      }
      if (c >= c1) break;
      const uint4* src =
          reinterpret_cast<const uint4*>(q) + (size_t)h.b * n_vec;
      for (int i = tid; i < n_vec; i += CTHREADS) qv[i] = src[i];
      consumer_sync();
      kth = 0;
      cur_b = h.b;
      b_chunks = 0;
    }
    ++b_chunks;
    score_stage<T>(ring + (size_t)s * stage_bytes, qv, n_vec, h, reg, my_list,
                   k, kth);
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[s]);
  }
}

// The row-split body's launch shape for rows of `row_bytes` and this k:
// chunk rows, dynamic shared memory, and whether the warp lists go to a
// device-memory scratch.
struct RowsShape {
  int R;
  size_t smem;
  bool global_lists;
};

RowsShape rows_shape(int row_bytes, int k) {
  RowsShape sh;
  sh.R = chunk_rows(row_bytes);
  const size_t lists = (size_t)CWARPS * k * sizeof(tr::Key);
  sh.global_lists = lists > MAX_SMEM_LISTS;
  sh.smem = (size_t)STAGES * sh.R * row_bytes + row_bytes +
            (sh.global_lists ? 0 : lists);
  return sh;
}

template <typename T>
cudaError_t rows_config(int D, int k, int* out) {
  static bool attr[MAX_DEVICES] = {};
  cudaError_t err = allow_smem(ivf_rows_kernel<T>, attr);
  const RowsShape sh = rows_shape(D * (int)sizeof(T), k);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, ivf_rows_kernel<T>, ROWS_THREADS, sh.smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  out[0] = sms * per_sm;
  out[1] = sh.R;
  out[2] = sh.global_lists;
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_rows(const void* q, const void* emb, const int* starts,
                        const int* counts, const float* scales, int B, int P,
                        int D, int k, int grid, void* part, void* state,
                        void* glists, float* out_v, int* out_i,
                        cudaStream_t st) {
  const RowsShape sh = rows_shape(D * (int)sizeof(T), k);
  if ((glists != nullptr) != sh.global_lists) return cudaErrorInvalidValue;
  ivf_rows_kernel<T><<<grid, ROWS_THREADS, sh.smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(emb), starts, counts,
      scales, B, P, D, k, sh.R, static_cast<tr::Key*>(part),
      static_cast<unsigned*>(state), static_cast<tr::Key*>(glists), out_v,
      out_i);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16, 2 = int8 (then scales is (B, n_probe) fp32).
// q (B, D) in the storage type. The first body: one block per query.
extern "C" int tr_ivf_probe_topk(const void* q, const void* emb, int dtype,
                                 const int* starts, const int* counts,
                                 const float* scales, int B, int n_probe,
                                 int D, int k, float* out_v, int* out_i,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 2)
    err = launch_scan<int8_t>(q, emb, starts, counts, scales, B, n_probe, D,
                              k, out_v, out_i, st);
  else if (dtype == 1)
    err = launch_scan<__nv_bfloat16>(q, emb, starts, counts, nullptr, B,
                                     n_probe, D, k, out_v, out_i, st);
  else if (dtype == 0)
    err = launch_scan<float>(q, emb, starts, counts, nullptr, B, n_probe, D,
                             k, out_v, out_i, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)err;
}

// The row-split body's launch shape on the current device: out[0] the grid
// (SMs x blocks per SM), out[1] the chunk rows R, out[2] whether the warp
// lists need the device-memory scratch.
extern "C" int tr_ivf_rows_config(int dtype, int D, int k, int* out) {
  if (dtype == 2) return (int)rows_config<int8_t>(D, k, out);
  if (dtype == 1) return (int)rows_config<__nv_bfloat16>(D, k, out);
  if (dtype == 0) return (int)rows_config<float>(D, k, out);
  return (int)cudaErrorInvalidValue;
}

// The row-split body. D * itemsize % 16 == 0 and <= 32 KB, q and emb
// 16-byte aligned. grid from tr_ivf_rows_config; part: (grid + B, k)
// uint64 scratch; state: (B, 4) uint32, zero before the first launch and
// left zero by every launch; glists: (grid, 8, k) uint64 scratch when the
// config says so, else null.
extern "C" int tr_ivf_probe_rows(const void* q, const void* emb, int dtype,
                                 const int* starts, const int* counts,
                                 const float* scales, int B, int n_probe,
                                 int D, int k, int grid, void* part,
                                 void* state, void* glists, float* out_v,
                                 int* out_i, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || n_probe < 1 || grid < 1 || k < 1)
    return (int)cudaErrorInvalidValue;
  if (dtype == 2)
    return (int)launch_rows<int8_t>(q, emb, starts, counts, scales, B,
                                    n_probe, D, k, grid, part, state, glists,
                                    out_v, out_i, st);
  if (dtype == 1)
    return (int)launch_rows<__nv_bfloat16>(q, emb, starts, counts, nullptr,
                                           B, n_probe, D, k, grid, part,
                                           state, glists, out_v, out_i, st);
  if (dtype == 0)
    return (int)launch_rows<float>(q, emb, starts, counts, nullptr, B,
                                   n_probe, D, k, grid, part, state, glists,
                                   out_v, out_i, st);
  return (int)cudaErrorInvalidValue;
}
