// K1's first body: fused dense cosine top-k for Hopper (sm_90a), and K5's
// first body, its int8 form. Aligned bf16 corpora take K1's TMA + wgmma
// body (dense_topk_sm90.cu), aligned int8 ones K5's (dense_topk_q8_sm90.cu);
// this one serves fp32, and bf16 / int8 rows that TMA cannot address (D %
// 8 != 0 / D % 16 != 0, or unaligned pointers).
//
// K1 replaces the Pallas kernel tpurag/kernels/dense.py:dense_topk_pallas
// (body _dense_topk_kernel). Same contract: (B, k) float32 scores
// descending and int32 ids, ties to the smaller id, corpus rows at or past
// n_valid never returned, empty slots (NEG_INF, -1), fp32 accumulation of
// a product taken in the corpus dtype (bf16 or fp32).
//
// K5 replaces tpurag/kernels/quant.py:dense_topk_pallas_q8 (the same
// Pallas body with quant=True): int8 query and corpus codes, an exact
// int32 product on the int8 tensor cores (WMMA s8, 16x16x16, int
// accumulators), then one fp32 multiply by the corpus row's scale, and
// from there K1's running lists, split merge, tie rule and n_valid mask.
// The int dot is exact and the scale one rounding, so K5 equals its plain
// version bit for bit. At small batch (32 queries x 1M rows x 1024) it is
// bound by the 1 GB of codes it reads; at 512 queries by the int8 rate.
// WMMA wants 32-byte aligned fragment pointers, so int8 slices are staged
// k-major: each 16-column slab of a tile is its own (rows x 16 B) block.
//
// What bounds it on this card: at the main-path shape (B = 1024 queries,
// N = 100k rows, D = 1024, bf16) the product is 0.2 TFLOP and the corpus
// 205 MB, so the kernel wants the tensor cores and must never write the
// (B, N) score matrix (400 MB of fp32) to device memory.
//
// Design:
// - The TPU grid carried one running top-k sequentially across corpus
//   tiles. Hopper blocks run in parallel and in no order, so the corpus
//   is cut into S splits: block (query tile, split) scans its own split
//   with its own running lists and writes them to a (B, S, k) scratch;
//   a second small kernel merges the S*k candidates of each query.
// - A block holds TQ = 64 queries x TN = 128 corpus rows. The product
//   runs through shared memory in 64-wide slices of D: bf16 on the tensor
//   cores with WMMA (mma.sync, 16x16x16 fragments, fp32 accumulators);
//   fp32 corpora with plain FMA. The fp32 score tile lands in shared
//   memory, and each warp folds its rows into their running lists.
// - A running list is k (value, id) pairs kept descending in shared
//   memory (global scratch when 64 lists of k do not fit). A score enters
//   only if it beats the list's k-th entry; the warp then inserts the best
//   candidate and re-checks against the new k-th, so once the lists are
//   warm almost every tile costs one compare per score. Any k works.
//   The fold and the merge launcher are shared with the wgmma body
//   (dense_topk.cuh).
//
// K7 replaces tpurag/kernels/dense.py:dense_topk_pallas_co (body
// _dense_topk_kernel_co): K1's contract with the corpus loop outside the
// query loop. K1 reads the corpus once per 64-query tile (8 times at 512
// queries); K7 reads it once, and the queries (1 MB at 512 x 1024 bf16)
// many times, from L2. The grid is corpus splits only: block s stages each
// corpus tile of its split whole in shared memory (TN = 64 rows at D =
// 1024 bf16: 129 KB; 32 or 16 rows where 64 do not fit), scores it against
// every query tile in turn (queries stream through a (TQ, TD) slice, the
// products in K1's order, so the scores are K1's), and folds each score
// tile into that query tile's running lists, which live in the (B, S, k)
// scratch in device memory. K1's merge kernel then takes the S*k
// candidates of each query. No batch cap (the JAX wrapper's 4096 was a
// VMEM cap).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include "dense_topk.cuh"

namespace {

constexpr int TQ = 64;        // queries per block
constexpr int TN = 128;       // corpus rows per tile
constexpr int TD = 64;        // D slice staged in shared memory
constexpr int THREADS = 256;  // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int LDS = TN + 4;   // score tile row stride (floats)
constexpr int MAX_SMEM = 232448;  // 227 KB: Hopper's per-block limit
constexpr int MERGE_THREADS = 128;

template <typename T>
struct Stage;
template <>
struct Stage<__nv_bfloat16> {
  static constexpr int LD = TD + 8;  // 144-byte rows: 16 B aligned, skewed
};
template <>
struct Stage<float> {
  static constexpr int LD = TD + 4;
};
template <>
struct Stage<int8_t> {
  static constexpr int LD = TD;  // k-major slabs, see stage_slice_i8
};

template <typename T>
constexpr size_t tile_bytes() {
  return (size_t)(TQ + TN) * Stage<T>::LD * sizeof(T) +
         (size_t)TQ * LDS * sizeof(float);
}

__device__ __forceinline__ void set_zero(float& x) { x = 0.f; }
__device__ __forceinline__ void set_zero(__nv_bfloat16& x) {
  x = __float2bfloat16(0.f);
}

// Stage rows [row0, row0 + rows) x columns [d0, d0 + TD) of a row-major
// (n_rows, D) matrix into shared memory (stride LD), zero past the edges.
template <typename T>
__device__ void stage_slice(T* dst, const T* src, int rows, int row0,
                            int n_rows, int d0, int D, bool vec) {
  constexpr int LD = Stage<T>::LD;
  if (vec) {  // D is a multiple of 16 bytes and src is 16-byte aligned
    constexpr int VEC = 16 / sizeof(T);
    constexpr int PER_ROW = TD / VEC;
    for (int e = threadIdx.x; e < rows * PER_ROW; e += THREADS) {
      const int r = e / PER_ROW;
      const int c = (e % PER_ROW) * VEC;
      const int gr = row0 + r;
      const int gc = d0 + c;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (gr < n_rows && gc < D)
        val = *reinterpret_cast<const uint4*>(src + (size_t)gr * D + gc);
      *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
    }
  } else {
    for (int e = threadIdx.x; e < rows * TD; e += THREADS) {
      const int r = e / TD;
      const int c = e % TD;
      const int gr = row0 + r;
      const int gc = d0 + c;
      T val;
      set_zero(val);
      if (gr < n_rows && gc < D) val = src[(size_t)gr * D + gc];
      dst[r * LD + c] = val;
    }
  }
}

// Stage int8 rows [row0, row0 + rows) x columns [d0, d0 + TD) k-major:
// column c of row r lands at (c / 16) * rows * 16 + r * 16 + c % 16, so
// every 16 x 16 fragment is one 32-byte aligned block with ldm 16.
__device__ void stage_slice_i8(int8_t* dst, const int8_t* src, int rows,
                               int row0, int n_rows, int d0, int D,
                               bool vec) {
  if (vec) {  // D is a multiple of 16 and src is 16-byte aligned
    for (int e = threadIdx.x; e < rows * (TD / 16); e += THREADS) {
      const int r = e / (TD / 16);  // neighbouring threads read one row
      const int slab = e % (TD / 16);
      const int gr = row0 + r;
      const int gc = d0 + slab * 16;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (gr < n_rows && gc < D)
        val = *reinterpret_cast<const uint4*>(src + (size_t)gr * D + gc);
      *reinterpret_cast<uint4*>(dst + (slab * rows + r) * 16) = val;
    }
  } else {
    for (int e = threadIdx.x; e < rows * TD; e += THREADS) {
      const int r = e / TD;
      const int c = e % TD;
      const int gr = row0 + r;
      const int gc = d0 + c;
      dst[((c / 16) * rows + r) * 16 + c % 16] =
          (gr < n_rows && gc < D) ? src[(size_t)gr * D + gc] : (int8_t)0;
    }
  }
}

// Score tile sc[TQ][LDS] = q[q0 : q0+TQ] . emb[n0 : n0+TN]^T in fp32.
// (e_scale is the int8 form's; the float forms ignore it.)
__device__ void score_tile(const __nv_bfloat16* q, const __nv_bfloat16* emb,
                           const float*, int B, int N, int D, int q0, int n0,
                           bool vec, __nv_bfloat16* qs, __nv_bfloat16* es,
                           float* sc) {
  using namespace nvcuda;
  constexpr int LD = Stage<__nv_bfloat16>::LD;
  const int warp = threadIdx.x >> 5;
  const int wr = (warp / 4) * 32;  // this warp's 32 x 32 block of the tile
  const int wc = (warp % 4) * 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  for (int d0 = 0; d0 < D; d0 += TD) {
    __syncthreads();  // the previous slice is no longer read
    stage_slice(qs, q, TQ, q0, B, d0, D, vec);
    stage_slice(es, emb, TN, n0, N, d0, D, vec);
    __syncthreads();
    for (int kk = 0; kk < TD; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> b[2];
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], qs + (wr + i * 16) * LD + kk, LD);
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], es + (wc + j * 16) * LD + kk, LD);
      for (int i = 0; i < 2; ++i)
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
  }
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(sc + (wr + i * 16) * LDS + wc + j * 16,
                              acc[i][j], LDS, wmma::mem_row_major);
  __syncthreads();
}

__device__ void score_tile(const float* q, const float* emb, const float*,
                           int B, int N, int D, int q0, int n0, bool vec,
                           float* qs, float* es, float* sc) {
  constexpr int LD = Stage<float>::LD;
  const int ty = threadIdx.x / 16;  // rows ty*4 .. ty*4+3
  const int tx = threadIdx.x % 16;  // cols tx + 16*j, j < 8
  float acc[4][8];
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int d0 = 0; d0 < D; d0 += TD) {
    __syncthreads();
    stage_slice(qs, q, TQ, q0, B, d0, D, vec);
    stage_slice(es, emb, TN, n0, N, d0, D, vec);
    __syncthreads();
    for (int d = 0; d < TD; ++d) {
      float a[4], b[8];
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty * 4 + i) * LD + d];
      for (int j = 0; j < 8; ++j) b[j] = es[(tx + 16 * j) * LD + d];
      for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 8; ++j)
      sc[(ty * 4 + i) * LDS + tx + 16 * j] = acc[i][j];
  __syncthreads();
}

// int8: exact int32 dots on the tensor cores, then sc = float(dot) *
// e_scale[row] (rows past N get scale 0; the n_valid mask drops them).
__device__ void score_tile(const int8_t* q, const int8_t* emb,
                           const float* e_scale, int B, int N, int D, int q0,
                           int n0, bool vec, int8_t* qs, int8_t* es,
                           float* sc) {
  using namespace nvcuda;
  const int warp = threadIdx.x >> 5;
  const int wr = (warp / 4) * 32;
  const int wc = (warp % 4) * 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[2][2];
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0);
  for (int d0 = 0; d0 < D; d0 += TD) {
    __syncthreads();
    stage_slice_i8(qs, q, TQ, q0, B, d0, D, vec);
    stage_slice_i8(es, emb, TN, n0, N, d0, D, vec);
    __syncthreads();
    for (int kk = 0; kk < TD; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char,
                     wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char,
                     wmma::col_major> b[2];
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(
            a[i], reinterpret_cast<const signed char*>(qs) +
                      ((kk / 16) * TQ + wr + i * 16) * 16, 16);
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(
            b[j], reinterpret_cast<const signed char*>(es) +
                      ((kk / 16) * TN + wc + j * 16) * 16, 16);
      for (int i = 0; i < 2; ++i)
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
  }
  int* sci = reinterpret_cast<int*>(sc);
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(sci + (wr + i * 16) * LDS + wc + j * 16,
                              acc[i][j], LDS, wmma::mem_row_major);
  __syncthreads();
  for (int e = threadIdx.x; e < TQ * TN; e += THREADS) {
    const int r = e / TN;
    const int c = e % TN;
    const float s = n0 + c < N ? e_scale[n0 + c] : 0.f;
    sc[r * LDS + c] = __int2float_rn(sci[r * LDS + c]) * s;
  }
  __syncthreads();
}

// grid (cdiv(B, TQ), S). Block (x, s) scans corpus tiles of split s for
// queries [x*TQ, x*TQ + TQ) and leaves each query's top-k of that split
// in part[(query * S + s) * k : ... + k].
template <typename T>
__global__ void __launch_bounds__(THREADS)
    dense_scan_kernel(const T* __restrict__ q, const T* __restrict__ emb,
                      const float* __restrict__ e_scale, int B, int N,
                      int D, int n_valid, int k, int S,
                      bool vec, bool lists_in_smem, float* part_v,
                      int* part_i) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int LD = Stage<T>::LD;
  T* qs = reinterpret_cast<T*>(smem);
  T* es = qs + TQ * LD;
  float* sc = reinterpret_cast<float*>(es + TN * LD);
  float* slv = sc + TQ * LDS;
  int* sli = reinterpret_cast<int*>(slv + TQ * k);

  const int q0 = blockIdx.x * TQ;
  const int s = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_tiles = (n_valid + TN - 1) / TN;
  const int per_split = (n_tiles + S - 1) / S;
  const int t_begin = s * per_split;
  const int t_end = min(n_tiles, t_begin + per_split);

  auto list_v = [&](int r) -> float* {
    return lists_in_smem ? slv + r * k
                         : part_v + ((size_t)(q0 + r) * S + s) * k;
  };
  auto list_i = [&](int r) -> int* {
    return lists_in_smem ? sli + r * k
                         : part_i + ((size_t)(q0 + r) * S + s) * k;
  };

  for (int r = warp; r < TQ && q0 + r < B; r += WARPS)
    tr::warp_list_init(list_v(r), list_i(r), k, tr::kDenseBigId);

  for (int t = t_begin; t < t_end; ++t) {
    const int n0 = t * TN;
    score_tile(q, emb, e_scale, B, N, D, q0, n0, vec, qs, es, sc);
    for (int r = warp; r < TQ && q0 + r < B; r += WARPS)
      tr::warp_fold_row<TN>(sc + r * LDS, n0, n_valid, k, list_v(r),
                            list_i(r));
  }

  if (lists_in_smem) {
    __syncwarp();
    for (int r = warp; r < TQ && q0 + r < B; r += WARPS) {
      const size_t out = ((size_t)(q0 + r) * S + s) * k;
      for (int j = lane; j < k; j += 32) {
        part_v[out + j] = slv[r * k + j];
        part_i[out + j] = sli[r * k + j];
      }
    }
  }
}

// One block per query: the top-k of its S*k split candidates, with
// sentinel ids and NEG_INF slots mapped to -1.
__global__ void __launch_bounds__(MERGE_THREADS)
    dense_merge_kernel(const float* __restrict__ part_v,
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
  tr::block_topk(cv, ci, m, k, tr::kDenseBigId, -1, out_v + row * k,
                 out_i + row * k, red_v, red_i, red_p);
}

// -- K7: corpus-outer order ------------------------------------------------

// Shared memory of K7 with corpus tiles of tn rows: the (tn, Dp) tile
// (Dp = D rounded up to TD), a (TQ, TD) query slice and the score tile.
// kernels/dense.py:co_tile_rows picks tn by the same sum.
template <typename T>
size_t co_bytes(int tn, int D) {
  const int dp = (D + TD - 1) / TD * TD;
  return (size_t)tn * (dp + 16 / sizeof(T)) * sizeof(T) +
         (size_t)TQ * Stage<T>::LD * sizeof(T) +
         (size_t)TQ * (tn + 4) * sizeof(float);
}

// Stage corpus rows [n0, n0 + TNC) x all Dp columns into es (stride LDE),
// zero past N and D.
template <typename T, int TNC>
__device__ void stage_tile(T* es, const T* emb, int n0, int N, int D, int Dp,
                           int LDE, bool vec) {
  if (vec) {
    constexpr int VEC = 16 / sizeof(T);
    const int per_row = Dp / VEC;
    for (int e = threadIdx.x; e < TNC * per_row; e += THREADS) {
      const int r = e / per_row;
      const int c = (e % per_row) * VEC;
      const int gr = n0 + r;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (gr < N && c < D)
        val = *reinterpret_cast<const uint4*>(emb + (size_t)gr * D + c);
      *reinterpret_cast<uint4*>(es + r * LDE + c) = val;
    }
  } else {
    for (int e = threadIdx.x; e < TNC * Dp; e += THREADS) {
      const int r = e / Dp;
      const int c = e % Dp;
      const int gr = n0 + r;
      T val;
      set_zero(val);
      if (gr < N && c < D) val = emb[(size_t)gr * D + c];
      es[r * LDE + c] = val;
    }
  }
}

// Score tile sc[TQ][TNC + 4] = q[q0 : q0+TQ] . es^T with the corpus tile
// resident in shared memory; the query rows stream through a (TQ, TD)
// slice. The sums run in K1's order (D slices of TD, then k-steps of 16 or
// single columns), so the scores are K1's.
template <int TNC>
__device__ void co_score_tile(const __nv_bfloat16* q,
                              const __nv_bfloat16* es, int LDE, int B, int D,
                              int Dp, int q0, bool vec, __nv_bfloat16* qs,
                              float* sc) {
  using namespace nvcuda;
  constexpr int LD = Stage<__nv_bfloat16>::LD;
  constexpr int LDC = TNC + 4;
  constexpr int FC = TNC / 16;                 // fragment columns
  constexpr int NF = (TQ / 16) * FC;           // fragments of the tile
  constexpr int FPW = (NF + WARPS - 1) / WARPS;  // fragments per warp
  const int warp = threadIdx.x >> 5;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FPW];
#pragma unroll
  for (int f = 0; f < FPW; ++f) wmma::fill_fragment(acc[f], 0.f);
  for (int d0 = 0; d0 < Dp; d0 += TD) {
    __syncthreads();
    stage_slice(qs, q, TQ, q0, B, d0, D, vec);
    __syncthreads();
    for (int kk = 0; kk < TD; kk += 16) {
#pragma unroll
      for (int f = 0; f < FPW; ++f) {
        const int fi = warp + f * WARPS;
        if (fi < NF) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::col_major> b;
          wmma::load_matrix_sync(a, qs + (fi / FC) * 16 * LD + kk, LD);
          wmma::load_matrix_sync(b, es + (fi % FC) * 16 * LDE + d0 + kk, LDE);
          wmma::mma_sync(acc[f], a, b, acc[f]);
        }
      }
    }
  }
#pragma unroll
  for (int f = 0; f < FPW; ++f) {
    const int fi = warp + f * WARPS;
    if (fi < NF)
      wmma::store_matrix_sync(sc + (fi / FC) * 16 * LDC + (fi % FC) * 16,
                              acc[f], LDC, wmma::mem_row_major);
  }
  __syncthreads();
}

template <int TNC>
__device__ void co_score_tile(const float* q, const float* es, int LDE,
                              int B, int D, int Dp, int q0, bool vec,
                              float* qs, float* sc) {
  constexpr int LD = Stage<float>::LD;
  constexpr int LDC = TNC + 4;
  constexpr int CJ = TNC / 16;
  const int ty = threadIdx.x / 16;  // rows ty*4 .. ty*4+3
  const int tx = threadIdx.x % 16;  // cols tx + 16*j, j < CJ
  float acc[4][CJ];
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < CJ; ++j) acc[i][j] = 0.f;
  for (int d0 = 0; d0 < Dp; d0 += TD) {
    __syncthreads();
    stage_slice(qs, q, TQ, q0, B, d0, D, vec);
    __syncthreads();
    for (int d = 0; d < TD; ++d) {
      float a[4], b[CJ];
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty * 4 + i) * LD + d];
      for (int j = 0; j < CJ; ++j) b[j] = es[(tx + 16 * j) * LDE + d0 + d];
      for (int i = 0; i < 4; ++i)
        for (int j = 0; j < CJ; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < CJ; ++j)
      sc[(ty * 4 + i) * LDC + tx + 16 * j] = acc[i][j];
  __syncthreads();
}

// grid (S): block s walks the corpus tiles of split s. Each tile is staged
// once and scored against every query tile in turn; each query's running
// list of the split lives in part[(query * S + s) * k : ... + k] (global
// memory, only this block touches it), always folded by warp query % 8.
template <typename T, int TNC>
__global__ void __launch_bounds__(THREADS)
    dense_co_scan_kernel(const T* __restrict__ q, const T* __restrict__ emb,
                         int B, int N, int D, int n_valid, int k, int S,
                         bool vec, float* part_v, int* part_i) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int LDC = TNC + 4;
  constexpr int CPL = (TNC + 31) / 32;  // candidates per lane
  const int Dp = (D + TD - 1) / TD * TD;
  const int LDE = Dp + 16 / (int)sizeof(T);  // 16-byte skew per row
  T* es = reinterpret_cast<T*>(smem);
  T* qs = es + TNC * LDE;
  float* sc = reinterpret_cast<float*>(qs + TQ * Stage<T>::LD);

  const int s = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_tiles = (n_valid + TNC - 1) / TNC;
  const int per_split = (n_tiles + S - 1) / S;
  const int t_begin = s * per_split;
  const int t_end = min(n_tiles, t_begin + per_split);

  for (int r = warp; r < B; r += WARPS)
    tr::warp_list_init(part_v + ((size_t)r * S + s) * k,
                       part_i + ((size_t)r * S + s) * k, k, tr::kDenseBigId);

  for (int t = t_begin; t < t_end; ++t) {
    const int n0 = t * TNC;
    // The previous tile's last score tile ended in a barrier after its
    // last read of es.
    stage_tile<T, TNC>(es, emb, n0, N, D, Dp, LDE, vec);
    for (int q0 = 0; q0 < B; q0 += TQ) {
      co_score_tile<TNC>(q, es, LDE, B, D, Dp, q0, vec, qs, sc);
      for (int r = warp; r < TQ && q0 + r < B; r += WARPS) {
        float* lv = part_v + ((size_t)(q0 + r) * S + s) * k;
        int* li = part_i + ((size_t)(q0 + r) * S + s) * k;
        float kv = lv[k - 1];
        int ki = li[k - 1];
        float v[CPL];
        int id[CPL];
        bool cand[CPL];
        bool any = false;
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          const int c = lane + 32 * j;
          id[j] = n0 + c;
          v[j] = c < TNC ? sc[r * LDC + c] : -INFINITY;
          cand[j] = c < TNC && id[j] < n_valid &&
                    tr::lex_gt(v[j], id[j], kv, ki);
          any |= cand[j];
        }
        while (__any_sync(tr::kFullMask, any)) {
          float bv = -INFINITY;
          int bi = tr::kIntMax;
#pragma unroll
          for (int j = 0; j < CPL; ++j)
            if (cand[j] && tr::lex_gt(v[j], id[j], bv, bi)) {
              bv = v[j];
              bi = id[j];
            }
          int unused = 0;
          tr::warp_lex_max3(bv, bi, unused);
          tr::warp_list_insert(lv, li, k, bv, bi);
          kv = lv[k - 1];
          ki = li[k - 1];
          any = false;
#pragma unroll
          for (int j = 0; j < CPL; ++j) {
            cand[j] = cand[j] && id[j] != bi &&
                      tr::lex_gt(v[j], id[j], kv, ki);
            any |= cand[j];
          }
        }
      }
    }
  }
}

template <typename T, int TNC>
cudaError_t launch_co_tn(const void* q, const void* emb, int B, int N, int D,
                         int n_valid, int k, int S, float* part_v,
                         int* part_i, cudaStream_t stream) {
  const size_t smem = co_bytes<T>(TNC, D);
  if (smem > (size_t)MAX_SMEM) return cudaErrorInvalidValue;
  const bool vec = (D * sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(emb) % 16 == 0;
  cudaError_t err = cudaFuncSetAttribute(
      dense_co_scan_kernel<T, TNC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dense_co_scan_kernel<T, TNC><<<S, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(emb), B, N, D, n_valid,
      k, S, vec, part_v, part_i);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_co(const void* q, const void* emb, int B, int N, int D,
                      int n_valid, int k, int tn, int S, float* part_v,
                      int* part_i, cudaStream_t stream) {
  switch (tn) {
    case 64:
      return launch_co_tn<T, 64>(q, emb, B, N, D, n_valid, k, S, part_v,
                                 part_i, stream);
    case 32:
      return launch_co_tn<T, 32>(q, emb, B, N, D, n_valid, k, S, part_v,
                                 part_i, stream);
    case 16:
      return launch_co_tn<T, 16>(q, emb, B, N, D, n_valid, k, S, part_v,
                                 part_i, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_dense(const void* q, const void* emb, const float* e_scale,
                         int B, int N, int D, int n_valid, int k, int S,
                         float* part_v, int* part_i, cudaStream_t stream) {
  const size_t lists = (size_t)TQ * k * (sizeof(float) + sizeof(int));
  const bool lists_in_smem = tile_bytes<T>() + lists <= (size_t)MAX_SMEM;
  const size_t smem = tile_bytes<T>() + (lists_in_smem ? lists : 0);
  const bool vec = (D * sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(emb) % 16 == 0;
  cudaError_t err = cudaFuncSetAttribute(
      dense_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((B + TQ - 1) / TQ, S);
  dense_scan_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(emb), e_scale, B, N, D,
      n_valid, k, S, vec, lists_in_smem, part_v, part_i);
  return cudaGetLastError();
}

}  // namespace

cudaError_t tr::dense_merge(const float* part_v, const int* part_i, int B,
                            int S, int k, float* out_v, int* out_i,
                            cudaStream_t st) {
  const size_t merge_smem = (size_t)S * k * (sizeof(float) + sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(
      dense_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)merge_smem);
  if (err != cudaSuccess) return err;
  dense_merge_kernel<<<B, MERGE_THREADS, merge_smem, st>>>(part_v, part_i, S,
                                                           k, out_v, out_i);
  return cudaGetLastError();
}

extern "C" int tr_dense_topk(const void* q, const void* emb, int dtype, int B,
                             int N, int D, int n_valid, int k, int S,
                             float* part_v, int* part_i, float* out_v,
                             int* out_i, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      dtype == 1
          ? launch_dense<__nv_bfloat16>(q, emb, nullptr, B, N, D, n_valid, k,
                                        S, part_v, part_i, st)
          : launch_dense<float>(q, emb, nullptr, B, N, D, n_valid, k, S,
                                part_v, part_i, st);
  if (err != cudaSuccess) return (int)err;
  return (int)tr::dense_merge(part_v, part_i, B, S, k, out_v, out_i, st);
}

// K5: int8 codes q (B, D) and emb (N, D), fp32 row scales e_scale (N,).
// The query scales are applied by the caller.
extern "C" int tr_dense_topk_q8(const void* q, const void* emb,
                                const float* e_scale, int B, int N, int D,
                                int n_valid, int k, int S, float* part_v,
                                int* part_i, float* out_v, int* out_i,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_dense<int8_t>(q, emb, e_scale, B, N, D, n_valid,
                                         k, S, part_v, part_i, st);
  if (err != cudaSuccess) return (int)err;
  return (int)tr::dense_merge(part_v, part_i, B, S, k, out_v, out_i, st);
}

// K7: K1's contract in corpus-outer order; corpus tiles of tn rows (64,
// 32 or 16, chosen by the caller to fit shared memory), S corpus splits,
// one block each, part_v / part_i (B, S, k) scratch.
extern "C" int tr_dense_topk_co(const void* q, const void* emb, int dtype,
                                int B, int N, int D, int n_valid, int k,
                                int tn, int S, float* part_v, int* part_i,
                                float* out_v, int* out_i, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      dtype == 1 ? launch_co<__nv_bfloat16>(q, emb, B, N, D, n_valid, k, tn,
                                            S, part_v, part_i, st)
                 : launch_co<float>(q, emb, B, N, D, n_valid, k, tn, S,
                                    part_v, part_i, st);
  if (err != cudaSuccess) return (int)err;
  return (int)tr::dense_merge(part_v, part_i, B, S, k, out_v, out_i, st);
}

extern "C" const char* tr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
