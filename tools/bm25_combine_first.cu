// K4's first body, no longer built into the library: tools/k4_anatomy.py
// and chip_smoke.py build it on its own to time the current body against.
//
// K4: exact narrow + wide BM25 combine + top-k for Hopper (sm_90a).
//
// Replaces the pair-row combine of tpurag/kernels/bm25_join.py
// (combine_pairs_batched :182, combine_narrow_wide_tiled :284), which
// reaches the Pallas merge kernel (bm25_pallas.py:232) on
// (narrow chunk x wide tile) rows. The function is the contract of
// combine_narrow_wide (bm25_join.py:342): per hard query, a narrow and a
// wide full row (merge_segsum_full output: doc-ascending, each doc's
// partial sum at its segment-end lane, > NEG_INF / 2; every other lane
// below; parked lanes at doc 2^30) give the exact top-k of the per-doc
// totals narrow + wide, ties to the smaller doc, scores <= 0 empty
// (NEG_INF, -1).
//
// What bounds it on this card: one read of both rows (up to 16384 narrow
// + 131072 wide lanes at 1M documents, 8 bytes each) and a (k,) write;
// the binary searches are ~17 shared- or L2-memory reads per valid lane.
//
// Design: one block per query row. The narrow docs sit in shared memory
// (128 KB at 32768 lanes; wider narrow rows are searched in device
// memory). Each valid wide lane binary-searches its doc among them and
// adds the narrow sum when it finds one; each valid narrow lane
// binary-searches the wide row and stands alone when its doc is not
// there. A doc's total is then one fp32 add of its two sums, the same add
// the plain version makes (its other window lanes add zeros), so scores
// are bit-identical. Candidates go into one running top-k list per warp
// (topk.cuh: a warp inserts a candidate only when it beats its list's last
// entry; the lists live in a device-memory scratch), and k block-wide
// argmax passes merge the warps' lists.

#include <cuda_runtime.h>

#include "topk.cuh"

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_STAGED = 32768;   // narrow docs held in shared memory
constexpr int BIG = 1 << 30;
constexpr float VALID = tr::kNegInf / 2;

// The last lane of the monotone row doc[0, n) holding doc q, or -1.
__device__ __forceinline__ int bsearch_last(const int* doc, int n, int q) {
  int lo = -1, hi = n;  // doc[lo] <= q < doc[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (doc[mid] <= q)
      lo = mid;
    else
      hi = mid;
  }
  return lo >= 0 && doc[lo] == q ? lo : -1;
}

// Offer each lane's candidate (has, v, d) to the warp's running list.
__device__ __forceinline__ void offer(bool has, float v, int d, float* lv,
                                      int* li, int k, float& kv, int& ki) {
  unsigned want = __ballot_sync(tr::kFullMask,
                                has && tr::lex_gt(v, d, kv, ki));
  while (want) {
    const int src = __ffs(want) - 1;
    want &= want - 1;
    const float cv = __shfl_sync(tr::kFullMask, v, src);
    const int cd = __shfl_sync(tr::kFullMask, d, src);
    if (tr::lex_gt(cv, cd, kv, ki)) {  // kv/ki are the same in every lane
      tr::warp_list_insert(lv, li, k, cv, cd);
      kv = lv[k - 1];
      ki = li[k - 1];
    }
  }
}

__global__ void __launch_bounds__(THREADS)
    combine_topk_kernel(const float* __restrict__ n_val,
                        const int* __restrict__ n_doc, int Wn,
                        const float* __restrict__ w_seg,
                        const int* __restrict__ w_doc, int Ww, int k,
                        float* list_v, int* list_i, float* out_v,
                        int* out_i) {
  extern __shared__ __align__(128) int staged[];
  __shared__ float red_v[32];
  __shared__ int red_i[32];
  __shared__ int red_p[32];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const size_t row = blockIdx.x;
  const float* nv = n_val + row * Wn;
  const int* nd = n_doc + row * Wn;
  const float* wv = w_seg + row * Ww;
  const int* wd = w_doc + row * Ww;
  const int* ndoc = nd;
  if (Wn <= MAX_STAGED) {
    for (int i = tid; i < Wn; i += THREADS) staged[i] = nd[i];
    ndoc = staged;
  }
  float* lv = list_v + (row * WARPS + warp) * k;
  int* li = list_i + (row * WARPS + warp) * k;
  tr::warp_list_init(lv, li, k, BIG);
  float kv = lv[k - 1];
  int ki = li[k - 1];
  __syncthreads();

  // Every lane of a warp runs the same trip count (offer is warp-wide).
  const int ww_pad = (Ww + THREADS - 1) / THREADS * THREADS;
  const int wn_pad = (Wn + THREADS - 1) / THREADS * THREADS;
  // Wide lanes: each doc's wide sum, plus its narrow sum where it has one.
  for (int j = tid; j < ww_pad; j += THREADS) {
    bool has = false;
    float v = 0.f;
    int d = BIG;
    if (j < Ww && wv[j] > VALID) {
      d = wd[j];
      v = wv[j];
      const int pos = bsearch_last(ndoc, Wn, d);
      if (pos >= 0 && nv[pos] > VALID) v = __fadd_rn(nv[pos], v);
      has = d < BIG && v > 0.f;
    }
    offer(has, v, d, lv, li, k, kv, ki);
  }
  // Narrow lanes whose doc the wide row lacks.
  for (int i = tid; i < wn_pad; i += THREADS) {
    bool has = false;
    float v = 0.f;
    int d = BIG;
    if (i < Wn && nv[i] > VALID) {
      d = nd[i];
      v = nv[i];
      const int pos = bsearch_last(wd, Ww, d);
      has = d < BIG && v > 0.f && !(pos >= 0 && wv[pos] > VALID);
    }
    offer(has, v, d, lv, li, k, kv, ki);
  }
  __syncthreads();  // every warp's list is final

  // Merge: k block-wide argmax passes over the WARPS * k list entries.
  float* rlv = list_v + row * WARPS * k;
  const int* rli = list_i + row * WARPS * k;
  float* ov = out_v + row * k;
  int* oi = out_i + row * k;
  for (int pass = 0; pass < k; ++pass) {
    float bv = -INFINITY;
    int bd = tr::kIntMax;
    int bp = tr::kIntMax;
    for (int e = tid; e < WARPS * k; e += THREADS) {
      if (rlv[e] > 0.f && tr::lex_gt(rlv[e], rli[e], bv, bd)) {
        bv = rlv[e];
        bd = rli[e];
        bp = e;
      }
    }
    tr::block_lex_max3(bv, bd, bp, red_v, red_i, red_p);
    if (bp == tr::kIntMax) {  // no positive total left
      for (int j = pass + tid; j < k; j += THREADS) {
        ov[j] = tr::kNegInf;
        oi[j] = -1;
      }
      break;
    }
    if (tid == 0) {
      ov[pass] = bv;
      oi[pass] = bd;
    }
    if (bp % THREADS == tid) rlv[bp] = -INFINITY;  // its owner takes it out
  }
}

}  // namespace

// list_v / list_i: (B, 32, k) scratch for the per-warp running lists.
extern "C" int tr_combine_topk(const float* n_val, const int* n_doc, int B,
                               int Wn, const float* w_seg, const int* w_doc,
                               int Ww, int k, float* list_v, int* list_i,
                               float* out_v, int* out_i, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Wn < 1 || Ww < 1 || k < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = Wn <= MAX_STAGED ? (size_t)Wn * sizeof(int) : 0;
  cudaError_t err = cudaFuncSetAttribute(
      combine_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(MAX_STAGED * sizeof(int)));
  if (err != cudaSuccess) return (int)err;
  combine_topk_kernel<<<B, THREADS, smem, st>>>(n_val, n_doc, Wn, w_seg,
                                                w_doc, Ww, k, list_v, list_i,
                                                out_v, out_i);
  return (int)cudaGetLastError();
}
