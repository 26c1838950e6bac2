// Shared by K1's two bodies (dense_topk.cu: WMMA, every dtype; and
// dense_topk_sm90.cu: TMA + wgmma, aligned bf16) and K5's two (the int8
// form of dense_topk.cu; dense_topk_q8_sm90.cu: TMA + int8 wgmma): the
// fold of a score row into its running list, and the launcher of the pass
// that merges the S split lists of each query.
#pragma once

#include <cuda_runtime.h>

#include "topk.cuh"

namespace tr {

// Sentinel ids of empty list slots start here; the merge maps them to -1.
constexpr int kDenseBigId = 1 << 30;

// Fold one query's score row (TN fp32 scores of corpus rows n0 .. n0+TN-1,
// in shared memory) into its descending running list lv/li of length k.
// A score enters only if it beats the list's k-th entry and its row is
// below n_valid; the warp inserts the best candidate and re-checks the
// rest against the new k-th, so once the list is warm a tile costs one
// compare per score. All 32 lanes of the warp call it.
template <int TN>
__device__ __forceinline__ void warp_fold_row(const float* row, int n0,
                                              int n_valid, int k, float* lv,
                                              int* li) {
  const int lane = threadIdx.x & 31;
  float kv = lv[k - 1];
  int ki = li[k - 1];
  float v[TN / 32];
  int id[TN / 32];
  bool cand[TN / 32];
  bool any = false;
#pragma unroll
  for (int j = 0; j < TN / 32; ++j) {
    id[j] = n0 + lane + 32 * j;
    v[j] = row[lane + 32 * j];
    cand[j] = id[j] < n_valid && lex_gt(v[j], id[j], kv, ki);
    any |= cand[j];
  }
  while (__any_sync(kFullMask, any)) {
    float bv = -INFINITY;
    int bi = kIntMax;
#pragma unroll
    for (int j = 0; j < TN / 32; ++j)
      if (cand[j] && lex_gt(v[j], id[j], bv, bi)) {
        bv = v[j];
        bi = id[j];
      }
    int unused = 0;
    warp_lex_max3(bv, bi, unused);
    warp_list_insert(lv, li, k, bv, bi);
    kv = lv[k - 1];
    ki = li[k - 1];
    any = false;
#pragma unroll
    for (int j = 0; j < TN / 32; ++j) {
      cand[j] = cand[j] && id[j] != bi && lex_gt(v[j], id[j], kv, ki);
      any |= cand[j];
    }
  }
}

// The top-k of each query's S*k split candidates part_v / part_i (B, S, k)
// into out_v / out_i (B, k), sentinel ids and NEG_INF slots mapped to -1
// (dense_topk.cu: dense_merge_kernel, one block per query).
cudaError_t dense_merge(const float* part_v, const int* part_i, int B, int S,
                        int k, float* out_v, int* out_i, cudaStream_t st);

}  // namespace tr
