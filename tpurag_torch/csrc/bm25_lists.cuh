// Doc-sorted term lists in shared memory, shared by K3 (bm25_full.cu) and K2
// (bm25_topk.cu): the bucket-matrix and slot entries of their tables, the
// staging of list ranges by bulk copies, and one level of the merge-path
// tree that merges the staged lists (lower slots first on equal docs).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"
#include "topk.cuh"

namespace termlists {

constexpr int BIG = 1 << 30;  // parked doc
constexpr int PAD_KEY = 0x7fffffff;

// The tables the wrappers build (kernels/bm25_merge._slot_table), in int64s.
struct Mat {  // 4 int64
  const int* doc;
  const float* imp;
  long long width;  // lanes per matrix row
  long long unused;
};
struct Slot {  // 2 int64
  int mat;
  int row;
  int len;  // lanes of the matrix row this slot merges; 0: empty
  float scale;
};
static_assert(sizeof(Mat) == 32 && sizeof(Slot) == 16, "table layout");

__device__ __forceinline__ const int* slot_doc(const Mat* mats,
                                               const Slot& s) {
  return mats[s.mat].doc + (size_t)s.row * mats[s.mat].width;
}

__device__ __forceinline__ const float* slot_imp(const Mat* mats,
                                                 const Slot& s) {
  return mats[s.mat].imp + (size_t)s.row * mats[s.mat].width;
}

// First index in [lo, hi) of the ascending row doc with doc[i] >= x.
__device__ __forceinline__ int lower_bound(const int* doc, int lo, int hi,
                                           int x) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (doc[mid] < x)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// Warp 0: exclusive prefix sums of n values into out[0, n], out[n] the
// total.
template <class Val>
__device__ void warp_scan(int n, Val val, int* out) {
  const int lane = threadIdx.x & 31;
  int carry = 0;
  for (int base = 0; base < n; base += 32) {
    const int v = base + lane < n ? val(base + lane) : 0;
    int x = v;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(tr::kFullMask, x, o);
      if (lane >= o) x += y;
    }
    if (base + lane < n) out[base + lane] = carry + x - v;
    carry += __shfl_sync(tr::kFullMask, x, 31);
  }
  if (lane == 0) out[n] = carry;
}

// A range of one list to stage: lanes [0, c) from doc and imp.
struct Range {
  const int* doc;
  const float* imp;
  int c;
};

// Stages range s = range(s) of t ranges into shared memory: its doc lane i
// at st_doc[at[s] + h + i], h = sm90::staging(doc, c).h, and its impact lane
// i at st_imp[at[s] + h' + i], h' the impact's own offset (at[s] is 16-byte
// aligned, with room for h + c lanes). Thread 0 expects every aligned middle
// on bar and starts their bulk copies; the unaligned edges are plain loads,
// 8 threads a range. The caller waits on bar (phase 0) and syncs.
template <class RangeOf>
__device__ void stage_ranges(int t, RangeOf range, const int* at,
                             int* st_doc, float* st_imp, uint64_t* bar) {
  if (threadIdx.x == 0) {
    uint32_t bytes = 0;
    for (int s = 0; s < t; ++s) {
      const Range r = range(s);
      if (r.c == 0) continue;
      bytes += sm90::middle_bytes(sm90::staging(r.doc, r.c)) +
               sm90::middle_bytes(sm90::staging(r.imp, r.c));
    }
    sm90::mbar_expect_tx(bar, bytes);
    for (int s = 0; s < t; ++s) {
      const Range r = range(s);
      if (r.c == 0) continue;
      sm90::bulk_middle(st_doc + at[s], r.doc, sm90::staging(r.doc, r.c),
                        bar);
      sm90::bulk_middle(st_imp + at[s], r.imp, sm90::staging(r.imp, r.c),
                        bar);
    }
  }
  for (int q = threadIdx.x; q < 8 * t; q += blockDim.x) {
    const Range r = range(q >> 3);
    if (r.c == 0) continue;
    sm90::plain_edges(st_doc + at[q >> 3], r.doc, sm90::staging(r.doc, r.c),
                      q & 7, 8);
    const int* imp = reinterpret_cast<const int*>(r.imp);
    sm90::plain_edges(reinterpret_cast<int*>(st_imp) + at[q >> 3], imp,
                      sm90::staging(imp, r.c), q & 7, 8);
  }
}

// One level of the merge tree over n_all lanes of t lists (list s at lanes
// [off[s], off[s + 1])), every segment of w lists already merged: the
// segments merge in pairs, the lower one first on equal keys, so equal docs
// stay in slot order. key(i) is input lane i's doc; move(x, i) makes input
// lane i output lane x. Each thread takes a run of consecutive output
// lanes, finds where it starts in its pair by a merge-path search, then
// walks. The caller syncs before the next level reads the output.
template <class Key, class Move>
__device__ void merge_level(int n_all, int t, int w, const int* off, Key key,
                            Move move) {
  const int per = (n_all + blockDim.x - 1) / blockDim.x;
  int x = min((int)threadIdx.x * per, n_all);
  const int x1 = min(x + per, n_all);
  while (x < x1) {
    int p = 0;  // the pair holding output lane x
    for (int hi = (t - 1) / (2 * w); p < hi;) {
      const int mid = (p + hi + 1) >> 1;
      if (off[2 * mid * w] <= x)
        p = mid;
      else
        hi = mid - 1;
    }
    const int a0 = off[2 * p * w];
    const int a1 = off[min(2 * p * w + w, t)];
    const int b1 = off[min(2 * p * w + 2 * w, t)];
    const int na = a1 - a0, nb = b1 - a1;
    const int diag = x - a0;
    int i = max(0, diag - nb), hi = min(diag, na);
    while (i < hi) {
      const int mid = (i + hi) >> 1;
      if (key(a0 + mid) <= key(a1 + diag - 1 - mid))
        i = mid + 1;
      else
        hi = mid;
    }
    int jb = diag - i;
    for (const int end = min(x1, b1); x < end; ++x) {
      const bool from_a = i < na && (jb >= nb || key(a0 + i) <= key(a1 + jb));
      move(x, from_a ? a0 + i++ : a1 + jb++);
    }
  }
}

}  // namespace termlists
