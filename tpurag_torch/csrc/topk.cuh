// Running top-k device functions shared by the kernels.
//
// Port of the JAX package's running top-k helpers (tpurag/kernels/topk.py:
// init_run_asc, fold_candidates_asc, merge_topk_cols_asc, emit_desc and the
// _lex_gt order). On the TPU they are vector ops over a transposed (k, tile)
// running set; here each query's running top-k is a short descending list
// owned by one warp, and a candidate enters it by a warp-wide insert.
//
// Order everywhere: value descending, ties to the smaller id.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace tr {

constexpr float kNegInf = -3.0e38f;  // NEG_INF of both packages
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kIntMax = 0x7fffffff;

// (va, ia) sorts strictly before (vb, ib).
__device__ __forceinline__ bool lex_gt(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

// Same, with a third key (a position) so equal (value, id) pairs still
// have one winner.
__device__ __forceinline__ bool lex_gt3(float va, int ia, int pa, float vb,
                                        int ib, int pb) {
  return va > vb || (va == vb && (ia < ib || (ia == ib && pa < pb)));
}

// Warp-wide lexicographic max of (v, id, pos); every lane ends with it.
__device__ __forceinline__ void warp_lex_max3(float& v, int& id, int& pos) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFullMask, v, off);
    const int oi = __shfl_xor_sync(kFullMask, id, off);
    const int op = __shfl_xor_sync(kFullMask, pos, off);
    if (lex_gt3(ov, oi, op, v, id, pos)) {
      v = ov;
      id = oi;
      pos = op;
    }
  }
}

// Block-wide lexicographic max of (v, id, pos); every thread ends with it.
// blockDim.x must be a multiple of 32; every thread of the block calls it.
// scratch: three arrays of 32 entries in shared memory.
__device__ __forceinline__ void block_lex_max3(float& v, int& id, int& pos,
                                               float* sv, int* si, int* sp) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  warp_lex_max3(v, id, pos);
  if (lane == 0) {
    sv[warp] = v;
    si[warp] = id;
    sp[warp] = pos;
  }
  __syncthreads();
  if (warp == 0) {
    v = lane < n_warps ? sv[lane] : -INFINITY;
    id = lane < n_warps ? si[lane] : kIntMax;
    pos = lane < n_warps ? sp[lane] : kIntMax;
    warp_lex_max3(v, id, pos);
    if (lane == 0) {
      sv[0] = v;
      si[0] = id;
      sp[0] = pos;
    }
  }
  __syncthreads();
  v = sv[0];
  id = si[0];
  pos = sp[0];
  __syncthreads();  // the scratch is free again for the next call
}

// Empty running list: NEG_INF values with distinct sentinel ids
// big_id + j, which sort after every real candidate.
__device__ __forceinline__ void warp_list_init(float* lv, int* li, int k,
                                               int big_id) {
  for (int j = threadIdx.x & 31; j < k; j += 32) {
    lv[j] = kNegInf;
    li[j] = big_id + j;
  }
  __syncwarp();
}

// Insert (v, id) into the descending list lv/li of length k (shared or
// global memory), dropping its last entry. The caller has checked that
// (v, id) sorts before lv[k-1]; ids in the list are distinct. All 32
// lanes of the warp call it.
__device__ __forceinline__ void warp_list_insert(float* lv, int* li, int k,
                                                 float v, int id) {
  const int lane = threadIdx.x & 31;
  int pos = 0;
  for (int base = 0; base < k; base += 32) {
    const int j = base + lane;
    const bool before = j < k && lex_gt(lv[j], li[j], v, id);
    pos += __popc(__ballot_sync(kFullMask, before));
  }
  // Shift [pos, k - 1) up by one slot, highest chunk first, so every read
  // of slot j - 1 happens before that slot is overwritten.
  for (int base = ((k - 1) >> 5) << 5; base >= 0; base -= 32) {
    const int j = base + lane;
    const bool write = j < k && j >= pos;
    float nv = v;
    int ni = id;
    if (write && j > pos) {
      nv = lv[j - 1];
      ni = li[j - 1];
    }
    __syncwarp();
    if (write) {
      lv[j] = nv;
      li[j] = ni;
    }
    __syncwarp();
  }
}

// The top-k of m (value, id) candidates in shared memory, by k block-wide
// argmax passes (ties to the smaller id, then the lower position); taken
// entries are consumed. A pick with an id >= big_id or a NEG_INF value is
// empty and comes out as (kNegInf, empty_id). Every thread of the block
// calls it; red_*: block_lex_max3's scratch.
__device__ inline void block_topk(float* cv, int* ci, int m, int k,
                                  int big_id, int empty_id, float* out_v,
                                  int* out_i, float* red_v, int* red_i,
                                  int* red_p) {
  for (int j = 0; j < k; ++j) {
    float bv = -INFINITY;
    int bi = kIntMax;
    int bp = kIntMax;
    for (int e = threadIdx.x; e < m; e += blockDim.x)
      if (lex_gt3(cv[e], ci[e], e, bv, bi, bp)) {
        bv = cv[e];
        bi = ci[e];
        bp = e;
      }
    block_lex_max3(bv, bi, bp, red_v, red_i, red_p);
    if (threadIdx.x == 0) {
      const bool empty = bi >= big_id || bv <= kNegInf / 2;
      out_v[j] = empty ? kNegInf : bv;
      out_i[j] = empty ? empty_id : bi;
      cv[bp] = -INFINITY;  // taken: sorts after everything
      ci[bp] = kIntMax;
    }
    __syncthreads();
  }
}

// A (score, id) pair as one 64-bit key whose unsigned order is the list
// order: the higher score first, then the smaller id. Negative scores are
// flipped so their bits order as the floats do, and -0 counts as +0 (the
// two compare equal); 0 is no entry.
using Key = unsigned long long;

__device__ __forceinline__ Key make_key(float v, int id) {
  uint32_t u = __float_as_uint(v + 0.f);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((Key)u << 32) | (uint32_t)~id;
}

__device__ __forceinline__ float key_value(Key key) {
  const uint32_t u = (uint32_t)(key >> 32);
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

__device__ __forceinline__ int key_id(Key key) { return (int)~(uint32_t)key; }

// Insert key into the descending list l[0, k) (shared or global memory),
// dropping l[k - 1]. The caller has checked that key > l[k - 1]; keys are
// distinct. All 32 lanes of the warp call it.
__device__ inline void warp_key_insert(Key* l, int k, Key key) {
  const int lane = threadIdx.x & 31;
  int pos = 0;
  for (int base = 0; base < k; base += 32) {
    const int j = base + lane;
    pos += __popc(__ballot_sync(kFullMask, j < k && l[j] > key));
  }
  // Shift [pos, k - 1) up by one slot, highest chunk first.
  for (int base = ((k - 1) >> 5) << 5; base >= 0; base -= 32) {
    const int j = base + lane;
    const bool write = j < k && j >= pos;
    Key nk = key;
    if (write && j > pos) nk = l[j - 1];
    __syncwarp();
    if (write) l[j] = nk;
    __syncwarp();
  }
}

// Offer each lane's candidate to the warp's list; kth = l[k - 1] in every
// lane, kept current.
__device__ __forceinline__ void warp_key_offer(bool has, Key key, Key* l,
                                               int k, Key& kth) {
  unsigned want = __ballot_sync(kFullMask, has && key > kth);
  while (want) {
    const int src = __ffs(want) - 1;
    want &= want - 1;
    const Key c = __shfl_sync(kFullMask, key, src);
    if (c > kth) {
      warp_key_insert(l, k, c);
      kth = l[k - 1];
    }
  }
}

// The same for a list of k <= 32 keys held one a lane (lane j holds entry
// j; lanes past k hold 0): an entry's place is a ballot, the shift a
// shuffle.
__device__ __forceinline__ void warp_reg_offer(bool has, Key key, Key& reg,
                                               int k, Key& kth) {
  const int lane = threadIdx.x & 31;
  unsigned want = __ballot_sync(kFullMask, has && key > kth);
  while (want) {
    const int src = __ffs(want) - 1;
    want &= want - 1;
    const Key c = __shfl_sync(kFullMask, key, src);
    if (c > kth) {
      const int pos = __popc(__ballot_sync(kFullMask, lane < k && reg > c));
      const Key up = __shfl_up_sync(kFullMask, reg, 1);
      if (lane < k && lane >= pos) reg = lane == pos ? c : up;
      kth = __shfl_sync(kFullMask, reg, k - 1);
    }
  }
}

// Entries of the descending list l[0, k) above key.
__device__ __forceinline__ int key_count_above(const Key* l, int k,
                                               Key key) {
  int lo = 0, hi = k;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (l[mid] > key)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// The top k of the n descending lists lists[w * k, (w + 1) * k), keys
// distinct: each entry's place is its index plus the entries above it in
// the other lists. emit(place, key) for places 0 .. k - 1, key 0 past the
// last entry. Threads tid = 0 .. nthreads - 1 call it.
template <class Emit>
__device__ void merge_key_lists(const Key* lists, int n, int k, int tid,
                                int nthreads, Emit emit) {
  int total = 0;
  for (int w = 0; w < n; ++w) total += key_count_above(lists + w * k, k, 0);
  for (int e = tid; e < n * k; e += nthreads) {
    const Key key = lists[e];
    if (key == 0) continue;
    const int own = e / k;
    int place = e - own * k;
    for (int w = 0; w < n && place < k; ++w)
      if (w != own) place += key_count_above(lists + w * k, k, key);
    if (place < k) emit(place, key);
  }
  for (int j = total + tid; j < k; j += nthreads) emit(j, 0ull);
}

}  // namespace tr
