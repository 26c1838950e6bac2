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
// totals narrow + wide, ties to the smaller doc, totals <= 0 empty
// (NEG_INF, -1).
//
// What bounds it on this card: bytes. Each row is read once (8 bytes a
// lane; a member reads only its own narrow width, and a wide chunk whose
// docs are all parked is not read), the (k,) result written once; the
// join and the selection are a few operations a lane.
//
// Design: one launch for a request's whole batch of wide classes, and
// one block per work item, an item being (member row, wide chunk of
// CHUNK lanes). A row table (one RowEntry per member: its wide row, width,
// narrow / output row, own narrow width, first item) and the item list go
// up from the host in one copy. Item j of a row owns the docs in
// [w_doc[j CHUNK], w_doc[(j + 1) CHUNK]) (the first from below every doc,
// the last up to 2^30, so parked lanes drop out), so every doc, and every
// narrow lane, belongs to exactly one item. A doc's lanes can straddle a
// chunk boundary (a full row repeats a doc over up to t lanes, only the
// segment-end lane valid): the range rule gives that doc to the item
// holding its end lane, and the lanes left in the item below are invalid
// ones, which the join skips. Two warp-wide 32-ary searches find the
// item's narrow sub-range. The wide chunk and the narrow sub-range (in
// tiles of NTILE lanes; one tile unless the narrow side crowds into the
// item's doc range) are staged in shared memory by 1-D bulk copies
// (cp.async.bulk completing on an mbarrier) for their 16-byte-aligned
// middles and plain loads for the unaligned edges. The two doc-sorted
// ranges are then joined by merge path: each thread takes one diagonal
// segment of the merged order (narrow lanes first on equal docs) and
// walks it linearly, with no per-lane search. A valid wide lane adds the
// narrow row's last lane of its doc when that lane is valid (one fp32
// add, as the plain version's segment sum makes it); a valid narrow lane
// stands alone when the wide chunk's last lane of its doc is not valid.
// Each warp keeps a running top-k of (score, doc) keys; the item's warp
// lists merge by rank (each entry's place is its index plus the entries
// above it in the other lists) into the item's sorted top-k in a scratch
// buffer. The row's last item to finish (a fence and an atomic count on
// the row entry, which that item sets back to zero) merges the row's item
// lists the same way, in item order, into the output row. Keys are
// distinct (each doc belongs to one item), so the result does not depend
// on the order in which blocks finish.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "sm90.cuh"
#include "topk.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 4096;  // wide lanes per work item
constexpr int NTILE = 2048;  // narrow lanes staged at a time
constexpr int SLACK = 8;     // room for the head offset of an aligned copy
constexpr int BIG = 1 << 30;
constexpr float VALID = tr::kNegInf / 2;
// A (score, doc) key (tr::make_key: a higher score, then a smaller doc,
// sorts first; 0 is no entry).
using tr::Key;
constexpr size_t STAGE_BYTES = (size_t)2 * (CHUNK + NTILE + 2 * SLACK) * 4;
// Warp lists live in shared memory up to this many bytes, else in a
// device-memory scratch.
constexpr size_t MAX_SMEM_LISTS = 64 * 1024;

// One member row of a wide class: 8 int64 in the table the wrapper builds.
struct RowEntry {
  const float* w_seg;  // the member's wide row
  const int* w_doc;
  long long ww;          // wide width
  long long sel;         // narrow row of n_val / n_doc, output row
  long long wn;          // own narrow width (<= the narrow buffers' stride)
  long long first_item;  // its items are first_item .. first_item + n_items
  long long n_items;
  unsigned long long done;  // items finished; zero between launches
};
static_assert(sizeof(RowEntry) == 64, "RowEntry is 8 int64");

// First index p in [0, n) of the ascending row doc with doc[p] >= x, else
// n: a 32-ary search, one warp, every lane returns it.
__device__ int warp_lower_bound(const int* doc, int n, int x) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = n;  // the answer is in [lo, hi]
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) / 32;
    const int p = lo + lane * step + step - 1;
    const bool lt = p < hi && doc[p] < x;
    const int c = __popc(__ballot_sync(tr::kFullMask, lt));
    const int nlo = lo + c * step;
    hi = min(nlo + step - 1, hi);
    lo = nlo;
  }
  const bool lt = lo + lane < hi && doc[lo + lane] < x;
  return lo + __popc(__ballot_sync(tr::kFullMask, lt));
}

// First index p in [0, n) of the ascending shared row doc with
// doc[p] >= x, else n.
__device__ __forceinline__ int lower_bound(const int* doc, int n, int x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (doc[mid] < x)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(THREADS)
    combine_items_kernel(const float* __restrict__ n_val,
                         const int* __restrict__ n_doc, long long wn_stride,
                         RowEntry* rows, const long long* __restrict__ items,
                         int k, Key* ilist, Key* glists,
                         float* out_v, int* out_i) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* swv = reinterpret_cast<float*>(smem);   // CHUNK + SLACK
  int* swd = reinterpret_cast<int*>(swv + CHUNK + SLACK);
  float* snv = reinterpret_cast<float*>(swd + CHUNK + SLACK);  // NTILE + SLACK
  int* snd = reinterpret_cast<int*>(snv + NTILE + SLACK);
  Key* lists = glists != nullptr
                        ? glists + (size_t)blockIdx.x * WARPS * k
                        : reinterpret_cast<Key*>(smem + STAGE_BYTES);
  __shared__ uint64_t bars[2];  // wide chunk, narrow tile
  __shared__ int s_lo, s_hi, s_b0, s_b1, s_tile_hi, s_last;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const long long item = items[blockIdx.x];
  RowEntry* row = rows + (item >> 32);
  const int j = (int)(item & 0xffffffff);
  const int ww = (int)row->ww;
  const int wn = (int)row->wn;
  const long long sel = row->sel;
  const int a0 = j * CHUNK;
  const int na = min(CHUNK, ww - a0);
  const float* wv = row->w_seg + a0;
  const int* wd = row->w_doc + a0;
  const float* nv = n_val + sel * wn_stride;
  const int* nd = n_doc + sel * wn_stride;
  Key* my_list = lists + warp * k;
  Key kth = 0;

  for (int e = tid; e < WARPS * k; e += THREADS) lists[e] = 0;
  const sm90::Staged sw_v = sm90::staging(wv, na),
                     sw_d = sm90::staging(wd, na);
  if (tid == 0) {
    sm90::mbar_init(&bars[0], 1);
    sm90::mbar_init(&bars[1], 1);
    sm90::fence_mbar_init();
    // The item's doc range [lo, hi).
    s_lo = j == 0 ? INT_MIN : wd[0];
    s_hi = a0 + na < ww ? wd[na] : BIG;
    if (s_lo < s_hi) {
      sm90::mbar_expect_tx(
          &bars[0], sm90::middle_bytes(sw_v) + sm90::middle_bytes(sw_d));
      sm90::bulk_middle(swv, wv, sw_v, &bars[0]);
      sm90::bulk_middle(swd, wd, sw_d, &bars[0]);
    }
  }
  __syncthreads();
  const int lo = s_lo, hi = s_hi;
  if (lo < hi) {
    sm90::plain_edges(reinterpret_cast<int*>(swv),
                      reinterpret_cast<const int*>(wv), sw_v, tid, THREADS);
    sm90::plain_edges(swd, wd, sw_d, tid, THREADS);
    // The narrow lanes of the item's docs: [b0, b1) of the own width.
    if (warp == 0) {
      const int b0 = j == 0 ? 0 : warp_lower_bound(nd, wn, lo);
      if (lane == 0) s_b0 = b0;
    } else if (warp == 1) {
      const int b1 = warp_lower_bound(nd, wn, hi);
      if (lane == 0) s_b1 = b1;
    }
    __syncthreads();
    const int b0 = s_b0, b1 = s_b1;
    const int n_tiles = max(1, (b1 - b0 + NTILE - 1) / NTILE);
    const int* A = swd + sw_d.h;  // the wide chunk, doc-ascending
    const float* Av = swv + sw_v.h;
    for (int tile = 0; tile < n_tiles; ++tile) {
      const int t0 = b0 + tile * NTILE;
      const int nb = max(0, min(NTILE, b1 - t0));
      const sm90::Staged sn_v = sm90::staging(nv + t0, nb),
                         sn_d = sm90::staging(nd + t0, nb);
      if (tid == 0) {
        // The shared tile was last read before the previous barrier.
        sm90::fence_proxy_async();
        sm90::mbar_expect_tx(
            &bars[1], sm90::middle_bytes(sn_v) + sm90::middle_bytes(sn_d));
        sm90::bulk_middle(snv, nv + t0, sn_v, &bars[1]);
        sm90::bulk_middle(snd, nd + t0, sn_d, &bars[1]);
        s_tile_hi = tile + 1 < n_tiles ? nd[t0 + nb] : INT_MAX;
      }
      sm90::plain_edges(reinterpret_cast<int*>(snv),
                        reinterpret_cast<const int*>(nv + t0), sn_v, tid,
                        THREADS);
      sm90::plain_edges(snd, nd + t0, sn_d, tid, THREADS);
      sm90::mbar_wait(&bars[0], 0);
      sm90::mbar_wait(&bars[1], tile & 1);
      __syncthreads();
      const int* B = snd + sn_d.h;
      const float* Bv = snv + sn_v.h;
      // The wide lanes of this tile's docs: a tile after the first starts
      // at its first narrow lane's doc, one before the last ends at the
      // next tile's first doc (a narrow doc straddling the two belongs to
      // the later tile, which holds its end lane).
      const int ia = tile == 0 ? 0 : lower_bound(A, na, B[0]);
      const int ib = tile + 1 < n_tiles ? lower_bound(A, na, s_tile_hi) : na;
      const int* As = A + ia;
      const float* Asv = Av + ia;
      const int nas = ib - ia;
      // Merge path: this thread's diagonals [d0, d0 + steps) of the merged
      // order, narrow lanes before wide ones on equal docs.
      const int n = nas + nb;
      const int steps = (n + THREADS - 1) / THREADS;
      const int d0 = min(tid * steps, n);
      int lo_i = max(0, d0 - nb), hi_i = min(d0, nas);
      while (lo_i < hi_i) {
        const int mid = (lo_i + hi_i) >> 1;
        if (As[mid] < B[d0 - 1 - mid])
          lo_i = mid + 1;
        else
          hi_i = mid;
      }
      int i = lo_i, jb = d0 - lo_i;
      for (int s = 0; s < steps; ++s) {
        bool has = false;
        Key key = 0;
        if (d0 + s < n) {
          if (jb < nb && (i >= nas || B[jb] <= As[i])) {
            // A narrow lane; its doc's wide lanes, if any, follow it.
            if (Bv[jb] > VALID) {
              const int d = B[jb];
              int e = i;
              while (e + 1 < nas && As[e + 1] == d) ++e;
              const bool wide = e < nas && As[e] == d && Asv[e] > VALID;
              const float v = Bv[jb];
              has = !wide && d < BIG && v > 0.f;
              key = tr::make_key(v, d);
            }
            ++jb;
          } else {
            // A wide lane; its doc's narrow lanes, if any, are behind it.
            if (Asv[i] > VALID) {
              const int d = As[i];
              float v = Asv[i];
              if (jb > 0 && B[jb - 1] == d && Bv[jb - 1] > VALID)
                v = __fadd_rn(Bv[jb - 1], v);
              has = d < BIG && v > 0.f;
              key = tr::make_key(v, d);
            }
            ++i;
          }
        }
        tr::warp_key_offer(has, key, my_list, k, kth);
      }
      __syncthreads();  // the tile is read; every warp list is current
    }
  } else {
    __syncthreads();
  }

  // The item's top-k, sorted, into its scratch list.
  Key* out_list = ilist + (size_t)blockIdx.x * k;
  tr::merge_key_lists(lists, WARPS, k, tid, THREADS,
                      [&](int p, Key key) { out_list[p] = key; });
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const unsigned long long prev = atomicAdd(&row->done, 1ull);
    s_last = prev + 1 == (unsigned long long)row->n_items;
    if (s_last) row->done = 0;  // no other item of the row is left
  }
  __syncthreads();
  if (!s_last) return;

  // The row's last item: merge the row's item lists, in item order.
  for (int e = tid; e < WARPS * k; e += THREADS) lists[e] = 0;
  __syncthreads();
  kth = 0;
  const Key* first = ilist + (size_t)row->first_item * k;
  for (int it = warp; it < (int)row->n_items; it += WARPS) {
    const Key* src = first + (size_t)it * k;
    for (int base = 0; base < k; base += 32) {
      const int e = base + lane;
      const Key key = e < k ? __ldcg(src + e) : 0ull;
      tr::warp_key_offer(key != 0, key, my_list, k, kth);
      // The list is descending: once its chunk ends at or below the warp's
      // k-th, nothing after it enters.
      if (__shfl_sync(tr::kFullMask, key, 31) <= kth) break;
    }
  }
  __syncthreads();
  float* ov = out_v + sel * k;
  int* oi = out_i + sel * k;
  tr::merge_key_lists(lists, WARPS, k, tid, THREADS, [&](int p, Key key) {
    ov[p] = key ? tr::key_value(key) : tr::kNegInf;
    oi[p] = key ? tr::key_id(key) : -1;
  });
}

}  // namespace

// table: n_rows RowEntry (8 int64 each) then n_items int64 items (row <<
// 32 | chunk index), as bm25_join._k4_table builds them. ilist: (n_items,
// k) uint64 scratch; glists: (n_items, 8, k) uint64 scratch when the warp
// lists do not fit in shared memory, else null. out_v / out_i: (rows of
// n_val, k), every row a member of exactly one class.
extern "C" int tr_combine_topk_classes(const float* n_val, const int* n_doc,
                                       long long wn_stride, void* table,
                                       int n_rows, int n_items, int k,
                                       void* ilist, void* glists, float* out_v,
                                       int* out_i, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_rows < 1 || n_items < 1 || k < 1) return (int)cudaErrorInvalidValue;
  const size_t list_bytes = (size_t)WARPS * k * sizeof(Key);
  if ((glists == nullptr) != (list_bytes <= MAX_SMEM_LISTS))
    return (int)cudaErrorInvalidValue;
  const size_t smem = STAGE_BYTES + (glists == nullptr ? list_bytes : 0);
  cudaError_t err = cudaFuncSetAttribute(
      combine_items_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  RowEntry* rows = static_cast<RowEntry*>(table);
  const long long* items = reinterpret_cast<const long long*>(rows + n_rows);
  combine_items_kernel<<<n_items, THREADS, smem, st>>>(
      n_val, n_doc, wn_stride, rows, items, k,
      static_cast<Key*>(ilist), static_cast<Key*>(glists), out_v,
      out_i);
  return (int)cudaGetLastError();
}
