// K3: BM25 full-row merge + segment sum for Hopper (sm_90a).
//
// Replaces the Pallas kernel tpurag/kernels/bm25_pallas.py:merge_segsum_full
// (:255, pallas_calls :340 and :359) and the gather that fed it, the
// bucket-row assembly of tpurag/index/inverted.py:_assemble. The contract
// is the Pallas kernel's: per full row of a query class, t term lists, each
// one doc-ascending bucket-matrix row (at most one lane per doc), merge
// into the W = t * p_max lane row doc_s (the live lanes ordered by doc,
// then by slot; parked lanes at 2^30 after them) and seg (each doc's sum at
// its segment-end lane, NEG_INF elsewhere). A lane contributes
// scale * impact, rounded once. A doc's sum starts at its last slot's
// contribution and adds the earlier ones going down (__fadd_rn), the
// t-window order of the plain version (kernels/bm25_merge.py:
// merge_segsum_full_ref), so the result does not depend on block order.
// cbits > 0 (t > 1) quantises each contribution as the packed layout does:
// q = round-half-even(con / max(rowmax, 1e-30) * qmax), clamped as an
// integer, summed as q * (safe / qmax); docs >= (2^31 - 1) >> cbits park.
//
// What bounds it on this card: bytes. Each live lane is read once (doc +
// impact, 8 bytes) and each output lane written once (seg + doc_s, 8
// bytes); the merge is a few compares a lane. The TPU kernel ran a bitonic
// network (it has no dynamic indexing) over rows that XLA code had first
// gathered, padded and scaled in device memory.
//
// Design: one launch for every full-row class of a search. A table goes up
// from the host in one copy: the bucket matrices (base pointers, width),
// one Row per output row (its output pointers, W, the lanes it writes,
// t, cbits, its first slot), one Slot per (row, term slot) (matrix, matrix
// row, live lanes, idf) and the work items. A work item is (row, output
// chunk of CHUNK lanes); one block per item:
//   1. its rank range [r0, r1) of the row; L = the row's live lanes (the
//      slots' lengths; a slot whose length holds parked docs is cut at its
//      first one by a binary search). Lanes [max(r0, L), r1) are parked.
//   2. the split of each list at ranks r0 and e = min(r1, L): the doc D of
//      the lane at that rank, found by a K-ary search over doc values (each
//      round K candidate docs, one binary search per list per candidate,
//      inside the bracket the last round left); equal docs go by slot. Two
//      half-blocks search the two ranks at once.
//   3. each list's range [a, b), with one lane before it (a doc whose lanes
//      straddle r0 belongs to the item holding its end lane: its earlier
//      lanes are the lists' last lanes before a) and one after (whether the
//      item's last doc ends there), staged in shared memory by bulk copies
//      of the 16-byte-aligned middles and plain loads of the edges
//      (bm25_lists.cuh); packed rows take the row max while the copies fly.
//   4. the lists merged in shared memory by a tree of two-way merge paths
//      (lower slots first on equal docs; bm25_lists.cuh, shared with K2),
//      the sums taken at segment ends, and the lanes written out.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "bm25_lists.cuh"
#include "sm90.cuh"
#include "topk.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int HALF = THREADS / 2;  // threads of one split search
constexpr int CHUNK = 4096;        // output lanes per work item
constexpr int MAX_T = 512;         // term lists one row merges
using termlists::BIG;
using termlists::Mat;
using termlists::PAD_KEY;
using termlists::Slot;

// The table's rows (kernels/bm25_merge._k3_prepare), in int64s.
struct Row {  // 8 int64
  float* seg;
  int* doc_s;
  long long W;      // t * p_max
  long long w_out;  // lanes written, >= W (lanes past W are parked)
  long long t;
  long long cbits;  // 0: unpacked
  long long first_slot;
  long long unused;
};
static_assert(sizeof(Row) == 64, "table layout");

// One term list of the item's row, in shared memory.
struct List {
  const int* doc;
  const float* imp;
  float scale;
  int n;     // lanes given
  int m;     // live lanes: [0, m) have doc < big
  int a, b;  // the item's lanes [a, b)
  int lo;    // first staged lane: a, or a - 1
  int c;     // lanes staged: [lo, b) and lane b if b < m
  int sd, si;  // shared index of the first staged doc / impact
};

// Dynamic shared memory (bytes) for a launch whose rows hold at most
// t_max lists: staging (doc, impact), a dense (doc, con) buffer, the lists,
// two offset arrays and the split searches' scratch. The staging area takes
// each list at a 16-byte line of its own (up to 6 lanes of slack), one lane
// before and after it.
__host__ __device__ constexpr int stage_lanes(int t_max) {
  return CHUNK + 8 * t_max;
}
__host__ __device__ constexpr int dense_lanes(int t_max) {
  return CHUNK + 2 * t_max;
}
__host__ __device__ constexpr int search_slots(int t_max) {
  return t_max > HALF ? t_max : HALF;
}
__host__ __device__ constexpr size_t smem_bytes(int t_max) {
  return (size_t)4 * (2 * stage_lanes(t_max) + 2 * dense_lanes(t_max)) +
         sizeof(List) * t_max +
         (size_t)4 * (2 * (t_max + 1) + 4 * t_max + 2 * search_slots(t_max) +
                      2 * HALF);
}

// The K-ary candidate c of the doc range [vlo, vhi).
__device__ __forceinline__ int candidate(int vlo, int vhi, int c, int K) {
  return vlo + (int)((long long)(vhi - vlo) * (c + 1) / (K + 1));
}

__global__ void __launch_bounds__(THREADS)
    full_rows_kernel(const Mat* __restrict__ mats,
                     const Row* __restrict__ rows,
                     const Slot* __restrict__ slots,
                     const long long* __restrict__ items, int t_max) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int SL = stage_lanes(t_max), BL = dense_lanes(t_max);
  const int KT = search_slots(t_max);
  int* st_doc = reinterpret_cast<int*>(smem);
  float* st_imp = reinterpret_cast<float*>(st_doc + SL);
  int* de_doc = reinterpret_cast<int*>(st_imp + SL);
  float* de_con = reinterpret_cast<float*>(de_doc + BL);
  List* lists = reinterpret_cast<List*>(de_con + BL);
  int* dense_off = reinterpret_cast<int*>(lists + t_max);  // t_max + 1
  int* stage_off = dense_off + t_max + 1;                  // t_max + 1
  int* ilo = stage_off + t_max + 1;  // 2 x t_max: per search, per list
  int* ihi = ilo + 2 * t_max;
  int* cnt = ihi + 2 * t_max;  // 2 x KT: (candidate, list) counts
  int* tot = cnt + 2 * KT;     // 2 x HALF: per candidate
  __shared__ uint64_t bar;
  __shared__ int s_live, s_given, s_first, s_last;
  __shared__ int s_vlo[2], s_vhi[2], s_tlo[2], s_cut[2];
  __shared__ float s_max[32];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const long long item = items[blockIdx.x];
  const Row& row = rows[item >> 32];
  float* const seg = row.seg;
  int* const doc_s = row.doc_s;
  const int W = (int)row.W;
  const int w_out = (int)row.w_out;
  const int t = (int)row.t;
  const int cbits = t > 1 ? (int)row.cbits : 0;
  const int big = cbits ? PAD_KEY >> cbits : BIG;
  const int r0 = (int)(item & 0xffffffff) * CHUNK;
  const int r1 = min(r0 + CHUNK, w_out);

  // 1. The lists and the row's live lanes.
  if (tid == 0) {
    s_live = s_given = 0;
    s_first = INT_MAX;
    s_last = INT_MIN;
    sm90::mbar_init(&bar, 1);
    sm90::fence_mbar_init();
  }
  __syncthreads();
  for (int s = tid; s < t; s += THREADS) {
    const Slot sl = slots[row.first_slot + s];
    List L{};
    L.n = sl.len;
    L.scale = sl.scale;
    if (sl.len > 0) {
      const Mat& mt = mats[sl.mat];
      L.doc = mt.doc + (size_t)sl.row * mt.width;
      L.imp = mt.imp + (size_t)sl.row * mt.width;
    }
    int m = sl.len;
    if (m > 0 && L.doc[m - 1] >= big)
      m = termlists::lower_bound(L.doc, 0, m, big);
    L.m = m;
    lists[s] = L;
    atomicAdd(&s_live, m);
    atomicAdd(&s_given, sl.len);
    if (m > 0) {
      atomicMin(&s_first, L.doc[0]);
      atomicMax(&s_last, L.doc[m - 1]);
    }
  }
  __syncthreads();
  const int live = s_live;
  const int e = min(r1, live);
  for (int x = max(r0, e) + tid; x < r1; x += THREADS) {
    seg[x] = tr::kNegInf;
    doc_s[x] = BIG;
  }
  if (r0 >= live) return;

  // 2. The splits at ranks r0 (half 0: the lists' a) and e (half 1: b).
  const int g = tid / HALF, gt = tid % HALF;
  const int target = g == 0 ? r0 : e;
  const bool searching = t > 1 && target > 0 && target < live;
  const int K = t >= HALF ? 1 : HALF / t;
  int* g_ilo = ilo + g * t_max;
  int* g_ihi = ihi + g * t_max;
  int* g_cnt = cnt + g * KT;
  int* g_tot = tot + g * HALF;
  for (int s = gt; s < t; s += HALF) {
    g_ilo[s] = 0;
    g_ihi[s] = lists[s].m;
  }
  if (gt == 0) {  // cnt_lt(first) = 0 <= target < live = cnt_lt(last + 1)
    s_vlo[g] = s_first;
    s_vhi[g] = s_last + 1;
    s_tlo[g] = 0;
  }
  __syncthreads();
  while (true) {
    const int vlo = s_vlo[g], vhi = s_vhi[g];
    const bool go = searching && vhi - vlo > 1;
    if (!__syncthreads_or(go)) break;
    if (go)
      for (int c = gt; c < K; c += HALF) g_tot[c] = 0;
    __syncthreads();
    if (go) {
      for (int q = gt; q < K * t; q += HALF) {
        const int c = q / t, s = q - c * t;
        const int v = candidate(vlo, vhi, c, K);
        const int lb =
            termlists::lower_bound(lists[s].doc, g_ilo[s], g_ihi[s], v);
        g_cnt[q] = lb;
        atomicAdd(&g_tot[c], lb);
      }
    }
    __syncthreads();
    if (go) {  // the last candidate with at most `target` lanes below it
      for (int c = gt; c < K; c += HALF)
        if (g_tot[c] <= target && (c + 1 == K || g_tot[c + 1] > target))
          s_cut[g] = c;
      if (gt == 0 && g_tot[0] > target) s_cut[g] = -1;
    }
    __syncthreads();
    if (go) {
      const int c = s_cut[g];
      for (int s = gt; s < t; s += HALF) {
        if (c >= 0) g_ilo[s] = g_cnt[c * t + s];
        if (c + 1 < K) g_ihi[s] = g_cnt[(c + 1) * t + s];
      }
      if (gt == 0) {
        if (c >= 0) {
          s_vlo[g] = candidate(vlo, vhi, c, K);
          s_tlo[g] = g_tot[c];
        }
        if (c + 1 < K) s_vhi[g] = candidate(vlo, vhi, c + 1, K);
      }
    }
    __syncthreads();
  }
  // [ilo, ihi) now holds each list's lanes of doc D = vlo (at most one);
  // the first target - cnt_lt(D) of them, by slot, lie before the split.
  if (gt < 32) {
    const int need = target - s_tlo[g];
    int taken = 0;
    for (int base = 0; base < t; base += 32) {
      const int s = base + lane;
      const bool has = s < t && searching && g_ihi[s] > g_ilo[s];
      const unsigned mask = __ballot_sync(tr::kFullMask, has);
      const int rank = taken + __popc(mask & ((1u << lane) - 1));
      if (s < t) {
        const int split = t == 1     ? target
                          : searching ? g_ilo[s] + (has && rank < need)
                          : g == 0    ? 0
                                      : lists[s].m;
        if (g == 0)
          lists[s].a = split;
        else
          lists[s].b = split;
      }
      taken += __popc(mask);
    }
  }
  __syncthreads();

  // 3. Staging: list s's lanes [lo, b + (b < m)) at stage_off[s].
  if (tid < 32) {
    termlists::warp_scan(t, [&](int s) {
      List& L = lists[s];
      L.lo = L.a - (L.a > 0);
      L.c = L.b + (L.b < L.m) - L.lo;
      return L.c;
    }, dense_off);
    termlists::warp_scan(
        t, [&](int s) { return (lists[s].c + 6) & ~3; }, stage_off);
    termlists::warp_scan(
        t, [&](int s) { return (int)(lists[s].a > 0); }, ilo);
  }
  __syncthreads();
  const int n_all = dense_off[t];
  const int n_before = ilo[t];  // look-back lanes, first in merged order
  for (int s = tid; s < t; s += THREADS) {
    List& L = lists[s];
    L.sd = stage_off[s] + sm90::staging(L.doc + L.lo, L.c).h;
    L.si = stage_off[s] + sm90::staging(L.imp + L.lo, L.c).h;
  }
  termlists::stage_ranges(
      t,
      [&](int s) {
        const List& L = lists[s];
        return termlists::Range{L.doc + L.lo, L.imp + L.lo, L.c};
      },
      stage_off, st_doc, st_imp, &bar);

  // Packed rows: the row max over every given lane (and 0 for the lanes
  // past them), while the copies fly.
  float safe = 0.f, qscale = 0.f;
  const int qmax = cbits ? (1 << cbits) - 1 : 0;
  if (cbits) {
    float mx = s_given < W ? 0.f : -INFINITY;
    for (int s = 0; s < t; ++s) {
      const List& L = lists[s];
      for (int i = tid; i < L.n; i += THREADS)
        mx = fmaxf(mx, __fmul_rn(L.scale, L.imp[i]));
    }
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(tr::kFullMask, mx, o));
    if (lane == 0) s_max[tid >> 5] = mx;
    __syncthreads();
    mx = s_max[0];
    for (int w = 1; w < THREADS / 32; ++w) mx = fmaxf(mx, s_max[w]);
    safe = fmaxf(mx, 1e-30f);
    qscale = __fdiv_rn(safe, (float)qmax);
  }
  sm90::mbar_wait(&bar, 0);
  __syncthreads();

  // The staged lanes, densely, with their contributions.
  for (int s = 0; s < t; ++s) {
    const List& L = lists[s];
    const int base = dense_off[s];
    for (int i = tid; i < L.c; i += THREADS) {
      float con = __fmul_rn(L.scale, st_imp[L.si + i]);
      if (cbits) {
        long long q = llrintf(__fmul_rn(__fdiv_rn(con, safe), (float)qmax));
        q = q < 0 ? 0 : (q > qmax ? qmax : q);
        con = __fmul_rn((float)q, qscale);
      }
      de_doc[base + i] = st_doc[L.sd + i];
      de_con[base + i] = con;
    }
  }
  __syncthreads();

  // 4. Merge: segments of w lists merge in pairs, lower slots first on
  // equal docs, between the dense buffer and the staging area.
  int* cur_doc = de_doc;
  float* cur_con = de_con;
  int* nxt_doc = st_doc;
  float* nxt_con = st_imp;
  for (int w = 1; w < t; w <<= 1) {
    termlists::merge_level(
        n_all, t, w, dense_off, [&](int i) { return cur_doc[i]; },
        [&](int x, int i) {
          nxt_doc[x] = cur_doc[i];
          nxt_con[x] = cur_con[i];
        });
    __syncthreads();
    int* td = cur_doc;
    cur_doc = nxt_doc;
    nxt_doc = td;
    float* tc = cur_con;
    cur_con = nxt_con;
    nxt_con = tc;
  }

  // The item's lanes: merged lanes n_before .. n_before + e - r0.
  for (int k = tid; k < e - r0; k += THREADS) {
    const int x = n_before + k;
    const int d = cur_doc[x];
    float v = tr::kNegInf;
    if (x + 1 == n_all || cur_doc[x + 1] != d) {
      v = cur_con[x];
      for (int j = 1; j < t && j <= x && cur_doc[x - j] == d; ++j)
        v = __fadd_rn(v, cur_con[x - j]);
    }
    seg[r0 + k] = v;
    doc_s[r0 + k] = d;
  }
}

}  // namespace

// table: n_mats Mat, n_rows Row, n_slots Slot, then n_items int64 items
// (row << 32 | output chunk), as kernels/bm25_merge._k3_prepare builds them;
// t_max: the most lists a row of the launch merges (<= MAX_T = 512, where
// a block takes 149 KB of shared memory).
extern "C" int tr_full_rows(const void* table, int n_mats, int n_rows,
                            int n_slots, int n_items, int t_max,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_rows < 1 || n_items < 1 || t_max < 1 || t_max > MAX_T)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(t_max);
  cudaError_t err = cudaFuncSetAttribute(
      full_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long* tab = static_cast<const long long*>(table);
  const Mat* mats = reinterpret_cast<const Mat*>(tab);
  const Row* rows = reinterpret_cast<const Row*>(tab + 4 * (size_t)n_mats);
  const Slot* slots = reinterpret_cast<const Slot*>(
      tab + 4 * (size_t)n_mats + 8 * (size_t)n_rows);
  const long long* items =
      tab + 4 * (size_t)n_mats + 8 * (size_t)n_rows + 2 * (size_t)n_slots;
  full_rows_kernel<<<n_items, THREADS, smem, st>>>(mats, rows, slots, items,
                                                   t_max);
  return (int)cudaGetLastError();
}
