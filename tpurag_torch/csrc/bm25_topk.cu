// K2: BM25 merge + segment sum + top-k for Hopper (sm_90a), one launch for
// every narrow class of a search.
//
// Replaces the Pallas kernel tpurag/kernels/bm25_pallas.py:merge_segsum_topk
// (:179, pallas_call :232) and the gather that fed it, the bucket-row
// assembly of tpurag/index/inverted.py:_assemble (:90) and the odd-slot flip
// of _bucket_score (:117). Per query row, t term lists, each the live lanes
// of one doc-ascending bucket-matrix row (at most one lane per doc), merge by
// (doc, slot); each doc's sum is taken at its last lane, its last slot's
// contribution first and then the earlier ones going down (__fadd_rn), the
// order of K3 (bm25_full.cu) and of the plain version (kernels/bm25_merge.py:
// merge_segsum_topk_ref); then the top-k by (score desc, doc asc) over sums
// > 0, the row's k slots filled with (NEG_INF, -1) past them. A lane
// contributes scale * impact, rounded once. cbits > 0 quantises each
// contribution as the packed layout does: q = round-half-even(con /
// max(rowmax, 1e-30) * qmax), clamped as an integer, summed as q * (safe /
// qmax); docs >= (2^31 - 1) >> cbits park. The TPU kernel merged with a
// bitonic network (Mosaic has no dynamic indexing) whose order of equal
// docs is its own; the set of lanes a doc's sum adds is the same.
//
// What bounds it on this card: bytes. Each live lane is read once (doc +
// impact, 8 bytes), plus the table and the (rows, k) result; the merge and
// the sums are a few shared-memory reads a lane. The first body
// (tools/bm25_merge_first.cu) ran the TPU kernel's network over every lane
// of rows that torch code had gathered, padded, scaled and flipped in
// device memory: ~40 stages over all 16384 lanes of a row, a barrier after
// each, padding included.
//
// Design: one block per row. A table goes up from the host in one copy:
// the bucket matrices, one Row per query (its output row, t, cbits, first
// slot) and one Slot per (query, term slot) (matrix, matrix row, live
// lanes, idf); rows come largest first. A row holds at most 16384 live
// lanes, so all of them fit one block:
//   1. each slot's live lanes, cut at the first parked doc, are staged by
//      bulk copies of their 16-byte-aligned middles and plain loads of the
//      edges (bm25_lists.cuh, shared with K3);
//   2. each staged impact becomes its contribution in place, and the merge
//      order starts as the lists one after the other; packed rows take the
//      row max on the way (from device memory, while the copies fly, only
//      for given lanes past a slot's cut) and quantise in place;
//   3. the lists merge by a tree of two-way merge paths, lower slots first
//      on equal docs (bm25_lists.cuh). The tree moves 16-bit stage indices,
//      not lanes: two index arrays of 2 bytes a lane beside the 8-byte
//      stage keep a 16384-lane row inside 227 KB;
//   4. each thread sums the segments ending in its lanes, in registers;
//   5. k block-wide argmax passes over those sums take the top-k (each warp
//      picking its best k first measured slower, tools/k2_anatomy.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "bm25_lists.cuh"
#include "sm90.cuh"
#include "topk.cuh"

namespace {

constexpr int MAX_THREADS = 1024;
constexpr int MAX_LPT = 16;  // merged lanes a thread sums
constexpr int MAX_LANES = MAX_THREADS * MAX_LPT;  // 16384 live lanes a row
constexpr int MAX_T = MAX_LANES / 16;  // slots a row at the narrowest bucket

using termlists::BIG;
using termlists::Mat;
using termlists::PAD_KEY;
using termlists::Slot;

// The table's rows (kernels/bm25_merge._k2_prepare), in int64s.
struct Row {  // 8 int64
  float* out_v;  // the row's k result slots
  int* out_i;
  long long W;  // t * p_max: the plain version's lanes (its row max sees a 0
                // when the slots give fewer)
  long long t;
  long long cbits;  // 0: unpacked
  long long first_slot;
  long long unused[2];
};
static_assert(sizeof(Row) == 64, "table layout");

// Dynamic shared memory (bytes): stage_cap lanes of (doc, contribution),
// two merge orders of lane_cap 16-bit indices, and per list its lanes, its
// stage index, its scale and the two offset arrays.
__host__ __device__ constexpr size_t smem_bytes(int stage_cap, int lane_cap,
                                                int t_max) {
  return (size_t)8 * stage_cap + (size_t)4 * lane_cap +
         (size_t)4 * (5 * t_max + 2);
}

// Stage lanes a list of c lanes whose first sits h lanes into its 16-byte
// line takes (the kernel and kernels/bm25_merge._k2_prepare agree on it).
__device__ __forceinline__ int stage_lanes(int h, int c) {
  return c ? (h + c + 3) & ~3 : 0;
}

// Takes merged lane x (a picked doc's) out of this thread's sums seg[r],
// lane x = threadIdx.x + r * blockDim.x.
__device__ __forceinline__ void drop_lane(float (&seg)[MAX_LPT], int x,
                                          int n_all) {
#pragma unroll
  for (int r = 0; r < MAX_LPT; ++r) {
    const int y = threadIdx.x + r * blockDim.x;
    if (y >= n_all) break;
    if (y == x) seg[r] = tr::kNegInf;
  }
}

__global__ void __launch_bounds__(MAX_THREADS)
    topk_rows_kernel(const Mat* __restrict__ mats,
                     const Row* __restrict__ rows,
                     const Slot* __restrict__ slots, int t_max, int stage_cap,
                     int lane_cap, int k) {
  extern __shared__ __align__(128) unsigned char smem[];
  int* st_doc = reinterpret_cast<int*>(smem);
  float* st_con = reinterpret_cast<float*>(st_doc + stage_cap);
  uint16_t* order0 = reinterpret_cast<uint16_t*>(st_con + stage_cap);
  uint16_t* order1 = order0 + lane_cap;
  int* l_c = reinterpret_cast<int*>(order1 + lane_cap);  // t_max
  int* l_sd = l_c + t_max;                                // t_max
  float* l_scale = reinterpret_cast<float*>(l_sd + t_max);  // t_max
  int* dense_off = reinterpret_cast<int*>(l_scale + t_max);  // t_max + 1
  int* stage_off = dense_off + t_max + 1;                     // t_max + 1
  __shared__ uint64_t bar;
  __shared__ int s_given;
  __shared__ float red_v[32];
  __shared__ int red_i[32];
  __shared__ int red_p[32];

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const Row& row = rows[blockIdx.x];
  const int t = (int)row.t;
  const int cbits = (int)row.cbits;
  const int big = cbits ? PAD_KEY >> cbits : BIG;
  const Slot* sl = slots + row.first_slot;

  // 1. The lists: slot s merges lanes [0, c) of its matrix row, its live
  // lanes cut at the first parked doc.
  if (tid == 0) {
    s_given = 0;
    sm90::mbar_init(&bar, 1);
    sm90::fence_mbar_init();
  }
  __syncthreads();
  for (int s = tid; s < t; s += nt) {
    const Slot q = sl[s];
    int c = q.len;
    if (c > 0) {
      const int* doc = termlists::slot_doc(mats, q);
      if (doc[c - 1] >= big) c = termlists::lower_bound(doc, 0, c, big);
    }
    l_c[s] = c;
    l_scale[s] = q.scale;
    atomicAdd(&s_given, q.len);
  }
  __syncthreads();
  if (tid < 32) {
    termlists::warp_scan(t, [&](int s) { return l_c[s]; }, dense_off);
    termlists::warp_scan(
        t,
        [&](int s) {
          const int h = sm90::staging(termlists::slot_doc(mats, sl[s]), 0).h;
          return stage_lanes(h, l_c[s]);
        },
        stage_off);
  }
  __syncthreads();
  const int n_all = dense_off[t];
  auto range = [&](int s) {
    const Slot q = sl[s];
    return termlists::Range{termlists::slot_doc(mats, q),
                            termlists::slot_imp(mats, q), l_c[s]};
  };
  for (int s = tid; s < t; s += nt)
    l_sd[s] = stage_off[s] + sm90::staging(range(s).doc, 0).h;
  termlists::stage_ranges(t, range, stage_off, st_doc, st_con, &bar);

  // Packed rows: the given lanes past a slot's cut (parked docs, rare) count
  // in the row max too, read while the copies fly.
  float mx = cbits && s_given < row.W ? 0.f : -INFINITY;
  if (cbits)
    for (int s = 0; s < t; ++s) {
      const Slot q = sl[s];
      const float* imp = termlists::slot_imp(mats, q);
      for (int i = l_c[s] + tid; i < q.len; i += nt)
        mx = fmaxf(mx, __fmul_rn(q.scale, imp[i]));
    }
  sm90::mbar_wait(&bar, 0);
  __syncthreads();

  // 2. Contributions in place (a list's doc and impact share their stage
  // index: the wrapper checks that the two matrices share their 16-byte
  // alignment), and the first merge order: the lists one after the other.
  for (int x = tid; x < n_all; x += nt) {
    int s = 0;  // the list holding lane x: the last s with dense_off[s] <= x
    for (int hi = t - 1; s < hi;) {
      const int mid = (s + hi + 1) >> 1;
      if (dense_off[mid] <= x)
        s = mid;
      else
        hi = mid - 1;
    }
    const int q = l_sd[s] + x - dense_off[s];
    const float con = __fmul_rn(l_scale[s], st_con[q]);
    mx = fmaxf(mx, con);
    st_con[q] = con;
    order0[x] = (uint16_t)q;
  }
  // Packed rows: the row max over every given lane (and 0 for the lanes
  // past them), then each contribution quantised in place (a thread's own
  // lanes of the pass above).
  if (cbits) {
    const int qmax = (1 << cbits) - 1;
    int unused_i = 0, unused_p = 0;
    tr::block_lex_max3(mx, unused_i, unused_p, red_v, red_i, red_p);
    const float safe = fmaxf(mx, 1e-30f);
    const float qscale = __fdiv_rn(safe, (float)qmax);
    for (int x = tid; x < n_all; x += nt) {
      const int q = order0[x];
      long long v =
          llrintf(__fmul_rn(__fdiv_rn(st_con[q], safe), (float)qmax));
      v = v < 0 ? 0 : (v > qmax ? qmax : v);
      st_con[q] = __fmul_rn((float)v, qscale);
    }
  }
  __syncthreads();

  // 3. Merge: segments of w lists merge in pairs, lower slots first on
  // equal docs; the orders hold stage indices.
  uint16_t* cur = order0;
  uint16_t* nxt = order1;
  for (int w = 1; w < t; w <<= 1) {
    termlists::merge_level(
        n_all, t, w, dense_off, [&](int i) { return st_doc[cur[i]]; },
        [&](int x, int i) { nxt[x] = cur[i]; });
    __syncthreads();
    uint16_t* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }

  // 4. Sums at segment ends; merged lane x = tid + r * nt lives in seg[r].
  // (The register loops stop at the row's last lane: a row of n lanes
  // takes ceil(n / nt) of the MAX_LPT rounds.)
  float seg[MAX_LPT];
#pragma unroll
  for (int r = 0; r < MAX_LPT; ++r) seg[r] = tr::kNegInf;
#pragma unroll
  for (int r = 0; r < MAX_LPT; ++r) {
    const int x = tid + r * nt;
    if (x >= n_all) break;
    const int d = st_doc[cur[x]];
    if (x + 1 == n_all || st_doc[cur[x + 1]] != d) {
      float v = st_con[cur[x]];
      for (int j = 1; j < t && j <= x && st_doc[cur[x - j]] == d; ++j)
        v = __fadd_rn(v, st_con[cur[x - j]]);
      seg[r] = v;
    }
  }

  // 5. Top-k by (score desc, doc asc) over the positive sums, one lane a
  // doc, by k block-wide argmax passes; the rest of the row's slots are
  // empty.
  for (int pass = 0; pass < k; ++pass) {
    float bv = -INFINITY;
    int bd = tr::kIntMax;
    int bl = tr::kIntMax;
#pragma unroll
    for (int r = 0; r < MAX_LPT; ++r) {
      const int x = tid + r * nt;
      if (x >= n_all) break;
      if (seg[r] > 0.f && seg[r] >= bv) {
        const int d = st_doc[cur[x]];
        if (tr::lex_gt(seg[r], d, bv, bd)) {
          bv = seg[r];
          bd = d;
          bl = x;
        }
      }
    }
    tr::block_lex_max3(bv, bd, bl, red_v, red_i, red_p);
    if (bl == tr::kIntMax) {  // no positive score left
      for (int j = pass + tid; j < k; j += nt) {
        row.out_v[j] = tr::kNegInf;
        row.out_i[j] = -1;
      }
      break;
    }
    if (tid == 0) {
      row.out_v[pass] = bv;
      row.out_i[pass] = bd;
    }
    drop_lane(seg, bl, n_all);
  }
}

}  // namespace

// table: n_mats Mat, n_rows Row, n_slots Slot, as kernels/bm25_merge.
// _k2_prepare builds them. t_max: the most slots a row holds (<= MAX_T);
// stage_cap: the most stage lanes a row takes (a multiple of 4); lane_cap:
// the most lanes a row's slots give (<= MAX_LANES); threads: the block's
// size, a multiple of 32 of at least lane_cap / MAX_LPT; k: result slots a
// row.
extern "C" int tr_topk_rows(const void* table, int n_mats, int n_rows,
                            int n_slots, int t_max, int stage_cap,
                            int lane_cap, int threads, int k, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_rows < 1 || t_max < 1 || t_max > MAX_T || lane_cap < 0 ||
      lane_cap > MAX_LANES || stage_cap < 0 || (stage_cap & 3) || k < 1 ||
      threads < 32 || threads > MAX_THREADS || (threads & 31) ||
      threads * MAX_LPT < lane_cap)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(stage_cap, lane_cap, t_max);
  cudaError_t err = cudaFuncSetAttribute(
      topk_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long* tab = static_cast<const long long*>(table);
  const Mat* mats = reinterpret_cast<const Mat*>(tab);
  const Row* rows = reinterpret_cast<const Row*>(tab + 4 * (size_t)n_mats);
  const Slot* slots = reinterpret_cast<const Slot*>(
      tab + 4 * (size_t)n_mats + 8 * (size_t)n_rows);
  (void)n_slots;
  topk_rows_kernel<<<n_rows, threads, smem, st>>>(mats, rows, slots, t_max,
                                                  stage_cap, lane_cap, k);
  return (int)cudaGetLastError();
}
