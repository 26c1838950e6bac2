// K2': BM25 top-k with the CSR gather fused in, for Hopper (sm_90a).
//
// Replaces tpurag/kernels/bm25_pallas.py:bm25_topk_fused (:402, reaching
// the pallas_call at :232): the CSR window gather of tpurag/kernels/bm25.py:
// _gather_candidates, the odd-term flip, then the Pallas kernel's merge:
// per query row, a bitonic merge of T P-lane windows (odd windows flipped,
// so the network starts at 2P), a T-window shift-add segment sum, then a
// k-pass top-k (scores <= 0 come out as (NEG_INF, -1)). cbits > 0 packs
// doc << cbits | quantized contribution into one int32 key per lane. The
// network and the T-window rule are kept as the TPU kernel has them (K2,
// the keyword index's merge, is csrc/bm25_topk.cu): on windows that are not
// doc-sorted (a clamped start spanning two terms, a doc repeated inside a
// window) they give the JAX package's answers, which a merge path would not.
//
// The network on live lanes only. Every pad lane (past its window's
// length, doc >= n_valid, or a packed doc past (2^31 - 1) >> cbits) holds
// the row's largest value: PAD_KEY packed, (2^30, 0) unpacked, which no
// live lane equals. A lane moves only on a strict compare, so a
// comparator between two pads does nothing and a live lane facing a pad
// ends on the comparator's min side. Running the network's stages over
// the live lanes alone, each finding its partner at pos ^ s in the row,
// therefore leaves the row exactly as the full network would, bit for bit.
//
// What bounds it on this card: the eval suite's rows hold ~168 live lanes
// of W = 16384 (T = 8 windows of ~21 postings at p_max = 2048), so device
// memory sees each live posting read once and the (k,) result written
// (well under a microsecond); the time is the chain of ~39 dependent
// stages of the network, each a shared-memory exchange and a barrier, then
// k argmax passes. So rows in flight hide that latency: the row stays in
// shared memory (80 KB packed at W = 16384: the row, the windows' offsets
// and the list of live lanes) and a block holds one row. With more rows
// than SMs, and where two blocks' shared memory fit on an SM (packed rows;
// unpacked rows of W = 16384 do not), the kernel is the build for two
// blocks an SM (__launch_bounds__(1024, 2): 32 registers a thread), which
// at the eval step's 512 rows halves the waves though the full route's
// lane arrays then spill; otherwise the build without the cap, which does
// not spill, runs: at b=16 rows of every lane live the capped build would
// be 14-19% slower, slower than the first body (PERF.md).
//
// Design: one block per row, up to 1024 threads (16 lanes a thread at W =
// 16384). Route, decided per row in the kernel from the windows' lengths:
// L = sum min(len, p) candidate lanes.
//  - L <= W/2, the live-lane route: warp 0 turns the lengths into offsets
//    of one run of L candidates while the block fills the row with pads;
//    candidate c = tid + r * nt finds its window j by a binary search over
//    the offsets and reads its posting once (doc + impact, 8 bytes,
//    neighbouring threads on neighbouring postings): start = clamp(
//    starts[j], 0, max(nnz - p, 0)), valid = doc < n_valid, contribution
//    idf[j] * impact (one rounding). The packed form takes the row max
//    over the contributions with every other lane as 0, as the plain
//    version does over the gathered row, then packs. Each live candidate
//    writes its lane (j * p + o, odd windows flipped) and joins a list of
//    live lanes. The warps that hold no list entry then leave; the rest
//    take the listed lanes into registers, run the network's stages over
//    them, a named barrier after each, and take the segment sums there;
//    the positive sums go to shared memory and warp 0 alone runs the k
//    argmax passes over them (in registers up to 256), stopping at the
//    first empty pass.
//  - L > W/2, the full route (the first body's, which reads each pair
//    once where the list would read a live pair from both ends): every
//    lane gathers its posting if inside its window, the full network runs
//    over all W/2 lane pairs, and k block-wide argmax passes reduce each
//    thread's best segment sum (held in registers, sought again only when
//    the thread loses a lane to a taken doc).

#include <cuda_runtime.h>

#include "sm90.cuh"
#include "topk.cuh"

namespace {

constexpr int BIG = 1 << 30;           // unpacked pad doc
constexpr int PAD_KEY = 0x7fffffff;    // packed pad key
constexpr int MAX_LANES_PER_THREAD = 16;
constexpr int MAX_THREADS = 1024;
constexpr int TILE = MAX_LANES_PER_THREAD * MAX_THREADS;  // 16384 lanes
// The live-lane route's candidates a thread: L <= W/2 and nt >= W/16.
constexpr int MAX_LIVE_PER_THREAD = MAX_LANES_PER_THREAD / 2;
constexpr int LIVE_BAR = 1;  // its named barrier

// CSR postings and the (B, T) query windows into them (K2').
struct Csr {
  const int* starts;
  const int* lens;
  const float* idf;
  const int* post_doc;
  const float* post_impact;
  int nnz;
  int n_valid;
  int T;
};

// The packed key of (doc d, contribution c): round(c / safe * qmax), half
// to even, clamped as an integer; docs that do not fit become the pad key.
__device__ __forceinline__ int pack_key(int d, float c, float safe,
                                        int cbits) {
  const int mask = (1 << cbits) - 1;
  long long q = llrintf(__fmul_rn(__fdiv_rn(c, safe), (float)mask));
  q = q < 0 ? 0 : (q > mask ? mask : q);
  return d < (PAD_KEY >> cbits) ? ((d << cbits) | (int)q) : PAD_KEY;
}

// Input lane of merged lane i when odd p-blocks load flipped.
__device__ __forceinline__ int src_lane(int i, int p) {
  return (i & p) ? (i ^ (p - 1)) : i;
}

// Lane i of row `row`'s flipped candidate row, gathered from the CSR
// postings: term j = src / p at window offset o = src % p. Only a lane
// inside its window (o < len) reads its posting.
__device__ __forceinline__ void gather_lane(const Csr& c, size_t row, int i,
                                            int p, int& d, float& v) {
  const int src = src_lane(i, p);
  const int o = src & (p - 1);
  const size_t slot = row * c.T + src / p;
  const int lim = c.nnz > p ? c.nnz - p : 0;
  int st = __ldg(c.starts + slot);
  st = st < 0 ? 0 : (st > lim ? lim : st);
  const bool in_window = o < __ldg(c.lens + slot);
  const int dd = in_window ? __ldg(c.post_doc + st + o) : BIG;
  const bool valid = in_window && dd < c.n_valid;
  d = valid ? dd : BIG;
  v = valid ? __fmul_rn(__ldg(c.idf + slot), __ldg(c.post_impact + st + o))
            : 0.f;
}

// Compare-exchange of lanes lo < hi in a level kk block; lo_global is lo's
// lane in the whole row. Ascending when (lo_global & kk) == 0; equal keys
// never swap.
template <bool PACKED>
__device__ __forceinline__ void exchange(int* key, float* cs, int lo, int hi,
                                         int lo_global, int kk) {
  const int a = key[lo];
  const int b = key[hi];
  const bool swap = (lo_global & kk) == 0 ? a > b : a < b;
  if (swap) {
    key[lo] = b;
    key[hi] = a;
    if (!PACKED) {
      const float c = cs[lo];
      cs[lo] = cs[hi];
      cs[hi] = c;
    }
  }
}

// The lo lane of compare-exchange pair pi at stride s.
__device__ __forceinline__ int pair_lo(int pi, int s) {
  return ((pi & ~(s - 1)) << 1) | (pi & (s - 1));
}

// Levels kk = kk_lo .. n of the network over n lanes in shared memory;
// each level runs its strides from kk / 2 down to 1.
template <bool PACKED>
__device__ void smem_network(int* key, float* cs, int n, int kk_lo) {
  for (int kk = kk_lo; kk <= n; kk <<= 1) {
    for (int s = kk >> 1; s >= 1; s >>= 1) {
      for (int pi = threadIdx.x; pi < (n >> 1); pi += blockDim.x) {
        const int lo = pair_lo(pi, s);
        exchange<PACKED>(key, cs, lo, lo + s, lo, kk);
      }
      __syncthreads();
    }
  }
}

template <bool PACKED>
__device__ __forceinline__ bool is_pad(int key) {
  return PACKED ? key == PAD_KEY : key == BIG;
}

// The same levels over the live lanes only: pos[r] (r < RL) is the
// current lane of this thread's r-th live element, -1 if none, and the
// first `threads` threads of the block take part. In a pair (lo, lo + s)
// of level kk the min side is lo when (lo & kk) == 0, else lo + s. A live
// lane whose partner is a pad moves to the min side (the pad takes its
// place); of two live lanes the one at lo compares and exchanges them, as
// the full network does. Pairs are disjoint within a stage, so a stage
// needs no ordering beyond the barrier that ends it: the other end of a
// live pair only reads a live key, whichever its owner leaves there.
template <bool PACKED>
__device__ void live_network(int* key, float* cs,
                             int (&pos)[MAX_LIVE_PER_THREAD], int RL, int W,
                             int kk_lo, int threads) {
  for (int kk = kk_lo; kk <= W; kk <<= 1) {
    for (int s = kk >> 1; s >= 1; s >>= 1) {
#pragma unroll
      for (int r = 0; r < MAX_LIVE_PER_THREAD; ++r) {
        if (r >= RL) break;
        const int i = pos[r];
        if (i < 0) continue;
        const int j = i ^ s;
        const int lo = i & ~s;
        const bool asc = (lo & kk) == 0;
        const int a = key[i];
        const int b = key[j];
        if (is_pad<PACKED>(b)) {
          const int to = asc ? lo : (lo | s);
          if (to != i) {
            key[to] = a;
            key[i] = PACKED ? PAD_KEY : BIG;
            if (!PACKED) {
              cs[to] = cs[i];
              cs[i] = 0.f;
            }
            pos[r] = to;
          }
        } else if (i == lo && (asc ? a > b : a < b)) {
          key[i] = b;
          key[j] = a;
          if (!PACKED) {
            const float c = cs[i];
            cs[i] = cs[j];
            cs[j] = c;
          }
        }
      }
      sm90::named_sync(LIVE_BAR, threads);
    }
  }
}

template <bool PACKED>
__device__ __forceinline__ int doc_of(const int* key, int i, int cbits) {
  return PACKED ? (int)((unsigned)key[i] >> cbits) : key[i];
}

template <bool PACKED>
__device__ __forceinline__ float con_of(const int* key, const float* cs,
                                        int i, int cbits, float scale) {
  return PACKED ? __fmul_rn((float)(key[i] & ((1 << cbits) - 1)), scale)
                : cs[i];
}

// Segment sum at lane i of a merged W-lane row: the doc's total over the
// t-lane window if lane i ends its segment and the doc is not a pad, else
// NEG_INF.
template <bool PACKED>
__device__ float seg_at(const int* key, const float* cs, int i, int W, int t,
                        int cbits, float scale, int big) {
  const int d = doc_of<PACKED>(key, i, cbits);
  const bool is_end = i == W - 1 || d != doc_of<PACKED>(key, i + 1, cbits);
  if (!is_end || d >= big) return tr::kNegInf;
  float total = con_of<PACKED>(key, cs, i, cbits, scale);
  for (int j = 1; j < t; ++j) {
    const float add = (i >= j && doc_of<PACKED>(key, i - j, cbits) == d)
                          ? con_of<PACKED>(key, cs, i - j, cbits, scale)
                          : 0.f;
    total = __fadd_rn(total, add);
  }
  return total;
}

// This lane's slot in a shared list that the lanes of the warp with
// `take` extend after *count (one atomic a warp). Every lane of the warp
// calls it.
__device__ __forceinline__ int warp_append(bool take, int* count) {
  const unsigned mask = __ballot_sync(tr::kFullMask, take);
  const int lane = threadIdx.x & 31;
  const int leader = mask ? __ffs(mask) - 1 : 0;
  int base = 0;
  if (mask && lane == leader) base = atomicAdd(count, __popc(mask));
  base = __shfl_sync(tr::kFullMask, base, leader);
  return base + __popc(mask & ((1u << lane) - 1));
}

// The window of candidate c: the last j with off[j] <= c (off ascending,
// off[0] = 0 <= c < off[t]; an empty window shares its successor's
// offset).
__device__ __forceinline__ int window_of(const int* off, int t, int c) {
  int lo = 0, hi = t;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (off[mid] <= c)
      lo = mid;
    else
      hi = mid;
  }
  return lo;
}

// Block-wide scratch of the argmax reductions and the row's counters.
struct Scratch {
  float v[32];
  int i[32];
  int p[32];
  int n_live;
  int n_cand;
};

// The full route: every lane gathered, the full network, k block-wide
// argmax passes over the segment sums in registers (lane i = tid + r * nt
// in seg[r]). While the packed form waits for the row max, a lane's doc
// waits in the row and only its contribution in a register (registers are
// what two blocks an SM run short of).
template <bool PACKED>
__device__ void full_row(const Csr& csr, size_t row, int W, int p, int t,
                         int cbits, int k, int* key, float* cs, float* ov,
                         int* oi, Scratch& sc) {
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  float scale = 0.f;
  int big = BIG;
  float gc[MAX_LANES_PER_THREAD];
  float m = -INFINITY;
#pragma unroll
  for (int r = 0; r < MAX_LANES_PER_THREAD; ++r) {
    const int i = tid + r * nt;
    if (i < W) {
      int d;
      gather_lane(csr, row, i, p, d, gc[r]);
      key[i] = d;
      if (!PACKED) cs[i] = gc[r];
      m = fmaxf(m, gc[r]);
    }
  }
  if (PACKED) {
    int unused_i = 0, unused_p = 0;
    tr::block_lex_max3(m, unused_i, unused_p, sc.v, sc.i, sc.p);
    const float safe = fmaxf(m, 1e-30f);
    scale = __fdiv_rn(safe, (float)((1 << cbits) - 1));
    big = PAD_KEY >> cbits;
#pragma unroll
    for (int r = 0; r < MAX_LANES_PER_THREAD; ++r) {
      const int i = tid + r * nt;
      if (i < W) key[i] = pack_key(key[i], gc[r], safe, cbits);
    }
  }
  __syncthreads();

  smem_network<PACKED>(key, cs, W, 2 * p);

  // Segment sums of this thread's lanes; bit r of `alive` marks lane
  // tid + r * nt while its sum is positive and its doc not yet taken. The
  // thread's best alive lane waits in (cv, cd, cl) and is sought again
  // only when the thread loses a lane, so a pass reads the sums of no
  // other thread.
  float seg[MAX_LANES_PER_THREAD];
  unsigned alive = 0;
#pragma unroll
  for (int r = 0; r < MAX_LANES_PER_THREAD; ++r) {
    const int i = tid + r * nt;
    seg[r] = i < W ? seg_at<PACKED>(key, cs, i, W, t, cbits, scale, big)
                   : tr::kNegInf;
    if (seg[r] > 0.f) alive |= 1u << r;
  }
  float cv = -INFINITY;
  int cd = tr::kIntMax;
  int cl = tr::kIntMax;
  auto seek = [&]() {
    cv = -INFINITY;
    cd = cl = tr::kIntMax;
#pragma unroll
    for (int r = 0; r < MAX_LANES_PER_THREAD; ++r) {
      const int i = tid + r * nt;
      if ((alive >> r) & 1u) {
        const int d = doc_of<PACKED>(key, i, cbits);
        if (tr::lex_gt(seg[r], d, cv, cd)) {
          cv = seg[r];
          cd = d;
          cl = i;
        }
      }
    }
  };
  seek();
  for (int pass = 0; pass < k; ++pass) {
    float bv = cv;
    int bd = cd;
    int bl = cl;
    tr::block_lex_max3(bv, bd, bl, sc.v, sc.i, sc.p);
    if (bl == tr::kIntMax) {  // no positive score left
      for (int j = pass + tid; j < k; j += nt) {
        ov[j] = tr::kNegInf;
        oi[j] = -1;
      }
      return;
    }
    if (tid == 0) {
      ov[pass] = bv;
      oi[pass] = bd;
    }
    // Every lane of the taken doc leaves the race (select_topk's rule): a
    // row that was not sorted going in (a clamped window that spans two
    // terms) can end one doc's segment twice.
    const unsigned before = alive;
#pragma unroll
    for (int r = 0; r < MAX_LANES_PER_THREAD; ++r)
      if (((alive >> r) & 1u) &&
          doc_of<PACKED>(key, tid + r * nt, cbits) == bd)
        alive &= ~(1u << r);
    if (alive != before) seek();
  }
}

// One warp's k argmax passes (score desc, doc asc) over nc positive sums
// cand_v / cand_d in shared memory; each taken doc leaves the race with
// all its segment ends, and the first empty pass fills the rest with
// (NEG_INF, -1). Up to 32 * CAND_REGS sums are held in registers, more
// are read from shared memory each pass.
constexpr int CAND_REGS = 8;

__device__ void warp_topk(float* cand_v, const int* cand_d, int nc, int k,
                          float* ov, int* oi) {
  const int lane = threadIdx.x & 31;
  const bool in_regs = nc <= 32 * CAND_REGS;
  float v[CAND_REGS];
  int d[CAND_REGS];
#pragma unroll
  for (int r = 0; r < CAND_REGS; ++r) {
    const int e = lane + 32 * r;
    v[r] = in_regs && e < nc ? cand_v[e] : -INFINITY;
    d[r] = in_regs && e < nc ? cand_d[e] : tr::kIntMax;
  }
  for (int pass = 0; pass < k; ++pass) {
    float bv = -INFINITY;
    int bd = tr::kIntMax;
    int bl = tr::kIntMax;
    if (in_regs) {
#pragma unroll
      for (int r = 0; r < CAND_REGS; ++r)
        if (v[r] > 0.f && tr::lex_gt(v[r], d[r], bv, bd)) {
          bv = v[r];
          bd = d[r];
          bl = lane + 32 * r;
        }
    } else {
      for (int e = lane; e < nc; e += 32) {
        const float x = cand_v[e];
        if (x > 0.f && tr::lex_gt(x, cand_d[e], bv, bd)) {
          bv = x;
          bd = cand_d[e];
          bl = e;
        }
      }
    }
    tr::warp_lex_max3(bv, bd, bl);
    if (bl == tr::kIntMax) {  // no positive score left
      for (int j = pass + lane; j < k; j += 32) {
        ov[j] = tr::kNegInf;
        oi[j] = -1;
      }
      return;
    }
    if (lane == 0) {
      ov[pass] = bv;
      oi[pass] = bd;
    }
    if (in_regs) {
#pragma unroll
      for (int r = 0; r < CAND_REGS; ++r)
        if (d[r] == bd) v[r] = -INFINITY;
    } else {
      for (int e = lane; e < nc; e += 32)
        if (cand_d[e] == bd) cand_v[e] = -INFINITY;
    }
  }
}

// The live-lane route for a row of L <= W/2 candidate lanes. Shared
// memory beyond the row: off[t + 1] and list[W / 2] (the live lanes as
// loaded, dealt to the threads that run the network); the positive sums
// reuse the row's first 4W bytes once the sums are taken.
template <bool PACKED>
__device__ void live_row(const Csr& csr, size_t row, int W, int p, int t,
                         int cbits, int k, int* key, float* cs, int* off,
                         unsigned short* list, float* ov, int* oi,
                         Scratch& sc) {
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int pad = PACKED ? PAD_KEY : BIG;

  // Each window's candidate lanes (o < min(len, p)) as offsets into one
  // run of L candidates; every lane a pad meanwhile.
  if (warp == 0) {
    int carry = 0;
    for (int base = 0; base < t; base += 32) {
      const int j = base + lane;
      int v = j < t ? __ldg(csr.lens + row * t + j) : 0;
      v = v < 0 ? 0 : (v > p ? p : v);
      int x = v;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(tr::kFullMask, x, o);
        if (lane >= o) x += y;
      }
      if (j < t) off[j] = carry + x - v;
      carry += __shfl_sync(tr::kFullMask, x, 31);
    }
    if (lane == 0) off[t] = carry;
  }
  for (int i = tid; i < W; i += nt) {
    key[i] = pad;
    if (!PACKED) cs[i] = 0.f;
  }
  __syncthreads();

  // Candidate c = tid + r * nt reads its posting once and, if valid,
  // puts its doc at its lane (window j, offset o: j * p + o, odd windows
  // flipped, in at[r]; -1 if invalid); its contribution waits in a
  // register until the row max is known.
  const int L = off[t];
  const int lim = csr.nnz > p ? csr.nnz - p : 0;
  const int R = (L + nt - 1) / nt;
  int at[MAX_LIVE_PER_THREAD];
  float gc[MAX_LIVE_PER_THREAD];
  float m = L < W ? 0.f : -INFINITY;  // lanes past the windows hold 0
#pragma unroll
  for (int r = 0; r < MAX_LIVE_PER_THREAD; ++r) {
    at[r] = -1;
    gc[r] = 0.f;
    const int c = tid + r * nt;
    if (r < R && c < L) {
      const int j = window_of(off, t, c);
      const int o = c - off[j];
      const size_t slot = row * t + j;
      int st = __ldg(csr.starts + slot);
      st = (st < 0 ? 0 : (st > lim ? lim : st)) + o;
      const int d = __ldg(csr.post_doc + st);
      if (d < csr.n_valid) {
        at[r] = j * p + ((j & 1) ? p - 1 - o : o);
        gc[r] = __fmul_rn(__ldg(csr.idf + slot), __ldg(csr.post_impact + st));
        key[at[r]] = d;
        if (!PACKED) cs[at[r]] = gc[r];
      }
      m = fmaxf(m, gc[r]);
    }
  }
  float safe = 0.f, scale = 0.f;
  int big = BIG;
  if (PACKED) {
    int unused_i = 0, unused_p = 0;
    tr::block_lex_max3(m, unused_i, unused_p, sc.v, sc.i, sc.p);
    safe = fmaxf(m, 1e-30f);
    scale = __fdiv_rn(safe, (float)((1 << cbits) - 1));
    big = PAD_KEY >> cbits;
  }
  // The live candidates (packed: docs that fit beside the contribution's
  // bits) take their keys and join the list.
#pragma unroll
  for (int r = 0; r < MAX_LIVE_PER_THREAD; ++r) {
    if (r >= R) break;
    const int i = at[r];
    if (PACKED && i >= 0) key[i] = pack_key(key[i], gc[r], safe, cbits);
    const bool live = i >= 0 && !is_pad<PACKED>(key[i]);
    const int slot = warp_append(live, &sc.n_live);
    if (live) list[slot] = (unsigned short)i;
  }
  __syncthreads();

  // From here on only the warps that hold list entries (warp 0 at least)
  // take part, through a named barrier; element tid + r * threads's lane
  // is in pos[r].
  const int n = sc.n_live;
  const int held = n < nt ? n : nt;
  const int threads = held > 32 ? (held + 31) & ~31 : 32;
  if (tid >= threads) return;
  const int RL = (n + threads - 1) / threads;
  int pos[MAX_LIVE_PER_THREAD];
#pragma unroll
  for (int r = 0; r < MAX_LIVE_PER_THREAD; ++r) {
    const int e = tid + r * threads;
    pos[r] = r < RL && e < n ? list[e] : -1;
  }
  live_network<PACKED>(key, cs, pos, RL, W, 2 * p, threads);

  // Segment sums at the live lanes (seg[r], doc dseg[r]); then the
  // positive ones go to shared memory over the row, which nobody reads
  // any more.
  float seg[MAX_LIVE_PER_THREAD];
  int dseg[MAX_LIVE_PER_THREAD];
#pragma unroll
  for (int r = 0; r < MAX_LIVE_PER_THREAD; ++r) {
    seg[r] = tr::kNegInf;
    dseg[r] = 0;
    if (r < RL && pos[r] >= 0) {
      seg[r] = seg_at<PACKED>(key, cs, pos[r], W, t, cbits, scale, big);
      dseg[r] = doc_of<PACKED>(key, pos[r], cbits);
    }
  }
  sm90::named_sync(LIVE_BAR, threads);
  float* cand_v = reinterpret_cast<float*>(key);
  int* cand_d = key + W / 2;
#pragma unroll
  for (int r = 0; r < MAX_LIVE_PER_THREAD; ++r) {
    if (r >= RL) break;
    const int slot = warp_append(seg[r] > 0.f, &sc.n_cand);
    if (seg[r] > 0.f) {
      cand_v[slot] = seg[r];
      cand_d[slot] = dseg[r];
    }
  }
  sm90::named_sync(LIVE_BAR, threads);
  if (warp == 0) warp_topk(cand_v, cand_d, sc.n_cand, k, ov, oi);
}

// One block per row, the whole row in shared memory, gathered from `csr`
// (odd terms flipped as they load); out_v/out_i receive the (B, k) top-k.
// Shared memory: key[W] (doc, or packed key), cs[W] (unpacked only), and
// for the live-lane route off[t + 1] and list[W / 2].
template <bool PACKED, int MIN_BLOCKS>
__global__ void __launch_bounds__(MAX_THREADS, MIN_BLOCKS)
    merge_segsum_kernel(Csr csr, int W, int p, int t, int cbits, int k,
                        float* out_v, int* out_i) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ Scratch sc;
  int* key = reinterpret_cast<int*>(smem);
  float* cs = reinterpret_cast<float*>(key + W);
  int* off = PACKED ? key + W : reinterpret_cast<int*>(cs + W);
  unsigned short* list = reinterpret_cast<unsigned short*>(off + t + 1);
  const size_t row = blockIdx.x;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) sc.n_live = sc.n_cand = 0;

  // L = sum over the windows of min(len, p), each warp on its own (the
  // route is the same for every thread).
  int L = 0;
  for (int j = lane; j < t; j += 32) {
    const int v = __ldg(csr.lens + row * t + j);
    L += v < 0 ? 0 : (v > p ? p : v);
  }
  L = __reduce_add_sync(tr::kFullMask, L);
  float* ov = out_v + row * k;
  int* oi = out_i + row * k;
  if (2 * L > W)
    full_row<PACKED>(csr, row, W, p, t, cbits, k, key, cs, ov, oi, sc);
  else
    live_row<PACKED>(csr, row, W, p, t, cbits, k, key, cs, off, list, ov,
                     oi, sc);
}

// Let `kernel` take all the dynamic shared memory a block may have beside
// its static shared memory, on the current device: once per kernel, device
// and process (done[device]).
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

// allow_smem for one build of the kernel, once per device.
template <bool PACKED, int MIN_BLOCKS>
cudaError_t allow_smem_once() {
  static bool done[MAX_DEVICES] = {};
  return allow_smem(merge_segsum_kernel<PACKED, MIN_BLOCKS>, done);
}

template <bool PACKED, int MIN_BLOCKS>
cudaError_t launch(const Csr& csr, int B, int W, int p, int t, int cbits,
                   int k, int nt, size_t smem, float* out_v, int* out_i,
                   cudaStream_t st) {
  const cudaError_t err = allow_smem_once<PACKED, MIN_BLOCKS>();
  if (err != cudaSuccess) return err;
  merge_segsum_kernel<PACKED, MIN_BLOCKS><<<B, nt, smem, st>>>(
      csr, W, p, t, cbits, k, out_v, out_i);
  return cudaGetLastError();
}

// The build for two blocks an SM when there are more rows than SMs and
// two of its blocks fit on one SM (the occupancy query: packed rows at W =
// 16384 take 80 KB of shared memory, two to an SM; unpacked ones 144 KB,
// one); otherwise the build without the register cap, which does not
// spill.
template <bool PACKED>
cudaError_t launch_rows(const Csr& csr, int B, int W, int p, int t,
                        int cbits, int k, float* out_v, int* out_i,
                        cudaStream_t st) {
  int nt = W / MAX_LANES_PER_THREAD;
  nt = nt < 32 ? 32 : (nt > MAX_THREADS ? MAX_THREADS : nt);
  if ((W + nt - 1) / nt > MAX_LANES_PER_THREAD) return cudaErrorInvalidValue;
  const size_t smem = (size_t)W * (PACKED ? sizeof(int)
                                          : sizeof(int) + sizeof(float)) +
                      (size_t)(t + 1) * sizeof(int) +
                      (size_t)(W / 2 + 1) * sizeof(unsigned short);
  int dev = 0, sms = 0, fit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && B > sms) {
    err = allow_smem_once<PACKED, 2>();
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &fit, merge_segsum_kernel<PACKED, 2>, nt, smem);
  }
  if (err != cudaSuccess) return err;
  return fit >= 2 ? launch<PACKED, 2>(csr, B, W, p, t, cbits, k, nt, smem,
                                      out_v, out_i, st)
                  : launch<PACKED, 1>(csr, B, W, p, t, cbits, k, nt, smem,
                                      out_v, out_i, st);
}

}  // namespace

// starts / lens (B, T) int32 and idf (B, T) float32 windows into the nnz
// postings post_doc int32 / post_impact float32; T and p powers of two with
// T * p <= TILE, p <= nnz and n_valid <= 2^30 (a live doc is below the
// unpacked pad).
extern "C" int tr_bm25_topk_fused(const int* starts, const int* lens,
                                  const float* idf, const int* post_doc,
                                  const float* post_impact, int nnz,
                                  int n_valid, int B, int T, int p, int cbits,
                                  int k, float* out_v, int* out_i,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int W = T * p;
  if (T < 1 || (T & (T - 1)) || p < 1 || (p & (p - 1)) || W > TILE ||
      p > nnz || n_valid > BIG)
    return (int)cudaErrorInvalidValue;
  const Csr csr{starts, lens, idf, post_doc, post_impact, nnz, n_valid, T};
  return (int)(cbits ? launch_rows<true>(csr, B, W, p, T, cbits, k, out_v,
                                          out_i, st)
                     : launch_rows<false>(csr, B, W, p, T, cbits, k, out_v,
                                          out_i, st));
}
