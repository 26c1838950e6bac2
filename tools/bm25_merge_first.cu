// The first bodies of K2 and K2', no longer built into the library:
// tools/k2_anatomy.py and chip_smoke.py build this file on its own to time
// the current bodies against. Entry tr_merge_segsum_topk is K2's first
// body (the current one is tpurag_torch/csrc/bm25_topk.cu), on rows
// gathered beforehand (odd slots flipped); entry tr_bm25_topk_fused is
// K2''s, the full network over every lane of the row (the current one,
// tpurag_torch/csrc/bm25_merge.cu, runs it on the live lanes). The file is
// csrc/bm25_merge.cu as it was before either was redesigned.
//
// K2: BM25 bitonic merge + segment sum + top-k for Hopper (sm_90a).
//
// Replaces the Pallas kernel tpurag/kernels/bm25_pallas.py:
// merge_segsum_topk (body _merge_segsum_kernel with out_full=False). Same
// contract, both layouts: per candidate row, a bitonic merge of T
// doc-sorted P-blocks (odd blocks flipped, so the network starts at 2P), a
// T-window shift-add segment sum (a doc appears at most once per term),
// then a k-pass top-k (scores <= 0 come out as (NEG_INF, -1)). cbits > 0
// packs doc << cbits | quantized contribution into one int32 key per lane.
// (K3, the full-row form, is csrc/bm25_full.cu.)
//
// What bounds it on this card: the network is ~40 compare-exchange
// stages at W = 16384, each a pass over the whole row, so the row has to
// stay on chip: 16384 lanes are 128 KB unpacked (doc + contribution), 64
// KB packed, inside one block's 227 KB of shared memory. Device memory
// sees one read of the row and a (k,) write.
//
// Design: one block per row, up to 1024 threads, the row in dynamic shared
// memory (cudaFuncSetAttribute past 48 KB). Packing happens in the kernel
// (a block max, then the key per lane), so the row is read once. Each
// stage is one pass of compare-exchanges over W/2 lane pairs followed by
// __syncthreads; the exchange rule is the Pallas kernel's, so equal keys
// never move and the sums below add in the same order (results are
// bit-identical to the plain version). The segment sums of each thread's
// <= 16 lanes stay in registers, and the top-k is k block-wide argmax
// passes over them that stop at the first score <= 0.
//
// K2' replaces tpurag/kernels/bm25_pallas.py:bm25_topk_fused: the CSR
// window gather of tpurag/kernels/bm25.py:_gather_candidates, the odd-term
// flip, then K2. In the JAX package the gather is XLA code that writes the
// (B, T * p_max) candidate rows to device memory for the Pallas kernel to
// read back; here it is K2's load stage (GATHER = true), so each lane reads
// its posting (doc + impact, 8 bytes, neighbouring lanes on neighbouring
// postings) and nothing else touches device memory but the (B, k) result.
// A lane of term j and window offset o: start = clamp(starts[j], 0,
// max(nnz - p, 0)), valid = o < lens[j] && doc < n_valid, contribution
// idf[j] * impact (one rounding) or 0, doc or 2^30. The packed form takes
// the row max over those contributions (invalid zeros included), as K2's
// plain version does over the gathered row. Bit-identical to K2's plain
// version of the gathered row.

#include <cuda_runtime.h>

#include "topk.cuh"

namespace {

constexpr int BIG = 1 << 30;           // unpacked pad doc
constexpr int PAD_KEY = 0x7fffffff;    // packed pad key
constexpr int MAX_LANES_PER_THREAD = 16;
constexpr int MAX_THREADS = 1024;
constexpr int TILE = MAX_LANES_PER_THREAD * MAX_THREADS;  // 16384 lanes

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
// postings: term j = src / p at window offset o = src % p.
__device__ __forceinline__ void gather_lane(const Csr& c, size_t row, int i,
                                            int p, int& d, float& v) {
  const int src = src_lane(i, p);
  const int o = src & (p - 1);
  const size_t slot = row * c.T + src / p;
  const int lim = c.nnz > p ? c.nnz - p : 0;
  int st = c.starts[slot];
  st = st < 0 ? 0 : (st > lim ? lim : st);
  const int dd = c.post_doc[st + o];
  const float imp = c.post_impact[st + o];
  const bool valid = o < c.lens[slot] && dd < c.n_valid;
  d = valid ? dd : BIG;
  v = valid ? __fmul_rn(c.idf[slot], imp) : 0.f;
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
// t-lane window if lane i ends its segment and the doc is not parked,
// else NEG_INF.
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

// Block-wide max of con over one row (the packed layout's scale).
__device__ float row_max(const float* crow, int W, float* red_v, int* red_i,
                         int* red_p) {
  float m = -INFINITY;
  for (int i = threadIdx.x; i < W; i += blockDim.x) m = fmaxf(m, crow[i]);
  int unused_i = 0, unused_p = 0;
  tr::block_lex_max3(m, unused_i, unused_p, red_v, red_i, red_p);
  return m;
}

// One block per row, the whole row in shared memory; the input arrives
// flipped and out_v/out_i receive the (B, k) top-k. GATHER (K2'): the row
// is gathered from `csr` (doc and con unused), odd terms flipped as they
// load.
template <bool PACKED, bool GATHER>
__global__ void __launch_bounds__(MAX_THREADS)
    merge_segsum_kernel(const int* __restrict__ doc,
                        const float* __restrict__ con, Csr csr, int W, int p,
                        int t, int cbits, int k, float* out_v, int* out_i) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float red_v[32];
  __shared__ int red_i[32];
  __shared__ int red_p[32];
  int* key = reinterpret_cast<int*>(smem);          // doc, or packed key
  float* cs = reinterpret_cast<float*>(key + W);    // unpacked only
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const size_t row = blockIdx.x;
  const int* drow = doc + row * W;
  const float* crow = con + row * W;

  float scale = 0.f;
  int big = BIG;
  if (GATHER) {
    // Lane i = tid + r * nt's gathered (doc, con) stays in registers until
    // the row max is known.
    int gd[MAX_LANES_PER_THREAD];
    float gc[MAX_LANES_PER_THREAD];
    float m = -INFINITY;
#pragma unroll
    for (int r = 0; r < MAX_LANES_PER_THREAD; ++r) {
      const int i = tid + r * nt;
      if (i < W) {
        gather_lane(csr, row, i, p, gd[r], gc[r]);
        m = fmaxf(m, gc[r]);
      }
    }
    float safe = 0.f;
    if (PACKED) {
      int unused_i = 0, unused_p = 0;
      tr::block_lex_max3(m, unused_i, unused_p, red_v, red_i, red_p);
      safe = fmaxf(m, 1e-30f);
      scale = __fdiv_rn(safe, (float)((1 << cbits) - 1));
      big = PAD_KEY >> cbits;
    }
#pragma unroll
    for (int r = 0; r < MAX_LANES_PER_THREAD; ++r) {
      const int i = tid + r * nt;
      if (i < W) {
        if (PACKED) {
          key[i] = pack_key(gd[r], gc[r], safe, cbits);
        } else {
          key[i] = gd[r];
          cs[i] = gc[r];
        }
      }
    }
  } else if (PACKED) {
    const float safe = fmaxf(row_max(crow, W, red_v, red_i, red_p), 1e-30f);
    for (int i = tid; i < W; i += nt)
      key[i] = pack_key(drow[i], crow[i], safe, cbits);
    scale = __fdiv_rn(safe, (float)((1 << cbits) - 1));
    big = PAD_KEY >> cbits;
  } else {
    for (int i = tid; i < W; i += nt) {
      key[i] = drow[i];
      cs[i] = crow[i];
    }
  }
  __syncthreads();

  smem_network<PACKED>(key, cs, W, 2 * p);

  // Segment sums at segment-end lanes; lane i = tid + r * nt lives in
  // seg[r].
  float seg[MAX_LANES_PER_THREAD];
#pragma unroll
  for (int r = 0; r < MAX_LANES_PER_THREAD; ++r) {
    const int i = tid + r * nt;
    seg[r] = i < W ? seg_at<PACKED>(key, cs, i, W, t, cbits, scale, big)
                   : tr::kNegInf;
  }

  // Top-k: k block-wide argmax passes (score desc, doc asc) over the
  // positive segment sums; the rest of the row is empty.
  float* ov = out_v + row * k;
  int* oi = out_i + row * k;
  for (int pass = 0; pass < k; ++pass) {
    float bv = -INFINITY;
    int bd = tr::kIntMax;
    int bl = tr::kIntMax;
#pragma unroll
    for (int r = 0; r < MAX_LANES_PER_THREAD; ++r) {
      const int i = tid + r * nt;
      if (i < W && seg[r] > 0.f) {
        const int d = doc_of<PACKED>(key, i, cbits);
        if (tr::lex_gt(seg[r], d, bv, bd)) {
          bv = seg[r];
          bd = d;
          bl = i;
        }
      }
    }
    tr::block_lex_max3(bv, bd, bl, red_v, red_i, red_p);
    if (bl == tr::kIntMax) {  // no positive score left
      for (int j = pass + tid; j < k; j += nt) {
        ov[j] = tr::kNegInf;
        oi[j] = -1;
      }
      break;
    }
    if (tid == 0) {
      ov[pass] = bv;
      oi[pass] = bd;
    }
    // Every lane of the taken doc leaves the race (select_topk's rule): a
    // row that was not sorted going in (a clamped window that spans two
    // terms) can end one doc's segment twice. Only positive lanes are
    // still in it.
#pragma unroll
    for (int r = 0; r < MAX_LANES_PER_THREAD; ++r) {
      const int i = tid + r * nt;
      if (i < W && seg[r] > 0.f && doc_of<PACKED>(key, i, cbits) == bd)
        seg[r] = tr::kNegInf;
    }
  }
}

template <typename F>
cudaError_t allow_smem(F* fn, size_t bytes) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <bool PACKED, bool GATHER = false>
cudaError_t launch_rows(const int* doc, const float* con, int B, int W, int p,
                        int t, int cbits, int k, float* out_v, int* out_i,
                        cudaStream_t st, Csr csr = Csr{}) {
  int nt = W / MAX_LANES_PER_THREAD;
  nt = nt < 32 ? 32 : (nt > MAX_THREADS ? MAX_THREADS : nt);
  if ((W + nt - 1) / nt > MAX_LANES_PER_THREAD) return cudaErrorInvalidValue;
  const size_t smem = (size_t)W * (PACKED ? sizeof(int)
                                          : sizeof(int) + sizeof(float));
  cudaError_t err = allow_smem(merge_segsum_kernel<PACKED, GATHER>, smem);
  if (err != cudaSuccess) return err;
  merge_segsum_kernel<PACKED, GATHER><<<B, nt, smem, st>>>(
      doc, con, csr, W, p, t, cbits, k, out_v, out_i);
  return cudaGetLastError();
}

}  // namespace

extern "C" int tr_merge_segsum_topk(const int* doc, const float* con, int B,
                                    int W, int p, int t, int cbits, int k,
                                    float* out_v, int* out_i, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(cbits ? launch_rows<true>(doc, con, B, W, p, t, cbits, k,
                                          out_v, out_i, st)
                     : launch_rows<false>(doc, con, B, W, p, t, cbits, k,
                                           out_v, out_i, st));
}

// K2'. starts / lens (B, T) int32 and idf (B, T) float32 windows into the
// nnz postings post_doc int32 / post_impact float32; T and p powers of two
// with T * p <= TILE and p <= nnz.
extern "C" int tr_bm25_topk_fused(const int* starts, const int* lens,
                                  const float* idf, const int* post_doc,
                                  const float* post_impact, int nnz,
                                  int n_valid, int B, int T, int p, int cbits,
                                  int k, float* out_v, int* out_i,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int W = T * p;
  if (T < 1 || (T & (T - 1)) || p < 1 || (p & (p - 1)) || W > TILE ||
      p > nnz)
    return (int)cudaErrorInvalidValue;
  const Csr csr{starts, lens, idf, post_doc, post_impact, nnz, n_valid, T};
  return (int)(cbits ? launch_rows<true, true>(nullptr, nullptr, B, W, p, T,
                                                cbits, k, out_v, out_i, st,
                                                csr)
                     : launch_rows<false, true>(nullptr, nullptr, B, W, p, T,
                                                cbits, k, out_v, out_i, st,
                                                csr));
}
