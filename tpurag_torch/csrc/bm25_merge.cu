// K2: fused BM25 bitonic merge + segment sum + top-k for Hopper (sm_90a).
//
// Replaces the Pallas kernel tpurag/kernels/bm25_pallas.py:merge_segsum_topk
// (body _merge_segsum_kernel with out_full=False). Same contract, both
// layouts: per candidate row, a bitonic merge of T doc-sorted P-blocks
// (odd blocks arrive flipped, so the network starts at 2P), a T-window
// shift-add segment sum (a doc appears at most once per term), then a
// k-pass top-k; scores <= 0 come out as (NEG_INF, -1). cbits > 0 packs
// doc << cbits | quantized contribution into one int32 key per lane.
//
// What bounds it on this card: the network is ~40 compare-exchange stages
// over a row of up to 16384 lanes, each stage a pass over the whole row,
// so the row has to stay on chip: 128 KB unpacked (doc + contribution),
// 64 KB packed, inside one block's 227 KB of shared memory. Device memory
// sees one read of the row and a (k,) write.
//
// Design: one block per row, up to 1024 threads, the row in dynamic shared
// memory (cudaFuncSetAttribute past 48 KB). Packing happens in the kernel
// (a block max, then the key per lane), so the row is read once. Each
// stage is one pass of compare-exchanges over W/2 lane pairs followed by
// __syncthreads; the exchange rule is the Pallas kernel's, so equal keys
// never move and the sums below add in the same order (results are
// bit-identical to the plain version). Each thread keeps the segment sums
// of its <= 16 lanes in registers, and the top-k is k block-wide argmax
// passes over them that stop at the first score <= 0.

#include <cuda_runtime.h>

#include "topk.cuh"

namespace {

constexpr int BIG = 1 << 30;           // unpacked pad doc
constexpr int PAD_KEY = 0x7fffffff;    // packed pad key
constexpr int MAX_LANES_PER_THREAD = 16;
constexpr int MAX_THREADS = 1024;

template <bool PACKED>
__global__ void __launch_bounds__(MAX_THREADS)
    merge_segsum_kernel(const int* __restrict__ doc,
                        const float* __restrict__ con, int W, int p, int t,
                        int cbits, int k, float* out_v, int* out_i) {
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
  const int mask = (1 << cbits) - 1;

  float scale = 0.f;
  int big = BIG;
  if (PACKED) {
    float m = -INFINITY;
    for (int i = tid; i < W; i += nt) m = fmaxf(m, crow[i]);
    int unused_i = 0, unused_p = 0;
    tr::block_lex_max3(m, unused_i, unused_p, red_v, red_i, red_p);
    const float safe = fmaxf(m, 1e-30f);
    const float qmax = (float)mask;
    const int pad_doc = PAD_KEY >> cbits;
    for (int i = tid; i < W; i += nt) {
      const int d = drow[i];
      // round(con / safe * qmax), half to even, clamped as an integer
      long long q = llrintf(__fmul_rn(__fdiv_rn(crow[i], safe), qmax));
      q = q < 0 ? 0 : (q > mask ? mask : q);
      key[i] = d < pad_doc ? ((d << cbits) | (int)q) : PAD_KEY;
    }
    scale = __fdiv_rn(safe, qmax);
    big = pad_doc;
  } else {
    for (int i = tid; i < W; i += nt) {
      key[i] = drow[i];
      cs[i] = crow[i];
    }
  }
  __syncthreads();

  // Bitonic merge from block size 2p up to W. Pair (lo, lo + s) sorts
  // ascending when (lo & kk) == 0; equal keys never swap.
  for (int kk = 2 * p; kk <= W; kk <<= 1) {
    for (int s = kk >> 1; s >= 1; s >>= 1) {
      for (int pi = tid; pi < (W >> 1); pi += nt) {
        const int lo = ((pi & ~(s - 1)) << 1) | (pi & (s - 1));
        const int hi = lo + s;
        const int a = key[lo];
        const int b = key[hi];
        const bool swap = (lo & kk) == 0 ? a > b : a < b;
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
      __syncthreads();
    }
  }

  auto doc_at = [&](int i) -> int {
    return PACKED ? (int)((unsigned)key[i] >> cbits) : key[i];
  };
  auto con_at = [&](int i) -> float {
    return PACKED ? __fmul_rn((float)(key[i] & mask), scale) : cs[i];
  };

  // Segment sums at segment-end lanes; duplicates of a doc sit within a
  // window of t lanes. Lane i = tid + r * nt lives in seg[r].
  float seg[MAX_LANES_PER_THREAD];
#pragma unroll
  for (int r = 0; r < MAX_LANES_PER_THREAD; ++r) {
    seg[r] = tr::kNegInf;
    const int i = tid + r * nt;
    if (i < W) {
      const int d = doc_at(i);
      const bool is_end = i == W - 1 || d != doc_at(i + 1);
      if (is_end && d < big) {
        float total = con_at(i);
        for (int j = 1; j < t; ++j) {
          const float add = (i >= j && doc_at(i - j) == d) ? con_at(i - j)
                                                           : 0.f;
          total = __fadd_rn(total, add);
        }
        seg[r] = total;
      }
    }
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
        const int d = doc_at(i);
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
#pragma unroll
    for (int r = 0; r < MAX_LANES_PER_THREAD; ++r)
      if (tid + r * nt == bl) seg[r] = tr::kNegInf;
  }
}

}  // namespace

extern "C" int tr_merge_segsum_topk(const int* doc, const float* con, int B,
                                    int W, int p, int t, int cbits, int k,
                                    float* out_v, int* out_i, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int nt = W / MAX_LANES_PER_THREAD;
  nt = nt < 32 ? 32 : (nt > MAX_THREADS ? MAX_THREADS : nt);
  if ((W + nt - 1) / nt > MAX_LANES_PER_THREAD)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)W * (cbits ? sizeof(int)
                                         : sizeof(int) + sizeof(float));
  cudaError_t err;
  if (cbits) {
    err = cudaFuncSetAttribute(merge_segsum_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    merge_segsum_kernel<true><<<B, nt, smem, st>>>(doc, con, W, p, t, cbits,
                                                   k, out_v, out_i);
  } else {
    err = cudaFuncSetAttribute(merge_segsum_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    merge_segsum_kernel<false><<<B, nt, smem, st>>>(doc, con, W, p, t, cbits,
                                                    k, out_v, out_i);
  }
  return (int)cudaGetLastError();
}
