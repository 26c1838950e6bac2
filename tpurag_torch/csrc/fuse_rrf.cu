// The hybrid search's fusion for Hopper (sm_90a): the score floor, the
// keyword gate, reciprocal-rank fusion, the dedup and the exact-order top-k
// of each query row in one launch (fuse_rrf_kernel).
//
// Replaces no Pallas kernel: in the JAX package this step is XLA glue
// (tpurag/engine/hybrid.py, tpurag/kernels/fusion.py:rrf_fuse), and in
// this port its plain version is ~110 small PyTorch launches a call
// (kernels/fusion.py: fuse_legs_ref), each costing its host dispatch and
// launch and nearly no device time.
//
// What bounds it: neither bytes nor operations. A row reads k_v + k_k
// (score, id) pairs and a mass (~130 bytes at 8 + 8) and writes final_k
// triples; its compares are (k_v + k_k)^2, a few hundred. So the time is
// the one launch, and the host's enqueue of it.
//
// Design: one thread a candidate lane. Rows of at most 32 lanes take a
// warp each, several rows a block; longer rows a block each, whose threads
// stride over ceil(kt / blockDim) lanes apiece, so any width runs whose
// row fits the block's shared memory (16 bytes a lane, up to the device's
// opt-in limit: ~14k lanes on an H100; past it the entry point returns
// TOO_WIDE). A lane applies the floor (vector lanes: score >= floor) or
// the gate (keyword lanes: the row's max keyword score, empties included,
// >= cov * mass), finds its id among the other live lanes, forms its fused
// score and source bits, and drops itself if an earlier lane holds its id.
// Its output slot is the count of kept lanes that sort before it (a
// greater score, or an equal score and a smaller id: select_topk's order,
// csrc/topk.cuh's lex_gt), so there is no sort; slots from the kept count
// up to final_k are empties (NEG_INF, -1, 0), final_k > k_v + k_k
// included, and a row with no lanes is all empties.
//
// The arithmetic is the plain version's, in its order and at its
// precision, so the triples are bit-identical: each reciprocal rank is
// fp32(w) * (1 / ((r + rrf_k) + 1)) (torch's `w / t` is a reciprocal then
// a multiply), a source's ranks are summed in lane order from 0, the
// fused score is (vector sum + keyword sum) + the bonus where both legs
// hit. Every step is an explicitly rounded intrinsic, so nvcc contracts
// nothing into an FMA. Within one leg an id is expected once (both legs'
// kernels keep each id once); a repeat sums in lane order.

#include <cuda_runtime.h>
#include <stdint.h>

#include "topk.cuh"

namespace {

constexpr int ROW_THREADS = 256;  // threads a block, and a wide row's
constexpr int TOO_WIDE = -1;      // a row's lanes exceed shared memory

__device__ __forceinline__ float reciprocal_rank(float w, int r, float rrf_k) {
  const float t = __fadd_rn(__fadd_rn(static_cast<float>(r), rrf_k), 1.0f);
  return __fmul_rn(__fdiv_rn(1.0f, t), w);
}

// `rows` rows a block of `lanes` threads each (a warp, or the whole
// block); thread t of a row handles its lanes t, t + lanes, ... Shared
// memory: four arrays of kt a row, each holding the rows' arrays one
// after another: the live ids, the scores (keyword scores for the gate,
// then the fused scores), the kept ids and the source bits.
__global__ void fuse_rrf_kernel(
    const float* __restrict__ v_s, const int* __restrict__ v_i, int kv,
    const float* __restrict__ k_s, const int* __restrict__ k_i, int kk,
    const float* __restrict__ mass, float floor_score, float cov, float wv,
    float wk, float rrf_k, float bonus, int B, int final_k, int lanes,
    float* __restrict__ out_s, int* __restrict__ out_i,
    int* __restrict__ out_b) {
  extern __shared__ int smem[];
  const int kt = kv + kk;
  const int rows = blockDim.x / lanes;
  const int r = threadIdx.x / lanes;
  const int t = threadIdx.x % lanes;
  const int row = blockIdx.x * rows + r;
  const int span = rows * kt;
  int* sid = smem + r * kt;
  float* sf = reinterpret_cast<float*>(smem + span) + r * kt;
  int* skeep = smem + 2 * span + r * kt;
  int* sbits = smem + 3 * span + r * kt;
  const bool live_row = row < B;

  // The floor on vector lanes; keyword lanes stage their scores for the
  // gate's row max.
  if (live_row) {
    for (int l = t; l < kt; l += lanes) {
      if (l < kv) {
        const int64_t at = static_cast<int64_t>(row) * kv + l;
        const int x = v_i[at];
        sid[l] = (x >= 0 && v_s[at] >= floor_score) ? x : -1;
      } else {
        const int64_t at = static_cast<int64_t>(row) * kk + (l - kv);
        sid[l] = max(k_i[at], -1);
        sf[l] = k_s[at];
      }
    }
  }
  __syncthreads();
  if (live_row && mass != nullptr && kk > 0) {
    // amax over every keyword lane, NaN propagating as torch's does.
    float best = sf[kv];
    for (int j = kv + 1; j < kt; ++j) {
      const float x = sf[j];
      best = (x > best || x != x) ? x : best;
    }
    if (!(best >= __fmul_rn(cov, mass[row])))
      for (int l = kv + t; l < kt; l += lanes) sid[l] = -1;
  }
  __syncthreads();

  // Fused score, source bits, and whether an earlier lane holds the id.
  if (live_row) {
    for (int l = t; l < kt; l += lanes) {
      const int id = sid[l];
      float f = 0.0f;
      int bits = 0;
      bool keep = false;
      if (id >= 0) {
        float sv = 0.0f, sk = 0.0f;
        bool earlier = false;
        for (int j = 0; j < kv; ++j) {
          if (sid[j] == id) {
            sv = __fadd_rn(sv, reciprocal_rank(wv, j, rrf_k));
            bits |= 1;
            earlier |= j < l;
          }
        }
        for (int j = kv; j < kt; ++j) {
          if (sid[j] == id) {
            sk = __fadd_rn(sk, reciprocal_rank(wk, j - kv, rrf_k));
            bits |= 2;
            earlier |= j < l;
          }
        }
        f = __fadd_rn(sv, sk);
        if (bits == 3) f = __fadd_rn(f, bonus);
        // A score at or below NEG_INF / 2 is an empty slot in the plain
        // version.
        keep = !earlier && f > tr::kNegInf * 0.5f;
      }
      skeep[l] = keep ? id : -1;
      sf[l] = f;
      sbits[l] = bits;
    }
  }
  __syncthreads();

  // Slot = kept lanes before this one; the rest of the row is empties.
  if (!live_row) return;
  int n = 0;
  for (int j = 0; j < kt; ++j) n += skeep[j] >= 0;
  const int64_t base = static_cast<int64_t>(row) * final_k;
  for (int l = t; l < kt; l += lanes) {
    const int id = skeep[l];
    if (id < 0) continue;
    const float f = sf[l];
    int slot = 0;
    for (int j = 0; j < kt; ++j) {
      const int y = skeep[j];
      slot += y >= 0 && tr::lex_gt(sf[j], y, f, id);
    }
    if (slot < final_k) {
      out_s[base + slot] = f;
      out_i[base + slot] = id;
      out_b[base + slot] = sbits[l];
    }
  }
  for (int s = n + t; s < final_k; s += lanes) {
    out_s[base + s] = tr::kNegInf;
    out_i[base + s] = -1;
    out_b[base + s] = 0;
  }
}

}  // namespace

// v_s, v_i: (B, kv) fp32 / int32; k_s, k_i: (B, kk), or null with kk = 0
// (no keyword leg); mass: (B,) fp32, or null (gate off). Writes (B,
// final_k) fp32 / int32 / int32 on `stream`; returns the launch's
// cudaError_t, or TOO_WIDE (-1) when a row of kv + kk lanes does not fit
// one block's shared memory.
extern "C" int tr_fuse_rrf(const float* v_s, const int* v_i, int kv,
                           const float* k_s, const int* k_i, int kk,
                           const float* mass, float floor_score, float cov,
                           float wv, float wk, float rrf_k, float bonus,
                           int B, int final_k, float* out_s, int* out_i,
                           int* out_b, void* stream) {
  if (B < 1 || final_k < 1 || kv < 0 || kk < 0 ||
      (kk > 0 && (k_s == nullptr || k_i == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int kt = kv + kk;
  const int lanes = kt <= 32 ? 32 : ROW_THREADS;
  int rows = ROW_THREADS / lanes;
  rows = rows < B ? rows : B;
  const int blocks = (B + rows - 1) / rows;
  const size_t smem = static_cast<size_t>(rows) * kt * 4 * sizeof(int);
  if (smem > 48 * 1024) {
    int dev = 0, optin = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;
    if (smem > static_cast<size_t>(optin)) return TOO_WIDE;
    err = cudaFuncSetAttribute(fuse_rrf_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return (int)err;
  }
  fuse_rrf_kernel<<<blocks, rows * lanes, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      v_s, v_i, kv, k_s, k_i, kk, mass, floor_score, cov, wv, wk, rrf_k,
      bonus, B, final_k, lanes, out_s, out_i, out_b);
  return (int)cudaGetLastError();
}
