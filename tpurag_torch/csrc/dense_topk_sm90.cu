// K1's Hopper body: fused dense cosine top-k for aligned bf16 corpora,
// with a TMA-fed wgmma mainloop (sm_90a, inline PTX, no library kernel).
//
// Replaces the Pallas kernel tpurag/kernels/dense.py:dense_topk_pallas
// (body _dense_topk_kernel) for bf16 corpora whose rows TMA can address
// (D % 8 == 0, 16-byte aligned pointers); fp32 and other bf16 corpora take
// K1's first body in dense_topk.cu. Same contract: (B, k) fp32 scores
// descending with int32 ids, ties to the smaller id, rows at or past
// n_valid never returned, empty slots (NEG_INF, -1), bf16 products summed
// in fp32.
//
// What bounds it on this card: at the main path's shapes (512 queries x
// 1M rows x 1024, 100k x 1024 at 1024 queries) the product is 0.2-1 TFLOP
// against 0.2-2 GB of corpus, so the tensor cores, which only wgmma drives
// at full rate. At 8 queries the corpus bytes bound it. What holds it
// under that bound (PERF.md): feeding 32 KB per 64-wide slice into each
// SM, and the fold, which runs on the same warps while the products wait.
//
// Design:
// - A block owns 128 queries (the wgmma N side) and walks the 128-row
//   corpus tiles of one split (the M side: two warpgroups of 64 rows).
//   Both operands are K-major, as emb (N, D) and q (B, D) lie in memory.
// - Thread 0 issues TMA copies of a 128 x 64 corpus box and a 128 x 64
//   query box (16 KB each, 128-byte swizzle) into a ring of 4 stages (5
//   do not fit beside the score tile). Each stage has a "full" mbarrier
//   (armed for the 32 KB) and an "empty" one (one arrival per warp once
//   the products reading the stage have retired); thread 0 refills a
//   stage when it empties. The ring runs on across tiles, so the next
//   tile's first slices load during the fold.
// - Each warpgroup issues four m64n128k16 wgmma (fp32 accumulators, 64
//   per thread) over the 64-wide slice, waits for them and frees the
//   stage at once: the ring, not the tensor cores, is what runs short, so
//   a stage is returned as early as possible rather than keeping a second
//   commit group in flight (measured faster on the card).
// - After a tile's last slice the accumulators go to a (128 queries x 132)
//   fp32 score tile in shared memory, and K1's fold (dense_topk.cuh) runs
//   on it unchanged: one warp per query row, running lists in shared
//   memory, or in the (B, S, k) scratch when they do not fit. K1's merge
//   kernel then takes each query's S*k candidates.
// - The grid is (query tile fastest, split), one block per SM: blocks of
//   one split read each corpus box from L2.
// - TMA zero-fills rows past N and B and columns past D; the fold masks
//   rows >= n_valid and skips queries >= B.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dense_topk.cuh"
#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int TQ = 128;       // queries per block: the wgmma N side
constexpr int TN = 128;       // corpus rows per tile: two warpgroups x 64
constexpr int TD = 64;        // D slice per stage: 128 bytes of bf16
constexpr int STAGES = 4;     // the TMA ring's depth
constexpr int THREADS = 256;  // two consumer warpgroups
constexpr int WARPS = THREADS / 32;
constexpr int LDS = TN + 4;   // score tile row stride (floats)
constexpr int BOX_BYTES = TN * TD * 2;  // one 128 x 64 bf16 box (TQ == TN)
constexpr int STAGE_BYTES = 2 * BOX_BYTES;
constexpr int SC_BYTES = TQ * LDS * 4;
constexpr int BAR_BYTES = 2 * STAGES * 8;  // the static mbarriers

// d (+)= A . B^T for this warpgroup: A 64 corpus rows x 16, B 128 queries
// x 16, both K-major bf16 in shared memory; scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// The ring's p-th load (slice p % ks_n of the split's tile p / ks_n) into
// stage p % STAGES, once the stage's previous contents were consumed.
// Thread 0 only.
__device__ __forceinline__ void produce(int p, int ks_n, int t_begin, int q0,
                                        unsigned char* ring, uint64_t* full,
                                        uint64_t* empty, uint64_t q_map,
                                        uint64_t e_map) {
  const int slot = p % STAGES;
  const int use = p / STAGES;
  if (use > 0) mbar_wait(&empty[slot], (use - 1) & 1);
  unsigned char* st = ring + slot * STAGE_BYTES;
  const int d0 = (p % ks_n) * TD;
  mbar_expect_tx(&full[slot], STAGE_BYTES);
  tma_load(st, e_map, &full[slot], d0, (t_begin + p / ks_n) * TN);
  tma_load(st + BOX_BYTES, q_map, &full[slot], d0, q0);
}

// grid (cdiv(B, TQ), S). Block (x, s) scans the corpus tiles of split s
// for queries [x*TQ, x*TQ + TQ) and leaves each query's top-k of that
// split in part[(query * S + s) * k : ... + k].
__global__ void __launch_bounds__(THREADS, 1)
    dense_scan_sm90_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap e_map, int B,
                           int D, int n_valid, int k, int S,
                           bool lists_in_smem, float* part_v, int* part_i) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES];
  __shared__ __align__(8) uint64_t empty[STAGES];
  unsigned char* ring =
      smem_raw + (ALIGN - smem_u32(smem_raw) % ALIGN) % ALIGN;
  float* sc = reinterpret_cast<float*>(ring + STAGES * STAGE_BYTES);
  float* slv = sc + TQ * LDS;
  int* sli = reinterpret_cast<int*>(slv + TQ * k);

  const int q0 = blockIdx.x * TQ;
  const int s = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_tiles = (n_valid + TN - 1) / TN;
  const int per_split = (n_tiles + S - 1) / S;
  const int t_begin = s * per_split;
  const int t_end = min(n_tiles, t_begin + per_split);
  const int ks_n = (D + TD - 1) / TD;
  const int total = max(t_end - t_begin, 0) * ks_n;  // the ring's loads
  const uint64_t qm = reinterpret_cast<uint64_t>(&q_map);
  const uint64_t em = reinterpret_cast<uint64_t>(&e_map);

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int p = 0; p < min(STAGES, total); ++p)
      produce(p, ks_n, t_begin, q0, ring, full, empty, qm, em);
  __syncwarp();

  auto list_v = [&](int r) -> float* {
    return lists_in_smem ? slv + r * k
                         : part_v + ((size_t)(q0 + r) * S + s) * k;
  };
  auto list_i = [&](int r) -> int* {
    return lists_in_smem ? sli + r * k
                         : part_i + ((size_t)(q0 + r) * S + s) * k;
  };
  for (int r = warp; r < TQ && q0 + r < B; r += WARPS)
    tr::warp_list_init(list_v(r), list_i(r), k, tr::kDenseBigId);

  const int g = warp >> 2;  // warpgroup: corpus rows 64g .. 64g + 63
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  int L = 0;  // the ring's next load to consume
  for (int t = t_begin; t < t_end; ++t) {
    for (int ks = 0; ks < ks_n; ++ks, ++L) {
      const int slot = L % STAGES;
      mbar_wait(&full[slot], (L / STAGES) & 1);
      const uint32_t a = smem_u32(ring + slot * STAGE_BYTES) + g * 64 * 128;
      const uint32_t b = smem_u32(ring + slot * STAGE_BYTES + BOX_BYTES);
      const uint64_t da = smem_desc(a);
      const uint64_t db = smem_desc(b);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TD / 16; ++kk)  // 32 bytes per k16 step
        wgmma_m64n128k16(acc, da + 2 * kk, db + 2 * kk, ks | kk);
      wgmma_commit();
      wgmma_wait_all();
      // This warp is done with the stage; thread 0 refills it with load
      // L + STAGES once every warp is.
      if (lane == 0) mbar_arrive(&empty[slot]);
      if (threadIdx.x == 0 && L + STAGES < total)
        produce(L + STAGES, ks_n, t_begin, q0, ring, full, empty, qm, em);
      __syncwarp();
    }
    fence_acc(acc);
    __syncthreads();  // every warp is done folding the previous tile

    // Accumulator r of lane l in warp w of warpgroup g holds corpus row
    // 64g + 16w + l/4 + 8((r%4)/2) and query 8(r/4) + 2(l%4) + r%2.
    const int row = 64 * g + 16 * (warp & 3) + (lane >> 2);
    const int col = 2 * (lane & 3);
#pragma unroll
    for (int r = 0; r < 64; ++r)
      sc[(8 * (r >> 2) + col + (r & 1)) * LDS + row + 8 * ((r >> 1) & 1)] =
          acc[r];
    __syncthreads();

    for (int r = warp; r < TQ && q0 + r < B; r += WARPS)
      tr::warp_fold_row<TN>(sc + r * LDS, t * TN, n_valid, k, list_v(r),
                            list_i(r));
  }

  if (lists_in_smem) {
    __syncwarp();
    for (int r = warp; r < TQ && q0 + r < B; r += WARPS) {
      const size_t out = ((size_t)(q0 + r) * S + s) * k;
      for (int j = lane; j < k; j += 32) {
        part_v[out + j] = slv[r * k + j];
        part_i[out + j] = sli[r * k + j];
      }
    }
  }
}

}  // namespace

// K1 on bf16 q (B, D) and emb (N, D), D % 8 == 0, 16-byte aligned; S
// corpus splits; part_v / part_i (B, S, k) scratch; out (B, k).
extern "C" int tr_dense_topk_sm90(const void* q, const void* emb, int B,
                                  int N, int D, int n_valid, int k, int S,
                                  float* part_v, int* part_i, float* out_v,
                                  int* out_i, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || D < 8 || D % 8 != 0 || reinterpret_cast<uintptr_t>(q) % 16 ||
      reinterpret_cast<uintptr_t>(emb) % 16)
    return (int)cudaErrorInvalidValue;
  // 128 x 64 bf16 boxes of both operands. No rows, no tiles: the kernel
  // issues no copy through e_map.
  CUtensorMap q_map, e_map{};
  cudaError_t err = encode_boxes(&q_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                                 q, B, D, TQ);
  if (err == cudaSuccess && n_valid > 0)
    err = encode_boxes(&e_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, emb, N,
                       D, TN);
  if (err != cudaSuccess) return (int)err;
  // The running lists stay in shared memory where they fit beside the
  // ring and the score tile (k <= 31), else in the (B, S, k) scratch.
  const size_t lists = (size_t)TQ * k * (sizeof(float) + sizeof(int));
  const size_t base = ALIGN + (size_t)STAGES * STAGE_BYTES + SC_BYTES;
  const bool lists_in_smem = base + lists + BAR_BYTES <= (size_t)MAX_SMEM;
  const size_t smem = base + (lists_in_smem ? lists : 0);
  err = cudaFuncSetAttribute(
      dense_scan_sm90_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dense_scan_sm90_kernel<<<dim3((B + TQ - 1) / TQ, S), THREADS, smem, st>>>(
      q_map, e_map, B, D, n_valid, k, S, lists_in_smem, part_v, part_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)tr::dense_merge(part_v, part_i, B, S, k, out_v, out_i, st);
}
