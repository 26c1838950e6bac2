// K5's Hopper body: int8 dense top-k for corpora whose rows TMA can
// address (D % 16 == 0, 16-byte aligned pointers), with a TMA-fed int8
// wgmma mainloop (sm_90a, inline PTX, no library kernel). Other int8
// corpora take K5's first body, the int8 form of dense_topk.cu.
//
// Replaces the Pallas kernel tpurag/kernels/quant.py:dense_topk_pallas_q8
// (quant.py:80). Same contract: exact int32 dots of the int8 codes, one
// fp32 multiply by the corpus row's scale, (B, k) values descending with
// int32 ids, ties to the smaller id, rows at or past n_valid never
// returned, empty slots (NEG_INF, -1); the caller applies the query scale.
// The dot is exact and the scale one rounding, so the body equals its
// plain version bit for bit.
//
// What bounds it on this card: at 32 queries x 1M rows x 1024 (a hybrid
// request on a quant KB) the 1.03 GB of corpus codes, read once (0.31 ms
// at 3.35 TB/s); at 512 queries the int8 operations (1.07 POP, 0.53 ms).
//
// Design (K1's TMA ring, dense_topk_sm90.cu, at the same byte geometry:
// one 128-byte swizzled box row holds 128 codes, one k32 step reads 32
// bytes, so K1's descriptor and accumulator layout carry over):
// - Two tiles, picked by the caller (kernels/quant.q8_sm90_tile). TQ = 32
//   (B <= 32, D <= 4096): the block loads its 32 query rows once,
//   ceil(D / 128) boxes of 32 x 128 B, and keeps them; the ring carries
//   only 128-row x 128-code corpus boxes (16 KB), so the kernel is a
//   stream of the corpus. TQ = 128: a stage carries a corpus box and a
//   128-query box, as in K1.
// - Thread 0 issues the TMA copies; each stage has a "full" mbarrier
//   (armed for the stage's bytes) and an "empty" one (one arrival per
//   warp once the products reading it have retired). The ring runs on
//   across tiles, so the next tile's first slices load during the fold.
// - Each warpgroup issues four wgmma m64nTQk32 .s32.s8.s8 per 128-code
//   slice (int32 accumulators: TQ / 2 per thread), waits for them and
//   frees the stage at once.
// - Epilogue: each thread converts its accumulators with __int2float_rn
//   and multiplies by e_scale of its two corpus rows (read when the tile
//   starts, 0 past n_valid) on the way into the fp32 score tile; K1's fold
//   (dense_topk.cuh) then folds it into the running lists (shared memory
//   where they fit, else the (B, S, k) scratch) and K1's merge kernel
//   takes the S splits.
// - The grid is (query tile, split), one block per SM in one wave
//   (kernels/dense.sm90_splits).

#include <cuda_runtime.h>
#include <stdint.h>

#include "dense_topk.cuh"
#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int TN = 128;       // corpus rows per tile: two warpgroups x 64
constexpr int TK = 128;       // codes per box row: 128 bytes
constexpr int THREADS = 256;  // two consumer warpgroups
constexpr int WARPS = THREADS / 32;
constexpr int LDS = TN + 4;   // score tile row stride (floats)
constexpr int BOX_BYTES = TN * TK;  // one 128 x 128 int8 box
// The TMA ring's depth. At 32 queries the card streamed the corpus at one
// rate with 4, 6, 8 or 10 stages (tools/k5_anatomy.py), so both tiles keep
// K1's 4, and the 32-query tile's spare shared memory holds its queries up
// to D = 4096.
constexpr int STAGES = 4;

// The 32-query tile loads its queries once and keeps them, so its stages
// hold corpus boxes only; a 128-query stage holds a query box beside.
template <int TQ>
struct Tile {
  static constexpr bool RESIDENT = TQ == 32;
  static constexpr int STAGE_BYTES = BOX_BYTES + (RESIDENT ? 0 : TQ * TK);
};

// Shared memory of a block without its running lists: the alignment slack,
// the ring, the resident query boxes (TQ = 32) and the score tile.
template <int TQ>
size_t base_bytes(int ks_n) {
  return ALIGN + (size_t)STAGES * Tile<TQ>::STAGE_BYTES +
         (Tile<TQ>::RESIDENT ? (size_t)ks_n * TQ * TK : 0) +
         (size_t)TQ * LDS * sizeof(float);
}

// d (+)= A . B^T for this warpgroup: A 64 corpus rows x 32 codes, B 32
// queries x 32 codes, both K-major int8 in shared memory, exact int32
// sums; scale_d 0 overwrites d. (The integer form has no scale-a/b or
// transpose operands.)
__device__ __forceinline__ void wgmma_s8(int (&d)[16], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15}, %16, %17, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// The same with B 128 queries x 32 codes.
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, %64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// The ring's p-th load (slice p % ks_n of the split's tile p / ks_n) into
// stage p % STAGES, once the stage's previous contents were consumed: the
// corpus box, and for TQ = 128 the query box beside it. Thread 0 only.
template <int TQ>
__device__ __forceinline__ void produce(int p, int ks_n, int t_begin, int q0,
                                        unsigned char* ring, uint64_t* full,
                                        uint64_t* empty, uint64_t q_map,
                                        uint64_t e_map) {
  const int slot = p % STAGES;
  const int use = p / STAGES;
  if (use > 0) mbar_wait(&empty[slot], (use - 1) & 1);
  unsigned char* st = ring + slot * Tile<TQ>::STAGE_BYTES;
  const int d0 = (p % ks_n) * TK;
  mbar_expect_tx(&full[slot], Tile<TQ>::STAGE_BYTES);
  tma_load(st, e_map, &full[slot], d0, (t_begin + p / ks_n) * TN);
  if (!Tile<TQ>::RESIDENT)
    tma_load(st + BOX_BYTES, q_map, &full[slot], d0, q0);
}

// grid (cdiv(B, TQ), S). Block (x, s) scans the corpus tiles of split s
// for queries [x*TQ, x*TQ + TQ) and leaves each query's top-k of that
// split in part[(query * S + s) * k : ... + k].
template <int TQ>
__global__ void __launch_bounds__(THREADS, 1)
    dense_scan_q8_sm90_kernel(const __grid_constant__ CUtensorMap q_map,
                              const __grid_constant__ CUtensorMap e_map,
                              const float* __restrict__ e_scale, int B,
                              int D, int n_valid, int k, int S,
                              bool lists_in_smem, float* part_v,
                              int* part_i) {
  constexpr bool RESIDENT = Tile<TQ>::RESIDENT;
  constexpr int QBOX = TQ * TK;  // one resident query box
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES];
  __shared__ __align__(8) uint64_t empty[STAGES];
  __shared__ __align__(8) uint64_t q_full;  // the resident queries
  const int ks_n = (D + TK - 1) / TK;
  unsigned char* ring =
      smem_raw + (ALIGN - smem_u32(smem_raw) % ALIGN) % ALIGN;
  unsigned char* qres = ring + STAGES * Tile<TQ>::STAGE_BYTES;
  float* sc = reinterpret_cast<float*>(qres + (RESIDENT ? ks_n * QBOX : 0));
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
  const int total = max(t_end - t_begin, 0) * ks_n;  // the ring's loads
  const uint64_t qm = reinterpret_cast<uint64_t>(&q_map);
  const uint64_t em = reinterpret_cast<uint64_t>(&e_map);

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], WARPS);
    }
    mbar_init(&q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0 && total > 0) {
    if (RESIDENT) {
      mbar_expect_tx(&q_full, ks_n * QBOX);
      for (int ks = 0; ks < ks_n; ++ks)
        tma_load(qres + ks * QBOX, qm, &q_full, ks * TK, q0);
    }
    for (int p = 0; p < min(STAGES, total); ++p)
      produce<TQ>(p, ks_n, t_begin, q0, ring, full, empty, qm, em);
  }
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
  if (RESIDENT && total > 0) mbar_wait(&q_full, 0);

  const int g = warp >> 2;  // warpgroup: corpus rows 64g .. 64g + 63
  // Accumulator r of lane l in warp w of warpgroup g holds corpus row
  // 64g + 16w + l/4 + 8((r%4)/2) and query 8(r/4) + 2(l%4) + r%2.
  const int row = 64 * g + 16 * (warp & 3) + (lane >> 2);
  const int col = 2 * (lane & 3);
  int acc[TQ / 2];
#pragma unroll
  for (int i = 0; i < TQ / 2; ++i) acc[i] = 0;
  int L = 0;  // the ring's next load to consume
  for (int t = t_begin; t < t_end; ++t) {
    // The scales of this thread's two corpus rows, read while the products
    // run (TMA zero-fills codes past N, but the scales are plain loads).
    const int n0 = t * TN;
    const float s_lo = n0 + row < n_valid ? e_scale[n0 + row] : 0.f;
    const float s_hi = n0 + row + 8 < n_valid ? e_scale[n0 + row + 8] : 0.f;
    for (int ks = 0; ks < ks_n; ++ks, ++L) {
      const int slot = L % STAGES;
      mbar_wait(&full[slot], (L / STAGES) & 1);
      unsigned char* st = ring + slot * Tile<TQ>::STAGE_BYTES;
      const uint64_t da = smem_desc(smem_u32(st) + g * 64 * TK);
      const uint64_t db =
          smem_desc(smem_u32(RESIDENT ? qres + ks * QBOX : st + BOX_BYTES));
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TK / 32; ++kk)  // 32 bytes per k32 step
        wgmma_s8(acc, da + 2 * kk, db + 2 * kk, ks | kk);
      wgmma_commit();
      wgmma_wait_all();
      // This warp is done with the stage; thread 0 refills it with load
      // L + STAGES once every warp is.
      if (lane == 0) mbar_arrive(&empty[slot]);
      if (threadIdx.x == 0 && L + STAGES < total)
        produce<TQ>(L + STAGES, ks_n, t_begin, q0, ring, full, empty, qm, em);
      __syncwarp();
    }
    fence_acc(acc);
    __syncthreads();  // every warp is done folding the previous tile

#pragma unroll
    for (int r = 0; r < TQ / 2; ++r)
      sc[(8 * (r >> 2) + col + (r & 1)) * LDS + row + 8 * ((r >> 1) & 1)] =
          __int2float_rn(acc[r]) * ((r & 2) ? s_hi : s_lo);
    __syncthreads();

    for (int r = warp; r < TQ && q0 + r < B; r += WARPS)
      tr::warp_fold_row<TN>(sc + r * LDS, n0, n_valid, k, list_v(r),
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

template <int TQ>
cudaError_t launch(const void* q, const void* emb, const float* e_scale,
                   int B, int N, int D, int n_valid, int k, int S,
                   float* part_v, int* part_i, cudaStream_t st) {
  // 128-code boxes: TQ query rows, 128 corpus rows. No rows, no tiles: the
  // kernel issues no copy through either map.
  CUtensorMap q_map{}, e_map{};
  cudaError_t err = cudaSuccess;
  if (n_valid > 0) {
    err = encode_boxes(&q_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, q, B, D, TQ);
    if (err == cudaSuccess)
      err = encode_boxes(&e_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, emb, N, D,
                         TN);
    if (err != cudaSuccess) return err;
  }
  // The running lists stay in shared memory where they fit, else in the
  // (B, S, k) scratch; the static mbarriers count too.
  const size_t bars = (2 * STAGES + 1) * sizeof(uint64_t);
  const size_t base = base_bytes<TQ>((D + TK - 1) / TK);
  const size_t lists = (size_t)TQ * k * (sizeof(float) + sizeof(int));
  if (base + bars > (size_t)MAX_SMEM) return cudaErrorInvalidValue;
  const bool lists_in_smem = base + lists + bars <= (size_t)MAX_SMEM;
  const size_t smem = base + (lists_in_smem ? lists : 0);
  err = cudaFuncSetAttribute(dense_scan_q8_sm90_kernel<TQ>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  dense_scan_q8_sm90_kernel<TQ>
      <<<dim3((B + TQ - 1) / TQ, S), THREADS, smem, st>>>(
          q_map, e_map, e_scale, B, D, n_valid, k, S, lists_in_smem, part_v,
          part_i);
  return cudaGetLastError();
}

}  // namespace

// K5 on int8 codes q (B, D) and emb (N, D), fp32 row scales e_scale (N,),
// D % 16 == 0, 16-byte aligned; tq the query tile (32: queries resident,
// B <= 32; or 128); S corpus splits; part_v / part_i (B, S, k) scratch;
// out (B, k). The query scales are applied by the caller.
extern "C" int tr_dense_topk_q8_sm90(const void* q, const void* emb,
                                     const float* e_scale, int B, int N,
                                     int D, int n_valid, int k, int tq, int S,
                                     float* part_v, int* part_i, float* out_v,
                                     int* out_i, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || D < 16 || D % 16 != 0 || (tq == 32 && B > 32) ||
      reinterpret_cast<uintptr_t>(q) % 16 ||
      reinterpret_cast<uintptr_t>(emb) % 16)
    return (int)cudaErrorInvalidValue;
  cudaError_t err =
      tq == 32    ? launch<32>(q, emb, e_scale, B, N, D, n_valid, k, S, part_v,
                               part_i, st)
      : tq == 128 ? launch<128>(q, emb, e_scale, B, N, D, n_valid, k, S,
                                part_v, part_i, st)
                  : cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  return (int)tr::dense_merge(part_v, part_i, B, S, k, out_v, out_i, st);
}
