// K7's Hopper body: K1's function (fused dense cosine top-k) in
// corpus-outer order for aligned bf16 corpora, with TMA-fed wgmma products
// (sm_90a, inline PTX, no library kernel).
//
// Replaces the Pallas kernel tpurag/kernels/dense.py:dense_topk_pallas_co
// (body _dense_topk_kernel_co) for bf16 corpora whose rows TMA can address
// (D % 8 == 0, 16-byte aligned pointers) and whose tiles fit one block's
// shared memory (kernels/dense.co_sm90_form); fp32, unaligned and wider
// corpora take K7's first body, dense_co_scan_kernel in dense_topk.cu.
// Same contract as K1: (B, k) fp32 scores descending with int32 ids, ties
// to the smaller id, rows at or past n_valid never returned, empty slots
// (NEG_INF, -1), bf16 products summed in fp32.
//
// What bounds it on this card: at 512 queries x 1M rows x 1024 the bf16
// operations (1.07 TFLOP, 1.06 ms at the peak); at 8 queries x 2.1M rows
// the 4.3 GB of corpus, read once. What holds form (ii) above that bound
// (tools/k7_anatomy.py, PERF.md): a 64-row corpus tile is all one block's
// shared memory holds at D = 1024, so every query byte streamed from L2
// feeds 64 flops, as in K1; and the fold.
//
// Two forms, chosen by the caller by batch (kernels/dense.co_sm90_form):
//
// (i) Resident queries, B <= 32 (dense_co_resident_q_kernel). JAX's own
//   layout, the query block pinned: the block loads its <= 32 query rows
//   once, as ceil(D / 64) swizzled 32 x 64 boxes, and keeps them; the
//   corpus streams through a 4-stage TMA ring of 128 x 64 boxes (16 KB).
//   Each warpgroup issues m64n32k16 over its 64 rows of the box; a
//   tile's (32 queries x 132) fp32 score tile is folded by K1's
//   warp_fold_row<128> into running lists in shared memory (the (B, S, k)
//   scratch where they do not fit). Each corpus byte is read once.
//
// (ii) Resident corpus tile, B > 32 (dense_co_resident_c_kernel).
//   - A block owns consecutive 64-row corpus tiles of its split. A tile is
//     loaded once by TMA as ceil(D / 64) swizzled 64 x 64 boxes (8 KB
//     each; 128 KB at D = 1024) and stays while the block's query tiles
//     pass. The 128-query tiles are dealt to `groups` blocks per split
//     (block (s, g) takes tiles g, g + groups, ...): each query then has
//     S = (blocks / groups) splits, so its running lists take fewer
//     insertions in all, and each corpus tile is read by `groups` blocks
//     (from L2 after the first).
//   - Query boxes of 128 x 64 (16 KB) stream through a TMA ring of 3 to 6
//     stages (as many as shared memory holds: 5 at D = 1024, k = 8),
//     filled by a ninth warp of its own: for each corpus tile, each of the
//     block's query tiles, each slice. The next tile's corpus box j is
//     loaded by the same warp, on a barrier of its own, as soon as every
//     consumer warp has read the last query tile's slice j: each box has
//     arrived by the time the next tile's first query tile needs it.
//   - The queries are the wgmma M side: each warpgroup issues m64n64k16
//     over its 64 queries of the box (A) and the corpus tile's slice (B),
//     and keeps one slice's products in flight while it waits for the
//     next. Each warp then holds 16 whole query rows of the (128 x 64)
//     score tile in its accumulators: it checks each row against its
//     list's k-th entry there, and stages only the rows that pass, one at
//     a time, in 256 bytes of its own, for K1's warp_fold_row<64>. No
//     warp waits for another outside the products and the ring. The
//     running lists stay in shared memory where they fit (the block's
//     queries x k), else in the (B, S, k) scratch.
//   - Shared memory at D = 1024, k = 8: 1 KB of realignment room + 80 KB
//     ring + 128 KB tile + 2 KB of staged rows + barriers + 8 KB of lists;
//     D up to 1344 (21 corpus boxes) with the ring at its least depth.
//
// Both forms: one block per SM (kernels/dense.co_sm90_splits: S =
// min(resident blocks / groups, corpus tiles, MAX_MERGE_CANDIDATES / k);
// each split a contiguous run of floor or ceil(tiles / S) tiles), then
// K1's merge kernel takes each query's S*k candidates. TMA zero-fills rows
// past N and B and columns past D; the fold masks rows >= n_valid and
// skips queries >= B. Both operands K-major as they lie in memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dense_topk.cuh"
#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int TD = 64;        // D slice per box: 128 bytes of bf16
constexpr int THREADS = 256;  // two consumer warpgroups
constexpr int WARPS = THREADS / 32;

// Form (i): resident queries.
struct ResQ {
  static constexpr int TQ = 32;   // queries: the wgmma N side
  static constexpr int TN = 128;  // corpus rows per tile: two warpgroups
  static constexpr int STAGES = 4;
  static constexpr int LDS = TN + 4;  // score tile row stride (floats)
  static constexpr int BOX = TN * TD * 2;   // one 128 x 64 corpus box
  static constexpr int QBOX = TQ * TD * 2;  // one 32 x 64 query box
  static constexpr int SCORE = TQ * LDS * 4;  // the fp32 score tile
  static constexpr int NBARS = 2 * STAGES + 1;
  // Without the running lists: the realignment room, the ring, the
  // resident query boxes, the score tile and the barriers.
  static size_t bytes(int ks_n) {
    return ALIGN + (size_t)STAGES * BOX + (size_t)ks_n * QBOX + SCORE +
           NBARS * sizeof(uint64_t);
  }
};

// Form (ii): resident corpus tile.
struct ResC {
  static constexpr int TN = 64;   // corpus rows per tile: the wgmma N side
  static constexpr int TQ = 128;  // queries per ring box: two warpgroups
  static constexpr int STAGES = 3;      // the ring's least depth
  static constexpr int MAX_STAGES = 6;  // and its most
  static constexpr int CBOX = TN * TD * 2;  // one 64 x 64 corpus box
  static constexpr int QBOX = TQ * TD * 2;  // one 128 x 64 query box
  static constexpr int SCORE = WARPS * TN * 4;  // a staged row per warp
  static constexpr size_t LIST = sizeof(float) + sizeof(int);  // one entry
  // Without the running lists, with a ring of `stages`: the realignment
  // room, the ring, the corpus tile, the staged rows and the barriers (two
  // per stage, one per corpus box).
  static size_t bytes(int ks_n, int stages = STAGES) {
    return ALIGN + (size_t)stages * QBOX + (size_t)ks_n * CBOX + SCORE +
           (2 * stages + ks_n) * sizeof(uint64_t);
  }
};

// d (+)= A . B^T for this warpgroup: A 64 corpus rows x 16, B 32 queries
// x 16, both K-major bf16 in shared memory; scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15}, %16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// The same with B 64 x 16 (form (ii): A 64 queries, B 64 corpus rows).
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// Split s's first corpus tile of n_tiles over S splits: the splits take
// contiguous runs of floor or ceil(n_tiles / S) tiles.
__device__ __forceinline__ int split_start(int s, int n_tiles, int S) {
  return (int)((long long)s * n_tiles / S);
}

// -- form (i): resident queries --------------------------------------------

// grid (S). Block s scans the 128-row corpus tiles of split s for every
// query (B <= 32) and leaves each query's top-k of that split in
// part[(query * S + s) * k : ... + k].
__global__ void __launch_bounds__(THREADS, 1)
    dense_co_resident_q_kernel(const __grid_constant__ CUtensorMap q_map,
                               const __grid_constant__ CUtensorMap e_map,
                               int B, int D, int n_valid, int k, int S,
                               bool lists_in_smem, float* part_v,
                               int* part_i) {
  using F = ResQ;
  constexpr int STAGES = F::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const int ks_n = (D + TD - 1) / TD;
  unsigned char* ring =
      smem_raw + (ALIGN - smem_u32(smem_raw) % ALIGN) % ALIGN;
  unsigned char* qres = ring + STAGES * F::BOX;
  float* sc = reinterpret_cast<float*>(qres + ks_n * F::QBOX);
  uint64_t* full = reinterpret_cast<uint64_t*>(sc + F::TQ * F::LDS);
  uint64_t* empty = full + STAGES;
  uint64_t* q_full = empty + STAGES;
  float* slv = reinterpret_cast<float*>(q_full + 1);
  int* sli = reinterpret_cast<int*>(slv + F::TQ * k);

  const int s = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_tiles = (n_valid + F::TN - 1) / F::TN;
  const int t_begin = split_start(s, n_tiles, S);
  const int t_end = split_start(s + 1, n_tiles, S);
  const int total = (t_end - t_begin) * ks_n;  // the ring's loads
  const uint64_t qm = reinterpret_cast<uint64_t>(&q_map);
  const uint64_t em = reinterpret_cast<uint64_t>(&e_map);

  // The ring's p-th load (slice p % ks_n of the split's tile p / ks_n)
  // into stage p % STAGES, once the stage's previous contents were
  // consumed. Thread 0 only.
  auto produce = [&](int p) {
    const int slot = p % STAGES;
    const int use = p / STAGES;
    if (use > 0) mbar_wait(&empty[slot], (use - 1) & 1);
    mbar_expect_tx(&full[slot], F::BOX);
    tma_load(ring + slot * F::BOX, em, &full[slot], (p % ks_n) * TD,
             (t_begin + p / ks_n) * F::TN);
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], WARPS);
    }
    mbar_init(q_full, 1);
    fence_mbar_init();
  }
  __syncthreads();
  if (threadIdx.x == 0 && total > 0) {
    mbar_expect_tx(q_full, ks_n * F::QBOX);
    for (int ks = 0; ks < ks_n; ++ks)
      tma_load(qres + ks * F::QBOX, qm, q_full, ks * TD, 0);
    for (int p = 0; p < min(STAGES, total); ++p) produce(p);
  }
  __syncwarp();

  auto list_v = [&](int r) -> float* {
    return lists_in_smem ? slv + r * k : part_v + ((size_t)r * S + s) * k;
  };
  auto list_i = [&](int r) -> int* {
    return lists_in_smem ? sli + r * k : part_i + ((size_t)r * S + s) * k;
  };
  for (int r = warp; r < B; r += WARPS)
    tr::warp_list_init(list_v(r), list_i(r), k, tr::kDenseBigId);
  if (total > 0) mbar_wait(q_full, 0);

  const int g = warp >> 2;  // warpgroup: corpus rows 64g .. 64g + 63
  // Accumulator r of lane l in warp w of warpgroup g holds corpus row
  // 64g + 16(w%4) + l/4 + 8((r%4)/2) and query 8(r/4) + 2(l%4) + r%2.
  const int row = 64 * g + 16 * (warp & 3) + (lane >> 2);
  const int col = 2 * (lane & 3);
  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
  int L = 0;  // the ring's next load to consume
  for (int t = t_begin; t < t_end; ++t) {
    for (int ks = 0; ks < ks_n; ++ks, ++L) {
      const int slot = L % STAGES;
      mbar_wait(&full[slot], (L / STAGES) & 1);
      const uint64_t da =
          smem_desc(smem_u32(ring + slot * F::BOX) + g * 64 * 128);
      const uint64_t db = smem_desc(smem_u32(qres + ks * F::QBOX));
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TD / 16; ++kk)  // 32 bytes per k16 step
        wgmma_m64n32k16(acc, da + 2 * kk, db + 2 * kk, ks | kk);
      wgmma_commit();
      wgmma_wait_all();
      // This warp is done with the stage; thread 0 refills it with load
      // L + STAGES once every warp is.
      if (lane == 0) mbar_arrive(&empty[slot]);
      if (threadIdx.x == 0 && L + STAGES < total) produce(L + STAGES);
      __syncwarp();
    }
    fence_acc(acc);
    __syncthreads();  // every warp is done folding the previous tile

#pragma unroll
    for (int r = 0; r < 16; ++r)
      sc[(8 * (r >> 2) + col + (r & 1)) * F::LDS + row + 8 * ((r >> 1) & 1)] =
          acc[r];
    __syncthreads();

    for (int r = warp; r < B; r += WARPS)
      tr::warp_fold_row<F::TN>(sc + r * F::LDS, t * F::TN, n_valid, k,
                               list_v(r), list_i(r));
  }

  if (lists_in_smem) {
    __syncwarp();
    for (int r = warp; r < B; r += WARPS) {
      const size_t out = ((size_t)r * S + s) * k;
      for (int j = lane; j < k; j += 32) {
        part_v[out + j] = slv[r * k + j];
        part_i[out + j] = sli[r * k + j];
      }
    }
  }
}

// -- form (ii): resident corpus tile ---------------------------------------

// K1's fold of one warp's 16 queries of a box against corpus rows n0 ..
// n0 + 63, straight from the m64n64 accumulators: lane l holds queries q =
// l/4 (accumulators 4c + e) and q + 8 (4c + 2 + e), corpus row 8c + 2(l%4)
// + e. Query q's list is at lists + at0 + q * stride; only the first
// `rows` queries are real. Each lane checks its two rows against their
// lists' k-th entries; a row that some score beats is staged in buf (64
// floats of this warp's own) and folded by warp_fold_row.
__device__ __forceinline__ void fold_acc(const float (&acc)[32], int n0,
                                         int n_valid, int k, int rows,
                                         float* lists_v, int* lists_i,
                                         size_t at0, size_t stride,
                                         float* buf) {
  const int lane = threadIdx.x & 31;
  const int col = 2 * (lane & 3);
  bool hit[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int q = (lane >> 2) + 8 * h;
    hit[h] = false;
    if (q < rows) {
      const size_t at = at0 + q * stride + k - 1;
      const float kv = lists_v[at];
      const int ki = lists_i[at];
#pragma unroll
      for (int c = 0; c < 8; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int id = n0 + 8 * c + col + e;
          hit[h] |= id < n_valid && tr::lex_gt(acc[4 * c + 2 * h + e], id,
                                               kv, ki);
        }
    }
  }
  // Bit q: some lane of query q's quad has a score that beats its list.
  const unsigned ha = __ballot_sync(tr::kFullMask, hit[0]);
  const unsigned hb = __ballot_sync(tr::kFullMask, hit[1]);
  unsigned hits = 0;
#pragma unroll
  for (int q = 0; q < 8; ++q)
    hits |= (unsigned)((ha >> 4 * q & 0xFu) != 0) << q |
            (unsigned)((hb >> 4 * q & 0xFu) != 0) << (q + 8);
  for (; hits; hits &= hits - 1) {
    const int q = __ffs(hits) - 1;
    if ((lane >> 2) == (q & 7)) {
#pragma unroll
      for (int c = 0; c < 8; ++c)
        *reinterpret_cast<float2*>(buf + 8 * c + col) =
            q < 8 ? make_float2(acc[4 * c], acc[4 * c + 1])
                  : make_float2(acc[4 * c + 2], acc[4 * c + 3]);
    }
    __syncwarp();
    const size_t at = at0 + q * stride;
    tr::warp_fold_row<64>(buf, n0, n_valid, k, lists_v + at, lists_i + at);
    __syncwarp();  // every lane has read buf before the next row
  }
}

// grid (S * groups), THREADS + 32 threads: two consumer warpgroups and the
// ring's producer warp. Block (s, g), x = g * S + s, keeps each 64-row
// corpus tile of split s in shared memory while its query tiles (g, g +
// groups, ...) stream past, and leaves each of their queries' top-k of
// that split in part[(query * S + s) * k : ... + k]. The ring has
// `stages` stages; lists_in_smem: the lists of the block's queries fit
// beside it.
__global__ void __launch_bounds__(THREADS + 32, 1)
    dense_co_resident_c_kernel(const __grid_constant__ CUtensorMap q_map,
                               const __grid_constant__ CUtensorMap e_map,
                               int B, int D, int n_valid, int k, int S,
                               int groups, int stages, bool lists_in_smem,
                               float* part_v, int* part_i) {
  using F = ResC;
  extern __shared__ unsigned char smem_raw[];
  const int ks_n = (D + TD - 1) / TD;
  unsigned char* ring =  // the query boxes' stages
      smem_raw + (ALIGN - smem_u32(smem_raw) % ALIGN) % ALIGN;
  unsigned char* ctile = ring + stages * F::QBOX;
  float* rowbuf = reinterpret_cast<float*>(ctile + ks_n * F::CBOX);
  uint64_t* full = reinterpret_cast<uint64_t*>(rowbuf + WARPS * F::TN);
  uint64_t* empty = full + stages;
  uint64_t* c_full = empty + stages;  // one per corpus box
  const int s = blockIdx.x % S;
  const int grp = blockIdx.x / S;
  // This block's query tiles: grp + groups * j, j < q_tiles.
  const int q_tiles = ((B + F::TQ - 1) / F::TQ - grp + groups - 1) / groups;
  float* slv = reinterpret_cast<float*>(c_full + ks_n);
  int* sli = reinterpret_cast<int*>(slv + q_tiles * F::TQ * k);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_tiles = (n_valid + F::TN - 1) / F::TN;
  const int t_begin = split_start(s, n_tiles, S);
  const int steps = split_start(s + 1, n_tiles, S) - t_begin;
  const int per_step = q_tiles * ks_n;  // the ring's loads per corpus tile
  const int total = steps * per_step;

  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], WARPS);
    }
    for (int ks = 0; ks < ks_n; ++ks) mbar_init(&c_full[ks], 1);
    fence_mbar_init();
  }
  __syncthreads();

  if (warp == WARPS) {
    // The producer. Load p (slice p % ks_n of query tile (p / ks_n) %
    // q_tiles) goes into stage p % stages once every consumer warp has
    // read load p - stages there; loads total .. total + stages - 1 only
    // wait for those reads. A read of the last query tile's slice j frees
    // corpus box j for the next tile, on its own barrier: the box arrives
    // while the rest of the tile's last query tile is read.
    if (lane == 0 && total > 0) {
      const uint64_t qm = reinterpret_cast<uint64_t>(&q_map);
      const uint64_t em = reinterpret_cast<uint64_t>(&e_map);
      for (int ks = 0; ks < ks_n; ++ks) {
        mbar_expect_tx(&c_full[ks], F::CBOX);
        tma_load(ctile + ks * F::CBOX, em, &c_full[ks], ks * TD,
                 t_begin * F::TN);
      }
      int slot = 0, phase = 0;  // load p's stage and its use's parity
      for (int p = 0; p < total + stages; ++p) {
        if (p >= stages) {
          mbar_wait(&empty[slot], phase ^ 1);
          const int c = p - stages;  // the load just read
          const int step = c / per_step;
          if (c % per_step >= per_step - ks_n && step + 1 < steps) {
            const int ks = c % ks_n;
            mbar_expect_tx(&c_full[ks], F::CBOX);
            tma_load(ctile + ks * F::CBOX, em, &c_full[ks], ks * TD,
                     (t_begin + step + 1) * F::TN);
          }
        }
        if (p < total) {
          mbar_expect_tx(&full[slot], F::QBOX);
          tma_load(ring + slot * F::QBOX, qm, &full[slot], (p % ks_n) * TD,
                   (grp + groups * ((p / ks_n) % q_tiles)) * F::TQ);
        }
        if (++slot == stages) {
          slot = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // The consumers. Warp wq of warpgroup g owns queries r0 .. r0 + 15 of
  // each of its block's query tiles: their lists are only ever its own.
  const int g = warp >> 2;
  const int r0 = 64 * g + 16 * (warp & 3);
  float* lists_v = lists_in_smem ? slv : part_v;
  int* lists_i = lists_in_smem ? sli : part_i;
  // The list of row r of this block's query tile j, and the step from one
  // query's list to the next's.
  auto list_at = [&](int j, int r) -> size_t {
    return lists_in_smem
               ? (size_t)(j * F::TQ + r) * k
               : ((size_t)((grp + groups * j) * F::TQ + r) * S + s) * k;
  };
  const size_t stride = lists_in_smem ? (size_t)k : (size_t)S * k;
  // This warp's real queries of tile j (those below B).
  auto warp_rows = [&](int j) {
    return max(0, min(16, B - (grp + groups * j) * F::TQ - r0));
  };
  for (int j = 0; j < q_tiles; ++j)
    for (int q = 0; q < warp_rows(j); ++q)
      tr::warp_list_init(lists_v + list_at(j, r0 + q),
                         lists_i + list_at(j, r0 + q), k, tr::kDenseBigId);
  __syncwarp();

  float* buf = rowbuf + warp * F::TN;
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  int slot = 0, phase = 0;  // the ring's next stage to read, its parity
  for (int step = 0; step < steps; ++step) {
    const int n0 = (t_begin + step) * F::TN;
    for (int qt = 0; qt < q_tiles; ++qt) {
      int prev = 0;  // the stage whose products may still run
      for (int ks = 0; ks < ks_n; ++ks) {
        if (qt == 0) mbar_wait(&c_full[ks], step & 1);
        mbar_wait(&full[slot], phase);
        const uint64_t da =
            smem_desc(smem_u32(ring + slot * F::QBOX) + g * 64 * 128);
        const uint64_t db = smem_desc(smem_u32(ctile + ks * F::CBOX));
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < TD / 16; ++kk)  // 32 bytes per k16 step
          wgmma_m64n64k16(acc, da + 2 * kk, db + 2 * kk, ks | kk);
        wgmma_commit();
        // The previous slice's products are done: its stage is free.
        wgmma_wait_one();
        if (ks > 0 && lane == 0) mbar_arrive(&empty[prev]);
        prev = slot;
        if (++slot == stages) {
          slot = 0;
          phase ^= 1;
        }
      }
      wgmma_wait_all();
      if (lane == 0) mbar_arrive(&empty[prev]);
      fence_acc(acc);
      fold_acc(acc, n0, n_valid, k, warp_rows(qt), lists_v, lists_i,
               list_at(qt, r0), stride, buf);
    }
  }

  if (lists_in_smem) {
    for (int j = 0; j < q_tiles; ++j)
      for (int q = 0; q < warp_rows(j); ++q) {
        const size_t in = list_at(j, r0 + q);
        const size_t out =
            ((size_t)((grp + groups * j) * F::TQ + r0 + q) * S + s) * k;
        for (int e = lane; e < k; e += 32) {
          part_v[out + e] = slv[in + e];
          part_i[out + e] = sli[in + e];
        }
      }
  }
}

cudaError_t launch_resident_q(const void* q, const void* emb, int B, int N,
                              int D, int n_valid, int k, int S,
                              float* part_v, int* part_i, cudaStream_t st) {
  using F = ResQ;
  const size_t base = F::bytes((D + TD - 1) / TD);
  if (B > F::TQ || base > (size_t)MAX_SMEM) return cudaErrorInvalidValue;
  // No rows, no tiles: the kernel issues no copy through either map.
  CUtensorMap q_map{}, e_map{};
  if (n_valid > 0) {
    cudaError_t err = encode_boxes(&q_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                                   2, q, B, D, F::TQ);
    if (err == cudaSuccess)
      err = encode_boxes(&e_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, emb, N,
                         D, F::TN);
    if (err != cudaSuccess) return err;
  }
  // The running lists stay in shared memory where they fit, else in the
  // (B, S, k) scratch.
  const size_t lists = (size_t)F::TQ * k * (sizeof(float) + sizeof(int));
  const bool lists_in_smem = base + lists <= (size_t)MAX_SMEM;
  const size_t smem = base + (lists_in_smem ? lists : 0);
  cudaError_t err = cudaFuncSetAttribute(
      dense_co_resident_q_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dense_co_resident_q_kernel<<<S, THREADS, smem, st>>>(
      q_map, e_map, B, D, n_valid, k, S, lists_in_smem, part_v, part_i);
  return cudaGetLastError();
}

cudaError_t launch_resident_c(const void* q, const void* emb, int B, int N,
                              int D, int n_valid, int k, int S, int groups,
                              float* part_v, int* part_i, cudaStream_t st) {
  using F = ResC;
  const int ks_n = (D + TD - 1) / TD;
  const int q_tiles = (B + F::TQ - 1) / F::TQ;
  if (F::bytes(ks_n) > (size_t)MAX_SMEM || groups < 1 || groups > q_tiles)
    return cudaErrorInvalidValue;
  // The lists of the most queries one block holds (its share of the query
  // tiles) stay in shared memory where they fit beside the ring at its
  // least depth, else in the (B, S, k) scratch; the ring takes what is
  // left, up to MAX_STAGES.
  const size_t lists =
      (size_t)((q_tiles + groups - 1) / groups) * F::TQ * k * F::LIST;
  const bool lists_in_smem = F::bytes(ks_n) + lists <= (size_t)MAX_SMEM;
  const size_t rest = lists_in_smem ? lists : 0;
  int stages = F::STAGES;
  while (stages < F::MAX_STAGES &&
         F::bytes(ks_n, stages + 1) + rest <= (size_t)MAX_SMEM)
    ++stages;
  const size_t smem = F::bytes(ks_n, stages) + rest;
  // 128 query rows per box, 64 corpus rows. No rows, no tiles: no copy
  // through e_map.
  CUtensorMap q_map{}, e_map{};
  cudaError_t err = encode_boxes(&q_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                                 q, B, D, F::TQ);
  if (err == cudaSuccess && n_valid > 0)
    err = encode_boxes(&e_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, emb, N, D,
                       F::TN);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dense_co_resident_c_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  dense_co_resident_c_kernel<<<S * groups, THREADS + 32, smem, st>>>(
      q_map, e_map, B, D, n_valid, k, S, groups, stages, lists_in_smem,
      part_v, part_i);
  return cudaGetLastError();
}

}  // namespace

// K7 on bf16 q (B, D) and emb (N, D), D % 8 == 0, 16-byte aligned: form
// (i) for B <= 32 (groups 1), else form (ii) with the query tiles dealt to
// `groups` blocks per split; S corpus splits, one block each per group;
// part_v / part_i (B, S, k) scratch; out (B, k).
extern "C" int tr_dense_topk_co_sm90(const void* q, const void* emb, int B,
                                     int N, int D, int n_valid, int k,
                                     int groups, int S, float* part_v,
                                     int* part_i, float* out_v, int* out_i,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || D < 8 || D % 8 != 0 || S < 1 ||
      reinterpret_cast<uintptr_t>(q) % 16 ||
      reinterpret_cast<uintptr_t>(emb) % 16)
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (B <= ResQ::TQ)
    err = groups == 1 ? launch_resident_q(q, emb, B, N, D, n_valid, k, S,
                                          part_v, part_i, st)
                      : cudaErrorInvalidValue;
  else
    err = launch_resident_c(q, emb, B, N, D, n_valid, k, S, groups, part_v,
                            part_i, st);
  if (err != cudaSuccess) return (int)err;
  return (int)tr::dense_merge(part_v, part_i, B, S, k, out_v, out_i, st);
}
