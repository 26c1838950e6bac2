# Ported from tpurag/kernels/dense.py (dense_topk_xla -> dense_topk_ref,
# dense_topk_pallas -> the CUDA kernels in csrc/dense_topk_sm90.cu and
# csrc/dense_topk.cu, dense_topk_pallas_co -> csrc/dense_topk_co_sm90.cu
# and csrc/dense_topk.cu).
"""Dense cosine-similarity top-k.

Embeddings and queries are L2-normalized by the index layer, so the dot
product is the cosine score. ``dense_topk`` is the dispatching wrapper:
a CUDA corpus goes to a hand-written Hopper kernel (the (B, N) score
matrix is never written to device memory), a CPU corpus to
``dense_topk_ref``, the plain version (one matmul, then a stable sort).
K1 has two bodies: bf16 corpora whose rows TMA can address
(``sm90_route``) take the TMA + wgmma one (csrc/dense_topk_sm90.cu),
every other corpus the first one (csrc/dense_topk.cu, WMMA).
``dense_topk_co`` computes the same function in corpus-outer order (K7:
each corpus tile read once and scored against every query tile); aligned
bf16 corpora take its Hopper body (csrc/dense_topk_co_sm90.cu: TMA,
wgmma), the rest its first body (csrc/dense_topk.cu). No path calls it; it is measured beside
``dense_topk``.

Contract (same as the JAX package's Pallas kernel): (B, k) float32
scores descending and int32 ids, ties to the smaller id, rows at or past
``n_valid`` never returned, empty slots (NEG_INF, -1) even when
k > n_valid, queries cast to the corpus dtype before the product, fp32
accumulation.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpurag_torch.kernels.runtime import (NEG_INF, cdiv, check_launch,
                                          cuda_stream, launch_counts,
                                          load_kernels)

# Kernel tile sizes (csrc/dense_topk.cu: TQ queries x TN corpus rows).
TILE_Q = 64
TILE_N = 128
# The TMA + wgmma body's tile (csrc/dense_topk_sm90.cu: 128 queries x 128
# corpus rows, one block per SM) and the H100 SXM's SM count.
SM90_TILE = 128
H100_SMS = 132
# Blocks the split heuristic aims for: two per SM on a 132-SM H100.
TARGET_BLOCKS = 264
# Candidates per query the merge pass holds in shared memory.
MAX_MERGE_CANDIDATES = 8192

# Storage-dtype codes of the kernels' C entry points.
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def dense_topk_ref(queries: torch.Tensor, emb: torch.Tensor, n_valid: int,
                   k: int):
    """Plain version: full (B, N) fp32 scores, masked past n_valid, then
    a stable descending sort (ties keep the smaller column first)."""
    q = queries.to(emb.dtype).float()
    scores = q @ emb.float().T
    n = emb.shape[0]
    col = torch.arange(n, device=emb.device)
    scores = torch.where(col[None, :] < int(n_valid), scores, NEG_INF)
    if n < k:
        scores = torch.nn.functional.pad(scores, (0, k - n), value=NEG_INF)
    vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    vals = vals[:, :k].contiguous()
    ids = torch.where(vals <= NEG_INF / 2, -1, idx[:, :k].to(torch.int32))
    return vals, ids


def dense_splits(b: int, n_valid: int, k: int) -> int:
    """Corpus splits per query tile: enough blocks to fill the card, at
    least one corpus tile each, and few enough partial lists per query
    for the merge pass."""
    q_tiles = cdiv(max(b, 1), TILE_Q)
    n_tiles = max(cdiv(n_valid, TILE_N), 1)
    s = min(cdiv(TARGET_BLOCKS, q_tiles), n_tiles)
    return max(1, min(s, MAX_MERGE_CANDIDATES // k))


def _check_args(name: str, queries: torch.Tensor, emb: torch.Tensor,
                n_valid: int, k: int) -> None:
    """Raise on what the CUDA dense kernels do not take."""
    if emb.dtype not in DTYPE_CODE:
        raise TypeError(f"{name}: corpus dtype {emb.dtype} not supported "
                        "by the kernel (bfloat16 or float32)")
    if emb.dim() != 2 or queries.dim() != 2:
        raise ValueError(f"{name}: queries and corpus must be 2-D")
    if queries.device != emb.device:
        raise ValueError(f"{name}: queries and corpus on different devices")
    if not emb.is_contiguous():
        raise ValueError(f"{name}: corpus must be contiguous")
    n, d = emb.shape
    if queries.shape[1] != d:
        raise ValueError(f"{name}: dim mismatch {queries.shape[1]} != {d}")
    if k < 1 or not 0 <= n_valid <= n:
        raise ValueError(f"{name}: bad k={k} or n_valid={n_valid} "
                         f"for {n} rows")


def sm90_route(dtype: torch.dtype, d: int, *ptrs: int) -> bool:
    """Whether a corpus takes K1's TMA + wgmma body: bf16, rows of a
    multiple of 16 bytes (D % 8 == 0) and 16-byte aligned data pointers
    (what a TMA tensor map needs). Every other corpus takes the first
    body."""
    return (dtype == torch.bfloat16 and d % 8 == 0
            and all(p % 16 == 0 for p in ptrs))


def sm90_splits(b: int, n_valid: int, k: int, sms: int = H100_SMS) -> int:
    """Corpus splits of the TMA + wgmma body: (query tiles x splits)
    blocks within one wave at one block per SM, at least one corpus tile
    in every split, and few enough partial lists per query for the merge
    pass."""
    q_tiles = cdiv(max(b, 1), SM90_TILE)
    n_tiles = max(cdiv(n_valid, SM90_TILE), 1)
    s = max(1, min(sms // q_tiles, n_tiles, MAX_MERGE_CANDIDATES // k))
    return cdiv(n_tiles, cdiv(n_tiles, s))  # no split left without a tile


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def dense_topk(queries: torch.Tensor, emb: torch.Tensor, n_valid: int,
               k: int):
    """Cosine top-k of (B, D) queries against the first n_valid rows of
    the (N, D) corpus. CPU tensors take the plain version; CUDA tensors
    launch K1 (csrc/dense_topk_sm90.cu where ``sm90_route`` allows it,
    else csrc/dense_topk.cu) or raise."""
    if emb.device.type == "cpu":
        return dense_topk_ref(queries, emb, n_valid, k)
    return _dense_topk_cuda(queries, emb, n_valid, k, sm90=None)


def _dense_topk_first_body(queries: torch.Tensor, emb: torch.Tensor,
                           n_valid: int, k: int):
    """K1's first body (csrc/dense_topk.cu) on a CUDA corpus that the
    route would send to the TMA + wgmma body: called by name only to time
    the two bodies on the same inputs."""
    return _dense_topk_cuda(queries, emb, n_valid, k, sm90=False)


def _dense_topk_cuda(queries: torch.Tensor, emb: torch.Tensor, n_valid: int,
                     k: int, sm90):
    """Launch one of K1's bodies: sm90 None routes by ``sm90_route``,
    False takes the first body."""
    if emb.device.type != "cuda":
        raise ValueError(f"dense_topk: unsupported device {emb.device}")
    n_valid = int(n_valid)
    _check_args("dense_topk", queries, emb, n_valid, k)
    b, d = queries.shape
    n = emb.shape[0]
    q = queries.to(emb.dtype).contiguous()
    out_v = torch.empty((b, k), dtype=torch.float32, device=emb.device)
    out_i = torch.empty((b, k), dtype=torch.int32, device=emb.device)
    if b == 0:
        return out_v, out_i
    if sm90 is None:
        sm90 = sm90_route(emb.dtype, d, q.data_ptr(), emb.data_ptr())
    lib = load_kernels()
    if sm90:
        splits = sm90_splits(b, n_valid, k, _sm_count(emb.device))
        fn, head = lib.tr_dense_topk_sm90, ()
    else:
        splits = dense_splits(b, n_valid, k)
        fn, head = lib.tr_dense_topk, (DTYPE_CODE[emb.dtype],)
    part_v = torch.empty((b, splits, k), dtype=torch.float32,
                         device=emb.device)
    part_i = torch.empty((b, splits, k), dtype=torch.int32, device=emb.device)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * (6 + len(head))
                   + [ctypes.c_void_p] * 5)
    err = fn(q.data_ptr(), emb.data_ptr(), *head, b, n, d, n_valid, k,
             splits, part_v.data_ptr(), part_i.data_ptr(), out_v.data_ptr(),
             out_i.data_ptr(), cuda_stream(emb.device))
    check_launch(err, "dense_topk")
    # Every K1 launch counts under dense_topk; the TMA + wgmma body's also
    # under dense_topk_sm90, so a run shows which body ran.
    launch_counts["dense_topk"] += 1
    if sm90:
        launch_counts["dense_topk_sm90"] += 1
    return out_v, out_i


# K7's first body's shared-memory budget (csrc/dense_topk.cu: co_bytes):
# Hopper's per-block limit, the D slice staged per step and each dtype's
# padded query-slice row.
MAX_SMEM = 232_448
TILE_D = 64
STAGE_LD = {torch.float32: TILE_D + 4, torch.bfloat16: TILE_D + 8}

# K7's Hopper body (csrc/dense_topk_co_sm90.cu: ResQ::bytes, ResC::bytes).
# Form (i), B <= 32: the queries resident in 32 x 64 boxes, 128 x 64
# corpus boxes through a ring of 4 stages, a (32 x 132) fp32 score tile, 9
# barriers. Form (ii): a 64-row corpus tile resident in 64 x 64 boxes,
# each with its barrier, 128 x 64 query boxes through a ring of at least 3
# stages (more where room is left), a staged 64-score row per consumer
# warp, 6 ring barriers at 3 stages. Both keep 1 KB to realign the boxes;
# the running lists take what is left where they fit.
SM90_ALIGN = 1024
CO_RESIDENT_Q = 32
CO_FORMS = {  # form: (rows per tile, ring stages (form (ii): the least),
              #        ring box bytes, resident box bytes, score bytes,
              #        barrier bytes)
    1: (128, 4, 128 * TILE_D * 2, 32 * TILE_D * 2, 32 * 132 * 4, 9 * 8),
    2: (64, 3, 128 * TILE_D * 2, 64 * TILE_D * 2 + 8, 8 * 64 * 4, 6 * 8),
}
# Query groups of form (ii): the 128-query tiles are dealt to this many
# blocks per corpus split (fewer splits per query: fewer list insertions
# in all, each corpus tile read by as many blocks).
CO_GROUPS = 4


def co_sm90_bytes(form: int, d: int) -> int:
    """Shared memory of one block of K7's Hopper body in `form`, without
    the running lists, which take what room is left where they fit."""
    _, stages, ring_box, res_box, score, rest = CO_FORMS[form]
    return (SM90_ALIGN + stages * ring_box + cdiv(d, TILE_D) * res_box
            + score + rest)


def co_sm90_form(b: int, d: int) -> int:
    """K7's Hopper form for a batch of b queries of width d: 1 (queries
    resident) for b <= 32, else 2 (corpus tile resident); 0 where that
    form's shared memory does not hold D (past 2,304 and 1,344)."""
    form = 1 if b <= CO_RESIDENT_Q else 2
    return form if co_sm90_bytes(form, d) <= MAX_SMEM else 0


def co_sm90_route(dtype: torch.dtype, b: int, d: int, *ptrs: int) -> int:
    """The form of K7's Hopper body that a corpus takes (``co_sm90_form``)
    where TMA can address it (``sm90_route``), else 0: the first body."""
    return co_sm90_form(b, d) if sm90_route(dtype, d, *ptrs) else 0


def co_sm90_groups(b: int, form: int, groups: int = CO_GROUPS) -> int:
    """Query groups of K7's Hopper body: form (ii) deals its 128-query
    tiles to up to `groups` blocks per corpus split; form (i) has one."""
    return min(groups, cdiv(b, 128)) if form == 2 else 1


def co_sm90_splits(n_tiles: int, k: int, slots: int = H100_SMS) -> int:
    """Corpus splits of K7's Hopper body: one block each, no more than the
    card holds at once (`slots`), no more than the corpus tiles where
    those allow, and few enough partial lists per query for the merge
    pass."""
    return max(1, min(slots, MAX_MERGE_CANDIDATES // k, n_tiles))


def co_tile_rows(dtype: torch.dtype, d: int) -> int:
    """Corpus rows per tile of K7's first body: the largest of 64, 32, 16
    whose (tn, D) tile (rows padded to TILE_D plus a 16-byte skew),
    (TILE_Q, TILE_D) query slice and (TILE_Q, tn + 4) fp32 score tile fit
    one block's shared memory, or 0."""
    size = torch.finfo(dtype).bits // 8
    dp = cdiv(d, TILE_D) * TILE_D
    for tn in (64, 32, 16):
        if (tn * (dp + 16 // size) * size + TILE_Q * STAGE_LD[dtype] * size
                + TILE_Q * (tn + 4) * 4 <= MAX_SMEM):
            return tn
    return 0


def dense_co_splits(n_tiles: int, k: int) -> int:
    """Corpus splits of K7's first body (one block each): enough blocks to
    fill the card, at least one corpus tile each, and few enough partial
    lists per query for the merge pass."""
    s = min(TARGET_BLOCKS, max(n_tiles, 1))
    return max(1, min(s, MAX_MERGE_CANDIDATES // k))


def dense_topk_co(queries: torch.Tensor, emb: torch.Tensor, n_valid: int,
                  k: int):
    """dense_topk's function in corpus-outer order (K7): the same (B, k)
    scores and ids. CPU tensors take the plain version; CUDA tensors
    launch K7 or raise: aligned bf16 corpora whose form fits
    (``co_sm90_route``) take its Hopper body
    (csrc/dense_topk_co_sm90.cu), every other corpus its first body
    (csrc/dense_topk.cu; any batch, D up to what one 16-row corpus tile in
    shared memory allows: 6,784 bf16, 3,264 fp32)."""
    if emb.device.type == "cpu":
        return dense_topk_ref(queries, emb, n_valid, k)
    return _dense_topk_co_cuda(queries, emb, n_valid, k, sm90=None)


def _dense_topk_co_first_body(queries: torch.Tensor, emb: torch.Tensor,
                              n_valid: int, k: int):
    """K7's first body (csrc/dense_topk.cu) on a CUDA corpus that the
    route would send to the Hopper body: called by name only to time the
    two bodies on the same inputs."""
    return _dense_topk_co_cuda(queries, emb, n_valid, k, sm90=False)


def _dense_topk_co_cuda(queries: torch.Tensor, emb: torch.Tensor,
                        n_valid: int, k: int, sm90=None):
    """Launch one of K7's bodies: sm90 None routes by ``co_sm90_route``,
    False takes the first body."""
    if emb.device.type != "cuda":
        raise ValueError(f"dense_topk_co: unsupported device {emb.device}")
    n_valid = int(n_valid)
    _check_args("dense_topk_co", queries, emb, n_valid, k)
    b, d = queries.shape
    n = emb.shape[0]
    q = queries.to(emb.dtype).contiguous()
    form = 0 if sm90 is False else co_sm90_route(
        emb.dtype, b, d, q.data_ptr(), emb.data_ptr())
    tile = co_tile_rows(emb.dtype, d)
    if not form and tile == 0:
        raise ValueError(f"dense_topk_co: D={d} {emb.dtype} rows do not fit "
                         "a 16-row tile in one block's shared memory")
    out_v = torch.empty((b, k), dtype=torch.float32, device=emb.device)
    out_i = torch.empty((b, k), dtype=torch.int32, device=emb.device)
    if b == 0:
        return out_v, out_i
    lib = load_kernels()
    if form:
        groups = co_sm90_groups(b, form)
        splits = co_sm90_splits(cdiv(n_valid, CO_FORMS[form][0]), k,
                                _sm_count(emb.device) // groups)
        fn, mid = lib.tr_dense_topk_co_sm90, (groups,)
        head = ()
    else:
        splits = dense_co_splits(cdiv(n_valid, tile), k)
        fn, mid = lib.tr_dense_topk_co, (tile,)
        head = (DTYPE_CODE[emb.dtype],)
    part_v = torch.empty((b, splits, k), dtype=torch.float32,
                         device=emb.device)
    part_i = torch.empty((b, splits, k), dtype=torch.int32, device=emb.device)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 2
                   + [ctypes.c_int] * (6 + len(head) + len(mid))
                   + [ctypes.c_void_p] * 5)
    err = fn(q.data_ptr(), emb.data_ptr(), *head, b, n, d, n_valid, k, *mid,
             splits, part_v.data_ptr(), part_i.data_ptr(), out_v.data_ptr(),
             out_i.data_ptr(), cuda_stream(emb.device))
    check_launch(err, "dense_topk_co")
    # Every K7 launch counts under dense_topk_co; the Hopper body's also
    # under dense_topk_co_sm90, so a run shows which body ran.
    launch_counts["dense_topk_co"] += 1
    if form:
        launch_counts["dense_topk_co_sm90"] += 1
    return out_v, out_i
