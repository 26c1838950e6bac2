# Ported from tpurag/kernels/quant.py (dense_topk_xla_q8 -> dense_scan_q8_ref,
# dense_topk_pallas_q8 -> csrc/dense_topk_q8_sm90.cu and the int8 form of
# csrc/dense_topk.cu, gather_scores_pallas and rescore_topk ->
# csrc/gather_scores.cu).
"""int8-quantized dense scan with an exact rescore.

- ``quantize_rows``: per-row symmetric max-abs int8 codes plus one fp32
  scale per row, bit for bit the JAX function (a true division, rounding
  half to even; zero rows get scale 0).
- ``dense_scan_q8`` (K5's wrapper): int8 x int8 -> exact int32 dots,
  times the corpus row's scale, running top-k; the query's scale is a
  per-row constant, applied after the kernel (it cannot reorder a
  query's list). Values are masked by their pre-scale value, so empty
  slots always carry id -1. ``dense_scan_q8_ref`` is the plain version.
  K5 has two bodies: corpora whose rows TMA can address
  (``q8_sm90_route``) take the TMA + int8 wgmma one
  (csrc/dense_topk_q8_sm90.cu) with a 32-query tile whose queries stay in
  shared memory for B <= 32, else K1's 128-query tile
  (``q8_sm90_tile``); every other corpus takes the first body (the int8
  form of csrc/dense_topk.cu).
- ``gather_scores`` (K8's wrapper): (B, M) fp32 dots of each query with
  its M candidate rows of the storage-dtype corpus; ``gather_scores_ref``
  is the plain version (a gather, then an fp32 einsum).
- ``rescore_topk`` re-ranks candidate ids by their exact dots (duplicates
  dropped, ties to the smaller id): on the card one launch of K8's
  rescore (the dots, the duplicate marking and the top-k in one block a
  query); ``rescore_topk_ref`` is its plain version (the dots by
  ``gather_scores_ref``, a stable id sort, a stable score sort).
  ``dense_topk_q8`` chains the int8 scan at an overfetched m = 2k with
  the rescore.

CPU tensors take the plain versions; CUDA tensors launch the kernels or
raise.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpurag_torch.kernels.dense import (DTYPE_CODE, _sm_count, dense_splits,
                                        sm90_splits)
from tpurag_torch.kernels.runtime import (NEG_INF, check_launch, cuda_stream,
                                          launch_counts, load_kernels)

_BIG = 2**30
# |dot| <= 127^2 * D stays below 2^24, so an fp32 product of int8 codes is
# exact in any summation order, up to this D.
EXACT_FP32_DIM = 1040
# K5's TMA + int8 wgmma body (csrc/dense_topk_q8_sm90.cu): its two query
# tiles, and the largest D whose 32 query rows stay in shared memory
# beside the 4-stage ring, the score tile and lists up to k = 69.
Q8_SMALL_TILE = 32
Q8_TILE = 128
Q8_RESIDENT_MAX_D = 4096
# K8's rescore keeps a query's candidates in one block's shared memory,
# 12 bytes each (csrc/gather_scores.cu: rescore_topk_kernel).
RESCORE_MAX_M = 16384


def quantize_rows(emb: torch.Tensor):
    """(N, D) float -> (int8 (N, D), fp32 (N,) per-row scales).

    Symmetric max-abs: e_i8 = round(e / s), s = max|row| / 127. Zero rows
    (index padding / tombstones) get scale 0 so they dequantize to 0.
    Bit for bit the JAX function: XLA folds its `m / 127.0` into a
    multiply by fp32(1/127), and divides the codes truly, so the codes
    divide by a tensor here (on CUDA, division by a Python scalar is a
    reciprocal multiply)."""
    a = emb.float()
    m = a.abs().amax(dim=1)
    s = m * torch.full_like(m, 1.0 / 127.0)
    safe = torch.clamp_min(s, 1e-30)
    q = torch.clamp(torch.round(a / safe[:, None]), -127, 127)
    return q.to(torch.int8), torch.where(m > 0, s, torch.zeros_like(s))


def _exact_dots(a_i8: torch.Tensor, b_i8: torch.Tensor) -> torch.Tensor:
    """(B, D) x (N, D) int8 codes -> (B, N) fp32 equal to the int32 dots
    converted to fp32 (fp32 products are exact up to EXACT_FP32_DIM and
    without TF32; float64 otherwise)."""
    exact = (a_i8.shape[1] <= EXACT_FP32_DIM
             and not (a_i8.is_cuda and torch.backends.cuda.matmul.allow_tf32))
    acc = torch.float32 if exact else torch.float64
    return (a_i8.to(acc) @ b_i8.to(acc).T).float()


def dense_scan_q8_ref(q_i8, q_scale, emb_i8, e_scale, n_valid: int, k: int):
    """Plain version of K5 (the JAX package's dense_topk_xla_q8): exact
    int dots times the row scales, columns at or past n_valid masked, a
    stable descending sort (ties to the smaller column), ids -1 where the
    pre-scale value is NEG_INF, then the query scale."""
    scores = _exact_dots(q_i8, emb_i8) * e_scale.float()[None, :]
    n = emb_i8.shape[0]
    col = torch.arange(n, device=emb_i8.device)
    scores = torch.where(col[None, :] < int(n_valid), scores, NEG_INF)
    if n < k:
        scores = torch.nn.functional.pad(scores, (0, k - n), value=NEG_INF)
    vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    vals = vals[:, :k].contiguous()
    ids = torch.where(vals <= NEG_INF / 2, -1, idx[:, :k].to(torch.int32))
    return vals * q_scale.float()[:, None], ids


def q8_sm90_route(d: int, *ptrs: int) -> bool:
    """Whether an int8 corpus takes K5's TMA + wgmma body: rows of a
    multiple of 16 bytes (D % 16 == 0) and 16-byte aligned code pointers
    (what a TMA tensor map needs). Every other corpus takes the first
    body."""
    return d % 16 == 0 and all(p % 16 == 0 for p in ptrs)


def q8_sm90_tile(b: int, d: int) -> int:
    """K5's wgmma query tile: 32 queries, loaded once and kept in shared
    memory, for B <= 32 where they fit (D <= Q8_RESIDENT_MAX_D); else
    K1's 128 queries, streamed through the ring beside the corpus."""
    return Q8_SMALL_TILE if b <= Q8_SMALL_TILE and d <= Q8_RESIDENT_MAX_D \
        else Q8_TILE


def dense_scan_q8(q_i8, q_scale, emb_i8, e_scale, n_valid: int, k: int):
    """int8 top-k of (B, D) query codes against the first n_valid rows of
    the (N, D) corpus codes: (B, k) fp32 approximate cosines (descending,
    ties to the smaller id) and int32 ids, -1 for empty slots. CPU tensors
    take the plain version; CUDA tensors launch K5
    (csrc/dense_topk_q8_sm90.cu where ``q8_sm90_route`` allows it, else
    csrc/dense_topk.cu) or raise."""
    if emb_i8.device.type == "cpu":
        return dense_scan_q8_ref(q_i8, q_scale, emb_i8, e_scale, n_valid, k)
    return _dense_scan_q8_cuda(q_i8, q_scale, emb_i8, e_scale, n_valid, k,
                               sm90=None)


def _dense_scan_q8_first_body(q_i8, q_scale, emb_i8, e_scale, n_valid: int,
                              k: int):
    """K5's first body (the int8 form of csrc/dense_topk.cu) on a CUDA
    corpus that the route would send to the wgmma body: called by name
    only to time the two bodies on the same inputs."""
    return _dense_scan_q8_cuda(q_i8, q_scale, emb_i8, e_scale, n_valid, k,
                               sm90=False)


def _dense_scan_q8_cuda(q_i8, q_scale, emb_i8, e_scale, n_valid: int, k: int,
                        sm90):
    """Launch one of K5's bodies: sm90 None routes by ``q8_sm90_route``,
    False takes the first body."""
    if emb_i8.device.type != "cuda":
        raise ValueError(f"dense_scan_q8: unsupported device {emb_i8.device}")
    tensors = (q_i8, q_scale, emb_i8, e_scale)
    if any(x.device != emb_i8.device for x in tensors):
        raise ValueError("dense_scan_q8: inputs on different devices")
    if q_i8.dtype != torch.int8 or emb_i8.dtype != torch.int8:
        raise TypeError("dense_scan_q8: query and corpus codes must be int8")
    if q_scale.dtype != torch.float32 or e_scale.dtype != torch.float32:
        raise TypeError("dense_scan_q8: scales must be float32")
    if q_i8.dim() != 2 or emb_i8.dim() != 2 or q_i8.shape[1] != emb_i8.shape[1]:
        raise ValueError("dense_scan_q8: expected (B, D) and (N, D) codes")
    b, d = q_i8.shape
    n = emb_i8.shape[0]
    if q_scale.shape != (b,) or e_scale.shape != (n,):
        raise ValueError("dense_scan_q8: expected (B,) and (N,) scales")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("dense_scan_q8: inputs must be contiguous")
    n_valid = int(n_valid)
    if k < 1 or not 0 <= n_valid <= n:
        raise ValueError(f"dense_scan_q8: bad k={k} or n_valid={n_valid} "
                         f"for {n} rows")
    dev = emb_i8.device
    out_v = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    if b == 0:
        return out_v, out_i
    if sm90 is None:
        sm90 = q8_sm90_route(d, q_i8.data_ptr(), emb_i8.data_ptr())
    lib = load_kernels()
    if sm90:
        # sm90_splits counts 128-query tiles; the 32-query tile serves
        # B <= 32, one tile either way.
        splits = sm90_splits(b, n_valid, k, _sm_count(dev))
        fn, head = lib.tr_dense_topk_q8_sm90, (q8_sm90_tile(b, d),)
    else:
        splits = dense_splits(b, n_valid, k)
        fn, head = lib.tr_dense_topk_q8, ()
    part_v = torch.empty((b, splits, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((b, splits, k), dtype=torch.int32, device=dev)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * (6 + len(head))
                   + [ctypes.c_void_p] * 5)
    err = fn(q_i8.data_ptr(), emb_i8.data_ptr(), e_scale.data_ptr(), b, n, d,
             n_valid, k, *head, splits, part_v.data_ptr(), part_i.data_ptr(),
             out_v.data_ptr(), out_i.data_ptr(), cuda_stream(dev))
    check_launch(err, "dense_scan_q8")
    # Every K5 launch counts under dense_scan_q8; the wgmma body's also
    # under dense_scan_q8_sm90, so a run shows which body ran.
    launch_counts["dense_scan_q8"] += 1
    if sm90:
        launch_counts["dense_scan_q8_sm90"] += 1
    return out_v * q_scale[:, None], out_i


def gather_scores_ref(queries, emb, cand_ids):
    """Plain version of K8: gather the candidate rows (ids < 0 read row 0
    and score garbage, masked downstream), then an fp32 einsum."""
    rows = emb[cand_ids.clamp_min(0).long()].float()        # (B, M, D)
    return torch.einsum("bd,bmd->bm", queries.float(), rows)


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    """K8's C entry points, their argument types set once."""
    fn = getattr(load_kernels(), name)
    fn.restype = ctypes.c_int
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = {
        "tr_gather_scores": [ptr, ptr, i32, ptr] + [i32] * 4 + [ptr, ptr],
        "tr_rescore_topk": [ptr, ptr, i32, ptr] + [i32] * 5 + [ptr] * 3,
    }[name]
    return fn


def _check_rescore_inputs(name, queries, emb, cand_ids):
    """K8's wrappers' checks on CUDA tensors (raise on what the kernel does
    not take)."""
    if emb.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {emb.device}")
    if queries.device != emb.device or cand_ids.device != emb.device:
        raise ValueError(f"{name}: inputs on different devices")
    if emb.dtype not in DTYPE_CODE:
        raise TypeError(f"{name}: corpus dtype {emb.dtype} not supported by "
                        "the kernel (bfloat16 or float32)")
    if queries.dtype != torch.float32 or cand_ids.dtype != torch.int32:
        raise TypeError(f"{name}: queries float32, ids int32")
    if (queries.dim() != 2 or emb.dim() != 2 or cand_ids.dim() != 2
            or queries.shape[1] != emb.shape[1]
            or cand_ids.shape[0] != queries.shape[0]):
        raise ValueError(f"{name}: expected (B, D), (N, D), (B, M)")
    if not (queries.is_contiguous() and emb.is_contiguous()
            and cand_ids.is_contiguous()):
        raise ValueError(f"{name}: inputs must be contiguous")


def gather_scores(queries, emb, cand_ids):
    """(B, M) fp32 dot of each (B, D) fp32 query with its candidate rows
    of the (N, D) storage-dtype corpus; cand_ids (B, M) int32, ids < 0
    score garbage (mask downstream). CPU tensors take the plain version;
    CUDA tensors launch K8's dots (csrc/gather_scores.cu) or raise."""
    if emb.device.type == "cpu":
        return gather_scores_ref(queries, emb, cand_ids)
    _check_rescore_inputs("gather_scores", queries, emb, cand_ids)
    b, d = queries.shape
    m = cand_ids.shape[1]
    out = torch.empty((b, m), dtype=torch.float32, device=emb.device)
    if b * m == 0:
        return out
    err = _entry("tr_gather_scores")(
        queries.data_ptr(), emb.data_ptr(), DTYPE_CODE[emb.dtype],
        cand_ids.data_ptr(), b, m, emb.shape[0], d, out.data_ptr(),
        cuda_stream(emb.device))
    check_launch(err, "gather_scores")
    launch_counts["gather_scores"] += 1
    return out


def rescore_topk_ref(queries, emb, cand_ids, k: int):
    """Plain version of the rescore: the exact dots, ids sorted stably
    first, so a duplicate candidate keeps its first lane and ties go to the
    smaller id; -1 ids and duplicates are no candidate. Returns (B, k) fp32
    / int32, empties (NEG_INF, -1)."""
    return _top_unique(gather_scores_ref(queries, emb, cand_ids), cand_ids, k)


def _top_unique(s, cand_ids, k: int):
    """The rescore after the dots s (B, M): top-k of the unique live
    candidates, as ``rescore_topk_ref`` describes."""
    valid = cand_ids >= 0
    s = torch.where(valid, s, NEG_INF)
    order = torch.argsort(torch.where(valid, cand_ids, _BIG), dim=1,
                          stable=True)
    s = torch.gather(s, 1, order)
    ci = torch.gather(cand_ids, 1, order)
    dup = torch.zeros_like(valid)
    dup[:, 1:] = ci[:, 1:] == ci[:, :-1]
    s = torch.where(dup, NEG_INF, s)
    if s.shape[1] < k:
        pad = k - s.shape[1]
        s = torch.nn.functional.pad(s, (0, pad), value=NEG_INF)
        ci = torch.nn.functional.pad(ci, (0, pad), value=-1)
    vals, pos = torch.sort(s, dim=1, descending=True, stable=True)
    vals = vals[:, :k].contiguous()
    ids = torch.gather(ci, 1, pos[:, :k])
    return vals, torch.where(vals <= NEG_INF / 2, -1, ids)


def rescore_topk(queries, emb, cand_ids, k: int):
    """Exact rescore of candidate ids against the full-precision corpus.

    queries (B, D) fp32 (normalized), emb (N, D) storage dtype, cand_ids
    (B, M) int32 with -1 = no candidate. Re-ranks by the exact dot, each
    id once, ties to the smaller id. Returns (B, k) fp32 / int32, empties
    (NEG_INF, -1). CPU tensors take ``rescore_topk_ref``; CUDA tensors
    launch K8's rescore (csrc/gather_scores.cu), one launch for the dots,
    the duplicate marking and the top-k, or raise (M up to
    RESCORE_MAX_M)."""
    if emb.device.type == "cpu":
        return rescore_topk_ref(queries, emb, cand_ids, k)
    queries, cand_ids = queries.float().contiguous(), cand_ids.contiguous()
    _check_rescore_inputs("rescore_topk", queries, emb, cand_ids)
    b, d = queries.shape
    m = cand_ids.shape[1]
    if k < 1 or m > RESCORE_MAX_M:
        raise ValueError(f"rescore_topk: k={k} or M={m} candidates outside "
                         f"the kernel's range (k >= 1, M <= {RESCORE_MAX_M})")
    out_v = torch.empty((b, k), dtype=torch.float32, device=emb.device)
    out_i = torch.empty((b, k), dtype=torch.int32, device=emb.device)
    if b == 0:
        return out_v, out_i
    if m == 0:
        return out_v.fill_(NEG_INF), out_i.fill_(-1)
    err = _entry("tr_rescore_topk")(
        queries.data_ptr(), emb.data_ptr(), DTYPE_CODE[emb.dtype],
        cand_ids.data_ptr(), b, m, emb.shape[0], d, k, out_v.data_ptr(),
        out_i.data_ptr(), cuda_stream(emb.device))
    check_launch(err, "rescore_topk")
    launch_counts["rescore_topk"] += 1
    return out_v, out_i


def dense_topk_q8(queries, emb_i8, e_scale, n_valid: int, k: int, *,
                  rescore_emb=None, overfetch: int = 2):
    """Quantized dense top-k with optional exact rescoring.

    queries: (B, D) float, L2-normalized by the caller. With rescore_emb
    (the full-precision (N, D) matrix) the int8 pass overfetches
    m = min(overfetch * k, N) candidates and the final (scores, ids) are
    exact cosines from ``rescore_topk``."""
    q_i8, q_scale = quantize_rows(queries)
    m = (min(overfetch * k, int(emb_i8.shape[0])) if rescore_emb is not None
         else k)
    vals, ids = dense_scan_q8(q_i8, q_scale, emb_i8, e_scale, n_valid, m)
    if rescore_emb is None:
        return vals, ids
    # Both scan paths give ids == -1 for padding / no-candidate slots, so
    # the ids feed the rescore directly.
    return rescore_topk(queries.float(), rescore_emb, ids, k)
