# Ported from tpurag/kernels/bm25_join.py (window_segsum, tiled_topk,
# dedup_topk, combine_narrow_wide, bsearch_last, join_add,
# combine_narrow_wide_bsearch); combine_topk is the K4 wrapper.
"""Exact narrow+wide BM25 score combination.

BM25 is additive across query terms, so a query's terms can be scored in
independent groups: the narrow terms (bucket width <= wide_term_width)
and the wide ones, each group merged into a full doc-ascending row with
every doc's partial sum at its segment-end lane
(kernels/bm25_merge.merge_segsum_full), provided the partial sums are
combined exactly afterwards.

``combine_narrow_wide`` is the plain version: both rows become (doc,
contribution) lists (invalid lanes contribute 0 at their doc, which keeps
them sorted), one bitonic 2-list merge (kernels/sortmerge.py), a
windowed segment sum, and a top-k. ``combine_topk`` is its wrapper: a
CUDA tensor launches K4 (csrc/bm25_combine.cu), a binary-search join
with a block top-k, which is bit-identical to it; a CPU tensor runs it.
``combine_narrow_wide_bsearch`` is a second exact reference for the
tests.

The JAX package's pair-row combine (combine_pairs_batched,
combine_narrow_wide_tiled) exists because a TPU kernel could not hold a
32768-lane row; K4 computes the same function directly, so it is not
carried over.
"""

from __future__ import annotations

import ctypes

import torch

from tpurag_torch.kernels.runtime import (NEG_INF, check_launch, cuda_stream,
                                          launch_counts, load_kernels)

_BIG = 2**30
# Warps per K4 block (csrc/bm25_combine.cu: THREADS / 32), one running
# list of k entries each.
_K4_WARPS = 32


def _next_pow2(x: int) -> int:
    return 1 << max(x - 1, 0).bit_length()


def _stable_topk(x: torch.Tensor, k: int):
    """Top-k along the last axis, ties to the lower index (lax.top_k's
    order)."""
    vals, pos = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], pos[..., :k]


def bsearch_last(sorted_doc: torch.Tensor, q: torch.Tensor):
    """Per-row binary search: for each q[g, j], the LAST index i with
    sorted_doc[g, i] == q[g, j] (the segment-end lane), else found=False.

    sorted_doc: (G, W) monotone int32; q: (G, Q) int32. Returns (pos,
    found) with pos clipped to [0, W)."""
    g, w = sorted_doc.shape
    lo = torch.full(q.shape, -1, dtype=torch.int64, device=q.device)
    hi = torch.full(q.shape, w, dtype=torch.int64, device=q.device)
    for _ in range(max(1, (w + 1).bit_length())):
        mid = (lo + hi) >> 1
        dv = torch.gather(sorted_doc, 1, mid.clamp(0, w - 1))
        le = dv <= q
        open_ = hi - lo > 1
        lo = torch.where(le & open_, mid, lo)
        hi = torch.where(~le & open_, mid, hi)
    pos = lo.clamp(0, w - 1)
    dv = torch.gather(sorted_doc, 1, pos)
    return pos, (lo >= 0) & (dv == q)


def join_add(n_val, n_doc, w_seg, w_doc):
    """Each narrow lane's sum plus its doc's wide sum (where the wide row
    has the doc); non-end and parked narrow lanes stay near NEG_INF."""
    pos, found = bsearch_last(w_doc, n_doc)
    wv = torch.gather(w_seg, 1, pos)
    return n_val + torch.where(found & (wv > NEG_INF / 2), wv, 0.0)


def dedup_topk(vals, ids, k: int):
    """Top-k by value over (G, M) lanes with duplicate ids resolved to
    their max value. Empty lanes: val <= NEG_INF/2 or id < 0."""
    g, m = vals.shape
    # Ascending (id, val): sort by val, then stably by id.
    o1 = torch.argsort(vals, dim=1, stable=True)
    i1 = torch.gather(ids, 1, o1)
    o2 = torch.argsort(i1, dim=1, stable=True)
    ids_s = torch.gather(i1, 1, o2)
    vals_s = torch.gather(torch.gather(vals, 1, o1), 1, o2)
    # The last lane of each id-run holds its max.
    nxt = torch.cat([ids_s[:, 1:], torch.full((g, 1), -2, dtype=ids_s.dtype,
                                              device=ids_s.device)], dim=1)
    keep = (ids_s != nxt) & (ids_s >= 0) & (vals_s > NEG_INF / 2)
    masked = torch.where(keep, vals_s, NEG_INF)
    kk = min(k, m)
    v, pos = _stable_topk(masked, kk)
    i = torch.gather(ids_s, 1, pos)
    empty = v <= NEG_INF / 2
    v = torch.where(empty, NEG_INF, v)
    i = torch.where(empty, -1, i)
    if kk < k:
        v = torch.nn.functional.pad(v, (0, k - kk), value=NEG_INF)
        i = torch.nn.functional.pad(i, (0, k - kk), value=-1)
    return v, i


def window_segsum(doc: torch.Tensor, con: torch.Tensor, window: int):
    """Per-doc totals at segment-END lanes over a doc-ascending row where
    each doc spans at most `window` lanes: window-1 shift-adds. Returns
    (seg, is_end): seg = total at end lanes, NEG_INF elsewhere."""
    g, w = doc.shape
    nxt = torch.cat([doc[:, 1:], torch.full((g, 1), -1, dtype=doc.dtype,
                                            device=doc.device)], dim=1)
    is_end = doc != nxt
    total = con
    for j in range(1, min(window, w)):
        dj = torch.cat([torch.full((g, j), -1, dtype=doc.dtype,
                                   device=doc.device), doc[:, :-j]], dim=1)
        cj = torch.cat([torch.zeros((g, j), dtype=con.dtype,
                                    device=con.device), con[:, :-j]], dim=1)
        total = total + torch.where(dj == doc, cj, 0.0)
    return torch.where(is_end, total, NEG_INF), is_end


def tiled_topk(seg: torch.Tensor, doc: torch.Tensor, k: int,
               tile: int = 4096):
    """Exact top-k over very wide rows in two stages: per-tile top-k (the
    global top-k is a subset of the per-tile winners), then top-k of the
    (G, W/tile * k) survivors. Ties go to the lower lane, as in one
    top-k over the whole row."""
    g, w = seg.shape
    if w < k:
        seg = torch.nn.functional.pad(seg, (0, k - w), value=NEG_INF)
        doc = torch.nn.functional.pad(doc, (0, k - w), value=_BIG)
        w = k
    if w <= 2 * tile or w % tile:
        vals, pos = _stable_topk(seg, k)
        return vals, torch.gather(doc, 1, pos)
    m = w // tile
    v1, p1 = _stable_topk(seg.reshape(g * m, tile), k)
    i1 = torch.gather(doc.reshape(g * m, tile), 1, p1)
    v2, p2 = _stable_topk(v1.reshape(g, m * k), k)
    i2 = torch.gather(i1.reshape(g, m * k), 1, p2)
    return v2, i2


def combine_narrow_wide(n_val, n_doc, w_seg, w_doc, k: int,
                        window: int = 12):
    """Plain version of K4: gather-free exact combine -> (G, k) (vals,
    ids). n_val/n_doc (G, Wn), w_seg/w_doc (G, Ww): doc-ascending rows
    with per-doc partial sums at valid lanes (> NEG_INF/2), parked lanes
    at doc=2^30. `window` bounds how many lanes one doc spans on the two
    sides combined (callers pass max narrow t + wide t)."""
    from tpurag_torch.kernels.sortmerge import merge_sorted_lists

    g, wn = n_val.shape
    ww = w_seg.shape[1]
    # Valid lanes carry their sum; every other lane contributes 0 at its
    # existing doc id, which keeps both rows doc-ascending.
    cn = torch.where(n_val > NEG_INF / 2, n_val, 0.0)
    cw = torch.where(w_seg > NEG_INF / 2, w_seg, 0.0)
    dn, dw = n_doc, w_doc
    p = _next_pow2(max(wn, ww))
    if wn < p:
        dn = torch.nn.functional.pad(dn, (0, p - wn), value=_BIG)
        cn = torch.nn.functional.pad(cn, (0, p - wn))
    if ww < p:
        dw = torch.nn.functional.pad(dw, (0, p - ww), value=_BIG)
        cw = torch.nn.functional.pad(cw, (0, p - ww))
    doc, con = merge_sorted_lists(torch.stack([dn, dw], dim=1),
                                  torch.stack([cn, cw], dim=1))
    tot, _ = window_segsum(doc, con, window)
    seg = torch.where((doc < _BIG) & (tot > 0.0), tot, NEG_INF)
    vals, ids = tiled_topk(seg, doc, k)
    ids = ids.to(torch.int32)
    empty = vals <= NEG_INF / 2
    return torch.where(empty, NEG_INF, vals), torch.where(empty, -1, ids)


def combine_narrow_wide_bsearch(n_val, n_doc, w_seg, w_doc, k: int):
    """Binary-search-join form: joined-narrow top-k union raw-wide
    top-2k, deduplicated. Exact by the union argument; a second
    reference for the tests."""
    joined = join_add(n_val, n_doc, w_seg, w_doc)
    kn = min(k, joined.shape[1])
    jv, jpos = _stable_topk(joined, kn)
    ji = torch.gather(n_doc, 1, jpos)
    ji = torch.where(jv > NEG_INF / 2, ji, -1)
    kw = min(2 * k, w_seg.shape[1])
    wv, wpos = _stable_topk(w_seg, kw)
    wi = torch.gather(w_doc, 1, wpos)
    wi = torch.where((wv > NEG_INF / 2) & (wi < _BIG), wi, -1)
    return dedup_topk(torch.cat([jv, wv], dim=1),
                      torch.cat([ji, wi], dim=1), k)


def combine_topk(n_val, n_doc, w_seg, w_doc, k: int, window: int = 12):
    """(G, k) exact top-k (scores, ids) of per-doc narrow + wide totals,
    empties as (NEG_INF, -1). CPU tensors take ``combine_narrow_wide``;
    CUDA tensors launch K4 (csrc/bm25_combine.cu), whose binary-search
    join needs no window, or raise."""
    if n_val.device.type == "cpu":
        return combine_narrow_wide(n_val, n_doc, w_seg, w_doc, k, window)
    if n_val.device.type != "cuda":
        raise ValueError(f"combine_topk: unsupported device {n_val.device}")
    tensors = (n_val, n_doc, w_seg, w_doc)
    if any(x.device != n_val.device for x in tensors):
        raise ValueError("combine_topk: inputs on different devices")
    if n_val.dtype != torch.float32 or w_seg.dtype != torch.float32 or (
            n_doc.dtype != torch.int32 or w_doc.dtype != torch.int32):
        raise TypeError("combine_topk: sums must be float32, docs int32")
    if (n_val.dim() != 2 or n_val.shape != n_doc.shape
            or w_seg.shape != w_doc.shape or w_seg.shape[0] != n_val.shape[0]):
        raise ValueError("combine_topk: expected (G, Wn) narrow and (G, Ww) "
                         "wide rows")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("combine_topk: inputs must be contiguous")
    g, wn = n_val.shape
    ww = w_seg.shape[1]
    if wn < 1 or ww < 1 or k < 1:
        raise ValueError(f"combine_topk: bad Wn={wn}, Ww={ww} or k={k}")
    dev = n_val.device
    out_v = torch.empty((g, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((g, k), dtype=torch.int32, device=dev)
    if g == 0:
        return out_v, out_i
    list_v = torch.empty((g, _K4_WARPS, k), dtype=torch.float32, device=dev)
    list_i = torch.empty((g, _K4_WARPS, k), dtype=torch.int32, device=dev)
    fn = load_kernels().tr_combine_topk
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    err = fn(n_val.data_ptr(), n_doc.data_ptr(), g, wn, w_seg.data_ptr(),
             w_doc.data_ptr(), ww, k, list_v.data_ptr(), list_i.data_ptr(),
             out_v.data_ptr(), out_i.data_ptr(), cuda_stream(dev))
    check_launch(err, "combine_topk")
    launch_counts["combine_topk"] += 1
    return out_v, out_i
