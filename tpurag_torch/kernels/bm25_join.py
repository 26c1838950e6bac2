# Ported from tpurag/kernels/bm25_join.py (window_segsum, tiled_topk,
# dedup_topk, combine_narrow_wide, bsearch_last, join_add,
# combine_narrow_wide_bsearch); combine_topk_classes and combine_topk
# are the K4 wrappers.
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
windowed segment sum, and a top-k. ``combine_topk_classes`` combines a
whole batch of wide classes (the wide path's one call per request); its
plain version ``combine_classes_ref`` runs combine_narrow_wide per class.
On CUDA tensors it launches K4 (csrc/bm25_combine.cu) once: blocks over
(member row, wide chunk) work items, a merge-path join of bulk-copied
rows, per-item and per-row top-k, bit-identical to the plain version; on
CPU tensors it runs the plain version. ``combine_topk`` is its one-class
case. ``combine_narrow_wide_bsearch`` is a second exact reference for the
tests.

The JAX package's pair-row combine (combine_pairs_batched,
combine_narrow_wide_tiled) exists because a TPU kernel could not hold a
32768-lane row; K4 computes the same function directly, so it is not
carried over.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tpurag_torch.kernels.runtime import (NEG_INF, check_launch, cuda_stream,
                                          launch_counts, load_kernels)

_BIG = 2**30
# csrc/bm25_combine.cu's shapes: warps per block (one running list of k
# keys each), wide lanes per work item, and the most bytes of warp lists
# held in shared memory (past it they live in a device-memory scratch).
_K4_WARPS = 8
_K4_CHUNK = 4096
_K4_SMEM_LISTS = 64 * 1024


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


def combine_classes_ref(n_val, n_doc, classes, k: int, window: int = 12):
    """Plain version of the batched K4: ``combine_narrow_wide`` per wide
    class on its members' narrow rows, scattered into the (H, k) result.
    classes: (w_seg, w_doc, sel, wn) per class, as combine_topk_classes
    takes them (wn is not needed: the narrow rows' padding is parked)."""
    h = n_val.shape[0]
    out_v = torch.full((h, k), NEG_INF, dtype=torch.float32,
                       device=n_val.device)
    out_i = torch.full((h, k), -1, dtype=torch.int32, device=n_val.device)
    for w_seg, w_doc, sel, _ in classes:
        sel_t = torch.as_tensor(_members(sel, w_seg.shape[0]),
                                device=n_val.device)
        s, i = combine_narrow_wide(n_val[sel_t], n_doc[sel_t], w_seg, w_doc,
                                   k, window)
        out_v[sel_t] = s
        out_i[sel_t] = i
    return out_v, out_i


def _members(sel, g: int) -> np.ndarray:
    """A class's narrow / output rows as a host int64 array (None: 0..g-1)."""
    if sel is None:
        return np.arange(g, dtype=np.int64)
    if isinstance(sel, torch.Tensor):
        sel = sel.cpu().numpy()
    return np.asarray(sel, dtype=np.int64).reshape(-1)


def _k4_table(n_val, classes, chunk: int = _K4_CHUNK):
    """K4's row table and item list as one int64 host array: per member a
    RowEntry (csrc/bm25_combine.cu: wide row pointers, wide width, narrow
    / output row, own narrow width, first item, item count, a zero
    counter), then per item (row << 32 | chunk index). Returns (table,
    n_rows, n_items)."""
    h, wn_max = n_val.shape
    blocks, sels = [], []
    first = 0
    for w_seg, w_doc, sel, wn in classes:
        g, ww = w_seg.shape
        members = _members(sel, g)
        widths = (np.full(g, wn_max, np.int64) if wn is None
                  else np.asarray(wn, np.int64).reshape(-1))
        if len(members) != g or len(widths) != g:
            raise ValueError("combine_topk_classes: sel / wn must give one "
                             "entry per wide row")
        if ((widths < 1) | (widths > wn_max)).any():
            raise ValueError(f"combine_topk_classes: narrow widths outside "
                             f"[1, {wn_max}]")
        n_it = -(-ww // chunk)
        rows = np.zeros((g, 8), np.int64)
        stride = np.arange(g, dtype=np.int64) * ww * 4
        rows[:, 0] = w_seg.data_ptr() + stride
        rows[:, 1] = w_doc.data_ptr() + stride
        rows[:, 2] = ww
        rows[:, 3] = members
        rows[:, 4] = widths
        rows[:, 5] = first + np.arange(g, dtype=np.int64) * n_it
        rows[:, 6] = n_it
        blocks.append(rows)
        sels.append(members)
        first += g * n_it
    rows = np.concatenate(blocks)
    sel_all = np.concatenate(sels)
    if (len(sel_all) != h or (sel_all < 0).any() or (sel_all >= h).any()
            or np.bincount(sel_all, minlength=h).max() != 1):
        raise ValueError("combine_topk_classes: every narrow row must belong "
                         "to exactly one class")
    n_items = rows[:, 6]
    row_of = np.repeat(np.arange(len(rows), dtype=np.int64), n_items)
    chunk_of = np.arange(first, dtype=np.int64) - np.repeat(rows[:, 5],
                                                            n_items)
    table = np.concatenate([rows.reshape(-1), (row_of << 32) | chunk_of])
    return table, len(rows), int(first)


def _k4_prepare(n_val, classes, k: int, chunk: int = _K4_CHUNK) -> dict:
    """Everything one K4 launch needs but the rows: the table, uploaded in
    one copy from pinned memory (no stream sync on the host), the outputs
    and the scratch. The kernel leaves the table's counters at zero, so a
    prepared launch can be repeated."""
    dev = n_val.device
    table, n_rows, n_items = _k4_table(n_val, classes, chunk)
    h = n_val.shape[0]
    return {"table": torch.from_numpy(table).pin_memory().to(
                dev, non_blocking=True),
            "n_rows": n_rows, "n_items": n_items, "k": k,
            "out_v": torch.empty((h, k), dtype=torch.float32, device=dev),
            "out_i": torch.empty((h, k), dtype=torch.int32, device=dev),
            "ilist": torch.empty((n_items, k), dtype=torch.int64, device=dev),
            "glists": (torch.empty((n_items, _K4_WARPS, k),
                                   dtype=torch.int64, device=dev)
                       if _K4_WARPS * k * 8 > _K4_SMEM_LISTS else None)}


def _k4_run(fn, prep: dict, n_val, n_doc) -> int:
    """Launch K4 through the C entry `fn` (tr_combine_topk_classes or a
    copy of it) on a prepared launch; returns its cudaError_t."""
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
    glists = prep["glists"]
    return fn(n_val.data_ptr(), n_doc.data_ptr(), n_val.shape[1],
              prep["table"].data_ptr(), prep["n_rows"], prep["n_items"],
              prep["k"], prep["ilist"].data_ptr(),
              None if glists is None else glists.data_ptr(),
              prep["out_v"].data_ptr(), prep["out_i"].data_ptr(),
              cuda_stream(n_val.device))


def combine_topk_classes(n_val, n_doc, classes, k: int, window: int = 12):
    """(H, k) exact top-k (scores, ids) of per-doc narrow + wide totals for
    a batch of wide classes, empties as (NEG_INF, -1).

    n_val / n_doc: (H, Wn) narrow full rows. classes: (w_seg, w_doc, sel,
    wn) per wide class: its (g, Ww) wide full rows, the g narrow rows (and
    output rows) of its members (host ints; None = 0..g-1) and each
    member's own narrow width (host ints, <= Wn, lanes past it parked;
    None = Wn). Every narrow row belongs to exactly one class. CPU tensors
    take ``combine_classes_ref`` (`window`: the most lanes one doc spans on
    the two sides); CUDA tensors launch K4 once (csrc/bm25_combine.cu),
    or raise."""
    if n_val.device.type == "cpu":
        return combine_classes_ref(n_val, n_doc, classes, k, window)
    if n_val.device.type != "cuda":
        raise ValueError(f"combine_topk: unsupported device {n_val.device}")
    wides = [x for cls in classes for x in cls[:2]]
    if any(x.device != n_val.device for x in [n_doc, *wides]):
        raise ValueError("combine_topk: inputs on different devices")
    if (n_val.dtype != torch.float32 or n_doc.dtype != torch.int32
            or any(x.dtype != torch.float32 for x in wides[0::2])
            or any(x.dtype != torch.int32 for x in wides[1::2])):
        raise TypeError("combine_topk: sums must be float32, docs int32")
    if (n_val.dim() != 2 or n_val.shape != n_doc.shape
            or any(w.dim() != 2 or w.shape != d.shape
                   for w, d in zip(wides[0::2], wides[1::2]))):
        raise ValueError("combine_topk: expected (H, Wn) narrow and (g, Ww) "
                         "wide rows")
    if not all(x.is_contiguous() for x in [n_val, n_doc, *wides]):
        raise ValueError("combine_topk: inputs must be contiguous")
    h, wn = n_val.shape
    if (not classes or wn < 1 or k < 1
            or any(w.shape[1] < 1 for w in wides[0::2])):
        raise ValueError(f"combine_topk: bad classes, Wn={wn} or k={k}")
    prep = _k4_prepare(n_val, classes, k)
    check_launch(_k4_run(load_kernels().tr_combine_topk_classes, prep, n_val,
                         n_doc), "combine_topk")
    launch_counts["combine_topk"] += 1
    return prep["out_v"], prep["out_i"]


def combine_topk(n_val, n_doc, w_seg, w_doc, k: int, window: int = 12):
    """(G, k) exact top-k (scores, ids) of per-doc narrow + wide totals of
    one wide class, empties as (NEG_INF, -1): combine_topk_classes with
    one class. CPU tensors take ``combine_narrow_wide``; CUDA tensors
    launch K4, or raise."""
    if n_val.device.type == "cpu":
        return combine_narrow_wide(n_val, n_doc, w_seg, w_doc, k, window)
    if w_seg.dim() != 2 or w_seg.shape[0] != n_val.shape[0]:
        raise ValueError("combine_topk: expected (G, Wn) narrow and (G, Ww) "
                         "wide rows")
    if n_val.shape[0] == 0:
        return (torch.empty((0, k), dtype=torch.float32, device=n_val.device),
                torch.empty((0, k), dtype=torch.int32, device=n_val.device))
    return combine_topk_classes(n_val, n_doc, [(w_seg, w_doc, None, None)], k,
                                window)
