# Ported from tpurag/kernels/bm25_pallas.py (merge_segsum_topk,
# merge_segsum_full and bm25_topk_fused, the forms of _merge_segsum_kernel,
# and pallas_merge_ok).
"""Fused BM25 merge + segment sum: top-k (K2, K2') and full rows (K3).

Per query row, t doc-sorted term lists (at most one lane per doc in each)
merge into one doc-sorted row and each doc's contributions are summed;
then either the top-k (K2: ``merge_segsum_topk_classes``, one launch for
every narrow class of a search, csrc/bm25_topk.cu) or the full row with
each doc's partial sum at its segment-end lane (K3:
``merge_segsum_full_classes``, csrc/bm25_full.cu, the input of the exact
narrow+wide combine in kernels/bm25_join.py). Both read the lists straight
from the bucket matrices through a table of slots, and merge by (doc,
slot): a doc's sum starts at its last slot's contribution and adds the
earlier ones going down. The JAX package's Pallas kernel merges with a
bitonic network instead, which adds the same lanes in its own order
(scores agree to float32 rounding). On a CUDA tensor each wrapper
launches its hand-written kernel; on a CPU tensor it runs its plain
version (``*_ref``): a stable sort by (doc, slot) and the same sums, bit
for bit.

cbits > 0 quantises each contribution as the JAX package's packed layout
does: q = round(con / max(rowmax, 1e-30) * qmax), qmax = 2^cbits - 1,
half-to-even rounding, q clamped to [0, qmax] as an integer, summed as
q * (max(rowmax, 1e-30) / qmax); docs >= (2^31 - 1) >> cbits park.

``merge_segsum_topk`` and ``merge_segsum_full`` take candidate rows
instead, (B, t*p) doc / con of t P-blocks (invalid lanes parked at doc
2^30 with contribution 0, each block doc-ascending; merge_segsum_topk's
odd blocks DESCENDING, the Pallas kernel's input) and run the same
kernels on them through a one-class table. K3's t == 1 rows come back as
(where(doc < 2^30, con, NEG_INF), doc) without a launch. No path of the
port calls these two; they stay because they take the JAX functions'
arguments, so the parity tests and chip_smoke.py's row checks hold the
classed kernels to the Pallas kernels through them.

``bm25_topk_fused`` (K2') keeps the TPU kernel's form: the bitonic
network of T gathered CSR windows (odd terms flipped), the T-window sum
and a top-k (csrc/bm25_merge.cu), the gather done by the kernel itself so
the candidate rows never reach device memory. The kernel runs the
network on a row's live lanes only: pad lanes hold the row's largest
value and a lane moves only on a strict compare, so pads never move and
a live lane facing one ends on the comparator's min side, which gives
the full network's row bit for bit (rows whose windows fill more than
half the lanes take the full network).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from tpurag_torch.kernels.bm25 import bm25_topk_segsum, gather_candidates
from tpurag_torch.kernels.runtime import (NEG_INF, check_launch, cuda_stream,
                                          launch_counts, load_kernels)
from tpurag_torch.kernels.topk import select_topk

_BIG = 2**30
_PAD_KEY = 2**31 - 1

# Widest row K2 and K2' take: 16384 live lanes fit one block's shared
# memory (8 bytes a lane staged, 4 for the merge orders). The JAX package
# has the same boundary (PALLAS_MAX_MERGE_LANES), so both packages route
# the same queries; wider rows take kernels/bm25.segsum_topk_candidates.
MAX_MERGE_LANES = 1 << 14
# K2 (csrc/bm25_topk.cu): the most slots a row holds, a block's most
# threads, and its most dynamic shared memory (sm90.cuh's MAX_SMEM less 1 KB
# for the kernel's own).
_K2_MAX_T = MAX_MERGE_LANES // 16
_K2_THREADS = 1024
_K2_SMEM = 232448 - 1024
# K3 (csrc/bm25_full.cu): output lanes per work item, and the most term
# slots one full row merges.
_K3_CHUNK = 4096
K3_MAX_T = 512


def merge_ok(w: int) -> bool:
    """True if a (B, w) candidate row goes to the fused merge."""
    return w <= MAX_MERGE_LANES


def _pack(doc: torch.Tensor, con: torch.Tensor, cbits: int):
    qmax = (1 << cbits) - 1
    pad_doc = _PAD_KEY >> cbits
    safe = torch.clamp_min(con.amax(dim=1, keepdim=True), 1e-30)
    # Clamp in integers: past cbits = 24 float32 cannot hold qmax, and a
    # float clamp would let the row max round up to 2^cbits and spill
    # into the doc bits (the JAX package's packed merge does, for
    # corpora under 63 docs).
    qv = torch.round(con / safe * qmax).to(torch.int64).clamp(0, qmax)
    qv = qv.to(torch.int32)
    key = torch.where(doc < pad_doc, (doc << cbits) | qv, _PAD_KEY)
    # A tensor divisor: PyTorch's CUDA division by a Python scalar is a
    # reciprocal multiply, which is not the kernel's (or JAX's) division.
    return key, safe / torch.full_like(safe, qmax)


def _bitonic_rows(doc: torch.Tensor, con: torch.Tensor, p: int, t: int,
                  cbits: int):
    """K2''s network and sums: bitonic merge of flipped rows from block
    size 2p up to W, then the t-window segment sum. Returns (seg, doc_s,
    big): seg holds each doc's sum at its segment-end lane, NEG_INF
    elsewhere; doc_s is the merged doc row; lanes with doc_s >= big are
    parked."""
    b, w = doc.shape
    lane = torch.arange(w, device=doc.device)
    if cbits:
        key, scale = _pack(doc, con, cbits)
        arrays = [key]
    else:
        arrays = [doc, con]
    kk = 2 * p
    while kk <= w:
        s = kk // 2
        while s >= 1:
            upper = (lane & s) != 0
            partner = torch.where(upper, lane - s, lane + s)
            nbrs = [x[:, partner] for x in arrays]
            want_min = ((lane & kk) == 0) ^ upper
            take = ((want_min & (nbrs[0] < arrays[0]))
                    | (~want_min & (nbrs[0] > arrays[0])))
            arrays = [torch.where(take, nx, x) for nx, x in zip(nbrs, arrays)]
            s //= 2
        kk *= 2
    if cbits:
        key = arrays[0]
        doc_s = key >> cbits            # keys are >= 0: arithmetic == logical
        con_s = (key & ((1 << cbits) - 1)).float() * scale
        big = _PAD_KEY >> cbits
    else:
        doc_s, con_s = arrays
        big = _BIG
    return _window_sums(doc_s, con_s, t, big), doc_s, big


def _window_sums(doc_s: torch.Tensor, con_s: torch.Tensor, t: int, big: int):
    """Each doc's sum at its segment-end lane of a merged (B, W) row (a
    doc spans at most t lanes), NEG_INF elsewhere and at parked lanes
    (doc_s >= big): the end lane's contribution, then the t - 1 lanes
    before it that hold the same doc, nearest first."""
    w = doc_s.shape[1]
    lane = torch.arange(w, device=doc_s.device)
    nxt = torch.roll(doc_s, -1, dims=1)
    is_end = (doc_s != nxt) | (lane == w - 1)
    total = con_s
    for j in range(1, t):
        dj = torch.roll(doc_s, j, dims=1)
        cj = torch.roll(con_s, j, dims=1)
        total = total + torch.where((dj == doc_s) & (lane >= j), cj, 0.0)
    return torch.where(is_end & (doc_s < big), total, NEG_INF)


def _topk_positive(seg: torch.Tensor, doc_s: torch.Tensor, k: int):
    """select_topk of the segment sums, scores <= 0 as (NEG_INF, -1)."""
    vals, ids = select_topk(seg, doc_s, k)
    empty = vals <= 0.0
    return torch.where(empty, NEG_INF, vals), torch.where(empty, -1, ids)


def _bitonic_topk_ref(doc: torch.Tensor, con: torch.Tensor, k: int, p: int,
                      t: int, cbits: int):
    """K2''s top-k over flipped rows: its network, its window sums (the
    JAX package's T-window rule, kept on unsorted windows too) and
    select_topk, which takes each doc once."""
    seg, doc_s, _ = _bitonic_rows(doc, con, p, t, cbits)
    return _topk_positive(seg, doc_s, k)


def merge_segsum_topk_ref(doc: torch.Tensor, con: torch.Tensor, k: int,
                          p: int, t: int = 1, cbits: int = 0):
    """Plain version of K2 on flipped candidate rows (merge_segsum_topk's
    input): the odd blocks turned back, the rows merged and summed as
    merge_segsum_full_ref does (packed when cbits > 0, at t == 1 too), and
    the top-k of the positive sums."""
    if t > 1:
        doc, con = flip_odd_blocks(doc, p, t), flip_odd_blocks(con, p, t)
    return _topk_positive(*_sorted_sums(doc, con, t, cbits), k)


def flip_odd_blocks(x: torch.Tensor, p: int, t: int) -> torch.Tensor:
    """A (B, t*p) row of t doc-ascending p-blocks with every odd block
    reversed, so each 2p block is bitonic (merge_segsum_topk's input)."""
    b = x.shape[0]
    x4 = x.reshape(b, t // 2, 2, p)
    return torch.stack([x4[:, :, 0], x4[:, :, 1].flip(-1)], dim=2).reshape(
        b, t * p)


def merge_segsum_full_ref(doc: torch.Tensor, con: torch.Tensor, p: int,
                          t: int = 1, cbits: int = 0):
    """Plain version of K3: the (seg, doc_s) full rows of
    ``merge_segsum_full`` (``_sorted_sums``; t == 1 rows, already merged,
    as they are and never packed)."""
    if t == 1:
        return torch.where(doc < _BIG, con, NEG_INF), doc
    return _sorted_sums(doc, con, t, cbits)


def _sorted_sums(doc: torch.Tensor, con: torch.Tensor, t: int, cbits: int):
    """(seg, doc_s) of (B, W) rows of t doc-ascending slots (parked lanes
    anywhere): the rows merged by (doc, slot), a stable sort of the row by
    doc with the parked lanes (doc >= big: 2^30, or (2^31 - 1) >> cbits
    when packed) at the end; each doc's sum is the t-window sum at its
    segment-end lane (its last slot's contribution first, then the earlier
    slots'). Packed rows (cbits > 0) sum the quantised contributions of
    ``_pack``; doc_s holds 2^30 at parked lanes."""
    big = _PAD_KEY >> cbits if cbits else _BIG
    if cbits:
        key, scale = _pack(doc, con, cbits)
        con = (key & ((1 << cbits) - 1)).float() * scale
    keys = torch.where(doc < big, doc, big)
    keys, order = torch.sort(keys, dim=1, stable=True)
    seg = _window_sums(keys, torch.gather(con, 1, order), t, big)
    return seg, torch.where(keys < big, keys, _BIG).to(torch.int32)


def merge_segsum_topk(doc: torch.Tensor, con: torch.Tensor, k: int, p: int,
                      t: int = 1, cbits: int = 0):
    """(B, k) BM25 top-k (scores, ids) of flipped candidate rows (the
    module's contract: t P-blocks, the odd ones descending; W = t * p),
    empties as (NEG_INF, -1). CPU tensors take the plain version; CUDA
    tensors turn the odd blocks back and launch K2 (csrc/bm25_topk.cu) with
    one class whose slots are the P-blocks at scale 1.0, or raise."""
    if doc.device.type == "cpu":
        return merge_segsum_topk_ref(doc, con, k, p, t, cbits)
    if doc.device.type != "cuda":
        raise ValueError(f"merge_segsum_topk: unsupported device {doc.device}")
    if doc.dtype != torch.int32 or con.dtype != torch.float32:
        raise TypeError("merge_segsum_topk: doc must be int32, con float32")
    if doc.dim() != 2 or doc.shape != con.shape or con.device != doc.device:
        raise ValueError("merge_segsum_topk: doc and con must be equal (B, W) "
                         "tensors on one device")
    if not (doc.is_contiguous() and con.is_contiguous()):
        raise ValueError("merge_segsum_topk: inputs must be contiguous")
    b, w = doc.shape
    if p < 1 or p & (p - 1) or t < 1 or t & (t - 1) or w != t * p:
        raise ValueError(f"merge_segsum_topk: W={w}, p={p}, t={t} must be "
                         "powers of two with W = t*p")
    if not merge_ok(w):
        raise ValueError(f"merge_segsum_topk: W={w} > {MAX_MERGE_LANES} lanes")
    if k < 1 or not 0 <= cbits <= 30:
        raise ValueError(f"merge_segsum_topk: bad k={k} or cbits={cbits}")
    if t > 1:
        doc, con = flip_odd_blocks(doc, p, t), flip_odd_blocks(con, p, t)
    out_v = torch.empty((b, k), dtype=torch.float32, device=doc.device)
    out_i = torch.empty((b, k), dtype=torch.int32, device=doc.device)
    widths, mats, spec = block_classes(doc, con, p, t, cbits)
    return merge_segsum_topk_classes(widths, mats, [spec], out_v, out_i)


def merge_segsum_full(doc: torch.Tensor, con: torch.Tensor, p: int,
                      t: int = 1, cbits: int = 0):
    """(seg, doc_s), each (B, W = t*p): the doc-sorted merged row and each
    doc's exact partial sum at its segment-end lane (NEG_INF elsewhere);
    doc_s is monotone with parked lanes at 2^30. Input P-blocks plain
    ascending (parked lanes at their ends). CPU tensors take the plain
    version; CUDA tensors launch K3 (csrc/bm25_full.cu) with one class
    whose slots are the P-blocks at scale 1.0, or raise; t == 1 launches
    nothing."""
    if doc.device.type == "cpu":
        return merge_segsum_full_ref(doc, con, p, t, cbits)
    if doc.device.type != "cuda":
        raise ValueError(f"merge_segsum_full: unsupported device {doc.device}")
    if t == 1:
        return torch.where(doc < _BIG, con, NEG_INF), doc
    if doc.dtype != torch.int32 or con.dtype != torch.float32:
        raise TypeError("merge_segsum_full: doc must be int32, con float32")
    if doc.dim() != 2 or doc.shape != con.shape or con.device != doc.device:
        raise ValueError("merge_segsum_full: doc and con must be equal "
                         "(B, W) tensors on one device")
    if not (doc.is_contiguous() and con.is_contiguous()):
        raise ValueError("merge_segsum_full: inputs must be contiguous")
    b, w = doc.shape
    if p < 1 or p & (p - 1) or t & (t - 1) or w != t * p:
        raise ValueError(f"merge_segsum_full: W={w}, p={p}, t={t} must be "
                         "powers of two with W = t*p")
    if b == 0:
        return (torch.empty((0, w), dtype=torch.float32, device=doc.device),
                torch.empty((0, w), dtype=torch.int32, device=doc.device))
    widths, mats, spec = block_classes(doc, con, p, t, cbits)
    _, _, (full,) = merge_segsum_full_classes(widths, mats, [], [spec], 0, 0)
    return full


def block_classes(doc: torch.Tensor, con: torch.Tensor, p: int, t: int,
                  cbits: int = 0):
    """(widths, mats, class) for (B, t*p) rows of plain doc-ascending
    P-blocks: one class whose slot s of row i is block s of row i (a matrix
    row of p lanes, all of them given: the kernels find where each block's
    parked lanes start), at scale 1.0, its rows in order (sel = 0 .. B-1)."""
    b = doc.shape[0]
    blocks = np.arange(b * t, dtype=np.int32).reshape(b, t)
    spec = (p, t, cbits, np.arange(b), np.full((b, t), p, np.int32), blocks,
            np.full((b, t), p, np.int32), np.ones((b, t), np.float32))
    return (p,), ((doc.view(b * t, p), con.view(b * t, p)),), spec


def slot_rows(widths, mats, bucketw, rowid, live, idf, p_max: int, t: int):
    """The (g, t * p_max) (doc, con) rows a class's slots describe: slot s
    of row i holds lanes [0, live) of row rowid of the bucket matrix of
    width bucketw (empty when bucketw is 0 or above p_max), each lane
    contributing idf * impact; the other lanes park at doc 2^30 with
    contribution 0. bucketw / rowid / live / idf: (g, t) host arrays."""
    dev = mats[0][0].device
    g = bucketw.shape[0]
    doc = torch.full((g, t, p_max), _BIG, dtype=torch.int32, device=dev)
    con = torch.zeros((g, t, p_max), dtype=torch.float32, device=dev)
    rowid, live, idf = (torch.as_tensor(np.asarray(x), device=dev)
                        for x in (rowid, live, idf))
    for w, (doc_mat, imp_mat) in zip(widths, mats):
        if w > p_max or not (bucketw == w).any():
            continue
        mask = torch.as_tensor(bucketw == w, device=dev)
        rows = torch.where(mask, rowid, 0).long()
        keep = mask[:, :, None] & (torch.arange(w, device=dev)
                                   < live[:, :, None])
        doc[:, :, :w] = torch.where(keep, doc_mat[rows], doc[:, :, :w])
        con[:, :, :w] = torch.where(keep, idf[:, :, None] * imp_mat[rows],
                                    con[:, :, :w])
    return doc.reshape(g, t * p_max), con.reshape(g, t * p_max)


def merge_segsum_full_classes_ref(widths, mats, narrow, wide, h: int,
                                  wn_max: int):
    """Plain version of the batched K3: each class's rows from its slots
    (``slot_rows``), merged by ``merge_segsum_full_ref``; narrow classes
    scattered into the (h, wn_max) buffers (lanes past a class's width
    parked), wide classes returned as their own rows."""
    dev = mats[0][0].device
    n_val = torch.full((h, wn_max), NEG_INF, dtype=torch.float32, device=dev)
    n_doc = torch.full((h, wn_max), _BIG, dtype=torch.int32, device=dev)

    def rows_of(cls):
        p_max, t, cbits, _, bucketw, rowid, live, idf = cls
        doc, con = slot_rows(widths, mats, np.asarray(bucketw), rowid, live,
                             idf, p_max, t)
        return merge_segsum_full_ref(doc, con, p_max, t, cbits)

    for cls in narrow:
        seg, doc_s = rows_of(cls)
        sel = torch.as_tensor(np.asarray(cls[3], np.int64), device=dev)
        n_val[sel, :seg.shape[1]] = seg
        n_doc[sel, :seg.shape[1]] = doc_s
    return n_val, n_doc, [rows_of(cls) for cls in wide]


def _slot_table(widths, mats, classes):
    """The matrix and slot entries of K2's and K3's tables
    (csrc/bm25_lists.cuh), for the classes' slots in order: per bucket
    matrix a Mat (doc and impact pointers, width: (n_mats, 4) int64), per
    (row, slot) a Slot (matrix, matrix row, live lanes, idf: (n_slots, 4)
    int32, all 0 but idf for an empty slot). A slot is empty when its width
    is 0 or above its class's p_max; its live lanes are clipped to its
    width."""
    p_max, t = (np.array([c[i] for c in classes], np.int64) for i in (0, 1))
    g = np.array([len(c[4]) for c in classes], np.int64)
    cls = np.repeat(np.arange(len(classes)), g)

    def flat(i, dtype):
        return np.concatenate([np.asarray(c[i], dtype).reshape(-1)
                               for c in classes])

    bw = flat(4, np.int64)
    used = (bw > 0) & (bw <= np.repeat(p_max[cls], t[cls]))
    warr = np.asarray(widths, np.int64)
    order = np.argsort(warr)
    widx = order[np.clip(np.searchsorted(warr[order], bw), 0, len(warr) - 1)]
    if (used & (warr[widx] != bw)).any():
        raise ValueError(f"merge_segsum: slot width "
                         f"{int(bw[used & (warr[widx] != bw)][0])} has no "
                         "bucket matrix")
    slots = np.zeros((len(bw), 4), np.int32)
    slots[:, 0] = np.where(used, widx, 0)
    slots[:, 1] = np.where(used, flat(5, np.int64), 0)
    slots[:, 2] = np.where(used, np.clip(flat(6, np.int64), 0, bw), 0)
    slots[:, 3] = flat(7, np.float32).view(np.int32)
    mat_tab = np.zeros((len(mats), 4), np.int64)
    mat_tab[:, 0] = [d.data_ptr() for d, _ in mats]
    mat_tab[:, 1] = [i.data_ptr() for _, i in mats]
    mat_tab[:, 2] = widths
    return mat_tab, slots


def _upload(parts, dev) -> torch.Tensor:
    """int64 host arrays concatenated into one table, sent to dev in one
    copy from pinned memory (no stream sync on the host)."""
    table = torch.from_numpy(np.concatenate([x.reshape(-1) for x in parts]))
    if dev.type == "cuda":
        table = table.pin_memory().to(dev, non_blocking=True)
    return table


def _k3_prepare(widths, mats, narrow, wide, h: int, wn_max: int,
                chunk: int = _K3_CHUNK) -> dict:
    """Everything one K3 launch needs: its outputs (the (h, wn_max) narrow
    buffers and one (g, W) pair per wide class) and its table, uploaded to
    the card in one copy from pinned memory; table None when there is no
    row to write.

    The table is one int64 array, as csrc/bm25_full.cu reads it: the Mats
    and Slots of ``_slot_table``, between them per output row a Row (seg and
    doc_s pointers, W, lanes written, t, cbits, first slot), then the items
    (row << 32 | output chunk), ceil(lanes written / chunk) a row."""
    dev = mats[0][0].device
    classes = [*narrow, *wide]
    n_narrow = len(narrow)
    p_max, t, cbits = (np.array([c[i] for c in classes], np.int64)
                       for i in range(3))
    g = np.array([len(c[4]) for c in classes], np.int64)
    w = t * p_max
    sizes = (g * w)[n_narrow:]
    n_val = torch.empty((h, wn_max), dtype=torch.float32, device=dev)
    n_doc = torch.empty((h, wn_max), dtype=torch.int32, device=dev)
    flat_v = torch.empty(int(sizes.sum()), dtype=torch.float32, device=dev)
    flat_d = torch.empty(int(sizes.sum()), dtype=torch.int32, device=dev)
    offs = np.cumsum(sizes) - sizes
    prep = {"n_val": n_val, "n_doc": n_doc, "table": None,
            "wide": [(flat_v[o:o + n].view(-1, ww),
                      flat_d[o:o + n].view(-1, ww))
                     for o, n, ww in zip(offs.tolist(), sizes.tolist(),
                                         w[n_narrow:].tolist())]}
    n_rows = int(g.sum())
    if n_rows == 0:
        return prep

    # Rows: narrow ones at their sel rows of the (h, wn_max) buffers, wide
    # ones in their class's block of the flat outputs.
    cls = np.repeat(np.arange(len(classes)), g)
    narrow_row = cls < n_narrow
    elem = np.empty(n_rows, np.int64)
    if n_narrow:
        elem[narrow_row] = np.concatenate(
            [np.asarray(c[3], np.int64).reshape(-1) for c in narrow]) * wn_max
    wc = cls[~narrow_row]
    elem[~narrow_row] = (offs[wc - n_narrow] + w[wc] * (
        np.arange(n_rows - narrow_row.sum()) - np.repeat(
            np.cumsum(g[n_narrow:]) - g[n_narrow:], g[n_narrow:])))
    rows = np.zeros((n_rows, 8), np.int64)
    rows[:, 0] = np.where(narrow_row, n_val.data_ptr(),
                          flat_v.data_ptr()) + 4 * elem
    rows[:, 1] = np.where(narrow_row, n_doc.data_ptr(),
                          flat_d.data_ptr()) + 4 * elem
    rows[:, 2] = w[cls]
    rows[:, 3] = np.where(narrow_row, wn_max, w[cls])
    rows[:, 4] = t[cls]
    rows[:, 5] = cbits[cls]
    rows[:, 6] = np.cumsum(t[cls]) - t[cls]
    mat_tab, slots = _slot_table(widths, mats, classes)
    per_row = -(-rows[:, 3] // chunk)
    items = ((np.repeat(np.arange(n_rows, dtype=np.int64), per_row) << 32)
             | (np.arange(int(per_row.sum()))
                - np.repeat(np.cumsum(per_row) - per_row, per_row)))
    table = _upload([mat_tab, rows, slots.view(np.int64), items], dev)
    prep.update(table=table, n_mats=len(mats), n_rows=n_rows,
                n_slots=len(slots), n_items=len(items), t_max=int(t.max()))
    return prep


def _k3_run(fn, prep: dict) -> int:
    """Launch K3 through the C entry `fn` (tr_full_rows or a copy of it)
    on a prepared launch; returns its cudaError_t."""
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    return fn(prep["table"].data_ptr(), prep["n_mats"], prep["n_rows"],
              prep["n_slots"], prep["n_items"], prep["t_max"],
              cuda_stream(prep["table"].device))


def merge_segsum_full_classes(widths, mats, narrow, wide, h: int,
                              wn_max: int):
    """K3 for one search: the full rows of every class at once.

    widths / mats: the bucket matrices, one (doc int32, impact float32)
    pair of (rows, width) tensors per width. narrow / wide: the classes,
    each (p_max, t, cbits, sel, bucketw, rowid, live, idf) with (g, t) host
    arrays per slot (bucket width, 0 = empty; matrix row; live lanes, <=
    the width; idf); a narrow class's rows go into the (h, wn_max)
    (n_val, n_doc) buffers at its `sel` rows, lanes past its width parked;
    a wide class gets (g, t * p_max) rows of its own (`sel` unused). Every
    narrow buffer row belongs to one narrow class. Returns (n_val, n_doc,
    [(w_seg, w_doc) per wide class]).

    CPU tensors take ``merge_segsum_full_classes_ref``; CUDA tensors
    launch K3 once (csrc/bm25_full.cu), or raise. Its limits: at most
    K3_MAX_T = 512 slots a row and W = t * p_max < 2^30."""
    dev = mats[0][0].device
    if dev.type == "cpu":
        return merge_segsum_full_classes_ref(widths, mats, narrow, wide, h,
                                             wn_max)
    if dev.type != "cuda":
        raise ValueError(f"merge_segsum_full: unsupported device {dev}")
    if any(d.device != dev or i.device != dev for d, i in mats):
        raise ValueError("merge_segsum_full: matrices on different devices")
    if any(d.dtype != torch.int32 or i.dtype != torch.float32
           or d.dim() != 2 or d.shape != i.shape or d.shape[1] != w
           or not (d.is_contiguous() and i.is_contiguous())
           for w, (d, i) in zip(widths, mats)):
        raise TypeError("merge_segsum_full: each matrix pair must be "
                        "contiguous (rows, width) int32 docs and float32 "
                        "impacts")
    for p_max, t, cbits, _, bucketw, *_ in [*narrow, *wide]:
        if not 1 <= t <= K3_MAX_T or t * p_max >= _BIG:
            raise ValueError(f"merge_segsum_full: a class of t={t} slots x "
                             f"p_max={p_max} lanes; K3 takes t <= "
                             f"{K3_MAX_T} and W = t * p_max < 2^30")
        if not 0 <= cbits <= 30 or np.shape(bucketw)[1:] != (t,):
            raise ValueError(f"merge_segsum_full: bad cbits={cbits} or slot "
                             f"arrays of shape {np.shape(bucketw)}")
    if any(t * p_max > wn_max for p_max, t, *_ in narrow):
        raise ValueError(f"merge_segsum_full: a narrow class wider than the "
                         f"narrow buffers' {wn_max} lanes")
    sel = np.concatenate([np.asarray(c[3], np.int64).reshape(-1)
                          for c in narrow] or [np.zeros(0, np.int64)])
    if (len(sel) != h or ((sel < 0) | (sel >= h)).any()
            or (h and np.bincount(sel, minlength=h).max() != 1)):
        raise ValueError("merge_segsum_full: every narrow buffer row must "
                         "belong to exactly one narrow class")
    prep = _k3_prepare(widths, mats, narrow, wide, h, wn_max)
    if prep["table"] is not None:
        check_launch(_k3_run(load_kernels().tr_full_rows, prep),
                     "merge_segsum_full")
        launch_counts["merge_segsum_full"] += 1
    return prep["n_val"], prep["n_doc"], prep["wide"]


def merge_segsum_topk_classes_ref(widths, mats, classes, out_v, out_i):
    """Plain version of the batched K2: each class's rows from its slots
    (``slot_rows``), merged and summed as ``_sorted_sums`` does (packed when
    cbits > 0, at t == 1 too), their top-k of the positive sums written into
    the (rows, k) out_v / out_i at the class's sel rows."""
    k = out_v.shape[1]
    for p_max, t, cbits, sel, bucketw, rowid, live, idf in classes:
        doc, con = slot_rows(widths, mats, np.asarray(bucketw), rowid, live,
                             idf, p_max, t)
        vals, ids = _topk_positive(*_sorted_sums(doc, con, t, cbits), k)
        sel = torch.as_tensor(np.asarray(sel, np.int64), device=out_v.device)
        out_v[sel] = vals
        out_i[sel] = ids
    return out_v, out_i


def _k2_prepare(widths, mats, classes, out_v, out_i) -> dict:
    """Everything one K2 launch needs: its table, uploaded to the card in
    one copy from pinned memory, and its sizes; table None when there is no
    row.

    The table is one int64 array, as csrc/bm25_topk.cu reads it: the Mats
    and Slots of ``_slot_table``, between them per query row a Row (its
    out_v and out_i row pointers, W = t * p_max, t, cbits, first slot),
    rows with the most given lanes first (they take longest). The sizes
    bound what a row's block holds: t_max slots, lane_cap given lanes,
    stage_cap stage lanes (each slot's lanes from the start of their 16-byte
    line, rounded up to a whole line)."""
    dev = mats[0][0].device
    k = out_v.shape[1]
    g = np.array([len(c[4]) for c in classes], np.int64)
    n_rows = int(g.sum())
    if n_rows == 0:
        return {"table": None}
    p_max, t, cbits = (np.array([c[i] for c in classes], np.int64)
                       for i in range(3))
    cls = np.repeat(np.arange(len(classes)), g)
    mat_tab, slots = _slot_table(widths, mats, classes)
    first = np.cumsum(t[cls]) - t[cls]
    slot_row = np.repeat(np.arange(n_rows), t[cls])
    lens = slots[:, 2].astype(np.int64)
    given = np.bincount(slot_row, lens, n_rows).astype(np.int64)
    head = ((mat_tab[slots[:, 0], 0] // 4
             + slots[:, 1].astype(np.int64) * mat_tab[slots[:, 0], 2]) % 4)
    stage = np.bincount(slot_row, np.where(lens > 0, (head + lens + 3) & ~3,
                                           0), n_rows).astype(np.int64)
    sel = np.concatenate([np.asarray(c[3], np.int64).reshape(-1)
                          for c in classes]) * k
    rows = np.zeros((n_rows, 8), np.int64)
    rows[:, 0] = out_v.data_ptr() + 4 * sel
    rows[:, 1] = out_i.data_ptr() + 4 * sel
    rows[:, 2] = (t * p_max)[cls]
    rows[:, 3] = t[cls]
    rows[:, 4] = cbits[cls]
    rows[:, 5] = first
    rows = rows[np.argsort(-given, kind="stable")]
    t_max, lane_cap = int(t.max()), int(given.max())
    stage_cap = int(stage.max())
    smem = 8 * stage_cap + 4 * lane_cap + 4 * (5 * t_max + 2)
    if t_max > _K2_MAX_T or lane_cap > MAX_MERGE_LANES or smem > _K2_SMEM:
        raise ValueError(f"merge_segsum_topk: a row of {t_max} slots and "
                         f"{lane_cap} lanes ({smem} bytes of shared memory) "
                         "is past K2's block")
    threads = min(_K2_THREADS, max(128, -(-lane_cap // 256) * 32))
    return {"table": _upload([mat_tab, rows, slots.view(np.int64)], dev),
            "n_mats": len(mats), "n_rows": n_rows, "n_slots": len(slots),
            "t_max": t_max, "stage_cap": stage_cap, "lane_cap": lane_cap,
            "threads": threads, "k": k}


def _k2_run(fn, prep: dict) -> int:
    """Launch K2 through the C entry `fn` (tr_topk_rows or a copy of it) on
    a prepared launch; returns its cudaError_t."""
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    return fn(prep["table"].data_ptr(), prep["n_mats"], prep["n_rows"],
              prep["n_slots"], prep["t_max"], prep["stage_cap"],
              prep["lane_cap"], prep["threads"], prep["k"],
              cuda_stream(prep["table"].device))


def merge_segsum_topk_classes(widths, mats, classes, out_v, out_i):
    """K2 for one search: the top-k of every narrow class at once.

    widths / mats: the bucket matrices, one (doc int32, impact float32)
    pair of (rows, width) tensors per width. classes: each (p_max, t, cbits,
    sel, bucketw, rowid, live, idf) with (g, t) host arrays per slot (bucket
    width, 0 = empty; matrix row; live lanes, <= the width; idf) and sel
    the (g,) rows of out_v / out_i its queries fill. out_v (float32) / out_i
    (int32): the search's (rows, k) result buffers; each class row gets its
    k slots, (score desc, doc asc) over sums > 0, then (NEG_INF, -1). Rows
    of no class are left as they are. Returns (out_v, out_i).

    CPU tensors take ``merge_segsum_topk_classes_ref``; CUDA tensors launch
    K2 once (csrc/bm25_topk.cu), or raise. Its limits: t * p_max <=
    MAX_MERGE_LANES, each matrix pair sharing its 16-byte alignment."""
    dev = mats[0][0].device
    if dev.type == "cpu":
        return merge_segsum_topk_classes_ref(widths, mats, classes, out_v,
                                             out_i)
    if dev.type != "cuda":
        raise ValueError(f"merge_segsum_topk: unsupported device {dev}")
    if any(d.device != dev or i.device != dev for d, i in mats) or any(
            x.device != dev for x in (out_v, out_i)):
        raise ValueError("merge_segsum_topk: tensors on different devices")
    if any(d.dtype != torch.int32 or i.dtype != torch.float32
           or d.dim() != 2 or d.shape != i.shape or d.shape[1] != w
           or not (d.is_contiguous() and i.is_contiguous())
           or (d.data_ptr() - i.data_ptr()) % 16
           for w, (d, i) in zip(widths, mats)):
        raise TypeError("merge_segsum_topk: each matrix pair must be "
                        "contiguous (rows, width) int32 docs and float32 "
                        "impacts sharing their 16-byte alignment")
    if (out_v.dtype != torch.float32 or out_i.dtype != torch.int32
            or out_v.dim() != 2 or out_v.shape != out_i.shape
            or out_v.shape[1] < 1
            or not (out_v.is_contiguous() and out_i.is_contiguous())):
        raise TypeError("merge_segsum_topk: out_v / out_i must be contiguous "
                        "(rows, k) float32 / int32 tensors")
    for p_max, t, cbits, sel, bucketw, *_ in classes:
        if not merge_ok(t * p_max) or t < 1:
            raise ValueError(f"merge_segsum_topk: a class of t={t} x "
                             f"p_max={p_max} lanes; K2 takes t * p_max <= "
                             f"{MAX_MERGE_LANES}")
        sel = np.asarray(sel)
        if (not 0 <= cbits <= 30 or np.shape(bucketw) != (len(sel), t)
                or ((sel < 0) | (sel >= out_v.shape[0])).any()):
            raise ValueError(f"merge_segsum_topk: bad cbits={cbits}, slot "
                             f"arrays of shape {np.shape(bucketw)} or sel")
    prep = _k2_prepare(widths, mats, classes, out_v, out_i)
    if prep["table"] is not None:
        check_launch(_k2_run(load_kernels().tr_topk_rows, prep),
                     "merge_segsum_topk")
        launch_counts["merge_segsum_topk"] += 1
    return out_v, out_i


def bm25_topk_fused_ref(starts, lens, idf, post_doc, post_impact,
                        n_valid: int, k: int, p_max: int, cbits: int = 0):
    """Plain version of K2': gather_candidates, odd terms flipped, then
    its bitonic network, window sums and top-k (``_bitonic_topk_ref``);
    rows past MAX_MERGE_LANES take bm25_topk_segsum, as the JAX package
    routes them."""
    b, t = starts.shape
    if not merge_ok(t * p_max):
        return bm25_topk_segsum(starts, lens, idf, post_doc, post_impact,
                                n_valid, k=k, p_max=p_max)
    doc, con = gather_candidates(starts, lens, idf, post_doc, post_impact,
                                 n_valid, p_max)
    if t > 1:
        doc = flip_odd_blocks(doc, p_max, t)
        con = flip_odd_blocks(con, p_max, t)
    return _bitonic_topk_ref(doc, con, k, p_max, t, cbits)


@functools.lru_cache(maxsize=None)
def _fused_entry():
    """K2''s C entry point, its argument types set once."""
    fn = load_kernels().tr_bm25_topk_fused
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p] * 3)
    return fn


def bm25_topk_fused(starts: torch.Tensor, lens: torch.Tensor,
                    idf: torch.Tensor, post_doc: torch.Tensor,
                    post_impact: torch.Tensor, n_valid: int, k: int,
                    p_max: int, cbits: int = 0):
    """(B, k) BM25 top-k (scores, ids) of (B, T) CSR windows (starts,
    lens int32, idf float32) into doc-ascending postings (post_doc int32,
    post_impact float32, padded by p_max), empties as (NEG_INF, -1). T and
    p_max are powers of two. CPU tensors take the plain version; CUDA
    tensors are checked, then launch K2' (csrc/bm25_merge.cu) or raise.
    Rows of T * p_max > MAX_MERGE_LANES lanes take bm25_topk_segsum
    (plain torch) on either device, as the JAX package routes them."""
    dev = post_doc.device
    if dev.type == "cpu":
        return bm25_topk_fused_ref(starts, lens, idf, post_doc, post_impact,
                                   n_valid, k, p_max, cbits)
    if dev.type != "cuda":
        raise ValueError(f"bm25_topk_fused: unsupported device {dev}")
    if starts.dim() != 2 or lens.shape != starts.shape \
            or idf.shape != starts.shape:
        raise ValueError("bm25_topk_fused: starts, lens and idf must be "
                         "equal (B, T) tensors")
    b, t = starts.shape
    if t < 1 or t & (t - 1) or p_max < 1 or p_max & (p_max - 1):
        raise ValueError(f"bm25_topk_fused: T={t} and p_max={p_max} must be "
                         "powers of two")
    if any(x.device != dev for x in (starts, lens, idf, post_impact)):
        raise ValueError("bm25_topk_fused: inputs on different devices")
    if (starts.dtype != torch.int32 or lens.dtype != torch.int32
            or post_doc.dtype != torch.int32 or idf.dtype != torch.float32
            or post_impact.dtype != torch.float32):
        raise TypeError("bm25_topk_fused: starts, lens, post_doc must be "
                        "int32, idf and post_impact float32")
    nnz = post_doc.shape[0]
    if post_doc.dim() != 1 or post_impact.shape != post_doc.shape:
        raise ValueError("bm25_topk_fused: postings must be equal 1-D tensors")
    if nnz < p_max or nnz >= 2**31:
        raise ValueError(f"bm25_topk_fused: {nnz} postings; need p_max="
                         f"{p_max} <= nnz < 2^31 (the index pads by p_max)")
    if k < 1 or not 0 <= cbits <= 30 or int(n_valid) > _BIG:
        raise ValueError(f"bm25_topk_fused: bad k={k}, cbits={cbits} or "
                         f"n_valid={n_valid} (at most 2^30)")
    if not merge_ok(t * p_max):  # XLA-level code in JAX too: no kernel
        return bm25_topk_segsum(starts, lens, idf, post_doc, post_impact,
                                n_valid, k=k, p_max=p_max)
    tables = [x.contiguous() for x in (starts, lens, idf, post_doc,
                                       post_impact)]
    out_v = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    if b == 0:
        return out_v, out_i
    err = _fused_entry()(*(x.data_ptr() for x in tables), nnz, int(n_valid),
                         b, t, p_max, cbits, k, out_v.data_ptr(),
                         out_i.data_ptr(), cuda_stream(dev))
    check_launch(err, "bm25_topk_fused")
    launch_counts["bm25_topk_fused"] += 1
    return out_v, out_i
