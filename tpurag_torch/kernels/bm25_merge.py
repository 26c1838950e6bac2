# Ported from tpurag/kernels/bm25_pallas.py (merge_segsum_topk and
# merge_segsum_full, the two forms of _merge_segsum_kernel, and
# pallas_merge_ok).
"""Fused BM25 merge + segment sum: top-k (K2) and full rows (K3).

Per candidate row (one query): a bitonic merge of T doc-sorted P-blocks,
a T-window shift-add segment sum, then either a k-pass top-k
(``merge_segsum_topk``, K2) or the full doc-sorted row with each doc's
partial sum at its segment-end lane (``merge_segsum_full``, K3, the
input of the exact narrow+wide combine in kernels/bm25_join.py). On a
CUDA tensor each wrapper launches its hand-written kernel
(csrc/bm25_merge.cu); on a CPU tensor it runs its plain version
(``*_ref``), which is the same network and the same sums in plain torch
(bit-identical to the JAX package's Pallas kernel in interpret mode).

merge_segsum_topk's input contract (prepared by
index/inverted.py:_bucket_score):
- doc (B, W) int32, con (B, W) float32, W = T*P with T, P powers of two;
- each P-block ascending by doc for even block index, DESCENDING for odd
  (the caller flips odd terms), so each 2P block is bitonic and the
  network starts at size 2P; for T == 1 the caller passes p = W and the
  row is already sorted;
- invalid lanes parked at doc = 2^30 with contribution 0.

cbits > 0 packs (doc, quantized contribution) into one int32 key,
key = doc << cbits | q, q = round(con / max(rowmax, 1e-30) * qmax),
qmax = 2^cbits - 1, half-to-even rounding, q clamped to [0, qmax] as an
integer; lanes whose doc does not fit
become the pad key 2^31 - 1. The network then moves one array instead
of two; the sums use q * (max(rowmax, 1e-30) / qmax).

merge_segsum_full takes the P-blocks plain ascending (the kernel flips
the odd ones as it loads them); t == 1 rows are already sorted with
unique docs and come back as (where(doc < 2^30, con, NEG_INF), doc)
without a launch.

``bm25_topk_fused`` (K2') is K2 fed straight from CSR postings: the
kernel gathers each query's term windows itself (kernels/bm25.
gather_candidates, odd terms flipped), so the candidate rows never reach
device memory.
"""

from __future__ import annotations

import ctypes

import torch

from tpurag_torch.kernels.bm25 import bm25_topk_segsum, gather_candidates
from tpurag_torch.kernels.runtime import (NEG_INF, check_launch, cuda_stream,
                                          launch_counts, load_kernels)
from tpurag_torch.kernels.topk import select_topk

_BIG = 2**30
_PAD_KEY = 2**31 - 1

# Widest candidate row the fused kernel takes: 16384 lanes are 128 KB of
# shared memory unpacked (doc + con), 64 KB packed. The JAX package has
# the same boundary (PALLAS_MAX_MERGE_LANES), so both packages route the
# same queries; wider rows take kernels/bm25.segsum_topk_candidates.
MAX_MERGE_LANES = 1 << 14


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


def _merge_rows(doc: torch.Tensor, con: torch.Tensor, p: int, t: int,
                cbits: int):
    """The kernels' network and sums: bitonic merge from block size 2p up
    to W, then the t-window segment sum. Returns (seg, doc_s, big): seg
    holds each doc's sum at its segment-end lane, NEG_INF elsewhere;
    doc_s is the merged doc row; lanes with doc_s >= big are parked."""
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
    nxt = torch.roll(doc_s, -1, dims=1)
    is_end = (doc_s != nxt) | (lane == w - 1)
    total = con_s
    for j in range(1, t):
        dj = torch.roll(doc_s, j, dims=1)
        cj = torch.roll(con_s, j, dims=1)
        total = total + torch.where((dj == doc_s) & (lane >= j), cj, 0.0)
    seg = torch.where(is_end & (doc_s < big), total, NEG_INF)
    return seg, doc_s, big


def merge_segsum_topk_ref(doc: torch.Tensor, con: torch.Tensor, k: int,
                          p: int, t: int = 1, cbits: int = 0):
    """Plain version of the fused kernel (same network, same sums)."""
    seg, doc_s, _ = _merge_rows(doc, con, p, t, cbits)
    vals, ids = select_topk(seg, doc_s, k)
    empty = vals <= 0.0
    return torch.where(empty, NEG_INF, vals), torch.where(empty, -1, ids)


def flip_odd_blocks(x: torch.Tensor, p: int, t: int) -> torch.Tensor:
    """A (B, t*p) row of t doc-ascending p-blocks with every odd block
    reversed, so each 2p block is bitonic (merge_segsum_topk's input)."""
    b = x.shape[0]
    x4 = x.reshape(b, t // 2, 2, p)
    return torch.stack([x4[:, :, 0], x4[:, :, 1].flip(-1)], dim=2).reshape(
        b, t * p)


def merge_segsum_full_ref(doc: torch.Tensor, con: torch.Tensor, p: int,
                          t: int = 1, cbits: int = 0):
    """Plain version of K3 (same network and sums as the kernel): the
    (seg, doc_s) full rows of ``merge_segsum_full``."""
    if t == 1:
        return torch.where(doc < _BIG, con, NEG_INF), doc
    seg, doc_s, big = _merge_rows(flip_odd_blocks(doc, p, t),
                                  flip_odd_blocks(con, p, t), p, t, cbits)
    return seg, torch.where(doc_s < big, doc_s, _BIG).to(torch.int32)


def merge_segsum_topk(doc: torch.Tensor, con: torch.Tensor, k: int, p: int,
                      t: int = 1, cbits: int = 0):
    """(B, k) BM25 top-k (scores, ids) of candidate rows, empties as
    (NEG_INF, -1). CPU tensors take the plain version; CUDA tensors launch
    the kernel (csrc/bm25_merge.cu) or raise."""
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
    if w & (w - 1) or p & (p - 1) or w % p or t < 1 or w % t:
        raise ValueError(f"merge_segsum_topk: W={w}, p={p}, t={t} must be "
                         "powers of two with p | W")
    if not merge_ok(w):
        raise ValueError(f"merge_segsum_topk: W={w} > {MAX_MERGE_LANES} lanes")
    if not 1 <= k <= w or not 0 <= cbits <= 30:
        raise ValueError(f"merge_segsum_topk: bad k={k} or cbits={cbits}")
    out_v = torch.empty((b, k), dtype=torch.float32, device=doc.device)
    out_i = torch.empty((b, k), dtype=torch.int32, device=doc.device)
    if b == 0:
        return out_v, out_i
    fn = load_kernels().tr_merge_segsum_topk
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    err = fn(doc.data_ptr(), con.data_ptr(), b, w, p, t, cbits, k,
             out_v.data_ptr(), out_i.data_ptr(), cuda_stream(doc.device))
    check_launch(err, "merge_segsum_topk")
    launch_counts["merge_segsum_topk"] += 1
    return out_v, out_i


def merge_segsum_full(doc: torch.Tensor, con: torch.Tensor, p: int,
                      t: int = 1, cbits: int = 0):
    """(seg, doc_s), each (B, W = t*p): the doc-sorted merged row and each
    doc's exact partial sum at its segment-end lane (NEG_INF elsewhere);
    doc_s is monotone with parked lanes at 2^30. Input P-blocks plain
    ascending. CPU tensors take the plain version; CUDA tensors launch
    K3 (csrc/bm25_merge.cu; any W: rows past one block's shared memory
    merge through device-memory scratch) or raise; t == 1 launches
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
    if p < 1 or p & (p - 1) or t & (t - 1) or w != t * p or w >= 2**30:
        raise ValueError(f"merge_segsum_full: W={w}, p={p}, t={t} must be "
                         "powers of two with W = t*p")
    if not 0 <= cbits <= 30 or b > 65535:
        raise ValueError(f"merge_segsum_full: bad cbits={cbits} or B={b}")
    dev = doc.device
    seg = torch.empty((b, w), dtype=torch.float32, device=dev)
    doc_s = torch.empty((b, w), dtype=torch.int32, device=dev)
    if b == 0:
        return seg, doc_s
    key_rows = con_rows = rowmax = None
    if not merge_ok(w):  # scratch rows for the device-memory merge
        key_rows = torch.empty((b, w), dtype=torch.int32, device=dev)
        if cbits:
            rowmax = torch.empty((b,), dtype=torch.float32, device=dev)
        else:
            con_rows = torch.empty((b, w), dtype=torch.float32, device=dev)
    fn = load_kernels().tr_merge_segsum_full
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    err = fn(doc.data_ptr(), con.data_ptr(), b, w, p, t, cbits,
             seg.data_ptr(), doc_s.data_ptr(),
             *(0 if x is None else x.data_ptr()
               for x in (key_rows, con_rows, rowmax)),
             cuda_stream(dev))
    check_launch(err, "merge_segsum_full")
    launch_counts["merge_segsum_full"] += 1
    return seg, doc_s


def bm25_topk_fused_ref(starts, lens, idf, post_doc, post_impact,
                        n_valid: int, k: int, p_max: int, cbits: int = 0):
    """Plain version of K2': gather_candidates, odd terms flipped, then
    K2's plain version; rows past MAX_MERGE_LANES take bm25_topk_segsum,
    as the JAX package routes them."""
    b, t = starts.shape
    if not merge_ok(t * p_max):
        return bm25_topk_segsum(starts, lens, idf, post_doc, post_impact,
                                n_valid, k=k, p_max=p_max)
    doc, con = gather_candidates(starts, lens, idf, post_doc, post_impact,
                                 n_valid, p_max)
    if t > 1:
        doc = flip_odd_blocks(doc, p_max, t)
        con = flip_odd_blocks(con, p_max, t)
    return merge_segsum_topk_ref(doc, con, k, p_max, t, cbits)


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
    if k < 1 or not 0 <= cbits <= 30:
        raise ValueError(f"bm25_topk_fused: bad k={k} or cbits={cbits}")
    if not merge_ok(t * p_max):  # XLA-level code in JAX too: no kernel
        return bm25_topk_segsum(starts, lens, idf, post_doc, post_impact,
                                n_valid, k=k, p_max=p_max)
    tables = [x.contiguous() for x in (starts, lens, idf, post_doc,
                                       post_impact)]
    out_v = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    if b == 0:
        return out_v, out_i
    fn = load_kernels().tr_bm25_topk_fused
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p] * 3)
    err = fn(*(x.data_ptr() for x in tables), nnz, int(n_valid), b, t, p_max,
             cbits, k, out_v.data_ptr(), out_i.data_ptr(), cuda_stream(dev))
    check_launch(err, "bm25_topk_fused")
    launch_counts["bm25_topk_fused"] += 1
    return out_v, out_i
