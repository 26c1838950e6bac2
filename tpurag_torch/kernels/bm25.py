# Ported from tpurag/kernels/bm25.py (_gather_candidates, bm25_topk_segsum,
# bm25_topk, segsum_topk_candidates, rank_compat).
"""BM25 scoring from CSR postings, in plain torch.

Postings live as flat CSR arrays: each term's (doc, impact) pairs are
adjacent and doc-ascending, and a query names each of its T terms by a
window (start, len) into them. ``gather_candidates`` turns the windows
into (B, T * p_max) candidate rows (the JAX package does it with XLA
slices, so it is plain torch here as well); ``bm25_topk_segsum`` merges
the rows doc-sorted and sums each doc's contributions (the reference's
scatter-free path); ``bm25_topk`` is its scatter-add cross-check.
``segsum_topk_candidates`` is the sort + segment-sum + top-k over
prepared candidate rows: the keyword index takes it for rows wider than
the fused kernel's limit (kernels/bm25_merge.MAX_MERGE_LANES), as the
JAX package does on the TPU; narrower rows take the fused merge kernel.
"""

from __future__ import annotations

import torch

from tpurag_torch.kernels.runtime import NEG_INF
from tpurag_torch.kernels.sortmerge import merge_sorted_lists

_BIG = 2**30


def gather_candidates(starts: torch.Tensor, lens: torch.Tensor,
                      idf: torch.Tensor, post_doc: torch.Tensor,
                      post_impact: torch.Tensor, n_valid: int, p_max: int):
    """(B, T) CSR windows -> (B, T * p_max) candidate (doc, contribution)
    rows, lane t * p_max + o holding offset o of term t's window. A
    window's start is clamped to [0, nnz - p_max], and its length still
    counts from the clamped start (the reference's dynamic slice).
    Lanes past a window's length or with doc >= n_valid are parked at
    doc 2^30 with contribution 0."""
    b, t = starts.shape
    nnz = post_doc.shape[0]
    if nnz < p_max:
        raise ValueError(f"gather_candidates: {nnz} postings < p_max={p_max} "
                         "(the index pads its postings by p_max)")
    dev = post_doc.device
    safe = starts.to(dev).long().clamp(0, max(nnz - p_max, 0))
    off = torch.arange(p_max, device=dev)
    pos = safe[:, :, None] + off
    doc = post_doc[pos]
    imp = post_impact[pos]
    valid = (off < lens.to(dev)[:, :, None]) & (doc < int(n_valid))
    contrib = torch.where(valid, idf.to(dev)[:, :, None] * imp, 0.0)
    doc = torch.where(valid, doc, _BIG).to(torch.int32)
    return doc.reshape(b, t * p_max), contrib.reshape(b, t * p_max)


def _segsum_topk_sorted(doc_s: torch.Tensor, contrib_s: torch.Tensor,
                        k: int):
    """Segment sums of doc-sorted rows as differences of a running sum,
    then the top-k (ties to the lower lane, lax.top_k's order)."""
    b, w = doc_s.shape
    dev = doc_s.device
    csum = torch.cumsum(contrib_s, dim=1)
    nxt = torch.cat([doc_s[:, 1:], torch.full((b, 1), -1, dtype=doc_s.dtype,
                                              device=dev)], dim=1)
    is_end = doc_s != nxt
    # csum at the previous segment end (0 for the first): contributions
    # are >= 0, so a shifted running max of the end values gives it.
    end_vals = torch.where(is_end, csum, 0.0)
    prev = torch.cat([torch.zeros((b, 1), dtype=csum.dtype, device=dev),
                      end_vals[:, :-1]], dim=1)
    prev = torch.cummax(prev, dim=1).values
    seg = torch.where(is_end & (doc_s < _BIG), csum - prev, NEG_INF)
    if w < k:
        seg = torch.nn.functional.pad(seg, (0, k - w), value=NEG_INF)
        doc_s = torch.nn.functional.pad(doc_s, (0, k - w), value=_BIG)
    vals, pos = torch.sort(seg, dim=1, descending=True, stable=True)
    vals = vals[:, :k]
    ids = torch.gather(doc_s, 1, pos[:, :k]).to(torch.int32)
    empty = vals <= 0.0
    return torch.where(empty, NEG_INF, vals), torch.where(empty, -1, ids)


def segsum_topk_candidates(doc: torch.Tensor, contrib: torch.Tensor, k: int):
    """doc (B, W) int32 with invalid lanes parked at 2^30, contrib (B, W)
    float32 >= 0. Returns (B, k) (scores, ids), empties as (NEG_INF, -1);
    ties go to the smaller doc id."""
    doc_s, order = torch.sort(doc, dim=1, stable=True)
    return _segsum_topk_sorted(doc_s, torch.gather(contrib, 1, order), k)


def bm25_topk_segsum(starts: torch.Tensor, lens: torch.Tensor,
                     idf: torch.Tensor, post_doc: torch.Tensor,
                     post_impact: torch.Tensor, n_valid: int, k: int,
                     p_max: int):
    """Merge + segment-sum BM25 top-k: the (B, T) windows' candidates
    merged doc-sorted (a bitonic merge tree when T and p_max are powers of
    two, else a stable sort), each doc's contributions summed, the top-k
    taken. Returns (B, k) (scores, ids), empties as (NEG_INF, -1) on the
    postings' device."""
    b, t = starts.shape
    doc, contrib = gather_candidates(starts, lens, idf, post_doc,
                                     post_impact, n_valid, p_max)
    if t & (t - 1) or p_max & (p_max - 1):
        return segsum_topk_candidates(doc, contrib, k)
    doc_s, contrib_s = merge_sorted_lists(doc.reshape(b, t, p_max),
                                          contrib.reshape(b, t, p_max))
    return _segsum_topk_sorted(doc_s, contrib_s, k)


def bm25_topk(starts: torch.Tensor, lens: torch.Tensor, idf: torch.Tensor,
              post_doc: torch.Tensor, post_impact: torch.Tensor, dnorm,
              n_valid: int, k: int, p_max: int):
    """Scatter-add cross-check of bm25_topk_segsum: every candidate's
    contribution added into a dense (B, n_rows) score matrix, n_rows =
    len(dnorm) (impacts are precomputed, so dnorm only sizes it), then the
    top-k of the positive scores of docs < n_valid."""
    b, _ = starts.shape
    doc, contrib = gather_candidates(starts, lens, idf, post_doc,
                                     post_impact, n_valid, p_max)
    n_rows = dnorm.shape[0]
    dev = doc.device
    scores = torch.zeros((b, n_rows + 1), dtype=torch.float32, device=dev)
    rows = torch.arange(b, device=dev)[:, None].expand_as(doc)
    scores.index_put_((rows.reshape(-1), doc.clamp(max=n_rows).long()
                       .reshape(-1)), contrib.reshape(-1), accumulate=True)
    scores = scores[:, :n_rows]
    col = torch.arange(n_rows, device=dev)
    scores = torch.where((col < int(n_valid)) & (scores > 0.0), scores,
                         NEG_INF)
    kk = min(k, n_rows)
    vals, ids = torch.sort(scores, dim=1, descending=True, stable=True)
    vals, ids = vals[:, :kk], ids[:, :kk].to(torch.int32)
    ids = torch.where(vals <= NEG_INF / 2, -1, ids)
    if kk < k:
        vals = torch.nn.functional.pad(vals, (0, k - kk), value=NEG_INF)
        ids = torch.nn.functional.pad(ids, (0, k - kk), value=-1)
    return vals, ids


def rank_compat(scores: torch.Tensor) -> torch.Tensor:
    """Meilisearch returns no scores; the reference converts rank -> score
    as 1/(rank+1) (src/lib/meilisearch.ts:235). Apply over (B, k) top-k
    output, preserving NEG_INF empties."""
    b, k = scores.shape
    rr = 1.0 / (torch.arange(k, dtype=torch.float32, device=scores.device)
                + 1.0)
    return torch.where(scores <= NEG_INF / 2, NEG_INF, rr.expand(b, k))
