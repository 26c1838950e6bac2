# Ported from tpurag/kernels/bm25.py (segsum_topk_candidates, rank_compat).
"""BM25 scoring tail in plain torch.

``segsum_topk_candidates`` is the sort + segment-sum + top-k over
prepared candidate rows. The keyword path takes it for rows wider than
the fused kernel's limit (kernels/bm25_merge.MAX_MERGE_LANES), as the
JAX package does on the TPU; narrower rows take the fused merge kernel.
"""

from __future__ import annotations

import torch

from tpurag_torch.kernels.runtime import NEG_INF

_BIG = 2**30


def segsum_topk_candidates(doc: torch.Tensor, contrib: torch.Tensor, k: int):
    """doc (B, W) int32 with invalid lanes parked at 2^30, contrib (B, W)
    float32 >= 0. Returns (B, k) (scores, ids), empties as (NEG_INF, -1);
    ties go to the smaller doc id."""
    b, w = doc.shape
    doc_s, order = torch.sort(doc, dim=1, stable=True)
    contrib_s = torch.gather(contrib, 1, order)
    csum = torch.cumsum(contrib_s, dim=1)
    nxt = torch.cat([doc_s[:, 1:], torch.full((b, 1), -1, dtype=doc_s.dtype,
                                              device=doc.device)], dim=1)
    is_end = doc_s != nxt
    end_vals = torch.where(is_end, csum, 0.0)
    prev = torch.cat([torch.zeros((b, 1), dtype=csum.dtype, device=doc.device),
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


def rank_compat(scores: torch.Tensor) -> torch.Tensor:
    """Meilisearch returns no scores; the reference converts rank -> score
    as 1/(rank+1) (src/lib/meilisearch.ts:235). Apply over (B, k) top-k
    output, preserving NEG_INF empties."""
    b, k = scores.shape
    rr = 1.0 / (torch.arange(k, dtype=torch.float32, device=scores.device)
                + 1.0)
    return torch.where(scores <= NEG_INF / 2, NEG_INF, rr.expand(b, k))
