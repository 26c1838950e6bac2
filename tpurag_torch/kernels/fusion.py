# Ported from tpurag/kernels/fusion.py (plain torch; no kernel in JAX either).
"""Reciprocal-rank-fusion rank merge.

Reference semantics (reciprocalRankFusion, src/lib/hybrid-search.ts:129-208):
  fused(id) = sum_s weight_s / (rrf_k + rank_s(id) + 1)   (rank 0-based)
  + both_bonus when the id appears in >= 2 sources;
  dedup by chunk id, sort desc, cut to final_top_k.

Ranks are implied by position: each source's id list is sorted by its
own score, best first; id -1 marks an empty slot. The merge is a few
elementwise ops over the concatenated (B, sum k_s) candidate set with
pairwise id-match masks, so it stays on the device of its inputs.
"""

from __future__ import annotations

from typing import Sequence

import torch

from tpurag_torch.kernels.runtime import NEG_INF
from tpurag_torch.kernels.topk import select_topk


def rrf_fuse(
    id_lists: Sequence[torch.Tensor],
    weights: tuple[float, ...],
    final_k: int,
    rrf_k: int = 60,
    both_bonus: float = 0.1,
):
    """Fuse S ranked (B, k_s) int32 id lists (-1 = empty) into one list.

    Returns (fused_scores (B, final_k) float32 descending, NEG_INF where
    empty; fused_ids int32, -1 where empty; src_mask int32 bitmask with
    bit s set if source s hit the id)."""
    cand = torch.cat(list(id_lists), dim=1)                     # (B, Kt)
    b, kt = cand.shape
    dev = cand.device
    fused = torch.zeros((b, kt), dtype=torch.float32, device=dev)
    hits = torch.zeros((b, kt), dtype=torch.int32, device=dev)
    src_bits = torch.zeros((b, kt), dtype=torch.int32, device=dev)

    for s, (ids_s, w) in enumerate(zip(id_lists, weights)):
        ks = ids_s.shape[1]
        rr = w / (rrf_k + torch.arange(ks, dtype=torch.float32, device=dev)
                  + 1.0)
        match = (cand[:, :, None] == ids_s[:, None, :]) & (ids_s[:, None, :] >= 0)
        fused = fused + torch.where(match, rr[None, None, :], 0.0).sum(dim=2)
        hit_s = match.any(dim=2)
        hits = hits + hit_s.to(torch.int32)
        src_bits = src_bits | (hit_s.to(torch.int32) << s)

    fused = fused + torch.where(hits >= 2, both_bonus, 0.0)

    # Dedup: a candidate id appearing several times keeps only its first
    # occurrence (all occurrences carry the same fused score).
    same = cand[:, :, None] == cand[:, None, :]
    before = torch.ones((kt, kt), dtype=torch.bool, device=dev).tril(-1)
    earlier = (same & before).any(dim=2)
    valid = (cand >= 0) & ~earlier
    fused = torch.where(valid, fused, NEG_INF)

    top_scores, top_ids = select_topk(fused, cand, final_k)
    match = cand[:, None, :] == top_ids[:, :, None]             # (B, k, Kt)
    top_bits = torch.where(match, src_bits[:, None, :], 0).amax(dim=2)
    empty = top_scores <= NEG_INF / 2
    return (
        torch.where(empty, NEG_INF, top_scores),
        torch.where(empty, -1, top_ids),
        torch.where(empty, 0, top_bits),
    )
