# Ported from tpurag/kernels/topk.py (select_topk, merge_topk).
"""Partial top-k on tensors with the JAX package's exact order.

Order is value descending, ties to the smaller id (`_lex_gt` in the JAX
module). ``torch.topk`` does not promise that tie order, so
``select_topk`` is the same k-pass select as the reference: each pass
takes the row max, the smallest id among lanes at that max, and masks
every lane carrying the winning id. That also reproduces the
reference's output once a row is exhausted (NEG_INF slots repeat the
smallest remaining id; callers mask ids where the value is NEG_INF).

The running-top-k helpers that the Pallas kernels fold through
(`init_run_asc`, `fold_candidates_asc`, `merge_topk_cols_asc`,
`emit_desc`) are device functions in ``csrc/topk.cuh`` in this port.
"""

from __future__ import annotations

import torch

from tpurag_torch.kernels.runtime import NEG_INF

_BIG_ID = 2**31 - 1


def select_topk(scores: torch.Tensor, ids: torch.Tensor, k: int):
    """Top-k of each row of (B, N) `scores` with explicit (B, N) int32
    candidate `ids`. Returns ((B, k) float32, (B, k) int32), sorted
    descending by score, ties to the smaller id."""
    s = scores.float()
    vals, outs = [], []
    for _ in range(k):
        m = s.max(dim=1, keepdim=True).values
        win = torch.where(s >= m, ids, _BIG_ID).min(dim=1, keepdim=True).values
        vals.append(m)
        outs.append(win)
        s = torch.where(ids == win, NEG_INF, s)
    return torch.cat(vals, dim=1), torch.cat(outs, dim=1)


def merge_topk(vals_a, ids_a, vals_b, ids_b, k: int):
    """Merge two (B, ka)/(B, kb) candidate sets into the top-k."""
    return select_topk(torch.cat([vals_a, vals_b], dim=1),
                       torch.cat([ids_a, ids_b], dim=1), k)
