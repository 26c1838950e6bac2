# Ported from tpurag/kernels/sortmerge.py.
"""Bitonic multi-way merge of pre-sorted lists, in plain torch.

Each term's postings are already doc-ascending, so the (B, T, P)
candidate lists merge into one doc-ordered (B, T*P) row through a tree
of bitonic merges: sum over levels l = 1..log2(T) of log2(2^l * P)
compare-exchange stages, against a full sort's O(log^2(T*P)).

The plain version of the narrow+wide combine (kernels/bm25_join.py)
merges its two sides with it.
"""

from __future__ import annotations

import torch


def _bitonic_merge(keys: torch.Tensor, vals: torch.Tensor):
    """Merge a bitonic sequence along the last axis into ascending order.

    keys/vals: (..., L) with L a power of two; the sequence must be
    bitonic (ascending then descending)."""
    length = keys.shape[-1]
    stride = length // 2
    while stride >= 1:
        shape = keys.shape[:-1] + (length // (2 * stride), 2, stride)
        k2 = keys.reshape(shape)
        v2 = vals.reshape(shape)
        lo_k, hi_k = k2[..., 0, :], k2[..., 1, :]
        lo_v, hi_v = v2[..., 0, :], v2[..., 1, :]
        swap = lo_k > hi_k
        nk = torch.stack([torch.where(swap, hi_k, lo_k),
                          torch.where(swap, lo_k, hi_k)], dim=-2)
        nv = torch.stack([torch.where(swap, hi_v, lo_v),
                          torch.where(swap, lo_v, hi_v)], dim=-2)
        keys = nk.reshape(keys.shape)
        vals = nv.reshape(vals.shape)
        stride //= 2
    return keys, vals


def merge_sorted_lists(keys: torch.Tensor, vals: torch.Tensor):
    """Merge T ascending-sorted lists into one ascending sequence.

    keys/vals: (B, T, P) with T and P powers of two, each [b, t, :]
    ascending. Returns (B, T*P) sorted by key (equal keys in no promised
    order, which is enough for segment reduction)."""
    b, t, p = keys.shape
    if t & (t - 1) or p & (p - 1):
        raise ValueError(f"T={t} and P={p} must be powers of two")
    while t > 1:
        # Pair lists (2i, 2i+1): ascending ++ reversed(ascending) is
        # bitonic; merge to ascending of twice the length.
        k2 = keys.reshape(b, t // 2, 2, p)
        v2 = vals.reshape(b, t // 2, 2, p)
        kcat = torch.cat([k2[:, :, 0, :], k2[:, :, 1, :].flip(-1)], dim=-1)
        vcat = torch.cat([v2[:, :, 0, :], v2[:, :, 1, :].flip(-1)], dim=-1)
        keys, vals = _bitonic_merge(kcat, vcat)
        t //= 2
        p *= 2
    return keys.reshape(b, p), vals.reshape(b, p)
