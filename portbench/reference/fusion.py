"""The configuration's preset arithmetic, in NumPy: the dense leg's
score floor, the keyword leg's coverage gate, reciprocal-rank fusion.

rag-era's reciprocalRankFusion (src/lib/hybrid-search.ts:129-208), as the
program states it: fused(id) = sum over legs s of w_s / (rrf_k + rank_s +
1), ranks 0-based, plus both_bonus for an id both legs hold; each id
once; descending, ties to the smaller id; cut to final_k. Taken in
float32 in the program's order, so a fused score here equals the
program's bit for bit.
"""

from __future__ import annotations

import numpy as np

VECTOR, KEYWORD = 1, 2  # found_in bits


def rank_scores(weight: float, rrf_k: int, n: int) -> np.ndarray:
    """The fused score of ranks 0..n-1 of one leg, alone: the weight
    times the float32 reciprocal, as PyTorch takes `w / tensor`."""
    inv = (np.float32(1.0) / (np.float32(rrf_k) + np.arange(n, dtype=np.float32)
                              + np.float32(1.0))).astype(np.float32)
    return (inv * np.float32(weight)).astype(np.float32)


def both_score(rv: np.ndarray, rk: np.ndarray, bonus: float) -> np.ndarray:
    """The fused score of an id at each (vector rank, keyword rank)."""
    return ((np.float32(0.0) + rv[:, None]) + rk[None, :]
            + np.float32(bonus)).astype(np.float32)


def rrf(v_ids: np.ndarray, k_ids: np.ndarray, preset: dict, final_k: int):
    """Fuse (B, kv) and (B, kk) ranked id lists (-1 empty) into (ids,
    fused scores, found_in bits), each (B, final_k), -1 / -inf / 0 where
    empty."""
    rv = rank_scores(preset["vector_weight"], preset["rrf_k"], v_ids.shape[1])
    rk = rank_scores(preset["keyword_weight"], preset["rrf_k"],
                     k_ids.shape[1])
    cand = np.concatenate([v_ids, k_ids], axis=1)
    fused = np.zeros(cand.shape, np.float32)
    bits = np.zeros(cand.shape, np.int64)
    hits = np.zeros(cand.shape, np.int64)
    for bit, ids, rr in ((VECTOR, v_ids, rv), (KEYWORD, k_ids, rk)):
        match = (cand[:, :, None] == ids[:, None, :]) & (ids[:, None, :] >= 0)
        fused = (fused + np.where(match, rr[None, None, :],
                                  np.float32(0)).sum(axis=2)).astype(
                                      np.float32)
        hit = match.any(axis=2)
        hits += hit
        bits |= hit * bit
    fused = np.where(hits >= 2, fused + np.float32(preset["both_bonus"]),
                     fused).astype(np.float32)
    same = cand[:, :, None] == cand[:, None, :]
    earlier = (same & np.tril(np.ones(same.shape[1:], bool), -1)).any(axis=2)
    valid = (cand >= 0) & ~earlier
    key = np.where(valid, fused, -np.inf)
    order = np.lexsort((cand, -key), axis=1)[:, :final_k]
    out_s = np.take_along_axis(key, order, 1)
    empty = ~np.isfinite(out_s)
    return (np.where(empty, -1, np.take_along_axis(cand, order, 1)),
            out_s, np.where(empty, 0, np.take_along_axis(bits, order, 1)))


def dense_leg(scores: np.ndarray, ids: np.ndarray, preset: dict):
    """The dense leg's ids after the score floor (-1 below it)."""
    return np.where(scores >= preset["min_vector_score"], ids, -1)


def gate_open(best: float, mass: float, preset: dict) -> bool:
    """The keyword leg's coverage gate: its best score covers at least
    min_keyword_coverage of the query's idf mass."""
    return best >= preset["min_keyword_coverage"] * mass
