# Ported from tpurag/kernels/fusion.py (plain torch; no kernel in JAX either);
# fuse_legs and csrc/fuse_rrf.cu are new.
"""Reciprocal-rank-fusion rank merge.

Reference semantics (reciprocalRankFusion, src/lib/hybrid-search.ts:129-208):
  fused(id) = sum_s weight_s / (rrf_k + rank_s(id) + 1)   (rank 0-based)
  + both_bonus when the id appears in >= 2 sources;
  dedup by chunk id, sort desc, cut to final_top_k.

Ranks are implied by position: each source's id list is sorted by its
own score, best first; id -1 marks an empty slot. The merge is a few
elementwise ops over the concatenated (B, sum k_s) candidate set with
pairwise id-match masks, so it stays on the device of its inputs.

``fuse_legs`` is the hybrid search's whole fusion step: the dense leg's
score floor, the keyword leg's confidence gate, ``rrf_fuse``. CPU
tensors take its plain version ``fuse_legs_ref``; CUDA tensors launch
one kernel (csrc/fuse_rrf.cu) that computes the same triples bit for
bit.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import numpy as np
import torch

from tpurag_torch.kernels.runtime import (NEG_INF, check_launch, cuda_stream,
                                          launch_counts, load_kernels)
from tpurag_torch.kernels.topk import select_topk
from tpurag_torch.utils import tracing

# tr_fuse_rrf's return when a row's lanes do not fit one block's shared
# memory (csrc/fuse_rrf.cu: TOO_WIDE).
_TOO_WIDE = -1


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


def apply_min_score(scores, ids, min_score: float):
    """Invalidate candidates below the cosine threshold (pre-RRF filter)."""
    keep = scores >= min_score
    return torch.where(keep, scores, NEG_INF), torch.where(keep, ids, -1)


def fuse_legs_ref(v_scores, v_ids, k_scores, k_ids, mass, preset):
    """Plain version of ``fuse_legs``: ``apply_min_score``, the keyword
    gate (a query's keyword ids dropped when its best BM25 score is under
    ``preset.min_keyword_coverage`` times its idf mass), ``rrf_fuse``."""
    v_scores, v_ids = apply_min_score(v_scores, v_ids,
                                      preset.min_vector_score)
    if k_ids is None:
        k_ids = torch.full((v_ids.shape[0], preset.keyword_top_k), -1,
                           dtype=torch.int32, device=v_ids.device)
    elif mass is not None:
        mass = torch.as_tensor(mass, device=k_scores.device)
        best = k_scores.amax(dim=1, keepdim=True)
        confident = best >= preset.min_keyword_coverage * mass[:, None]
        k_ids = torch.where(confident, k_ids, -1)
    return rrf_fuse(
        (v_ids, k_ids),
        weights=(preset.vector_weight, preset.keyword_weight),
        final_k=preset.final_top_k,
        rrf_k=preset.rrf_k,
        both_bonus=preset.both_bonus,
    )


def fuse_legs(v_scores, v_ids, k_scores, k_ids, mass, preset):
    """Fuse a batch's two legs into its (B, final_k) results.

    v_scores, v_ids: (B, k_v) fp32 / int32 dense hits, best first, -1
    empty; k_scores, k_ids: (B, k_k) keyword hits, or None without a
    keyword leg; mass: (B,) host fp32 idf masses for the keyword gate, or
    None with the gate off; preset: a ``HybridPreset`` (floor, gate
    coverage, weights, rrf_k, both-bonus, final_top_k). Returns
    (scores fp32, ids int32, source bits int32), empties (NEG_INF, -1, 0).

    CUDA tensors launch csrc/fuse_rrf.cu once (counted in
    ``launch_counts["fuse_legs"]``); CPU tensors take ``fuse_legs_ref``,
    each call counted under ``tracing.counters["fuse_plain"]``."""
    if v_ids.device.type != "cuda":
        tracing.counters["fuse_plain"] += 1
        return fuse_legs_ref(v_scores, v_ids, k_scores, k_ids, mass, preset)
    return _fuse_legs_cuda(v_scores, v_ids, k_scores, k_ids, mass, preset)


@functools.lru_cache(maxsize=None)
def _fuse_entry():
    fn = load_kernels().tr_fuse_rrf
    fn.restype = ctypes.c_int
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = ([ptr, ptr, i32, ptr, ptr, i32, ptr] + [f32] * 6
                   + [i32, i32] + [ptr] * 4)
    return fn


def _fuse_legs_cuda(v_scores, v_ids, k_scores, k_ids, mass, preset):
    dev = v_ids.device
    legs = [v_scores, v_ids] + ([] if k_ids is None else [k_scores, k_ids])
    if any(x.device != dev for x in legs):
        raise ValueError("fuse_legs: legs on different devices")
    if (v_scores.dtype != torch.float32 or v_ids.dtype != torch.int32
            or (k_ids is not None and (k_scores.dtype != torch.float32
                                       or k_ids.dtype != torch.int32))):
        raise TypeError("fuse_legs: scores float32, ids int32")
    b, kv = v_ids.shape
    kk = 0 if k_ids is None else k_ids.shape[1]
    if v_scores.shape != (b, kv) or (
            k_ids is not None and (k_ids.shape[0] != b
                                   or k_scores.shape != k_ids.shape)):
        raise ValueError("fuse_legs: expected (B, k_v) and (B, k_k) legs")
    fk = preset.final_top_k
    out_s = torch.empty((b, fk), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, fk), dtype=torch.int32, device=dev)
    out_b = torch.empty((b, fk), dtype=torch.int32, device=dev)
    if b == 0 or fk == 0:
        return out_s, out_i, out_b
    v_scores, v_ids = v_scores.contiguous(), v_ids.contiguous()
    if k_ids is not None:
        k_scores, k_ids = k_scores.contiguous(), k_ids.contiguous()
    if mass is not None and k_ids is not None:
        # One host-to-device copy from pinned memory, queued behind the
        # legs rather than waiting for them as a pageable copy would.
        host = torch.from_numpy(np.ascontiguousarray(mass, np.float32))
        if host.shape != (b,):
            raise ValueError("fuse_legs: expected (B,) idf masses")
        mass = host.pin_memory().to(dev, non_blocking=True)
    else:
        mass = None

    def ptr(x):
        return None if x is None else x.data_ptr()

    err = _fuse_entry()(
        v_scores.data_ptr(), v_ids.data_ptr(), kv, ptr(k_scores), ptr(k_ids),
        kk, ptr(mass), preset.min_vector_score, preset.min_keyword_coverage,
        preset.vector_weight, preset.keyword_weight, preset.rrf_k,
        preset.both_bonus, b, fk, out_s.data_ptr(), out_i.data_ptr(),
        out_b.data_ptr(), cuda_stream(dev))
    if err == _TOO_WIDE:
        raise ValueError(f"fuse_legs: a row of {kv} + {kk} lanes does not "
                         "fit the kernel's shared memory")
    check_launch(err, "fuse_legs")
    launch_counts["fuse_legs"] += 1
    return out_s, out_i, out_b
