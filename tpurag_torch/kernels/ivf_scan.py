# Ported from tpurag/kernels/ivf_scan.py (ivf_probe_topk_pallas ->
# ivf_probe_topk + csrc/ivf_probe.cu; ivf_scan_pallas -> ivf_scan).
"""IVF probe-scan: per-query cluster scans with a running top-k.

The IVF build lays clusters out cluster-major (``index/ivf.py``): cluster
c owns rows cluster_starts[c] .. + cluster_counts[c] of one flat matrix.
``ivf_probe_topk`` (K6's wrapper) scores each query against the rows of
its probed clusters and keeps the top-k over IVF-row ids (value
descending, ties to the smaller id; empty slots (NEG_INF, >= 2^30)).
``ivf_scan`` is the whole search: the centroid product, the top-nprobe
probe choice, the scan (int8 with an exact rescore, or bf16 / fp32) and
the map back to original row ids (-1 for empty slots).

CPU tensors take ``ivf_probe_topk_ref``, the plain version; CUDA tensors
launch the kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch

from tpurag_torch.kernels.dense import DTYPE_CODE
from tpurag_torch.kernels.quant import _exact_dots, quantize_rows, rescore_topk
from tpurag_torch.kernels.runtime import (NEG_INF, cdiv, check_launch,
                                          cuda_stream, launch_counts,
                                          load_kernels)

_BIG = 2**30
# Layout contracts of the JAX package's builds, kept so that partitions
# saved by either package load in the other: the largest per-cluster scan
# extent a TPU probe kernel may fetch past a cluster start (builds
# over-allocate round_up(c_max, IVF_SCAN_EXTENT) + IVF_SCAN_EXTENT tail
# rows), and the cluster-start alignment of builds whose clusters average
# >= 2 * IVF_ALIGN rows. K6 reads only each cluster's own rows and takes
# any alignment.
IVF_SCAN_EXTENT = 512
IVF_ALIGN = 128
# Blocks the probe split aims for (two per SM on a 132-SM H100), the
# candidates per query the merge pass holds, and the largest k (each warp
# keeps a k-entry list in shared memory).
TARGET_BLOCKS = 264
MAX_MERGE_CANDIDATES = 8192
MAX_K = 2048

_STORE_CODE = {**DTYPE_CODE, torch.int8: 2}


def ivf_probe_topk_ref(q, emb_ivf, starts_sel, counts_sel, k: int,
                       scales_sel=None):
    """Plain version of K6: for each query, gather the rows of its probed
    clusters, score them as the kernel does (int8 codes: exact int dots
    times the cluster scale; otherwise the query cast to the storage type,
    fp32 sums), and take the top-k by (value desc, id asc)."""
    b = q.shape[0]
    dev = emb_ivf.device
    out_v = torch.full((b, k), NEG_INF, dtype=torch.float32, device=dev)
    out_i = torch.full((b, k), _BIG, dtype=torch.int32, device=dev)
    starts, counts = starts_sel.cpu().long(), counts_sel.cpu().long()
    for i in range(b):
        live = counts[i] > 0
        if not live.any():
            continue
        rows = torch.cat([torch.arange(s, s + c) for s, c in
                          zip(starts[i][live].tolist(),
                              counts[i][live].tolist())]).to(dev)
        if scales_sel is not None:
            row_scale = torch.repeat_interleave(
                scales_sel[i].float()[live.to(dev)], counts[i][live].to(dev))
            scores = _exact_dots(q[i:i + 1], emb_ivf[rows])[0] * row_scale
        else:
            qi = q[i:i + 1].to(emb_ivf.dtype).float()
            scores = (qi @ emb_ivf[rows].float().T)[0]
        order = torch.argsort(rows, stable=True)  # ties to the smaller id
        rows, scores = rows[order], scores[order]
        vals, pos = torch.sort(scores, descending=True, stable=True)
        kk = min(k, len(rows))
        out_v[i, :kk] = vals[:kk]
        out_i[i, :kk] = rows[pos[:kk]].to(torch.int32)
    return out_v, out_i


def probe_splits(b: int, n_probe: int, k: int) -> int:
    """Probe slices per query: enough blocks to fill the card, at most one
    slice per probe, and few enough partial lists for the merge pass."""
    s = min(cdiv(TARGET_BLOCKS, max(b, 1)), max(n_probe, 1))
    return max(1, min(s, MAX_MERGE_CANDIDATES // k))


def ivf_probe_topk(q, emb_ivf, starts_sel, counts_sel, k: int,
                   scales_sel=None):
    """Running top-k over each query's probed clusters.

    q (B, D): fp32 (cast to the storage type), or int8 codes when
    scales_sel (B, n_probe) fp32 per-cluster scales is given (emb_ivf is
    then int8). emb_ivf (Npad, D) cluster-major; starts_sel / counts_sel
    (B, n_probe) int32. Returns (B, k) fp32 scores (int8: before the query
    scale) and int32 IVF-row ids, empty slots (NEG_INF, 2^30). CPU tensors
    take the plain version; CUDA tensors launch K6 (csrc/ivf_probe.cu) or
    raise."""
    if emb_ivf.device.type == "cpu":
        return ivf_probe_topk_ref(q, emb_ivf, starts_sel, counts_sel, k,
                                  scales_sel)
    dev = emb_ivf.device
    if dev.type != "cuda":
        raise ValueError(f"ivf_probe_topk: unsupported device {dev}")
    quant = scales_sel is not None
    tables = (starts_sel, counts_sel) + ((scales_sel,) if quant else ())
    if q.device != dev or any(x.device != dev for x in tables):
        raise ValueError("ivf_probe_topk: inputs on different devices")
    if emb_ivf.dtype not in _STORE_CODE or quant != (emb_ivf.dtype
                                                     == torch.int8):
        raise TypeError(f"ivf_probe_topk: storage {emb_ivf.dtype} needs "
                        "scales exactly when it is int8 (else bfloat16 or "
                        "float32)")
    if quant and (q.dtype != torch.int8 or scales_sel.dtype != torch.float32):
        raise TypeError("ivf_probe_topk: int8 scans take int8 query codes "
                        "and float32 scales")
    if starts_sel.dtype != torch.int32 or counts_sel.dtype != torch.int32:
        raise TypeError("ivf_probe_topk: starts and counts must be int32")
    if q.dim() != 2 or emb_ivf.dim() != 2 or q.shape[1] != emb_ivf.shape[1]:
        raise ValueError("ivf_probe_topk: expected (B, D) and (Npad, D)")
    b, d = q.shape
    n_probe = starts_sel.shape[1]
    if any(x.shape != (b, n_probe) for x in tables):
        raise ValueError("ivf_probe_topk: tables must be (B, n_probe)")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"ivf_probe_topk: k={k} outside 1..{MAX_K}")
    if not emb_ivf.is_contiguous():
        raise ValueError("ivf_probe_topk: the IVF matrix must be contiguous")
    qs = q.contiguous() if quant else q.to(emb_ivf.dtype).contiguous()
    tables = tuple(x.contiguous() for x in tables)
    out_v = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    if b == 0:
        return out_v, out_i
    splits = probe_splits(b, n_probe, k)
    part_v = torch.empty((b, splits, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((b, splits, k), dtype=torch.int32, device=dev)
    fn = load_kernels().tr_ivf_probe_topk
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p] * 5)
    err = fn(qs.data_ptr(), emb_ivf.data_ptr(), _STORE_CODE[emb_ivf.dtype],
             tables[0].data_ptr(), tables[1].data_ptr(),
             tables[2].data_ptr() if quant else None, b, n_probe, d, k,
             splits, part_v.data_ptr(), part_i.data_ptr(), out_v.data_ptr(),
             out_i.data_ptr(), cuda_stream(dev))
    check_launch(err, "ivf_probe_topk")
    launch_counts["ivf_probe_topk"] += 1
    return out_v, out_i


def probe_clusters(q, centroids, nprobe: int):
    """(B, nprobe) cluster indices by centroid score, descending, ties to
    the lower index (lax.top_k's order): an fp32 product, a stable sort."""
    cscores = q.float() @ centroids.float().T
    return torch.sort(cscores, dim=1, descending=True,
                      stable=True).indices[:, :nprobe]


def ivf_scan(q, centroids, emb_ivf, cluster_starts, cluster_counts, row_ids,
             k: int, nprobe: int, cluster_scales=None, rescore_emb=None,
             overfetch: int = 2, nprobe_dyn=None):
    """Full IVF search. q (B, D) normalized fp32. Returns (B, k) scores and
    ORIGINAL row ids (-1 for empty slots).

    cluster_scales: (C,) fp32, emb_ivf then holds the per-cluster int8
    codes; the queries are row-quantized here and their scales folded
    back into the values. rescore_emb: the full-precision packed matrix;
    the int8 scan then overfetches overfetch * k candidates and re-ranks
    them by exact dots. nprobe_dyn: probes past this runtime count scan
    nothing (count 0)."""
    probe = probe_clusters(q, centroids, nprobe)
    starts_sel = cluster_starts[probe].to(torch.int32)
    counts_sel = cluster_counts[probe].to(torch.int32)
    if nprobe_dyn is not None:
        live = torch.arange(counts_sel.shape[1], device=counts_sel.device)
        counts_sel = torch.where(live[None, :] < int(nprobe_dyn), counts_sel,
                                 0)
    if cluster_scales is not None:
        q8, qs = quantize_rows(q)
        m = overfetch * k if rescore_emb is not None else k
        vals, ids = ivf_probe_topk(q8, emb_ivf, starts_sel, counts_sel, m,
                                   scales_sel=cluster_scales[probe].float())
        if rescore_emb is not None:
            # Sentinel ids and NEG_INF slots (raw, before any query scale)
            # are no candidate: a zero padding row must never rescore.
            cand = torch.where((ids >= _BIG) | (vals <= NEG_INF / 2), -1, ids)
            vals, ids = rescore_topk(q.float(), rescore_emb, cand, k)
            ids = torch.where(ids < 0, _BIG, ids)
        else:
            # Scale only live entries: NEG_INF * qs would drift above the
            # empty threshold.
            vals = torch.where(vals <= NEG_INF / 2, NEG_INF,
                               vals * qs[:, None])
    else:
        vals, ids = ivf_probe_topk(q.float(), emb_ivf, starts_sel,
                                   counts_sel, k)
    empty = vals <= NEG_INF / 2
    orig = row_ids[ids.clamp(0, row_ids.shape[0] - 1).long()]
    return (torch.where(empty, NEG_INF, vals),
            torch.where(empty | (ids >= _BIG), -1, orig))
