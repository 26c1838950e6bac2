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

K6 has two bodies (csrc/ivf_probe.cu). Calls whose rows a bulk copy can
take (``ivf_sm90_route``) go to the row-split body: every query's probed
rows are cut into chunks of ``ivf_chunk_rows`` rows that never cross a
cluster and dealt to a grid sized to the card in equal shares
(``ivf_row_split`` is the kernel's split), one launch per search. Every
other call takes the first body, one block per query.

CPU tensors take ``ivf_probe_topk_ref``, the plain version; CUDA tensors
launch a kernel or raise.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from tpurag_torch.kernels.dense import DTYPE_CODE
from tpurag_torch.kernels.quant import _exact_dots, quantize_rows, rescore_topk
from tpurag_torch.kernels.runtime import (NEG_INF, check_launch, cuda_stream,
                                          launch_counts, load_kernels)

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
# The largest k (each warp keeps a k-entry list).
MAX_K = 2048
# The row-split body: the bytes and rows of a chunk (one stage of its
# shared-memory ring), and its consumer warps (each keeps a k-entry list).
ROWS_STAGE_BYTES = 32768
ROWS_MAX_CHUNK = 256
ROWS_WARPS = 8

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


def ivf_chunk_rows(row_bytes: int) -> int:
    """Rows of one chunk of the row-split body: a 32 KB stage, at most 256
    rows."""
    return min(ROWS_MAX_CHUNK, ROWS_STAGE_BYTES // row_bytes)


def ivf_sm90_route(q, emb_ivf, n_probe: int) -> bool:
    """Whether a K6 call takes the row-split body: int8, bf16 or fp32 rows
    of a multiple of 16 bytes up to one 32 KB stage, the IVF matrix and
    the queries (in the storage type) 16-byte aligned, as a bulk copy
    takes them, and at least one probe. Every other call takes the first
    body."""
    row_bytes = emb_ivf.shape[1] * emb_ivf.element_size()
    return (emb_ivf.dtype in _STORE_CODE and row_bytes % 16 == 0
            and 0 < row_bytes <= ROWS_STAGE_BYTES and n_probe > 0
            and emb_ivf.data_ptr() % 16 == 0 and q.data_ptr() % 16 == 0)


def ivf_row_split(counts, chunk_rows: int, grid: int) -> list:
    """The row-split body's split, as each of its blocks computes it: a
    copy of the kernel's arithmetic (csrc/ivf_probe.cu's setup), which no
    launch calls, so that tests can check the split on the CPU. The card
    tests hold ``ivf_chunk_rows`` to the kernel's chunk rows.

    Entry (b, p) of the (B, n_probe) counts table holds ceil(count /
    chunk_rows) chunks, and a query's first probe at least one (an empty
    one when the query has no rows). The C chunks, query-major then probe,
    go to G = min(grid, C) blocks, block g taking chunks floor(g C / G) ..
    floor((g + 1) C / G). Returns one (c0, c1, query, probe, first row in
    the cluster) per block that has a share."""
    counts = np.asarray(counts, dtype=np.int64)
    if counts.size == 0:
        return []
    p = counts.shape[1]
    n = np.where(counts > 0, -(-counts // chunk_rows), 0)
    n[:, 0] = np.maximum(n[:, 0], 1)
    prefix = np.concatenate([[0], np.cumsum(n.ravel())])
    total = int(prefix[-1])
    g_eff = min(grid, total)
    out = []
    for g in range(g_eff):
        c0, c1 = g * total // g_eff, (g + 1) * total // g_eff
        e = int(np.searchsorted(prefix, c0, side="right")) - 1
        out.append((c0, c1, e // p, e % p,
                    (c0 - int(prefix[e])) * chunk_rows))
    return out


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    """A kernel library entry point with its argument types."""
    fn = getattr(load_kernels(), name)
    fn.restype = ctypes.c_int
    ptrs = [ctypes.c_void_p]
    fn.argtypes = {
        "tr_ivf_rows_config": [ctypes.c_int] * 3 + ptrs,
        "tr_ivf_probe_topk": (ptrs * 2 + [ctypes.c_int] + ptrs * 3
                              + [ctypes.c_int] * 4 + ptrs * 3),
        "tr_ivf_probe_rows": (ptrs * 2 + [ctypes.c_int] + ptrs * 3
                              + [ctypes.c_int] * 5 + ptrs * 6),
    }[name]
    return fn


@functools.lru_cache(maxsize=None)
def ivf_rows_config(code: int, d: int, k: int, device_index: int) -> tuple:
    """(grid, chunk rows, warp lists in device memory) of the row-split
    body for a storage code, D and k on a device: the grid is the SMs
    times the blocks per SM that its shared memory and registers allow."""
    out = (ctypes.c_int * 3)()
    with torch.cuda.device(device_index):
        check_launch(_entry("tr_ivf_rows_config")(code, d, k, out),
                     "ivf_probe_topk")
    return tuple(out)


# The row-split body's per-query completion counters, by (device, stream):
# zero when made, and every launch leaves them zero.
_rows_state: dict = {}


def _state(dev, stream: int, b: int):
    state = _rows_state.get((dev.index, stream))
    if state is None or state.numel() < 4 * b:
        state = torch.zeros(4 * max(b, 64), dtype=torch.int32, device=dev)
        _rows_state[(dev.index, stream)] = state
    return state


def ivf_probe_topk(q, emb_ivf, starts_sel, counts_sel, k: int,
                   scales_sel=None):
    """Running top-k over each query's probed clusters.

    q (B, D): fp32 (cast to the storage type), or int8 codes when
    scales_sel (B, n_probe) fp32 per-cluster scales is given (emb_ivf is
    then int8). emb_ivf (Npad, D) cluster-major; starts_sel / counts_sel
    (B, n_probe) int32. Returns (B, k) fp32 scores (int8: before the query
    scale) and int32 IVF-row ids, empty slots (NEG_INF, 2^30). CPU tensors
    take the plain version; CUDA tensors launch K6 (csrc/ivf_probe.cu: the
    row-split body where ``ivf_sm90_route`` says so, else the first body;
    both count under "ivf_probe_topk", the row-split body also under
    "ivf_probe_topk_sm90") or raise."""
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
    code = _STORE_CODE[emb_ivf.dtype]
    scales = tables[2].data_ptr() if quant else None
    stream = cuda_stream(dev)
    if ivf_sm90_route(qs, emb_ivf, n_probe):
        grid, _, global_lists = ivf_rows_config(code, d, k, dev.index or 0)
        part = torch.empty((grid + b) * k, dtype=torch.int64, device=dev)
        glists = (torch.empty(grid * ROWS_WARPS * k, dtype=torch.int64,
                              device=dev) if global_lists else None)
        err = _entry("tr_ivf_probe_rows")(
            qs.data_ptr(), emb_ivf.data_ptr(), code, tables[0].data_ptr(),
            tables[1].data_ptr(), scales, b, n_probe, d, k, grid,
            part.data_ptr(), _state(dev, stream.value, b).data_ptr(),
            None if glists is None else glists.data_ptr(), out_v.data_ptr(),
            out_i.data_ptr(), stream)
        check_launch(err, "ivf_probe_topk")
        launch_counts["ivf_probe_topk_sm90"] += 1
    else:
        err = _entry("tr_ivf_probe_topk")(
            qs.data_ptr(), emb_ivf.data_ptr(), code, tables[0].data_ptr(),
            tables[1].data_ptr(), scales, b, n_probe, d, k, out_v.data_ptr(),
            out_i.data_ptr(), stream)
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
