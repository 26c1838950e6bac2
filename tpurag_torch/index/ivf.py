# Ported from tpurag/index/ivf.py (single device).
"""IVF (inverted-file) partitioned dense index.

IVF serves the small-batch regime: scanning nprobe clusters instead of
all N rows cuts the work by ~N / (nprobe * mean cluster). Recall is
accounted against the exact oracle.

Layout (the JAX package's, so a partition saved by either package loads
in the other): k-means centroids (C, D); corpus rows reordered
cluster-major into one flat (Npad, D) matrix with every cluster start
aligned (8 rows, or IVF_ALIGN = 128 when clusters average >= 256 rows)
and IVF_SCAN_EXTENT tail rows; per cluster its start and live count; a
(C, Cmax) row-id table (-1 padded); row_ids mapping IVF rows back to
corpus rows. quant builds add per-CLUSTER max-abs int8 codes and scales.

k-means, the nearest-centroid assignment and the probe choice are plain
torch on the index's device; the scan is K6 (kernels/ivf_scan.py). The
layout arithmetic and the int8 codes are numpy, as in the JAX package,
so both packages build the same bytes from the same assignment.
"""

from __future__ import annotations

import json
import pathlib
import shutil
import tempfile
from typing import Optional

import numpy as np
import torch

from tpurag_torch.core.config import IVFConfig
from tpurag_torch.index.dense import as_dtype, l2_normalize, to_storage
from tpurag_torch.kernels.ivf_scan import (IVF_ALIGN, IVF_SCAN_EXTENT,
                                           ivf_scan)
from tpurag_torch.kernels.runtime import round_up
from tpurag_torch.utils.mem import drop_memmap_pages


def _kmeans(data: torch.Tensor, centroids: torch.Tensor,
            n_iters: int) -> torch.Tensor:
    """Lloyd iterations on the data's device (spherical k-means: data and
    centroids L2-normalized, assignment by max dot)."""

    def unit(c):
        return c / torch.clamp_min(torch.linalg.norm(c, dim=1, keepdim=True),
                                   1e-30)

    cents = centroids.float()
    for _ in range(n_iters):
        cents = unit(cents)
        assign = torch.argmax(data @ cents.T, dim=1)
        sums = torch.zeros_like(cents).index_add_(0, assign, data)
        counts = torch.bincount(assign, minlength=cents.shape[0]).float()
        counts = counts[:, None]
        cents = torch.where(counts > 0, sums / torch.clamp_min(counts, 1.0),
                            cents)
    return unit(cents)


def _host_normalize(vectors) -> np.ndarray:
    """L2-normalize on the host (a device normalize would need the input
    and output of a multi-GB snapshot in device memory at once)."""
    if torch.is_tensor(vectors):
        vectors = vectors.cpu().float().numpy()
    data = np.array(vectors, np.float32, copy=True)
    norms = np.linalg.norm(data, axis=1, keepdims=True)
    norms[norms == 0] = 1.0
    data /= norms
    return data


def split_oversized(cents: np.ndarray, assign: np.ndarray,
                    data: np.ndarray, factor: Optional[float],
                    align: int = 8):
    """Split clusters larger than cap = factor x mean into contiguous
    parts of <= cap rows, each part getting its own (re-averaged)
    centroid. Returns (cents, assign, counts).

    The scan's cost per probe follows the probed clusters' sizes, so a
    k-means size skew costs every query that probes a fat cluster;
    capping converts the skew into a few extra lists whose centroids sit
    near the parent's mean, so recall at equal rows scanned is kept."""
    n_lists = cents.shape[0]
    counts = np.bincount(assign, minlength=n_lists)
    if not factor or n_lists == 0:
        return cents, assign, counts
    mean = max(int(np.ceil(counts.sum() / max(n_lists, 1))), 8)
    cap = int(round_up(int(np.ceil(factor * mean)), align))
    big = np.where(counts > cap)[0]
    if len(big) == 0:
        return cents, assign, counts
    cents = np.array(cents, np.float32, copy=True)
    assign = np.array(assign, copy=True)  # never mutate the caller's
    extra = []
    next_id = n_lists
    for c in big:
        rows = np.where(assign == c)[0]
        for gi, g in enumerate(np.array_split(
                rows, int(np.ceil(len(rows) / cap)))):
            m = data[g].mean(axis=0)
            m /= max(float(np.linalg.norm(m)), 1e-30)
            if gi == 0:
                cents[c] = m
            else:
                assign[g] = next_id
                extra.append(m[None])
                next_id += 1
    cents = np.concatenate([cents] + extra, axis=0)
    counts = np.bincount(assign, minlength=next_id)
    return cents, assign, counts


def kmeans_assign(data: np.ndarray, cfg: IVFConfig, seed: int = 0,
                  device="cuda"):
    """Spherical k-means over host-resident normalized `data` (N, D) f32,
    run on `device`. Returns (centroids (C, D) np.float32, assign (N,)
    np.int32, n_lists)."""
    n, _ = data.shape
    n_lists = min(cfg.n_lists, max(n // 8, 1))
    rng = np.random.default_rng(seed)
    sample = data[rng.choice(n, min(n, cfg.sample_size), replace=False)]
    init = data[rng.choice(n, n_lists, replace=False)]
    cents = _kmeans(torch.from_numpy(sample).to(device),
                    torch.from_numpy(init).to(device), cfg.kmeans_iters)
    assign = np.empty(n, np.int32)
    step = 262_144
    for s in range(0, n, step):
        sc = torch.from_numpy(data[s:s + step]).to(device) @ cents.T
        assign[s:s + step] = torch.argmax(sc, dim=1).cpu().numpy()
    return cents.cpu().numpy().astype(np.float32), assign, n_lists


def _norm_block(blk) -> np.ndarray:
    """f32-normalize one row block (a tensor in any float dtype, or a host
    array) into a new host array."""
    if torch.is_tensor(blk):
        out = blk.cpu().float().numpy()
    else:
        out = np.array(blk, np.float32)
    if out.base is not None:
        out = out.copy()
    norms = np.sqrt(np.einsum("nd,nd->n", out, out))
    out /= np.maximum(norms, 1e-30)[:, None]
    return out


def _assign_rows(rows: torch.Tensor, cents: torch.Tensor) -> torch.Tensor:
    """Nearest-centroid assignment for one block: bf16 operands with fp32
    accumulation (the product of two bf16 values is exact in fp32). int8
    rows are per-ROW quantized, and a positive row scale cannot change
    that row's argmax."""
    sc = rows.to(torch.bfloat16).float() @ cents.to(torch.bfloat16).float().T
    return torch.argmax(sc, dim=1).to(torch.int32)


def _to_staged(blk: np.ndarray, dtype: torch.dtype) -> np.ndarray:
    """Normalized f32 rows -> the staging form of a float storage dtype
    (bf16 as its uint16 payload, rounded to nearest even)."""
    if dtype == torch.bfloat16:
        return torch.from_numpy(blk).to(dtype).view(torch.int16).numpy(
            ).view(np.uint16)
    return blk.astype(np.float32)


def _staged_f32(rows: np.ndarray) -> np.ndarray:
    """Staged rows as f32 (bf16 payloads widen exactly)."""
    if rows.dtype == np.uint16:
        return (rows.astype(np.uint32) << 16).view(np.float32)
    return rows.astype(np.float32)


def sample_kmeans(source, n: int, n_lists: int, cfg, rng,
                  device="cuda") -> np.ndarray:
    """k-means centroids from RANGED sample reads (bounded memory):
    returns a writable (n_lists, D) f32 array."""
    want = min(n, cfg.sample_size)
    n_ranges = max(1, min(64, want // 1024)) if want > 2048 else 1
    per = -(-want // n_ranges)
    parts = []
    for r in range(n_ranges):
        lo = (r * n) // n_ranges
        parts.append(_norm_block(source(lo, min(lo + per, n))))
    sample = np.concatenate(parts)[:want]
    del parts
    init = sample[rng.choice(len(sample), n_lists, replace=False)]
    cents = _kmeans(torch.from_numpy(sample).to(device),
                    torch.from_numpy(init).to(device), cfg.kmeans_iters)
    return np.array(cents.cpu().numpy(), np.float32)


def stage_and_assign(source, n: int, d: int, stage_path, dtype,
                     quant: bool, block: int, cents: np.ndarray,
                     device="cuda"):
    """Pass 1 of a streaming build: stage normalized rows on disk
    (per-row int8 when quant, else the storage dtype) and assign each
    block on `device`. Returns (staged memmap, rscale (N,) f32 or None,
    assign (N,) i32)."""
    stage_np = (np.int8 if quant else
                np.uint16 if dtype == torch.bfloat16 else np.float32)
    staged = np.lib.format.open_memmap(
        stage_path, mode="w+", dtype=stage_np, shape=(n, d))
    rscale = np.empty(n, np.float32) if quant else None
    assign = np.empty(n, np.int32)
    cents_dev = torch.from_numpy(cents).to(device)
    for s in range(0, n, block):
        e = min(s + block, n)
        blk = _norm_block(source(s, e))
        if quant:
            m = np.abs(blk).max(axis=1)
            sc = np.where(m > 0, m, 1.0) / 127.0
            up = np.clip(np.rint(blk / sc[:, None]), -127, 127
                         ).astype(np.int8)
            staged[s:e] = up
            rscale[s:e] = sc
            rows = torch.from_numpy(up)
        else:
            up = _to_staged(blk, dtype)
            staged[s:e] = up
            rows = to_storage(up, dtype)
        assign[s:e] = _assign_rows(rows.to(device), cents_dev).cpu().numpy()
        if (s // block) % 8 == 7:
            drop_memmap_pages(staged)
    staged.flush()
    drop_memmap_pages(staged)
    return staged, rscale, assign


def split_oversized_streaming(cents, assign, counts, factor, align,
                              staged, rscale=None):
    """split_oversized from DISK-staged rows (part centroids averaged
    from the staged bytes; dequantized when rscale is given). Mutates
    cents/assign in place where possible; returns (cents, assign,
    counts)."""
    n_lists = len(counts)
    n = len(assign)
    if not factor or not n_lists:
        return cents, assign, counts
    mean = max(int(np.ceil(n / max(n_lists, 1))), 8)
    cap = int(round_up(int(np.ceil(factor * mean)), align))
    big = np.where(counts > cap)[0]
    extra = []
    next_id = n_lists
    for c in big:
        rows_c = np.where(assign == c)[0]
        for gi, g in enumerate(np.array_split(
                rows_c, int(np.ceil(len(rows_c) / cap)))):
            rows_f = _staged_f32(staged[g])
            if rscale is not None:
                rows_f *= rscale[g][:, None]
            m = rows_f.mean(axis=0)
            m /= max(float(np.linalg.norm(m)), 1e-30)
            if gi == 0:
                cents[c] = m
            else:
                assign[g] = next_id
                extra.append(m[None])
                next_id += 1
    if extra:
        cents = np.concatenate([cents] + extra, axis=0)
    return cents, assign, np.bincount(assign, minlength=next_id)


def _layout(counts: np.ndarray, c_max: int, align: int):
    """Padded cluster starts (C + 1,) and the total row count: aligned
    starts plus the IVF_SCAN_EXTENT tail the JAX package's kernels need."""
    n_lists = len(counts)
    pad_counts = (counts + align - 1) // align * align
    starts_pad = np.zeros(n_lists + 1, np.int64)
    np.cumsum(pad_counts, out=starts_pad[1:])
    total = int(round_up(
        int(starts_pad[-1]) + round_up(c_max, IVF_SCAN_EXTENT)
        + IVF_SCAN_EXTENT, align))
    return starts_pad, total


def _row_table(counts: np.ndarray, starts_pad: np.ndarray,
               c_max: int) -> np.ndarray:
    row_table = np.full((len(counts), c_max), -1, np.int32)
    for c in range(len(counts)):
        m = int(counts[c])
        row_table[c, :m] = np.arange(starts_pad[c], starts_pad[c] + m,
                                     dtype=np.int32)
    return row_table


class IVFIndex:
    """Built once from a snapshot of vectors (rebuild to refresh; the
    active segment stays on the exact path). Every tensor lives on
    `device`; row_table stays a host array (only the save format and the
    layout of partitions without cluster starts use it)."""

    def __init__(self, config: Optional[IVFConfig] = None, device="cuda"):
        self.config = config or IVFConfig()
        self.device = torch.device(device)
        self.centroids = None        # (C, D) f32
        self.emb_ivf = None          # (Npad, D) storage dtype
        self.row_table = None        # (C, Cmax) int32 ivf-row ids, -1 pad
        self.row_ids = None          # (Npad,) int32 original ids
        self.cluster_starts = None   # (C,) int32 aligned packed starts
        self.cluster_counts = None   # (C,) int32 live rows per cluster
        self.emb_ivf_q8 = None       # (Npad, D) int8 (quant builds)
        self.cluster_scales = None   # (C,) fp32 per-cluster dequant scale
        self.n = 0
        self.n_lists = 0
        self.c_max = 0
        self.align = 8
        self.nprobe_scale = 1.0

    def _dev(self, arr) -> torch.Tensor:
        return torch.as_tensor(arr).to(self.device)

    def _set_layout(self, cents, counts, starts_pad, row_ids, n) -> None:
        self.centroids = self._dev(np.asarray(cents, np.float32))
        self.row_ids = self._dev(row_ids)
        self.row_table = _row_table(counts, starts_pad, self.c_max)
        self.cluster_starts = self._dev(starts_pad[:-1].astype(np.int32))
        self.cluster_counts = self._dev(counts.astype(np.int32))
        self.n = n
        self.n_lists = len(counts)

    def build(self, vectors, dtype=torch.bfloat16, seed: int = 0,
              quant: bool = False) -> "IVFIndex":
        """quant: also store a per-CLUSTER max-abs int8 copy of the packed
        rows (K6's int8 form reads half the bytes); one scale per cluster
        keeps the dequant a scalar multiply."""
        dtype = as_dtype(dtype)
        cfg = self.config
        data = _host_normalize(vectors)
        n, d = data.shape
        cents, assign, n_lists = kmeans_assign(data, cfg, seed=seed,
                                               device=self.device)
        n_lists_before = n_lists
        align = IVF_ALIGN if n >= 2 * IVF_ALIGN * n_lists else 8
        self.align = align
        cents, assign, counts = split_oversized(
            cents, assign, data, cfg.max_cluster_factor, align=align)
        n_lists = len(counts)
        # split_oversized grows n_lists; scale the default nprobe with it.
        self.nprobe_scale = n_lists / max(n_lists_before, 1)
        order = np.argsort(assign, kind="stable")
        self.c_max = int(round_up(max(int(counts.max()), 1), 8))
        starts_pad, total = _layout(counts, self.c_max, align)
        starts_nopad = np.zeros(n_lists + 1, np.int64)
        np.cumsum(counts, out=starts_nopad[1:])
        cl_sorted = assign[order]
        dest = (starts_pad[cl_sorted]
                + (np.arange(n) - starts_nopad[cl_sorted])).astype(np.int64)
        emb = np.zeros((total, d), np.float32)
        emb[dest] = data[order]
        row_ids = np.full(total, -1, np.int32)
        row_ids[dest] = order.astype(np.int32)
        self.emb_ivf = torch.from_numpy(emb).to(dtype).to(self.device)
        if quant:
            rowmax = np.abs(data).max(axis=1)
            cl_max = np.zeros(n_lists, np.float32)
            np.maximum.at(cl_max, assign, rowmax)
            scales = np.where(cl_max > 0, cl_max / 127.0, 1.0)
            e8 = np.zeros((total, d), np.int8)
            e8[dest] = np.clip(
                np.round(data[order] / scales[cl_sorted][:, None]),
                -127, 127).astype(np.int8)
            self.emb_ivf_q8 = self._dev(e8)
            self.cluster_scales = self._dev(scales.astype(np.float32))
        self._set_layout(cents, counts, starts_pad, row_ids, n)
        return self

    def build_streaming(self, source, n: int, *, dtype=torch.bfloat16,
                        seed: int = 0, quant: bool = False,
                        block: int = 1 << 18,
                        stage_dir=None) -> "IVFIndex":
        """Build from a BLOCK SOURCE in bounded host memory.

        source(lo, hi) -> (hi - lo, D) rows (a tensor or a host array, any
        float dtype, raw or normalized); typically ``DenseIndex.get_rows``.
        Peak host memory is O(block x D) + O(n) bookkeeping: staged rows
        live in a disk-backed memmap (stage_dir or a temp dir, deleted
        after), and the packed layout goes to the device block by block.

        quant: stage per-ROW int8, pack the per-CLUSTER-requantized int8
        matrix, and also pack the full-precision matrix for the exact
        rescore while that copy stays under ~6 GB."""
        dtype = as_dtype(dtype)
        cfg = self.config
        d = int(source(0, 1).shape[1])
        n_lists = min(cfg.n_lists, max(n // 8, 1))
        rng = np.random.default_rng(seed)

        # -- k-means on a sample: ranged reads only ------------------------
        cents = sample_kmeans(source, n, n_lists, cfg, rng, self.device)

        # -- pass 1: stage rows on disk + assign on the device -------------
        own_stage = stage_dir is None
        stage = pathlib.Path(stage_dir
                             or tempfile.mkdtemp(prefix="tpurag_ivf_"))
        stage.mkdir(parents=True, exist_ok=True)
        staged, rscale, assign = stage_and_assign(
            source, n, d, stage / "rows.npy", dtype, quant, block, cents,
            device=self.device)
        n_lists_before = n_lists

        # -- split oversized clusters (streamed part centroids) ------------
        align = IVF_ALIGN if n >= 2 * IVF_ALIGN * n_lists else 8
        self.align = align
        counts = np.bincount(assign, minlength=n_lists)
        cents, assign, counts = split_oversized_streaming(
            cents, assign, counts, cfg.max_cluster_factor, align,
            staged, rscale)
        drop_memmap_pages(staged)  # split walked the fat clusters
        n_lists = len(counts)
        self.nprobe_scale = n_lists / max(n_lists_before, 1)

        # -- layout (identical shapes/contracts to build()) ----------------
        self.c_max = int(round_up(max(int(counts.max()), 1), 8))
        starts_pad, total = _layout(counts, self.c_max, align)
        starts_nopad = np.zeros(n_lists + 1, np.int64)
        np.cumsum(counts, out=starts_nopad[1:])
        order = np.argsort(assign, kind="stable")
        cl_sorted = assign[order]
        dest_sorted = (starts_pad[cl_sorted]
                       + (np.arange(n) - starts_nopad[cl_sorted]))
        dest_orig = np.empty(n, np.int64)
        dest_orig[order] = dest_sorted
        row_ids = np.full(total, -1, np.int32)
        row_ids[dest_sorted] = order.astype(np.int32)
        del order, cl_sorted, dest_sorted

        # -- pass 2: pack block by block straight into device memory -------
        if quant:
            cl_max = np.zeros(n_lists, np.float32)
            np.maximum.at(cl_max, assign, rscale)
            scales = np.where(cl_max > 0, cl_max, 1.0).astype(np.float32)
            dest = torch.zeros((total, d), dtype=torch.int8,
                               device=self.device)
            dest_fp = (torch.zeros((total, d), dtype=dtype,
                                   device=self.device)
                       if total * d * 2 <= 6e9 else None)
        else:
            dest = torch.zeros((total, d), dtype=dtype, device=self.device)
            dest_fp = None
        for s in range(0, n, block):
            e = min(s + block, n)
            rows = np.asarray(staged[s:e])
            idx = torch.from_numpy(dest_orig[s:e]).to(self.device)
            if quant:
                ratio = rscale[s:e] / scales[assign[s:e]]
                rows_q = torch.from_numpy(np.clip(
                    np.rint(rows.astype(np.float32) * ratio[:, None]),
                    -127, 127).astype(np.int8))
            else:
                rows_q = to_storage(rows, dtype)
            dest[idx] = rows_q.to(self.device)
            if dest_fp is not None:
                # Re-read the ORIGINAL rows for the rescore copy: a
                # dequantized int8 round-trip would bake quantization
                # noise into the exact rescore matrix.
                fp = _norm_block(source(s, e))
                dest_fp[idx] = torch.from_numpy(fp).to(dtype).to(self.device)
            if (s // block) % 8 == 7:
                drop_memmap_pages(staged)
        del staged
        if own_stage:
            shutil.rmtree(stage, ignore_errors=True)

        if quant:
            self.emb_ivf_q8 = dest
            self.cluster_scales = self._dev(scales)
            self.emb_ivf = dest_fp  # None when the fp copy can't fit
        else:
            self.emb_ivf = dest
            self.emb_ivf_q8 = None
            self.cluster_scales = None
        self._set_layout(cents, counts, starts_pad, row_ids, n)
        return self

    def search(self, queries, k: int, nprobe: Optional[int] = None,
               nprobe_dyn=None):
        """Top-k over the partition: (B, k) scores and original row ids
        (-1 empty) on the index's device. nprobe_dyn: optional runtime
        probe count <= nprobe; probes past it scan nothing."""
        if nprobe is None:
            nprobe = int(np.ceil(self.config.n_probe * self.nprobe_scale))
        nprobe = min(nprobe, self.n_lists)
        q = l2_normalize(torch.as_tensor(queries).to(self.device))
        if q.dim() == 1:
            q = q[None]
        if self.emb_ivf_q8 is not None:
            return ivf_scan(q, self.centroids, self.emb_ivf_q8,
                            self.cluster_starts, self.cluster_counts,
                            self.row_ids, k=k, nprobe=nprobe,
                            cluster_scales=self.cluster_scales,
                            rescore_emb=self.emb_ivf, nprobe_dyn=nprobe_dyn)
        return ivf_scan(q, self.centroids, self.emb_ivf, self.cluster_starts,
                        self.cluster_counts, self.row_ids, k=k,
                        nprobe=nprobe, nprobe_dyn=nprobe_dyn)

    def tune_nprobe(self, queries, exact_ids, k: int = 10,
                    target_recall: float = 0.95) -> int:
        """Smallest nprobe whose recall@k vs the exact oracle meets the
        target (the BASELINE gate). exact_ids: (B, k) from exact search.

        Doubles to bracket the target, then binary-searches inside the
        bracket, so it returns the MINIMAL passing nprobe. (The JAX
        package's shared_shape mode, one compiled search driven through
        nprobe_dyn, saves compiles the port does not have; its answers
        are these.)"""
        exact = np.asarray(exact_ids)

        def recall_at(nprobe: int) -> float:
            _, ids = self.search(queries, k=k, nprobe=nprobe)
            got = ids.cpu().numpy()
            return float(np.mean([
                len(set(got[i]) & set(exact[i])) / max(len(set(exact[i])), 1)
                for i in range(exact.shape[0])
            ]))

        lo, hi = 0, 1    # lo: last failing, hi: first passing candidate
        while hi < self.n_lists and recall_at(hi) < target_recall:
            lo, hi = hi, hi * 2
        hi = min(hi, self.n_lists)
        while hi - lo > 1:
            mid = (lo + hi) // 2
            if recall_at(mid) >= target_recall:
                hi = mid
            else:
                lo = mid
        return hi

    def save(self, path) -> None:
        """The JAX package's .npz: the fp matrix in its storage dtype (bf16
        as uint16 payloads; 'none' for an int8-only layout), the int8
        codes and scales of quant builds, and the layout tables."""
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        extra = {"cluster_starts": self.cluster_starts.cpu().numpy(),
                 "cluster_counts": self.cluster_counts.cpu().numpy()}
        if self.emb_ivf_q8 is not None:
            extra["emb_q8"] = self.emb_ivf_q8.cpu().numpy()
            extra["cluster_scales"] = self.cluster_scales.cpu().numpy()
        if self.emb_ivf is None:
            emb_np, emb_dtype = np.zeros((0, 1), np.float32), "none"
        elif self.emb_ivf.dtype == torch.bfloat16:
            emb_np = self.emb_ivf.cpu().view(torch.int16).numpy().view(
                np.uint16)
            emb_dtype = "bfloat16"
        else:
            emb_np, emb_dtype = self.emb_ivf.cpu().numpy(), "float32"
        np.savez(
            path,
            centroids=self.centroids.cpu().numpy().astype(np.float32),
            emb=emb_np,
            row_table=self.row_table,
            row_ids=self.row_ids.cpu().numpy(),
            meta=json.dumps({"n": self.n, "c_max": self.c_max,
                             "n_lists": self.n_lists,
                             "nprobe_scale": self.nprobe_scale,
                             "align": self.align,
                             "emb_dtype": emb_dtype,
                             "quant": self.emb_ivf_q8 is not None}),
            **extra,
        )

    @classmethod
    def load(cls, path, config: Optional[IVFConfig] = None,
             dtype=torch.bfloat16, device="cuda") -> "IVFIndex":
        """Load a partition saved by either package (legacy fp32 saves
        and saves without cluster starts included: the starts and counts
        are then read off row_table)."""
        dtype = as_dtype(dtype)
        data = np.load(pathlib.Path(path).with_suffix(".npz"))
        meta = json.loads(str(data["meta"]))
        idx = cls(config, device=device)
        idx.centroids = idx._dev(data["centroids"].astype(np.float32))
        saved = meta.get("emb_dtype", "float32")
        if saved == "none":  # quant-only layout: no fp matrix persisted
            idx.emb_ivf = None
        elif saved == "bfloat16":
            emb = to_storage(data["emb"], torch.bfloat16)
            idx.emb_ivf = emb.to(dtype).to(idx.device)
        else:
            idx.emb_ivf = to_storage(data["emb"], torch.float32).to(
                dtype).to(idx.device)
        idx.row_table = np.asarray(data["row_table"], np.int32)
        idx.row_ids = idx._dev(data["row_ids"].astype(np.int32))
        if "cluster_starts" in data:
            starts = data["cluster_starts"]
            counts = data["cluster_counts"]
        else:
            counts = (idx.row_table >= 0).sum(axis=1)
            starts = np.where(counts > 0, idx.row_table[:, 0], 0)
        idx.cluster_starts = idx._dev(np.asarray(starts, np.int32))
        idx.cluster_counts = idx._dev(np.asarray(counts, np.int32))
        if meta.get("quant"):
            idx.emb_ivf_q8 = idx._dev(data["emb_q8"])
            idx.cluster_scales = idx._dev(data["cluster_scales"])
        idx.n = meta["n"]
        idx.c_max = meta["c_max"]
        idx.n_lists = meta["n_lists"]
        idx.align = meta.get("align", 8)
        idx.nprobe_scale = meta.get("nprobe_scale", 1.0)
        return idx
