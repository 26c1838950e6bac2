#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (tpurag_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (each raises on failure; nothing catches, so any fault exits
non-zero before the result line):
  1. device: needs CUDA; prints the card's name and power limit;
  2. build: compiles tpurag_torch/csrc with nvcc (sm_90a);
  3. K1 dense_topk against dense_topk_ref on the card at the main-path
     shape (1024 queries x 100k of 131072 rows x 1024 bf16, k=8), its
     TMA + wgmma body at SM90_SHAPES, its first body at k=200,
     in fp32 and at an unaligned D; the two bodies and torch.topk(q @
     emb.T) timed on the same inputs;
  4. K2 (csrc/bm25_topk.cu) against its plain version bit for bit, each
     case twice: merge_segsum_topk (flipped candidate rows) for every width
     class p in {64, 256, 1024, 2048} x t in {1, 2, 8}, packed and not,
     and merge_segsum_topk_classes at its edges (K2_CASES: empty slots,
     live lanes below the bucket width, slots narrower than p_max, t = 1, k
     above the live lanes, ties, parked docs, a 16384-lane row, 256 slots,
     a class mix in one launch); at b=1024 t=8 p=2048 packed and not,
     timed beside its first body (tools/bm25_merge_first.cu, built by
     tools/k2_anatomy.py) on the same rows;
     K3 merge_segsum_full_classes against its plain version at its edges
     (K3_CASES: a doc whose t lanes straddle an item boundary at t = 4
     and 16, docs in every slot, an all-parked row, empty slots, a slot
     wider than p_max, t = 1, W = 131072 at t = 4 and 8, cbits 12 and 14,
     a class mix in one launch), each twice, and merge_segsum_full (the
     same kernel fed (doc, con) rows) at every narrow class (p in {64,
     256, 1024, 2048} x t in {2, 8}) and the 1M point's wide shapes (p in
     {4096 .. 32768} x t in {2, 4}, up to W = 131072), both layouts where
     packing applies, timed beside K3's first body at W = 131072
     (tools/bm25_full_first.cu, built by tools/k3_anatomy.py); K4
     combine_topk_classes against
     combine_classes_ref at its edges (K4_CASES: a doc straddling a chunk
     boundary, a narrow lane on an item's first doc, Ww below, equal to
     and not a multiple of the chunk, several narrow tiles, ties across
     items, an all-invalid wide row, k past the candidates) x k in {1, 8,
     40, 200} and k=1100, each twice, and one class at narrow W in {2048,
     16384} x wide W in {4096, 32768, 131072} x k in {8, 40}; at g=64,
     16384 + 131072 lanes, K4 timed beside its first body
     (tools/bm25_combine_first.cu, built by tools/k4_anatomy.py);
  5. the 100k slice: KnowledgeBase(dim=1024, device="cuda") ingests 100k
     chunks (bench.py's Zipf postings plan: df = clip(2048 (1+r)^-0.5,
     16, 2048) over a 50k vocabulary, ~1.05M postings), answers 4
     search_batch(mode="hybrid") requests of 1024 queries and 3 single
     searches, with the kernels' launch counters reset just before: K2
     and the fusion kernel (csrc/fuse_rrf.cu) launched once a search; one
     request's K2 call replayed bit for bit and timed beside its first
     body; its fusion call replayed through fuse_legs and fuse_legs_ref,
     bit for bit, and both timed; one profiled request (device busy, port
     kernels, glue; one fusion kernel); then a save, a reload on the CPU,
     and 64 queries compared there;
  6. timings (CUDA events, median of >= 10) of each kernel and its plain
     version, search_batch p50 at b=1024, ingest seconds;
  7. the 1M wide-term slice (bench.py's TPURAG_BENCH_N=1000000 plan:
     vocab 158110, df up to 20480, ~16.2M postings, 1M x 1024 bf16):
     ingest through add_chunks, 4 search_batch(hybrid) requests of 512
     queries (about half hold a wide term) with every counter reset just
     before, one profiled request (device busy, K3's, K4's and the
     gathers' shares), 64 hard queries' keyword top-8 against a CPU index
     of the same postings; every K1 launch took the TMA + wgmma body, and
     K2, K3, K4 and the fusion kernel launched exactly once per request;
     K1 (both bodies, within TOL at near ties), K2, K3, K4 and the fusion
     kernel (bit for bit) held to their plain versions and timed on the
     very inputs one request gave them,
     K2, K3 and K4 beside their first bodies' per-class launches on the
     same rows.
  8. the int8 + IVF slice at the JAX package's 1M-chunk hybrid_ivf point
     (benchmarks/kb_10m.py --n 1000000 with the device store): K5's TMA +
     int8 wgmma body at Q8_SHAPES and its first body, K6
     (int8, bf16, fp32; its row-split body and, at unaligned D, its first
     body, each case asserting the route it took; IVF_CASES: b=1 on one
     20k-row cluster, ivf_latency's shape, masked probes, a query with no
     rows, k past the rows, k=2048) and K8 against their plain versions
     at small shapes; KnowledgeBase(quant=True) ingests 1M x 1024 chunks of a
     1024-center mixture through add_chunks, build_ivf() packs 4096 int8
     lists, then 4 search_batch requests each of hybrid_ivf at b=32 and
     b=8 and of hybrid at b=32 with every counter reset just before; every
     K5 launch took the wgmma body and every K6 launch the row-split body;
     K5, K6, K8 and K4 replayed bit for bit (K8 within 1e-5) on one
     request's own inputs, K6 and K8 timed singly and in chains of 10
     launches, K6 beside its first design (tools/ivf_probe_first.cu);
     K5's two bodies beside K1 and torch._int_mm at b=32 and b=512; K6's
     bf16 form on a 100k-row bf16 IVF; mode 'ivf' recall@10 >= 0.95 against the full probe; the
     same partition on the CPU giving the same ids; 1000 chunks after the
     build scanned by K1 in the tail; one profiled request each of
     hybrid_ivf (exactly one K6 kernel on the device) and hybrid (K5's
     path).
  9. the eval-suite slice (tpurag_torch/eval/bench.py, the JAX package's
     tpurag/eval/bench.py): K2' bm25_topk_fused against its plain
     version bit for bit at t in {1, 2, 4, 8} x p_max in {16, 64, 256,
     2048}, packed and not (clamped starts, empty windows, docs >=
     n_valid, k past the row), and K7 dense_topk_co against dense_topk_ref
     within TOL: its TMA + wgmma body at K7_SHAPES,
     tests/test_dense.py's shapes, b=4160, and its first body on fp32,
     D=1352, a misaligned corpus and as named; the
     five runnable configs (exact_dense, hybrid, memory_fusion, graph,
     ivf_latency) at full size through run_all(device="cuda"), every
     launch count reset just before each and read just after, with
     exact_dense recall 1.0 and ivf_latency recall@10 >= 0.95, every
     ivf_latency K6 launch through the row-split body; one hybrid
     step's K2' call replayed bit for bit, timed singly and in chains of
     10 beside its first body (tools/bm25_merge_first.cu), and both on
     rows whose every lane is live (b=16 and 512, packed and not);
     ivf_latency's K6 call replayed
     within TOL, timed singly and in chains of 10 beside the first design,
     and profiled (one K6 kernel on the device); hybrid_step at
     bench.example_inputs' shapes on the card against the CPU; K7 (its Hopper body as
     routed, and its first body) timed
     beside both K1 bodies and torch.topk on the dense inputs of hybrid
     (512 x 100k), graph (256 x 1M), ivf_latency (8 x 2.1M) and phase 7's
     1M request (512 x 1M), every routed K7 call through the Hopper body.

The second-to-last stdout line is the kernel table as JSON, one row per
kernel: launches over the 1M phases' requests (K1-K4 and the fusion
kernel phase 7, K5, K6 and K8's rescore phase 8; K8's dots alone are on no path since the rescore
became one launch, 0) and over phase 9's eval configs (K2'; K7 is on no
path, 0), and times, plain times, bounds and library times summed over
one 1M request's launches (K7: phase 7's request; K2': one hybrid step's
call; K6 and K8's dots timed in chains of 10 launches, K8's rescore on
the device in phase 8's profiled hybrid_ivf request, K2' on the device
in 9f's profile of eval `hybrid`'s chain, the fusion kernel on the
device in phase 7's profiled request, the kernel's own time); the
last is
{"ok": true, "device": {...}}. Without a CUDA device, or run outside the
repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

# torch.profiler (Kineto + CUPTI) on an H100 with torch 2.11: left set up
# between sessions, later sessions lose their first device operations, more
# of them the longer the process has run, down to none; torn down after
# each session, every other session records nothing and the rest record
# every operation (tools/profiler_probe.py). So CUPTI is torn down after
# every session, and device_profile takes an empty session again.
os.environ["TEARDOWN_CUPTI"] = "1"

import numpy as np  # noqa: E402
import torch  # noqa: E402

N_DOCS = 100_000
DIM = 1024
VOCAB = 50_000
DF_MAX = 2048
QUERY_TERMS = 8
BATCH = 1024
TOL = 1e-3  # near-tie / score tolerance for bf16 inputs summed in fp32
# bench.py's >= 1M-chunk point (TPURAG_BENCH_N=1000000): vocab
# max(50000, int(5000 (n / 100000)^0.5) * 10), df_max 2048 n / 100000.
N_WIDE = 1_000_000
VOCAB_WIDE = 158_110
DF_MAX_WIDE = 20_480
BATCH_WIDE = 512
# benchmarks/kb_10m.py --n 1000000: 4096 lists, n_lists // 4 mixture
# centers, noise 0.3, ingest blocks of 131072, b=32 held-out queries, k=10.
N_IVF = 1_000_000
N_LISTS_IVF = 4096
N_CENTERS_IVF = 1024
NOISE_IVF = 0.3
IVF_BLOCK = 1 << 17
B_IVF = 32
K_IVF = 10
# Phase 8's bf16 check: an IVF of the KB's first rows.
N_IVF_BF16 = 100_000
# Published H100 SXM peaks (NVIDIA data sheet) for the kernels' bounds.
HBM_BYTES_S = 3.35e12
BF16_FLOPS_S = 989e12
INT8_OPS_S = 1979e12
FP32_OPS_S = 67e12  # outside the tensor cores; one compare counts as one


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, iters: int = 10, warmup: int = 2, chain: int = 1) -> float:
    """Median milliseconds of fn() over `iters` samples (CUDA events); a
    sample runs fn `chain` times back to back and counts their mean, so a
    launch whose host enqueue is slower than a short kernel is timed by the
    card's work, not the host's."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(chain):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / chain)
    return statistics.median(times)


def topk_agree(v_k, i_k, v_r, i_r, tol: float = TOL) -> float:
    """Kernel (v_k, i_k) against the plain version's (v_r, i_r), (B, k)
    each with one extra column in the plain version: scores within tol,
    and ids equal except where the plain scores tie within tol (a
    neighbour in its list, or the first entry past k). Returns the
    largest score difference."""
    k = v_k.shape[1]
    err = (v_k - v_r[:, :k]).abs().max().item() if v_k.numel() else 0.0
    assert err <= tol, f"scores differ by {err}"
    bad = (i_k != i_r[:, :k]).nonzero().tolist()
    for row, j in bad:
        near = [v_r[row, jj].item() for jj in (j - 1, j + 1)
                if 0 <= jj < v_r.shape[1]]
        assert any(abs(x - v_r[row, j].item()) <= tol for x in near), (
            f"row {row} slot {j}: id {i_k[row, j].item()} != "
            f"{i_r[row, j].item()} without a near tie")
    return err


def unit_rows(rng, n: int, d: int) -> np.ndarray:
    x = rng.standard_normal((n, d), dtype=np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


# K1's TMA + wgmma body at every edge it has: b in {1, 8, 130, 512}
# (one to five query tiles), n_valid < N and not a multiple of 128, D in
# {64, 72, 1024} (72: TMA's zero fill past D), k in {8, 31, 40, 64, 200,
# 600} (31: the largest lists that fit in shared memory beside the ring
# and the score tile; from 32 on they live in device memory).
SM90_SHAPES = [(1, 1000, 1000, 1024, 8), (8, 5000, 4777, 72, 8),
               (130, 3000, 2900, 64, 8), (512, 20_480, 20_000, DIM, 8),
               (130, 9000, 8999, DIM, 31), (8, 40_000, 39_999, DIM, 40),
               (130, 2500, 2397, DIM, 64), (130, 2500, 2397, DIM, 200),
               (8, 1000, 999, 64, 600), (512, 8192, 8000, 72, 600)]


def check_dense(b: int, n_rows: int, n_valid: int, d: int, k: int,
                dtype=torch.bfloat16, seed: int = 0,
                first_body: bool = False, timed: bool = False):
    """K1 (as routed, or its first body) against its plain version on the
    card. Returns (max_abs_err, dense_times(...) or None unless timed)."""
    from tpurag_torch.kernels.dense import (_dense_topk_first_body,
                                            dense_topk, dense_topk_ref)

    rng = np.random.default_rng(seed)
    emb = torch.zeros((n_rows, d), dtype=dtype, device="cuda")
    emb[:n_valid] = torch.from_numpy(unit_rows(rng, n_valid, d)).cuda().to(dtype)
    q = torch.from_numpy(unit_rows(rng, b, d)).cuda()
    v_r, i_r = dense_topk_ref(q, emb, n_valid, k + 1)
    fn = _dense_topk_first_body if first_body else dense_topk
    v_k, i_k = fn(q, emb, n_valid, k)
    torch.cuda.synchronize()
    assert v_k.shape == (b, k) and i_k.dtype == torch.int32
    assert torch.isfinite(v_k).all()
    err = topk_agree(v_k, i_k, v_r, i_r)
    del v_r, i_r
    return err, dense_times(q, emb, n_valid, k) if timed else None


def dense_times(q, emb, n_valid: int, k: int) -> dict:
    """Median ms on the same inputs of K1 as routed ("ms") and of K1's
    first body ("first_ms"), timed in turns (routed, first, first,
    routed; each the mean of its two), of the plain version and of
    torch.topk(q @ emb.T, k) in the corpus dtype ("lib_ms")."""
    from tpurag_torch.kernels.dense import (_dense_topk_first_body,
                                            dense_topk, dense_topk_ref)

    def routed():
        return cuda_ms(lambda: dense_topk(q, emb, n_valid, k))

    def first():
        return cuda_ms(lambda: _dense_topk_first_body(q, emb, n_valid, k))

    a, b, c, d = routed(), first(), first(), routed()
    live = emb[:n_valid]
    qb = q.to(emb.dtype)
    return {"ms": (a + d) / 2, "first_ms": (b + c) / 2,
            "plain_ms": cuda_ms(lambda: dense_topk_ref(q, emb, n_valid, k)),
            "lib_ms": cuda_ms(lambda: torch.topk(qb @ live.T, k))}


def merge_rows(rng, b: int, t: int, p: int, n_docs: int, flip: bool = True):
    """(B, t*p) host arrays in the fused merge's input contract: t slots
    of p lanes, each slot doc-ascending (unique docs, random fill, pads at
    2^30 with contribution 0), odd slots flipped unless flip=False (the
    full-row merge's contract)."""
    step = max(2 * n_docs // p, 2)
    doc = np.cumsum(rng.integers(1, step, (b, t, p)), axis=2) - 1
    fill = rng.integers(0, p + 1, (b, t, 1))
    pad = (np.arange(p)[None, None, :] >= fill) | (doc >= n_docs)
    doc = np.where(pad, 2**30, doc).astype(np.int32)
    con = np.where(pad, 0.0, rng.uniform(0.05, 4.0, (b, t, p))).astype(
        np.float32)
    if t > 1 and flip:
        doc[:, 1::2] = doc[:, 1::2, ::-1]
        con[:, 1::2] = con[:, 1::2, ::-1]
    return doc.reshape(b, t * p).copy(), con.reshape(b, t * p).copy()


def check_merge(b: int, t: int, p: int, cbits: int, k: int = 8,
                n_docs: int = N_DOCS, seed: int = 0, runs: int = 1,
                first=None):
    """K2 on flipped candidate rows (merge_segsum_topk) against its plain
    version on the card, `runs` times: the same merge order and the same
    sums, so ids and scores must be bit-identical. first (tools/
    k2_anatomy.py's build of K2's first body): also time the launch alone,
    the first body on the same rows and the plain version. Returns
    (max_abs_err, {"ms", "first_ms", "plain_ms"} or None)."""
    from tpurag_torch.kernels.bm25_merge import (block_classes,
                                                 flip_odd_blocks,
                                                 merge_segsum_topk,
                                                 merge_segsum_topk_ref)

    doc, con = (torch.from_numpy(x).cuda() for x in
                merge_rows(np.random.default_rng(seed), b, t, p, n_docs))
    pp = p if t > 1 else t * p
    v_r, i_r = merge_segsum_topk_ref(doc, con, k, pp, t, cbits)
    for _ in range(runs):
        v_k, i_k = merge_segsum_topk(doc, con, k, pp, t, cbits)
        torch.cuda.synchronize()
        where = f"t={t} p={p} cbits={cbits}"
        assert torch.equal(i_k, i_r), f"ids differ at {where}"
        assert torch.equal(v_k, v_r), f"scores differ at {where}"
    assert (i_k[:, 0] >= 0).any(), "no hits at all: the case is vacuous"
    err = (v_k - v_r).abs().max().item()
    if first is None:
        return err, None
    tool = load_tool("k2_anatomy")
    rows = (flip_odd_blocks(doc, pp, t), flip_odd_blocks(con, pp, t)) \
        if t > 1 else (doc, con)  # the slots turned back, as the wrapper
    widths, mats, spec = block_classes(*rows, pp, t, cbits)
    return err, {
        "ms": k2_classes_launch_ms(widths, mats, [spec],
                                   *k2_out(b, k, "cuda")),
        "first_ms": cuda_ms(lambda: tool.first_topk(first, doc, con, k, pp,
                                                    t, cbits), chain=10),
        "plain_ms": cuda_ms(lambda: merge_segsum_topk_ref(doc, con, k, pp, t,
                                                          cbits))}


def k2_classes_launch_ms(widths, mats, classes, out_v, out_i) -> float:
    """K2's device time: its launch alone, repeated on one prepared table
    (the wrapper's host work, the table build and upload, left out), in
    chains of 10 (its host enqueue outlasts a small launch)."""
    from tpurag_torch.kernels.bm25_merge import _k2_prepare, _k2_run
    from tpurag_torch.kernels.runtime import load_kernels

    fn = load_kernels().tr_topk_rows
    prep = _k2_prepare(widths, mats, classes, out_v, out_i)
    return cuda_ms(lambda: _k2_run(fn, prep), chain=10)


def check_full(b: int, t: int, p: int, cbits: int, n_docs: int = N_DOCS,
               seed: int = 0, timed: bool = False):
    """K3 fed (doc, con) rows (merge_segsum_full) against its plain version
    on the card: the same merge order, the same sums, so seg and doc_s
    must be bit-identical. Returns (max_abs_err, kernel ms: the launch
    alone, plain ms)."""
    from tpurag_torch.kernels.bm25_merge import (block_classes,
                                                 merge_segsum_full,
                                                 merge_segsum_full_ref)

    doc, con = (torch.from_numpy(x).cuda() for x in merge_rows(
        np.random.default_rng(seed), b, t, p, n_docs, flip=False))
    seg_k, doc_k = merge_segsum_full(doc, con, p, t, cbits)
    seg_r, doc_r = merge_segsum_full_ref(doc, con, p, t, cbits)
    torch.cuda.synchronize()
    assert seg_k.shape == (b, t * p) and doc_k.dtype == torch.int32
    assert torch.equal(doc_k, doc_r), f"doc_s differ at t={t} p={p} cbits={cbits}"
    assert torch.equal(seg_k, seg_r), f"seg differ at t={t} p={p} cbits={cbits}"
    assert (seg_k > 0).any(), "no segment sums at all: the case is vacuous"
    if not timed:
        return 0.0, None, None
    widths, mats, spec = block_classes(doc, con, p, t, cbits)
    return (0.0, k3_launch_ms((widths, mats, [], [spec], 0, 0)),
            cuda_ms(lambda: merge_segsum_full_ref(doc, con, p, t, cbits)))


def csr_windows(rng, b: int, t: int, p_max: int, n_docs: int):
    """Host arrays in bm25_topk_fused's input contract: CSR postings of
    max(4t, 8) terms (each doc-ascending, unique docs, df 1..p_max, no
    tail padding) and (b, t) query windows into them, with the edge cases
    in: row 0's first window is the last term's, whose start lies past
    nnz - p_max and is clamped; ~15% of the windows (and the last row's
    last) have length 0; docs >= n_valid = 7/8 n_docs are masked. Returns
    (starts, lens, idf, post_doc, post_impact, n_valid)."""
    n_terms = max(4 * t, 8)
    df = rng.integers(1, p_max + 1, n_terms)
    df[-1] = max(1, p_max // 2)
    bounds = np.concatenate([[0], np.cumsum(df)])
    post_doc = np.concatenate([np.sort(rng.choice(n_docs, m, replace=False))
                               for m in df]).astype(np.int32)
    post_impact = rng.uniform(0.2, 2.0, len(post_doc)).astype(np.float32)
    if len(post_doc) < p_max:  # an index holds at least p_max postings
        pad = p_max - len(post_doc)
        post_doc = np.concatenate([post_doc, np.full(pad, 2**30, np.int32)])
        post_impact = np.concatenate([post_impact, np.zeros(pad, np.float32)])
    tid = rng.integers(0, n_terms, (b, t))
    tid[0, 0] = n_terms - 1
    starts = bounds[tid].astype(np.int32)
    lens = df[tid].astype(np.int32)
    lens[rng.random((b, t)) < 0.15] = 0
    lens[-1, -1] = 0
    idf = rng.uniform(0.5, 3.0, (b, t)).astype(np.float32)
    return starts, lens, idf, post_doc, post_impact, n_docs - n_docs // 8


def check_fused(b: int, t: int, p_max: int, cbits: int, k: int = 8,
                n_docs: int = N_DOCS, seed: int = 0):
    """K2' against its plain version on the card on csr_windows' draw:
    the same gather, network and sums, so ids and scores must be
    bit-identical (else it raises)."""
    *arrays, n_valid = csr_windows(np.random.default_rng(seed), b, t, p_max,
                                   n_docs)
    fused_agree(arrays, n_valid, k, p_max, cbits)


def fused_agree(arrays, n_valid: int, k: int, p_max: int, cbits: int,
                hits: bool = True):
    """K2' (bm25_topk_fused) against bm25_topk_fused_ref on the card on
    (starts, lens, idf, post_doc, post_impact), host arrays or tensors:
    bit-identical ids and scores, else it raises; with hits, some row has
    one (the case is not vacuous), else none has."""
    from tpurag_torch.kernels.bm25_merge import (bm25_topk_fused,
                                                 bm25_topk_fused_ref)

    args = [torch.as_tensor(x).cuda() for x in arrays] + [n_valid]
    kw = {"k": k, "p_max": p_max, "cbits": cbits}
    v_k, i_k = bm25_topk_fused(*args, **kw)
    v_r, i_r = bm25_topk_fused_ref(*args, **kw)
    torch.cuda.synchronize()
    b, t = args[0].shape
    assert v_k.shape == (b, k) and i_k.dtype == torch.int32
    where = f"b={b} t={t} p_max={p_max} cbits={cbits} k={k}"
    assert torch.equal(i_k, i_r), f"K2' ids differ at {where}"
    assert torch.equal(v_k, v_r), f"K2' scores differ at {where}"
    assert (i_k[:, 0] >= 0).any() == hits, f"K2' hits at {where}: {hits}"


# K2''s edge cases beyond csr_windows' draws (csrc/bm25_merge.cu routes
# each row by its live lanes: at most W/2 run the network on the live
# lanes, more the full network; more rows than SMs take the build for two
# blocks an SM). name -> (b, t, p_max): "full": every lane live (16384
# lanes, the full network); "half": rows of W/2 and of W/2 + 1 live lanes
# in one launch (both routes); "one": one live lane a row, in an odd
# (flipped) window; "none": no live lane; "mixed": 200 rows of every kind
# (every lane, half, random lengths, one lane) in the two-blocks build.
FUSED_CASES = {"full": (16, 8, 2048), "half": (8, 8, 64),
               "one": (16, 8, 2048), "none": (8, 8, 2048),
               "mixed": (200, 8, 2048)}


def fused_case(name: str, seed: int = 0, b=None):
    """Host arrays (starts, lens, idf, post_doc, post_impact, n_valid,
    p_max) of FUSED_CASES[name] (b rows if given): 2t terms of p_max
    distinct docs each, all below n_valid = N_DOCS, so every lane inside a
    window is live."""
    b0, t, p_max = FUSED_CASES[name]
    b = b or b0
    rng = np.random.default_rng(seed)
    n_terms = 2 * t
    post_doc = np.concatenate(
        [np.sort(rng.choice(N_DOCS, p_max, replace=False))
         for _ in range(n_terms)] + [np.full(p_max, 2**30)]).astype(np.int32)
    post_impact = rng.uniform(0.2, 2.0, len(post_doc)).astype(np.float32)
    starts = (rng.integers(0, n_terms, (b, t)) * p_max).astype(np.int32)
    lens = np.full((b, t), p_max, np.int32)
    idf = rng.uniform(0.5, 3.0, (b, t)).astype(np.float32)
    if name == "half":
        lens[:, t // 2:] = 0
        lens[1::2, t // 2] = 1
    elif name == "one":
        lens[:] = 0
        lens[:, 3] = 1
    elif name == "none":
        lens[:] = 0
    elif name == "mixed":
        kind = np.arange(b) % 4
        lens[kind == 1, t // 2:] = 0
        lens[kind == 2] = rng.integers(0, p_max + 1, ((kind == 2).sum(), t))
        lens[kind == 3] = 0
        lens[kind == 3, 3] = 1
    return starts, lens, idf, post_doc, post_impact, N_DOCS, p_max


def check_fused_case(name: str, cbits: int, k: int = 8, seed: int = 0):
    *arrays, n_valid, p_max = fused_case(name, seed)
    fused_agree(arrays, n_valid, k, p_max, cbits, hits=name != "none")


# K7's Hopper body at every edge it has: b in {1, 8, 32, 33, 130, 512,
# 4160} (form (i) up to 32 resident queries; from 33 on form (ii), whose
# second half-box is then all zero fill), n_valid in {0, 5, 63, mid-tile},
# an odd count of 64-row tiles, D in {64, 1024, 1152, 1344} (1344: the
# widest form (ii) tile, its ring at the least depth), k in {1, 8, 40,
# 200, 600} (k > n_valid: empty slots); the lists in shared memory, and
# in device memory (form (i) at k = 600; form (ii) at b = 4160 and at D =
# 1152 and 1344 past a few entries per query); form (ii)'s ring at 3, 4
# and 5 stages.
K7_SHAPES = [(1, 1000, 1000, DIM, 8), (8, 5000, 4777, 64, 40),
             (8, 1000, 999, DIM, 600),
             (32, 20_480, 20_000, DIM, 200), (8, 40_000, 39_999, DIM, 40),
             (1, 1000, 63, 64, 200), (33, 3000, 2900, DIM, 8),
             (130, 200, 5, DIM, 1), (130, 300, 0, 64, 8),
             (130, 320, 300, DIM, 40), (512, 100, 63, 1344, 8),
             (512, 20_480, 20_000, DIM, 8), (256, 20_480, 20_000, 1152, 200),
             (4160, 20_480, 20_000, DIM, 8), (4160, 5000, 4900, DIM, 200)]


def check_dense_co(b: int, n_rows: int, n_valid: int, d: int, k: int,
                   dtype=torch.bfloat16, seed: int = 0,
                   first_body: bool = False, misalign: bool = False):
    """K7 (as routed, or its first body) against dense_topk_ref on the
    card (within TOL, ids equal but at near ties) and against K1 (the same
    scores, so ids equal but at near ties). misalign: the corpus starts one
    element past a 16-byte boundary. Returns max_abs_err against the plain
    version."""
    from tpurag_torch.kernels.dense import (_dense_topk_co_cuda, dense_topk,
                                            dense_topk_ref)

    rng = np.random.default_rng(seed)
    flat = torch.zeros(n_rows * d + misalign, dtype=dtype, device="cuda")
    emb = flat[int(misalign):].view(n_rows, d)
    emb[:n_valid] = torch.from_numpy(unit_rows(rng, n_valid, d)).cuda().to(dtype)
    q = torch.from_numpy(unit_rows(rng, b, d)).cuda()
    v_1, i_1 = dense_topk(q, emb, n_valid, k)
    v_r, i_r = dense_topk_ref(q, emb, n_valid, k + 1)
    v_c, i_c = _dense_topk_co_cuda(q, emb, n_valid, k,
                                   sm90=False if first_body else None)
    torch.cuda.synchronize()
    assert v_c.shape == (b, k) and i_c.dtype == torch.int32
    assert torch.isfinite(v_c).all()
    err = topk_agree(v_c, i_c, v_r, i_r)
    topk_agree(v_c, i_c, torch.cat([v_1, v_r[:, k:]], 1),
               torch.cat([i_1, i_r[:, k:]], 1))
    return err


def combine_rows(g: int, wn: int, ww: int, n_docs: int = N_DOCS,
                 seed: int = 0):
    """Narrow (g, wn) and wide (g, ww) full rows on the card, as the
    wide path makes them: plain full-row merges of random doc-sorted
    term slots (narrow t=8; wide t=1 up to 4096 lanes, 2 at 32768, 4
    past it) over one doc range, so the two sides share docs. Returns
    (n_val, n_doc, w_seg, w_doc, window)."""
    from tpurag_torch.kernels.bm25_merge import merge_segsum_full_ref

    rng = np.random.default_rng(seed)
    t_w = 1 if ww <= 4096 else min(4, ww // 16384)
    sides = []
    for w, t in ((wn, 8), (ww, t_w)):
        doc, con = (torch.from_numpy(x).cuda() for x in merge_rows(
            rng, g, t, w // t, n_docs, flip=False))
        sides.append(merge_segsum_full_ref(doc, con, w // t, t))
    (n_val, n_doc), (w_seg, w_doc) = sides
    return n_val, n_doc, w_seg.contiguous(), w_doc.contiguous(), 8 + t_w


def check_combine(g: int, wn: int, ww: int, k: int, n_docs: int = N_DOCS,
                  seed: int = 0, timed: bool = False):
    """K4 against combine_narrow_wide on the card: bit-identical ids and
    scores. Returns (max_abs_err, kernel ms, plain ms)."""
    from tpurag_torch.kernels.bm25_join import (combine_narrow_wide,
                                                combine_topk)

    n_val, n_doc, w_seg, w_doc, window = combine_rows(g, wn, ww, n_docs, seed)
    v_k, i_k = combine_topk(n_val, n_doc, w_seg, w_doc, k, window)
    v_r, i_r = combine_narrow_wide(n_val, n_doc, w_seg, w_doc, k, window)
    torch.cuda.synchronize()
    assert v_k.shape == (g, k) and i_k.dtype == torch.int32
    assert torch.equal(i_k, i_r), f"ids differ at wn={wn} ww={ww} k={k}"
    assert torch.equal(v_k, v_r), f"scores differ at wn={wn} ww={ww} k={k}"
    assert (i_k[:, 0] >= 0).any(), "no hits at all: the case is vacuous"
    if not timed:
        return 0.0, None, None
    return (0.0, k4_launch_ms(n_val, n_doc, [(w_seg, w_doc, None, None)], k),
            cuda_ms(lambda: combine_narrow_wide(n_val, n_doc, w_seg, w_doc, k,
                                                window)))


def k4_launch_ms(n_val, n_doc, classes, k: int) -> float:
    """K4's device time: its launch alone, repeated on one prepared table
    (the wrapper's host work, the table build and upload, left out)."""
    from tpurag_torch.kernels.bm25_join import _k4_prepare, _k4_run
    from tpurag_torch.kernels.runtime import load_kernels

    fn = load_kernels().tr_combine_topk_classes
    prep = _k4_prepare(n_val, classes, k)
    return cuda_ms(lambda: _k4_run(fn, prep, n_val, n_doc))


def k4_full_row(rng, w: int, t: int, n_docs: int, m=None, lo: int = 0,
                value=None):
    """One (w,) full row as merge_segsum_full leaves it, on the host: m
    sorted docs from [lo, n_docs), each over 1..t lanes, its sum at its
    end lane and NEG_INF on the others, the parked tail at doc 2^30 with a
    0 at its end lane."""
    if m is None:
        m = int(rng.integers(max(1, w // (2 * t)), max(2, w // t)))
    m = min(m, n_docs - lo)
    docs = np.sort(rng.choice(np.arange(lo, n_docs), size=m, replace=False))
    lanes = np.repeat(docs, rng.integers(1, t + 1, size=m))[:w]
    doc = np.full(w, 2**30, np.int32)
    val = np.full(w, -3.0e38, np.float32)
    doc[:len(lanes)] = lanes
    ends = np.r_[lanes[:-1] != lanes[1:], True]
    v = rng.uniform(0.05, 4.0, len(lanes)).astype(np.float32)
    if value is not None:
        v[:] = value
    val[:len(lanes)][ends] = v[ends]
    if len(lanes) < w:
        val[w - 1] = 0.0
    return val, doc


# K4's edge cases (csrc/bm25_combine.cu: CHUNK = 4096 wide lanes a work
# item, narrow tiles of NTILE = 2048 lanes): name -> (wn_max, [(members,
# Ww)], n_docs, narrow t, wide t). "mixed": Ww below, equal to and not a
# multiple of CHUNK, a one-member class, own narrow widths below wn_max,
# permuted rows; "tiles": narrow docs crowded into one item's doc range
# (eight narrow tiles); "ties": every total equal, so ties cross items;
# "invalid": an all-invalid wide row and a row with no valid narrow lane;
# "straddle": a doc over wide lanes 4094..4097 (its end lane in the second
# item) whose narrow lane is that item's first doc; "sparse": fewer
# candidates than k.
K4_CASES = {"mixed": (2048, [(3, 5000), (1, 4096), (2, 100), (2, 8195)],
                      20_000, 4, 3),
            "tiles": (16384, [(2, 12288)], 200_000, 2, 3),
            "ties": (1024, [(2, 9000)], 30_000, 4, 3),
            "invalid": (1024, [(3, 4500)], 30_000, 4, 3),
            "straddle": (1024, [(1, 8192)], 30_000, 4, 1),
            "sparse": (64, [(2, 300), (1, 40)], 100_000, 2, 2)}


def k4_case(name: str, device="cuda", seed: int = 0):
    """(n_val, n_doc, classes, window) of one K4_CASES case: classes as
    combine_topk_classes takes them, (w_seg, w_doc, sel, own narrow
    width) per class."""
    wn_max, specs, n_docs, t_n, t_w = K4_CASES[name]
    rng = np.random.default_rng(seed)
    h = sum(g for g, _ in specs)
    perm = rng.permutation(h)
    widths = np.minimum(rng.choice([wn_max, wn_max // 2, wn_max // 8, 37], h),
                        wn_max)
    n_val = np.full((h, wn_max), -3.0e38, np.float32)
    n_doc = np.full((h, wn_max), 2**30, np.int32)
    for r in range(h):
        kw = {}
        if name == "tiles":
            widths[r] = wn_max
            kw = {"m": 11_000, "lo": 1000}
        elif name == "sparse":
            kw = {"m": 3}
        w = int(widths[r])
        n_val[r, :w], n_doc[r, :w] = k4_full_row(
            rng, w, t_n, 40_000 if name == "tiles" else n_docs,
            value=1.0 if name == "ties" else None, **kw)
    classes, at = [], 0
    for g, ww in specs:
        rows = [k4_full_row(rng, ww, t_w, n_docs,
                            m=5 if name == "sparse" else None,
                            value=1.0 if name == "ties" else None)
                for _ in range(g)]
        w_seg = np.stack([v for v, _ in rows])
        w_doc = np.stack([d for _, d in rows])
        members = perm[at:at + g]
        classes.append([w_seg, w_doc, members, widths[members]])
        at += g
    if name == "invalid":
        w_seg, w_doc, sel, _ = classes[0]
        w_seg[1], w_doc[1] = -3.0e38, 2**30
        n_val[sel[2]] = -3.0e38
    if name == "straddle":
        w_seg, w_doc, sel, wn = classes[0]
        w_doc[0, 4094:4098] = w_doc[0, 4093] + 1
        w_seg[0, 4094:4097] = -3.0e38
        w_seg[0, 4097] = 2.5
        d = int(w_doc[0, 4097])
        assert w_doc[0, 4098] > d
        r, w = int(sel[0]), int(wn[0])
        pos = int(np.searchsorted(n_doc[r, :w], d))
        # d's narrow lanes: an invalid one, then its end lane with a sum
        # high enough that a second copy of d would show in any top-k.
        n_doc[r, pos:pos + 2] = d
        n_val[r, pos:pos + 2] = (-3.0e38, 100.0)
        assert (np.diff(n_doc[r]) >= 0).all()
    n_val, n_doc = (torch.from_numpy(x).to(device) for x in (n_val, n_doc))
    classes = [(torch.from_numpy(ws).to(device),
                torch.from_numpy(wd).to(device), sel, wn)
               for ws, wd, sel, wn in classes]
    return n_val, n_doc, classes, t_n + t_w


def check_combine_classes(name: str, k: int, runs: int = 2, seed: int = 0):
    """The batched K4 on a K4_CASES case against combine_classes_ref on the
    card, bit for bit, `runs` times (block arrival order must not show)."""
    from tpurag_torch.kernels.bm25_join import (combine_classes_ref,
                                                combine_topk_classes)

    n_val, n_doc, classes, window = k4_case(name, seed=seed)
    v_r, i_r = combine_classes_ref(n_val, n_doc, classes, k, window)
    for _ in range(runs):
        v_k, i_k = combine_topk_classes(n_val, n_doc, classes, k, window)
        torch.cuda.synchronize()
        assert torch.equal(i_k, i_r), f"K4 ids differ: {name} k={k}"
        assert torch.equal(v_k, v_r), f"K4 scores differ: {name} k={k}"
    assert (i_r[:, 0] >= 0).any(), f"{name}: no hits, the case is vacuous"
    if name == "sparse" and k >= 16:  # at most 3 + 5 docs a row
        assert (i_r[:, -1] == -1).all(), "sparse: k must pass the candidates"


def k3_matrix(rng, w: int, lists, n_docs: int):
    """One bucket matrix of width w as index/inverted.py builds them: row
    0 the pad row, then one row per doc list (sorted, unique, at most w),
    padded with doc 2^30 and impact 0. Returns (doc, imp, live) host
    arrays."""
    doc = np.full((len(lists) + 1, w), 2**30, np.int32)
    imp = np.zeros((len(lists) + 1, w), np.float32)
    live = np.zeros(len(lists) + 1, np.int32)
    for r, docs in enumerate(lists, start=1):
        doc[r, :len(docs)] = docs
        imp[r, :len(docs)] = rng.uniform(0.2, 2.0, len(docs))
        live[r] = len(docs)
    return doc, imp, live


def k3_lists(rng, n_rows: int, w: int, n_docs: int, fill=(0.5, 1.0)):
    """n_rows random doc lists of (fill) x w docs from [0, n_docs)."""
    lo, hi = max(1, int(fill[0] * w)), max(1, int(fill[1] * w))
    return [np.sort(rng.choice(n_docs, int(rng.integers(lo, hi + 1)),
                               replace=False)) for _ in range(n_rows)]


def k3_straddle_lists(rng, t: int, w: int, n_docs: int, chunk: int = 4096):
    """t doc lists of at most w docs that all hold doc n_docs // 2, with
    chunk - t // 2 docs below it in all: its t lanes take merged ranks
    chunk - t // 2 .. chunk + t // 2 - 1, across an item boundary."""
    d = n_docs // 2
    below = np.full(t, (chunk - t // 2) // t)
    below[:(chunk - t // 2) % t] += 1
    out = []
    for x in below:
        above = int(rng.integers(1, w - x))
        out.append(np.concatenate([
            np.sort(rng.choice(d, int(x), replace=False)), [d],
            d + 1 + np.sort(rng.choice(n_docs - d - 1, above,
                                       replace=False))]))
    return out


def k3_class(rng, mats, p_max: int, t: int, g: int, cbits: int, sel=None,
             empty=0.0, rows=None):
    """A class spec as merge_segsum_full_classes takes it, its slots drawn
    from `mats` ({width: (doc, imp, live)}, host): widths <= p_max at
    random (a share `empty` of the slots empty), or the given (g, t)
    (width, matrix row) pairs in `rows`; idf in [0.5, 3)."""
    widths = sorted(w for w in mats if w <= p_max)
    bucketw = np.zeros((g, t), np.int32)
    rowid = np.zeros((g, t), np.int32)
    live = np.zeros((g, t), np.int32)
    for i in range(g):
        for s in range(t):
            if rows is not None:
                w, r = rows[i][s]
            elif rng.random() < empty:
                continue
            else:
                w = int(rng.choice(widths))
                r = int(rng.integers(1, mats[w][0].shape[0]))
            bucketw[i, s] = w
            rowid[i, s] = r
            live[i, s] = mats[w][2][r] if w in mats else 0
    idf = rng.uniform(0.5, 3.0, (g, t)).astype(np.float32)
    return (p_max, t, cbits, sel, bucketw, rowid, live, idf)


# K3's edge cases (csrc/bm25_full.cu: output chunks of CHUNK = 4096 lanes
# a work item). "straddle": t = 4, a doc in every slot whose 4 lanes take
# ranks 4094..4097 (its end lane in the second item); "straddle16": t =
# 16 at p = 512, the same at ranks 4088..4103; "every16": t = 16 at p =
# 64, 24 docs in every slot; "parked": an all-parked row, empty slots, a
# slot wider than p_max, t = 1 and w < p_max; "wide4" / "wide8": W =
# 131072 at t = 4 and t = 8; "packed12" / "packed14": cbits 12 and 14
# (docs past (2^31 - 1) >> 14 park); "mix": narrow and wide classes of
# several shapes in one launch, rows permuted.
K3_CASES = ("straddle", "straddle16", "every16", "parked", "wide4", "wide8",
            "packed12", "packed14", "mix")


def k3_case(name: str, device="cuda", seed: int = 0):
    """(widths, mats, narrow, wide, h, wn_max) of one K3_CASES case, as
    merge_segsum_full_classes takes them (mats on `device`)."""
    rng = np.random.default_rng(seed)
    mats, narrow, wide, h, wn_max = {}, [], [], 0, 16

    def add(w, lists, n_docs):
        mats[w] = k3_matrix(rng, w, lists, n_docs)

    def narrow_class(p_max, t, g, cbits=0, **kw):
        nonlocal h
        sel = np.arange(h, h + g)
        h += g
        narrow.append(k3_class(rng, mats, p_max, t, g, cbits, sel, **kw))

    if name in ("straddle", "straddle16"):
        t, w = (4, 2048) if name == "straddle" else (16, 512)
        add(w, k3_straddle_lists(rng, t, w, 20_000)
            + k3_lists(rng, 6, w, 20_000), 20_000)
        wide.append(k3_class(rng, mats, w, t, 3, 0, rows=[
            [(w, s + 1) for s in range(t)]]
            + [[(w, int(rng.integers(1, t + 7))) for _ in range(t)]
               for _ in range(2)]))
    elif name == "every16":
        common = np.sort(rng.choice(3000, 24, replace=False))
        lists = [np.union1d(common, rng.choice(3000, int(rng.integers(0, 40)),
                                               replace=False))[:64]
                 for _ in range(16)]
        add(64, lists, 3000)
        wide.append(k3_class(rng, mats, 64, 16, 2, 0, rows=[
            [(64, s + 1) for s in range(16)],
            [(64, 16 - s) for s in range(16)]]))
    elif name == "parked":
        for w in (16, 64, 256):
            add(w, k3_lists(rng, 5, w, 5000), 5000)
        wn_max = 4 * 64
        narrow_class(64, 4, 3, empty=0.3)
        narrow_class(64, 4, 1, rows=[[(0, 0)] * 4])     # all parked
        narrow_class(64, 4, 1, rows=[[(256, 1), (64, 2), (0, 0), (16, 3)]])
        narrow_class(64, 1, 2, rows=[[(16, 1)], [(64, 4)]])
        wide.append(k3_class(rng, mats, 256, 2, 2, 0, rows=[
            [(0, 0), (0, 0)], [(256, 2), (64, 1)]]))
    elif name in ("wide4", "wide8"):
        t, w = (4, 32768) if name == "wide4" else (8, 16384)
        add(w, k3_lists(rng, t + 2, w, N_WIDE, fill=(0.6, 1.0)), N_WIDE)
        wide.append(k3_class(rng, mats, w, t, 2, 0))
    elif name in ("packed12", "packed14"):
        cbits = 12 if name == "packed12" else 14
        n_docs = 2**18 if cbits == 12 else 200_000
        for w in (64, 1024, 4096):
            add(w, k3_lists(rng, 6, w, n_docs), n_docs)
        wn_max = 8 * 1024
        narrow_class(1024, 8, 3, cbits, empty=0.2)
        narrow_class(64, 2, 2, cbits)
        wide.append(k3_class(rng, mats, 4096, 2, 2, cbits))
    elif name == "mix":
        for w in (16, 64, 256, 1024, 2048, 4096, 16384):
            add(w, k3_lists(rng, 6, w, 100_000), 100_000)
        wn_max = 8 * 2048
        narrow_class(64, 1, 3)
        narrow_class(256, 2, 2, empty=0.2)
        narrow_class(2048, 8, 4, empty=0.1)
        narrow_class(1024, 4, 2)
        perm = rng.permutation(h)
        narrow[:] = [(*c[:3], perm[c[3]], *c[4:]) for c in narrow]
        wide.append(k3_class(rng, mats, 4096, 1, 3, 0))
        wide.append(k3_class(rng, mats, 16384, 2, 2, 0))
        wide.append(k3_class(rng, mats, 16384, 4, 2, 0, empty=0.25))
    else:
        raise KeyError(name)
    widths = tuple(sorted(mats))
    dev_mats = tuple((torch.from_numpy(mats[w][0]).to(device),
                      torch.from_numpy(mats[w][1]).to(device))
                     for w in widths)
    return widths, dev_mats, narrow, wide, h, wn_max


def check_full_classes(name: str, runs: int = 2, seed: int = 0):
    """The batched K3 on a K3_CASES case against its plain version on the
    card, bit for bit, `runs` times (block arrival order must not show)."""
    from tpurag_torch.kernels.bm25_merge import (
        merge_segsum_full_classes, merge_segsum_full_classes_ref)

    args = k3_case(name, seed=seed)
    n_val_r, n_doc_r, wide_r = merge_segsum_full_classes_ref(*args)
    for _ in range(runs):
        n_val, n_doc, wide = merge_segsum_full_classes(*args)
        torch.cuda.synchronize()
        got = [n_val, n_doc, *[x for pair in wide for x in pair]]
        want = [n_val_r, n_doc_r, *[x for pair in wide_r for x in pair]]
        for i, (g, w) in enumerate(zip(got, want)):
            assert g.shape == w.shape and g.dtype == w.dtype, (name, i)
            assert torch.equal(g, w), f"K3 differs: {name}, output {i}"
    sums = [n_val_r, *[v for v, _ in wide_r]]
    assert any((v > 0).any() for v in sums), f"{name}: no sums, vacuous"


# K2's edge cases (csrc/bm25_topk.cu: one block per query row, its slots'
# live lanes staged and merged in shared memory). "empty": empty slots, an
# all-empty row; "live": live lanes below the bucket width, and cut short
# of a row's docs; "narrow": slots narrower than p_max; "t1": t = 1 at two
# widths, packed and not; "sparse": k above the live lanes; "ties": equal
# scores across docs (doc order breaks them); "park": cbits 14 with docs
# past (2^31 - 1) >> 14 parked; "full": t = 8 x 2048 all live (16384
# lanes, the most shared memory); "many": t = 256 slots of 64 lanes; "mix":
# classes of several (p_max, t) and both layouts in one launch, rows
# permuted, one result row left to no class. name -> k (8 to 300 argmax
# passes).
K2_CASES = {"empty": 8, "live": 8, "narrow": 8, "t1": 8, "sparse": 300,
            "ties": 24, "park": 8, "full": 8, "many": 8, "mix": 40}


def k2_case(name: str, device="cuda", seed: int = 0):
    """(widths, mats, classes, h, k) of one K2_CASES case, as
    merge_segsum_topk_classes takes them (mats on `device`; the results go
    into (h, k) buffers)."""
    rng = np.random.default_rng(seed)
    mats, classes, h = {}, [], 0

    def add(w, lists, n_docs, value=None):
        mats[w] = k3_matrix(rng, w, lists, n_docs)
        if value is not None:
            mats[w][1][mats[w][1] > 0] = value

    def cls(p_max, t, g, cbits=0, **kw):
        nonlocal h
        sel = np.arange(h, h + g)
        h += g
        classes.append(k3_class(rng, mats, p_max, t, g, cbits, sel, **kw))

    if name == "empty":
        for w in (16, 64, 256):
            add(w, k3_lists(rng, 5, w, 5000), 5000)
        cls(256, 4, 3, empty=0.4)
        cls(256, 4, 1, rows=[[(0, 0)] * 4])
        cls(64, 2, 2, 14, rows=[[(0, 0), (64, 2)], [(16, 1), (0, 0)]])
    elif name == "live":
        for w in (256, 1024):
            add(w, k3_lists(rng, 6, w, 20_000), 20_000)
        cls(1024, 4, 4)
        cls(1024, 8, 3, 14)
        for c in classes:  # half the slots merge only part of their row
            live = c[6]
            cut = rng.random(live.shape) < 0.5
            live[cut] = np.maximum(live[cut] // 3, 1)
    elif name == "narrow":
        for w in (16, 32, 64, 128, 2048):
            add(w, k3_lists(rng, 4, w, 50_000), 50_000)
        cls(2048, 8, 3, rows=[[(16, 1), (32, 2), (64, 1), (128, 3),
                               (2048, 1), (16, 2), (32, 1), (64, 4)]] * 3)
        cls(2048, 2, 2, 14, rows=[[(16, 3), (128, 2)]] * 2)
    elif name == "t1":
        for w in (64, 2048):
            add(w, k3_lists(rng, 5, w, 60_000), 60_000)
        cls(64, 1, 3)
        cls(2048, 1, 3, 14)
        cls(2048, 1, 2)
    elif name == "sparse":
        for w in (16, 64):
            add(w, k3_lists(rng, 4, w, 1000, fill=(0.1, 0.3)), 1000)
        cls(64, 4, 3)
        cls(16, 2, 2, 14)
    elif name == "ties":
        add(256, k3_lists(rng, 6, 256, 3000), 3000, value=1.0)
        cls(256, 4, 3)
        for c in classes:
            c[7][:] = 1.5
    elif name == "park":
        for w in (64, 1024, 4096):
            add(w, k3_lists(rng, 6, w, 200_000), 200_000)
        cls(4096, 4, 3, 14)
        cls(1024, 2, 2, 14)
    elif name == "full":
        add(2048, k3_lists(rng, 10, 2048, N_WIDE, fill=(1.0, 1.0)), N_WIDE)
        cls(2048, 8, 2)
        cls(2048, 8, 1, 11)
    elif name == "many":
        add(64, k3_lists(rng, 300, 64, 30_000), 30_000)
        cls(64, 256, 2)
    elif name == "mix":
        for w in (16, 64, 256, 1024, 2048):
            add(w, k3_lists(rng, 6, w, 100_000), 100_000)
        cls(64, 1, 3)
        cls(256, 2, 2, empty=0.2)
        cls(2048, 8, 4, empty=0.1)
        cls(1024, 4, 2, 14)
        h += 1  # a row of no class
        perm = rng.permutation(h)
        classes[:] = [(*c[:3], perm[c[3]], *c[4:]) for c in classes]
    else:
        raise KeyError(name)
    widths = tuple(sorted(mats))
    dev_mats = tuple((torch.from_numpy(mats[w][0]).to(device),
                      torch.from_numpy(mats[w][1]).to(device))
                     for w in widths)
    return widths, dev_mats, classes, h, K2_CASES[name]


def k2_out(h: int, k: int, device):
    """(h, k) result buffers as a search makes them: (NEG_INF, -1)."""
    return (torch.full((h, k), -3.0e38, device=device),
            torch.full((h, k), -1, dtype=torch.int32, device=device))


def check_topk_classes(name: str, runs: int = 2, seed: int = 0):
    """The batched K2 on a K2_CASES case against its plain version on the
    card, bit for bit, `runs` times (a fresh pair of result buffers each
    time)."""
    from tpurag_torch.kernels.bm25_merge import (
        merge_segsum_topk_classes, merge_segsum_topk_classes_ref)

    widths, mats, classes, h, k = k2_case(name, seed=seed)
    v_r, i_r = merge_segsum_topk_classes_ref(widths, mats, classes,
                                             *k2_out(h, k, "cuda"))
    for _ in range(runs):
        v_k, i_k = merge_segsum_topk_classes(widths, mats, classes,
                                             *k2_out(h, k, "cuda"))
        torch.cuda.synchronize()
        assert torch.equal(i_k, i_r), f"K2 ids differ: {name}"
        assert torch.equal(v_k, v_r), f"K2 scores differ: {name}"
    assert (i_r[:, 0] >= 0).any(), f"{name}: no hits, the case is vacuous"
    if name == "sparse":
        assert (i_r[:, -1] == -1).all(), "sparse: k must pass the live lanes"


# K5 at every edge its two bodies have: b in {1, 8, 32} (the wgmma body's
# 32-query tile, queries resident) and {33, 40, 512} (its 128-query tile),
# n_valid < N and not a multiple of 128, D in {48, 1024, 4096} (48: TMA's
# zero fill past D in a 128-code box; 4096: the most resident queries) and
# 40 (the first body: rows of 40 bytes), k in {1, 20, 31, 32, 600} (lists
# in shared memory up to 31 at the 128-query tile and up to 453 at the
# 32-query one at D = 1024, else in device memory), and k > n_valid.
Q8_SHAPES = [(1, 1000, 999, DIM, 1), (8, 5000, 4777, 48, 20),
             (32, 20_480, 20_000, DIM, 20), (32, 9000, 8999, DIM, 31),
             (32, 3000, 2900, DIM, 600), (33, 3000, 2900, DIM, 32),
             (33, 9000, 8999, 48, 31), (512, 8192, 8000, DIM, 8),
             (512, 8192, 8000, DIM, 600), (5, 300, 20, 48, 40),
             (40, 300, 20, DIM, 32), (8, 3000, 2900, 4096, 20),
             (5, 300, 20, 40, 40), (32, 2000, 1999, 40, 20)]


def check_q8(b: int, n_rows: int, n_valid: int, d: int, k: int, seed: int = 0,
             first_body: bool = False):
    """K5 (as routed, or its first body) against its plain version on the
    card: exact int dots and one scale multiply, so values and ids must be
    bit-identical."""
    from tpurag_torch.kernels.quant import (_dense_scan_q8_first_body,
                                            dense_scan_q8, dense_scan_q8_ref,
                                            quantize_rows)

    rng = np.random.default_rng(seed)
    emb = torch.zeros((n_rows, d), device="cuda")
    emb[:n_valid] = torch.from_numpy(unit_rows(rng, n_valid, d)).cuda()
    e8, es = quantize_rows(emb)
    q8, qs = quantize_rows(torch.from_numpy(unit_rows(rng, b, d)).cuda())
    args = (q8, qs, e8, es, n_valid, k)
    v_r, i_r = dense_scan_q8_ref(*args)
    fn = _dense_scan_q8_first_body if first_body else dense_scan_q8
    v_k, i_k = fn(*args)
    torch.cuda.synchronize()
    assert v_k.shape == (b, k) and i_k.dtype == torch.int32
    assert torch.equal(i_k, i_r), (
        f"K5 ids differ at b={b} n={n_valid} d={d} k={k}")
    assert torch.equal(v_k, v_r), (
        f"K5 values differ at b={b} n={n_valid} d={d} k={k}")


def check_gather(b: int, m: int, n: int, d: int, dtype=torch.bfloat16,
                 seed: int = 0):
    """K8 against its plain version on the card: the same fp32 dots summed
    in another order, within 1e-5 (cosines of unit rows); ids < 0 are
    masked downstream, so only live candidates are compared. Returns
    max_abs_err."""
    from tpurag_torch.kernels.quant import gather_scores, gather_scores_ref

    rng = np.random.default_rng(seed)
    emb = torch.from_numpy(unit_rows(rng, n, d)).cuda().to(dtype)
    q = torch.from_numpy(unit_rows(rng, b, d)).cuda()
    ids = rng.integers(0, n, (b, m)).astype(np.int32)
    ids[rng.random((b, m)) < 0.1] = -1
    ids = torch.from_numpy(ids).cuda()
    got = gather_scores(q, emb, ids)
    want = gather_scores_ref(q, emb, ids)
    torch.cuda.synchronize()
    live = ids >= 0
    err = (got - want)[live].abs().max().item()
    assert err <= 1e-5, f"K8 differs by {err}"
    return err


# K8's rescore at its edges (csrc/gather_scores.cu: one block a query,
# its candidates in shared memory). name -> (b, m, n, d, k, dtype):
# "request": phase 8's shape (32 x 20 of 50k bf16, k=10); "dups": ids
# repeated across lanes; "empty": -1 ids and an all -1 row; "few": M = 5
# < k = 12; "wide": M = 600 (several candidates a thread), fp32, an
# unaligned D.
RESCORE_CASES = {"request": (32, 20, 50_000, DIM, 10, torch.bfloat16),
                 "dups": (16, 32, 200, DIM, 10, torch.bfloat16),
                 "empty": (8, 24, 5000, DIM, 10, torch.bfloat16),
                 "few": (8, 5, 5000, 256, 12, torch.float32),
                 "wide": (4, 600, 3000, 37, 50, torch.float32)}


def check_rescore(name: str, seed: int = 0) -> float:
    """K8's rescore (rescore_topk) against rescore_topk_ref on the card:
    ids equal away from near ties and scores within 1e-5 (the same fp32
    dots summed in another order). Returns max_abs_err."""
    from tpurag_torch.kernels.quant import rescore_topk, rescore_topk_ref

    b, m, n, d, k, dtype = RESCORE_CASES[name]
    rng = np.random.default_rng(seed)
    emb = torch.from_numpy(unit_rows(rng, n, d)).cuda().to(dtype)
    q = torch.from_numpy(unit_rows(rng, b, d)).cuda()
    ids = rng.integers(0, n, (b, m)).astype(np.int32)
    if name == "dups":
        ids[:, m // 2:] = ids[:, :m - m // 2][:, ::-1]
    elif name == "empty":
        ids[rng.random((b, m)) < 0.3] = -1
        ids[1] = -1
    elif name == "few":  # distinct ids: every lane a candidate
        ids = np.stack([rng.choice(n, m, replace=False) for _ in range(b)])
    ids = torch.from_numpy(ids.astype(np.int32)).cuda()
    v_k, i_k = rescore_topk(q, emb, ids, k)
    v_r, i_r = rescore_topk_ref(q, emb, ids, k + 1)
    torch.cuda.synchronize()
    assert v_k.shape == (b, k) and i_k.dtype == torch.int32
    err = topk_agree(v_k, i_k, v_r, i_r, 1e-5)
    if name == "empty":
        assert (i_k[1] == -1).all()
    if name == "few":
        assert (i_k[:, m:] == -1).all() and (i_k[:, :m] >= 0).all()
    return err


def ivf_layout(rng, n_lists: int, d: int, dtype, sizes=(0, 1, 7, 40, 300)):
    """A cluster-major IVF matrix on the card as the builds lay it out:
    cluster sizes drawn from `sizes` (empty and small clusters included),
    8-aligned starts, one IVF_SCAN_EXTENT tail. Returns (emb, starts,
    counts, scales); emb holds int8 codes (with per-cluster scales) for
    dtype torch.int8, else unit rows."""
    from tpurag_torch.kernels.ivf_scan import IVF_SCAN_EXTENT

    counts = rng.choice(sizes, n_lists).astype(np.int32)
    pad = (counts + 7) // 8 * 8
    starts = np.concatenate([[0], np.cumsum(pad)[:-1]]).astype(np.int32)
    total = int(pad.sum()) + IVF_SCAN_EXTENT
    scales = torch.from_numpy(rng.uniform(0.002, 0.01, n_lists).astype(
        np.float32)).cuda()
    if dtype == torch.int8:
        emb = torch.from_numpy(rng.integers(-127, 128, (total, d)).astype(
            np.int8)).cuda()
    else:
        emb = torch.from_numpy(unit_rows(rng, total, d)).cuda().to(dtype)
    return (emb, torch.from_numpy(starts).cuda(),
            torch.from_numpy(counts).cuda(), scales)


def probe_tables(rng, layout, b: int, n_probe: int):
    """(B, n_probe) starts / counts / scales of distinct random clusters
    per query."""
    _, starts, counts, scales = layout
    probe = torch.from_numpy(np.stack([
        rng.choice(len(starts), n_probe, replace=False) for _ in range(b)
    ])).cuda()
    return starts[probe], counts[probe], scales[probe]


# K6's edge cases on the card beyond random probes of small clusters:
# name -> (b, n_lists, n_probe, d, k, dtype, check_ivf options).
IVF_CASES = {
    # One query's rows spread over every block of the grid.
    "b1_one_cluster": (1, 2, 1, DIM, 10, torch.int8,
                       {"sizes": (20_480, 24_000)}),
    # eval ivf_latency's shape at a small N: 8 queries x 2 probes of
    # ~1000-row clusters, bf16 D=1024.
    "ivf_latency": (8, 48, 2, DIM, 10, torch.bfloat16,
                    {"sizes": (960, 1000, 1040, 1100)}),
    # ivf_scan's nprobe_dyn mask: probes of count 0 among live ones.
    "masked_probes": (16, 256, 24, DIM, 20, torch.int8,
                      {"sizes": (100, 245, 400), "mask": 0.4}),
    # A query whose every probe is empty comes out all (NEG_INF, 2^30).
    "empty_query": (6, 64, 4, 256, 10, torch.int8, {"empty_query": 2}),
    "k_past_rows": (4, 40, 3, 256, 600, torch.int8,
                    {"sizes": (0, 1, 7, 40)}),
    # MAX_K: the warp lists in device memory.
    "k_max": (4, 128, 16, 512, 2048, torch.int8, {"sizes": (100, 300)}),
}


def check_ivf(b: int, n_lists: int, n_probe: int, d: int, k: int, dtype,
              seed: int = 0, sizes=(0, 1, 7, 40, 300), mask: float = 0.0,
              empty_query=None):
    """K6 against its plain version on the card: int8 bit-identical (the
    scores before the query scale, and the ids); bf16 / fp32 within TOL,
    ids equal except at near ties. mask: the share of probes given count
    0, as ivf_scan's nprobe_dyn makes them; empty_query: a query whose
    every probe has count 0. The call must take the row-split body
    exactly when a row is a multiple of 16 bytes (the layouts are
    aligned), and the body's chunk rows must be those of the Python split
    (ivf_chunk_rows). Returns max_abs_err."""
    from tpurag_torch.kernels.ivf_scan import (_STORE_CODE, ivf_chunk_rows,
                                               ivf_probe_topk,
                                               ivf_probe_topk_ref,
                                               ivf_rows_config)
    from tpurag_torch.kernels.runtime import launch_counts

    rng = np.random.default_rng(seed)
    layout = ivf_layout(rng, n_lists, d, dtype, sizes)
    emb = layout[0]
    starts, counts, scales = probe_tables(rng, layout, b, n_probe)
    if mask:
        drop = torch.from_numpy(rng.random((b, n_probe)) < mask).cuda()
        counts = torch.where(drop, 0, counts)
    if empty_query is not None:
        counts[empty_query] = 0
    before = (launch_counts["ivf_probe_topk"],
              launch_counts["ivf_probe_topk_sm90"])
    rows_body = d * emb.element_size() % 16 == 0
    if dtype == torch.int8:
        q = torch.from_numpy(rng.integers(-127, 128, (b, d)).astype(
            np.int8)).cuda()
        args = (q, emb, starts, counts, k)
        v_k, i_k = ivf_probe_topk(*args, scales_sel=scales)
        v_r, i_r = ivf_probe_topk_ref(*args, scales_sel=scales)
        torch.cuda.synchronize()
        assert torch.equal(i_k, i_r), f"K6 int8 ids differ at b={b} k={k}"
        assert torch.equal(v_k, v_r), f"K6 int8 values differ at b={b} k={k}"
        err = 0.0
    else:
        q = torch.from_numpy(unit_rows(rng, b, d)).cuda()
        v_k, i_k = ivf_probe_topk(q, emb, starts, counts, k)
        v_r, i_r = ivf_probe_topk_ref(q, emb, starts, counts, k + 1)
        torch.cuda.synchronize()
        assert v_k.shape == (b, k) and i_k.dtype == torch.int32
        err = topk_agree(v_k, i_k, v_r, i_r)
    if empty_query is not None:
        assert (i_k[empty_query] == 2**30).all()
        assert (v_k[empty_query] < -1e38).all()
    assert (launch_counts["ivf_probe_topk"],
            launch_counts["ivf_probe_topk_sm90"]) == (
        before[0] + 1, before[1] + rows_body), f"K6's route at b={b} d={d}"
    if rows_body:
        chunk = ivf_rows_config(_STORE_CODE[dtype], d, k,
                                emb.device.index or 0)[1]
        assert chunk == ivf_chunk_rows(d * emb.element_size()), (
            f"K6's chunk rows {chunk} at d={d} {dtype}")
    return err


def zipf_df(vocab: int, df_max: int) -> np.ndarray:
    """bench.py's document frequencies: clip(df_max (1+r)^-0.5, 16, df_max)."""
    return np.clip(df_max * (1 + np.arange(vocab)) ** -0.5, 16,
                   df_max).astype(np.int64)


def zipf_corpus(rng, n_docs: int = N_DOCS, vocab: int = VOCAB,
                df_max: int = DF_MAX):
    """bench.py's postings plan as texts: term r ('w<r>') lands in
    df[r] distinct random docs. Returns (texts, n_postings)."""
    df = zipf_df(vocab, df_max)
    docs = np.concatenate([rng.choice(n_docs, int(m), replace=False)
                           for m in df])
    terms = np.repeat(np.arange(vocab), df)
    order = np.argsort(docs, kind="stable")
    docs, terms = docs[order], terms[order]
    bounds = np.searchsorted(docs, np.arange(n_docs + 1))
    words = np.char.add("w", terms.astype(str)).tolist()
    texts = [" ".join(words[bounds[i]:bounds[i + 1]]) for i in range(n_docs)]
    return texts, len(docs)


def zipf_queries(rng, n: int, vocab: int = VOCAB) -> list[str]:
    """bench.py's query plan: 8 terms each, P(r) ~ (1 + r)^-0.7."""
    w = (1 + np.arange(vocab)) ** -0.7
    tid = rng.choice(vocab, size=(n, QUERY_TERMS), p=w / w.sum())
    return [" ".join(f"w{t}" for t in row) for row in tid]


def query_vectors(rng, emb_rows: np.ndarray, n: int):
    """Each query vector is the sum of 3 seeded corpus rows plus a little
    noise, so its 3 source rows are its true nearest neighbours (cosine
    ~0.54, above the document preset's 0.3 floor)."""
    src = rng.integers(0, len(emb_rows), (n, 3))
    q = emb_rows[src].sum(axis=1)
    q += 0.02 * rng.standard_normal(q.shape, dtype=np.float32)
    return q, src


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def drive_slice(device: str, kernels=()) -> dict:
    """The main path through the public API: ingest the bench corpus into
    KnowledgeBase(dim=1024, device=device), one warm-up search_batch
    (compaction; its K2 and fusion calls are recorded), 4
    search_batch(hybrid) requests of BATCH queries and 3 single searches
    (each kernel's launch count reset just before and read just after),
    check the answers, profile one request on the card, then save, reload
    on the CPU and compare 64 queries there."""
    from tpurag_torch import KnowledgeBase
    from tpurag_torch.core.types import Chunk
    from tpurag_torch.engine import hybrid as hybrid_mod
    from tpurag_torch.index import inverted as inverted_mod
    from tpurag_torch.kernels.runtime import BUILD_DIR, launch_counts

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    texts, n_post = zipf_corpus(rng)
    emb_rows = unit_rows(rng, N_DOCS, DIM)
    log(f"[kb] corpus plan: {N_DOCS} docs, {n_post} postings, "
        f"{time.perf_counter() - t0:.1f}s")
    kb = KnowledgeBase("smoke", dim=DIM, device=device)
    t0 = time.perf_counter()
    kb.add_chunks([Chunk(text=t, doc_id=f"d{i}") for i, t in enumerate(texts)],
                  vectors=emb_rows)
    sync()
    ingest_s = time.perf_counter() - t0
    assert len(kb) == N_DOCS and kb.dense.embeddings.dtype == torch.bfloat16
    widest = max(map(kb.inverted._df, range(len(kb.inverted.vocab))))
    assert widest <= kb.config.bm25.wide_term_width, widest
    log(f"[kb] ingest {N_DOCS} x {DIM} bf16 + {n_post} postings: "
        f"{ingest_s:.2f}s; widest term df={widest} (narrow route only)")

    batches = []
    for _ in range(5):  # one warm-up (the first search compacts), four timed
        qv, src = query_vectors(rng, emb_rows, BATCH)
        batches.append((zipf_queries(rng, BATCH), qv, src))
    calls, fuse_calls = [], []
    with recording(inverted_mod, "merge_segsum_topk_classes", calls), \
            recording(hybrid_mod, "fuse_legs", fuse_calls):
        kb.search_batch(batches[0][0], mode="hybrid", vectors=batches[0][1])
    sync()

    for name in count_names(kernels):
        launch_counts[name] = 0
    lat, answers = [], []
    for queries, qv, _ in batches[1:]:
        t0 = time.perf_counter()
        answers.append(kb.search_batch(queries, mode="hybrid", vectors=qv))
        lat.append((time.perf_counter() - t0) * 1e3)
    singles = [kb.search(" ".join(f"w{t}" for t in rng.integers(0, 500, 3)))
               for _ in range(3)]
    launches = {n: launch_counts[n] for n in count_names(kernels)}
    log(f"[kb] 4 x search_batch(b={BATCH}, hybrid) + 3 x search: "
        f"launches {launches}")

    found = 0
    for res, (_, _, src) in zip(answers, batches[1:]):
        assert len(res) == BATCH
        for r, s in zip(res, src):
            ids = [x.chunk_id for x in r.results]
            assert 0 < len(ids) <= 8 and len(set(ids)) == len(ids)
            assert all(np.isfinite(x.score) and x.score > 0 for x in r.results)
            found += len(set(s.tolist()) & set(ids))
    recall = found / (4 * BATCH * 3)
    assert recall > 0.99, f"seed rows missing from the fused top-8: {recall}"
    assert all(s.results for s in singles)
    log(f"[kb] answers: 4 x {BATCH} responses, seed-row recall in fused "
        f"top-8 {recall:.4f}; 3 single searches non-empty")
    profile = device_profile(lambda: kb.search_batch(
        batches[1][0], mode="hybrid", vectors=batches[1][1])) \
        if device == "cuda" else None

    save_dir = BUILD_DIR / "smoke_kb"
    shutil.rmtree(save_dir, ignore_errors=True)
    kb.save(save_dir)
    cpu_kb = KnowledgeBase.load(save_dir, device="cpu")
    queries, qv, _ = batches[1]
    got = cpu_kb.search_batch(queries[:64], mode="hybrid", vectors=qv[:64])
    for a, b in zip(answers[0][:64], got):
        assert [x.chunk_id for x in a.results] == [x.chunk_id for x in b.results]
    shutil.rmtree(save_dir, ignore_errors=True)
    log("[kb] save -> load(device='cpu'): 64 queries give the same top-8")
    return {"launches": launches, "lat_ms": lat, "ingest_s": ingest_s,
            "calls": calls, "fuse_calls": fuse_calls, "profile": profile}


def count_names(kernels) -> list:
    """The launch counts a drive resets and reads: each kernel wrapper's,
    and beside dense_topk's (every K1 launch), dense_scan_q8's (every K5
    launch), dense_topk_co's (every K7 launch) and ivf_probe_topk's (every
    K6 launch) dense_topk_sm90's, dense_scan_q8_sm90's, dense_topk_co_sm90's
    and ivf_probe_topk_sm90's (those that took the TMA + wgmma bodies, or
    K6's row-split body)."""
    names = [fn.__name__ for fn in kernels]
    return names + [f"{n}_sm90" for n in ("dense_topk", "dense_scan_q8",
                                          "dense_topk_co", "ivf_probe_topk")
                    if n in names]


def recording(module, name: str, calls: list):
    """Context manager: while it is open, module.name records the
    arguments of each call (and still calls the real function)."""
    real = getattr(module, name)

    def rec(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    @contextlib.contextmanager
    def ctx():
        setattr(module, name, rec)
        try:
            yield
        finally:
            setattr(module, name, real)

    return ctx()


def bound_ms(nbytes: float, ops: float, peak_ops: float):
    """(least ms, what bounds it): bytes over the H100's 3.35 TB/s, or
    operations over `peak_ops` per second, whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def replay_dense(calls) -> dict:
    """K1 (as routed, and its first body) and K7 (as routed, and its first
    body) on the main path's own inputs (one request's K1 calls): each held
    to dense_topk_ref by topk_agree, with the summed times of both K1
    bodies, both K7 bodies, the plain version and
    torch.topk(q @ emb.T) in bf16 (one function, so one bound). Every K7
    call as routed must take its Hopper body."""
    from tpurag_torch.kernels.dense import (_dense_topk_co_first_body,
                                            _dense_topk_first_body,
                                            dense_topk, dense_topk_co,
                                            dense_topk_ref)
    from tpurag_torch.kernels.runtime import launch_counts

    err = co_err = first_err = nbytes = ops = 0.0
    times = dict.fromkeys(("ms", "first_ms", "plain_ms", "lib_ms"), 0.0)
    co = dict.fromkeys(("co_ms", "co_first_ms"), 0.0)
    shapes = []
    for (q, emb, n_valid, k), _ in calls:
        before = launch_counts["dense_topk_co_sm90"]
        v_c, i_c = dense_topk_co(q, emb, n_valid, k)
        assert launch_counts["dense_topk_co_sm90"] == before + 1, (
            f"K7 missed its Hopper body at {tuple(q.shape)} x {n_valid}")
        v_k, i_k = dense_topk(q, emb, n_valid, k)
        v_f, i_f = _dense_topk_first_body(q, emb, n_valid, k)
        v_r, i_r = dense_topk_ref(q, emb, n_valid, k + 1)
        torch.cuda.synchronize()
        assert all(torch.isfinite(v).all() for v in (v_k, v_f, v_c))
        err = max(err, topk_agree(v_k, i_k, v_r, i_r))
        first_err = max(first_err, topk_agree(v_f, i_f, v_r, i_r))
        co_err = max(co_err, topk_agree(v_c, i_c, v_r, i_r))
        del v_r, i_r
        for key, t in dense_times(q, emb, n_valid, k).items():
            times[key] += t
        co["co_ms"] += cuda_ms(lambda: dense_topk_co(q, emb, n_valid, k))
        co["co_first_ms"] += cuda_ms(
            lambda: _dense_topk_co_first_body(q, emb, n_valid, k), iters=5,
            warmup=1)
        b, d = q.shape
        nbytes += (b * d * q.element_size() + n_valid * d * emb.element_size()
                   + b * k * 8)
        ops += 2 * b * n_valid * d
        shapes.append(f"{b}x{n_valid}x{d} k={k}")
    return {"err": err, "first_err": first_err, "co_err": co_err, **co,
            **times, "shapes": shapes,
            "bound": bound_ms(nbytes, ops, BF16_FLOPS_S)}


def replay_fused(calls, first=None) -> dict:
    """K2' on the main path's own inputs: bit-identical to its plain
    version (err is the measured largest score difference), and the
    summed times, one launch at a time and in chains of 10; with first
    (tools/k2_anatomy.first_fused), K2''s first body on the same inputs,
    held to the same answer and timed the same ways. The bound is by
    bytes: the
    postings this run's windows hold (live lanes, 8 bytes each), the (B, T)
    tables and the (B, k) result. Its integer compares have no rate in the
    data sheet's table, and the fewest a T-way merge needs (live * log2 T)
    would take under a tenth of the byte time even at the fp32 rate."""
    from tpurag_torch.kernels.bm25_merge import (bm25_topk_fused,
                                                 bm25_topk_fused_ref)

    tool = load_tool("k2_anatomy") if first is not None else None
    err = nbytes = all_lanes = 0.0
    times = dict.fromkeys(("ms", "chain_ms", "plain_ms", "first_ms",
                           "first_chain_ms"), 0.0)
    shapes = []
    for args, kw in calls:
        v_k, i_k = bm25_topk_fused(*args, **kw)
        v_r, i_r = bm25_topk_fused_ref(*args, **kw)
        torch.cuda.synchronize()
        assert torch.equal(i_k, i_r) and torch.equal(v_k, v_r), kw
        assert (i_k[:, 0] >= 0).any(), "no hits at all: the replay is vacuous"
        live_out = i_r >= 0
        err = max(err, (v_k - v_r)[live_out].abs().max().item())
        times["ms"] += cuda_ms(lambda: bm25_topk_fused(*args, **kw))
        times["chain_ms"] += cuda_ms(lambda: bm25_topk_fused(*args, **kw),
                                     chain=10)
        times["plain_ms"] += cuda_ms(lambda: bm25_topk_fused_ref(*args,
                                                                 **kw))
        if first is not None:
            def old():
                return tool.first_fused_topk(first, *args, **kw)

            v_f, i_f = old()
            torch.cuda.synchronize()
            assert torch.equal(i_f, i_r) and torch.equal(v_f, v_r), kw
            times["first_ms"] += cuda_ms(old)
            times["first_chain_ms"] += cuda_ms(old, chain=10)
        starts, lens = args[:2]
        b, t = starts.shape
        p_max = kw["p_max"]
        live = int(lens.clamp(0, p_max).sum().item())
        nbytes += live * 8 + starts.numel() * 12 + b * kw["k"] * 8
        all_lanes += b * t * p_max * 8
        shapes.append(f"{b}x{t}x{p_max} cbits={kw['cbits']} "
                      f"({live} live postings)")
    return {"err": err, **times, "shapes": shapes,
            "bound": bound_ms(nbytes, 0.0, FP32_OPS_S),
            "all_lanes_ms": all_lanes / HBM_BYTES_S * 1e3}


def fused_full_times(first, cbits: int) -> list:
    """K2' and its first body on rows whose every lane is live
    (fused_case "full", the full-network route) at b = 16 and 512, held
    to the plain version: [(b, ms, first ms)] in chains of 10."""
    from tpurag_torch.kernels.bm25_merge import bm25_topk_fused

    tool = load_tool("k2_anatomy")
    out = []
    for b in (16, 512):
        *arrays, n_valid, p_max = fused_case("full", seed=b, b=b)
        fused_agree(arrays, n_valid, 8, p_max, cbits)
        args = [torch.from_numpy(x).cuda() for x in arrays] + [n_valid]
        kw = {"k": 8, "p_max": p_max, "cbits": cbits}
        out.append((b, cuda_ms(lambda: bm25_topk_fused(*args, **kw),
                               chain=10),
                    cuda_ms(lambda: tool.first_fused_topk(first, *args, **kw),
                            chain=10)))
    return out


def k2_bytes(classes, h: int, k: int) -> tuple[float, int]:
    """(bytes, live lanes) K2 must move for these classes: every live lane
    of every used slot (doc + impact, 8 bytes) read once, the table (8
    bytes an entry: 4 a bucket matrix the slots use, 8 a row, 2 a slot)
    and the (h, k) result (8 bytes a slot) written once."""
    live = table = 0
    used = set()
    for p_max, _, _, _, bucketw, _, lv, _ in classes:
        bw = np.asarray(bucketw)
        ok = (bw > 0) & (bw <= p_max)
        live += int(np.where(ok, np.minimum(lv, bw), 0).sum())
        used |= set(np.unique(bw[ok]).tolist())
        table += 8 * bw.shape[0] + 2 * bw.size
    return (live + 4 * len(used) + table) * 8 + h * k * 8, live


def replay_topk(calls, first=None) -> dict:
    """K2 on the main path's own inputs (merge_segsum_topk_classes calls,
    one per search): bit-identical to its plain version in fresh result
    buffers, and the times of the one launch (device time), the whole
    wrapper call (its host work included), the plain version and (first:
    tools/k2_anatomy.py's build of K2's first body) that body's per-class
    launches on the same rows gathered beforehand (the launches timed in
    chains: device time). The bound is by bytes
    (k2_bytes): the merge's few compares a lane would take a tenth of that
    even at the fp32 rate."""
    from tpurag_torch.kernels.bm25_merge import (
        merge_segsum_topk_classes, merge_segsum_topk_classes_ref)

    tool = load_tool("k2_anatomy") if first is not None else None
    ms = call_ms = plain_ms = first_ms = nbytes = lanes = 0.0
    shapes = []
    for (widths, mats, classes, out_v, _), _ in calls:
        h, k = out_v.shape
        args = (widths, mats, classes)

        def fresh():  # result buffers as the search made them
            return k2_out(h, k, out_v.device)

        v_k, i_k = merge_segsum_topk_classes(*args, *fresh())
        v_r, i_r = merge_segsum_topk_classes_ref(*args, *fresh())
        torch.cuda.synchronize()
        assert torch.equal(i_k, i_r) and torch.equal(v_k, v_r), "K2 replay"
        assert (i_k[:, 0] >= 0).any(), "no hits at all: the replay is vacuous"
        ms += k2_classes_launch_ms(*args, *fresh())
        call_ms += cuda_ms(lambda: merge_segsum_topk_classes(*args, *fresh()))
        plain_ms += cuda_ms(
            lambda: merge_segsum_topk_classes_ref(*args, *fresh()), iters=3,
            warmup=1)
        if tool is not None:
            first_ms += cuda_ms(tool.first_launches(first, widths, mats,
                                                    classes, k), chain=10)
        b, n = k2_bytes(classes, h, k)
        nbytes += b
        lanes += n
        shapes.append(f"{sum(len(c[3]) for c in classes)} rows in "
                      f"{len(classes)} classes (" + ", ".join(
                          f"{len(c[3])}x{c[1]}x{c[0]}" for c in classes)
                      + f"), k={k}")
    return {"ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
            "first_ms": first_ms, "shapes": shapes, "lanes": int(lanes),
            "bound": bound_ms(nbytes, lanes, FP32_OPS_S), "nbytes": nbytes}


def k3_launch_ms(args) -> float:
    """K3's device time: its launch alone, repeated on one prepared table
    (the wrapper's host work, the table build and upload, left out)."""
    from tpurag_torch.kernels.bm25_merge import _k3_prepare, _k3_run
    from tpurag_torch.kernels.runtime import load_kernels

    fn = load_kernels().tr_full_rows
    prep = _k3_prepare(*args)
    return cuda_ms(lambda: _k3_run(fn, prep))


def k3_bytes(args) -> tuple[float, int, int]:
    """(bytes, live lanes, output lanes) K3 must move for these classes:
    every live lane
    of every used slot (doc + impact, 8 bytes) read once, every output
    lane (seg + doc_s, 8 bytes; the narrow buffers' whole width) written
    once, and the table (8 bytes an entry, as bm25_merge._k3_table builds
    it: 4 a matrix, 8 a row, 2 a slot, 1 an item)."""
    from tpurag_torch.kernels.bm25_merge import _K3_CHUNK

    widths, _, narrow, wide, h, wn_max = args
    live = out = table = 0
    for p_max, t, _, _, bucketw, _, lv, _ in [*narrow, *wide]:
        bw = np.asarray(bucketw)
        live += int(np.where((bw > 0) & (bw <= p_max),
                             np.minimum(lv, bw), 0).sum())
        g = bw.shape[0]
        table += 8 * g + 2 * g * t
    out = h * wn_max + sum(len(c[4]) * c[0] * c[1] for c in wide)
    items = h * -(-wn_max // _K3_CHUNK) + sum(
        len(c[4]) * -(-(c[0] * c[1]) // _K3_CHUNK) for c in wide)
    table += 4 * len(widths) + items
    return (live + out) * 8 + table * 8, live, out


def replay_full(calls, first=None) -> dict:
    """K3 on the main path's own inputs (merge_segsum_full_classes calls):
    bit-identical to its plain version, and the times of the one launch
    (device time: k3_launch_ms), the whole wrapper call (its host work
    included), the plain version and (first: tools/k3_anatomy.py's build
    of K3's first body) that body's launches on the same rows gathered
    beforehand, and the flow it ran in (gather glue included). The bound
    is by bytes (k3_bytes); the merge's few compares a lane would take a
    tenth of that even at the fp32 rate."""
    from tpurag_torch.kernels.bm25_merge import (
        merge_segsum_full_classes, merge_segsum_full_classes_ref)

    tool = load_tool("k3_anatomy") if first is not None else None
    ms = call_ms = plain_ms = first_ms = flow_ms = nbytes = lanes = 0.0
    out_lanes = 0
    shapes = []
    for args, _ in calls:
        got = merge_segsum_full_classes(*args)
        want = merge_segsum_full_classes_ref(*args)
        torch.cuda.synchronize()
        got = [got[0], got[1], *[x for pair in got[2] for x in pair]]
        want = [want[0], want[1], *[x for pair in want[2] for x in pair]]
        assert all(torch.equal(g, w) for g, w in zip(got, want)), "K3 replay"
        assert (want[0] > 0).any(), "no sums at all: the replay is vacuous"
        ms += k3_launch_ms(args)
        call_ms += cuda_ms(lambda: merge_segsum_full_classes(*args))
        plain_ms += cuda_ms(lambda: merge_segsum_full_classes_ref(*args),
                            iters=3, warmup=1)
        if tool is not None:
            first_ms += cuda_ms(tool.first_launches(first, *args))
            flow_ms += cuda_ms(tool.first_flow(first, *args))
        b, n, o = k3_bytes(args)
        nbytes += b
        lanes += n
        out_lanes += o
        widths, _, narrow, wide, h, wn_max = args
        shapes.append(f"{h} narrow rows ({wn_max} lanes) in {len(narrow)} "
                      f"classes (" + ", ".join(
                          f"{len(c[4])}x{c[1]}x{c[0]}" for c in narrow)
                      + f"), {len(wide)} wide classes (" + ", ".join(
                          f"{len(c[4])}x{c[1]}x{c[0]}" for c in wide) + ")")
    return {"ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
            "first_ms": first_ms, "flow_ms": flow_ms, "shapes": shapes,
            "bound": bound_ms(nbytes, lanes, FP32_OPS_S), "nbytes": nbytes,
            "lanes": (int(lanes), out_lanes)}


def load_tool(name: str):
    """A module of tools/ by path (tools/ is no package)."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent / "tools" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def k4_live_bytes(n_val, n_doc, classes, k: int) -> tuple[float, float]:
    """(bytes, lanes) K4 must move for this data: every live lane (doc <
    2^30) of each member's wide row and of its own narrow width, 8 bytes
    each, once; the (H, k) result; the row table and item list (8 bytes an
    entry, as bm25_join._k4_table builds them)."""
    from tpurag_torch.kernels.bm25_join import _K4_CHUNK, _members

    lanes = 0
    n_table = 0
    for w_seg, w_doc, sel, wn in classes:
        g, ww = w_doc.shape
        rows = _members(sel, g)
        widths = (np.full(g, n_doc.shape[1]) if wn is None
                  else np.asarray(wn).reshape(-1))
        live_n = n_doc[torch.as_tensor(rows, device=n_doc.device)] < 2**30
        live_n &= (torch.arange(n_doc.shape[1], device=n_doc.device)[None]
                   < torch.as_tensor(widths, device=n_doc.device)[:, None])
        lanes += int((w_doc < 2**30).sum().item()) + int(live_n.sum().item())
        n_table += g * 8 + g * -(-ww // _K4_CHUNK)
    return lanes * 8 + n_val.shape[0] * k * 8 + n_table * 8, lanes


def replay_combine(calls, first=None) -> dict:
    """K4 on the main path's own inputs (combine_topk_classes calls):
    bit-identical to combine_classes_ref, and the times of the one launch
    (device time: k4_launch_ms), the whole wrapper call (its host work
    included), the plain version and (first: tools/k4_anatomy.py's build
    of K4's first body) that body's per-class launches on the same
    rows. The
    bound is by bytes (k4_live_bytes); the join's one compare a lane would
    take a tenth of that even at the fp32 rate."""
    from tpurag_torch.kernels.bm25_join import (combine_classes_ref,
                                                combine_topk_classes)

    tool = load_tool("k4_anatomy") if first is not None else None
    ms = call_ms = plain_ms = first_ms = nbytes = lanes = 0.0
    shapes = []
    for args, kw in calls:
        v_k, i_k = combine_topk_classes(*args, **kw)
        v_r, i_r = combine_classes_ref(*args, **kw)
        torch.cuda.synchronize()
        assert torch.equal(i_k, i_r) and torch.equal(v_k, v_r), "K4 replay"
        assert (i_k[:, 0] >= 0).any(), "no hits at all: the replay is vacuous"
        n_val, n_doc, classes = args
        ms += k4_launch_ms(n_val, n_doc, classes, kw["k"])
        call_ms += cuda_ms(lambda: combine_topk_classes(*args, **kw))
        plain_ms += cuda_ms(lambda: combine_classes_ref(*args, **kw), iters=3,
                            warmup=1)
        if tool is not None:
            first_ms += cuda_ms(tool.first_classes(first, n_val, n_doc,
                                                   classes, kw["k"]))
        b, n = k4_live_bytes(n_val, n_doc, classes, kw["k"])
        nbytes += b
        lanes += n
        shapes.append(f"{n_val.shape[0]} rows in {len(classes)} classes ("
                      + ", ".join(f"{w.shape[0]}x{w.shape[1]}"
                                  for w, *_ in classes)
                      + f"), narrow {n_val.shape[1]}, k={kw['k']}")
    return {"ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
            "first_ms": first_ms, "shapes": shapes,
            "bound": bound_ms(nbytes, lanes, FP32_OPS_S), "nbytes": nbytes}


def drive_wide(device: str, kernels=()) -> dict:
    """The wide-term slice at bench.py's 1M point through the public API:
    KnowledgeBase(dim=1024, device=device) ingests 1M chunks of the Zipf
    plan (df up to 20480, so ~1/2 of the queries hold a wide term), one
    warm-up search_batch (compaction; its kernel calls are recorded),
    then 4 timed search_batch(hybrid) requests of BATCH_WIDE queries with
    every kernel's launch count reset just before and read just after;
    the keyword top-8 of 64 hard queries against a CPU index of the same
    postings."""
    from tpurag_torch import KnowledgeBase
    from tpurag_torch.core.types import Chunk
    from tpurag_torch.engine import hybrid as hybrid_mod
    from tpurag_torch.index import dense as dense_mod
    from tpurag_torch.index import inverted as inverted_mod
    from tpurag_torch.index.inverted import InvertedIndex
    from tpurag_torch.kernels.runtime import BUILD_DIR, launch_counts

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    rng = np.random.default_rng(1)
    t0 = time.perf_counter()
    texts, n_post = zipf_corpus(rng, N_WIDE, VOCAB_WIDE, DF_MAX_WIDE)
    emb_rows = unit_rows(rng, N_WIDE, DIM)
    log(f"[wide] corpus plan: {N_WIDE} docs, vocab {VOCAB_WIDE}, df_max "
        f"{DF_MAX_WIDE}, {n_post} postings, {time.perf_counter() - t0:.1f}s")
    kb = KnowledgeBase("wide", dim=DIM, device=device)
    t0 = time.perf_counter()
    kb.add_chunks([Chunk(text=t, doc_id=f"d{i}") for i, t in enumerate(texts)],
                  vectors=emb_rows)
    sync()
    ingest_s = time.perf_counter() - t0
    del texts
    assert len(kb) == N_WIDE
    df = zipf_df(VOCAB_WIDE, DF_MAX_WIDE)
    wide_w = kb.config.bm25.wide_term_width
    log(f"[wide] ingest route: add_chunks, {N_WIDE} x {DIM} bf16 + {n_post} "
        f"postings in {ingest_s:.2f}s; {int((df > wide_w).sum())} terms with "
        f"df > wide_term_width={wide_w}")

    def is_hard(q: str) -> bool:
        return any(df[int(w[1:])] > wide_w for w in q.split())

    batches = []
    for _ in range(5):  # one warm-up (the first search compacts), four timed
        qv, src = query_vectors(rng, emb_rows, BATCH_WIDE)
        batches.append((zipf_queries(rng, BATCH_WIDE, VOCAB_WIDE), qv, src))
    hard = [sum(map(is_hard, qs)) for qs, _, _ in batches]
    calls = {n: [] for n in ("dense_topk", "merge_segsum_topk_classes",
                             "merge_segsum_full_classes",
                             "combine_topk_classes", "fuse_legs")}
    t0 = time.perf_counter()
    with recording(dense_mod, "dense_topk", calls["dense_topk"]), \
            recording(inverted_mod, "merge_segsum_topk_classes",
                      calls["merge_segsum_topk_classes"]), \
            recording(inverted_mod, "merge_segsum_full_classes",
                      calls["merge_segsum_full_classes"]), \
            recording(inverted_mod, "combine_topk_classes",
                      calls["combine_topk_classes"]), \
            recording(hybrid_mod, "fuse_legs", calls["fuse_legs"]):
        kb.search_batch(batches[0][0], mode="hybrid", vectors=batches[0][1])
    sync()
    log(f"[wide] warm-up request (compaction included): "
        f"{time.perf_counter() - t0:.2f}s")

    for name in count_names(kernels):
        launch_counts[name] = 0
    lat, answers = [], []
    for queries, qv, _ in batches[1:]:
        t0 = time.perf_counter()
        answers.append(kb.search_batch(queries, mode="hybrid", vectors=qv))
        lat.append((time.perf_counter() - t0) * 1e3)
    launches = {n: launch_counts[n] for n in count_names(kernels)}
    log(f"[wide] 4 x search_batch(b={BATCH_WIDE}, hybrid), hard (wide-term) "
        f"queries {hard[1:]} of {BATCH_WIDE}: launches {launches}")

    profile = device_profile(lambda: kb.search_batch(
        batches[1][0], mode="hybrid", vectors=batches[1][1])) \
        if device == "cuda" else None

    found = 0
    for res, (_, _, src) in zip(answers, batches[1:]):
        assert len(res) == BATCH_WIDE
        for r, s in zip(res, src):
            ids = [x.chunk_id for x in r.results]
            assert 0 < len(ids) <= 8 and len(set(ids)) == len(ids)
            assert all(np.isfinite(x.score) and x.score > 0 for x in r.results)
            found += len(set(s.tolist()) & set(ids))
    recall = found / (4 * BATCH_WIDE * 3)
    assert recall > 0.99, f"seed rows missing from the fused top-8: {recall}"
    log(f"[wide] seed-row recall in fused top-8 {recall:.4f}")

    # The keyword leg of 64 hard queries against the plain versions.
    path = BUILD_DIR / "smoke_wide_inverted"
    t0 = time.perf_counter()
    kb.inverted.save(path)
    cpu_inv = InvertedIndex.load(path, kb.config.bm25, device="cpu")
    path.with_suffix(".npz").unlink()
    queries = [q for q in batches[1][0] if is_hard(q)][:64]
    assert len(queries) == 64
    gv, gi = kb.inverted.search(queries, 8)
    cv, ci = cpu_inv.search(queries, 8)
    np.testing.assert_array_equal(gi, ci)
    np.testing.assert_allclose(gv, cv, rtol=1e-5)
    assert (gi[:, -1] >= 0).all()
    log(f"[wide] 64 hard queries: keyword top-8 ids equal to a CPU index of "
        f"the same postings, scores within 1e-5 relative (max |d| "
        f"{np.abs(gv - cv).max():.3e}; {time.perf_counter() - t0:.1f}s)")
    del cpu_inv
    return {"launches": launches, "lat_ms": lat, "ingest_s": ingest_s,
            "hard": hard[1:], "calls": calls, "profile": profile}


def ivf_corpus(n: int, d: int, n_centers: int, seed: int = 0):
    """benchmarks/kb_10m.py's mixture: unit centers, each row a center
    plus Gaussian noise of norm ~NOISE_IVF. Returns (centers, a generator
    of (lo, hi, rows) blocks of IVF_BLOCK rows)."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_centers, d)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    which = rng.integers(0, n_centers, n)

    def blocks():
        for s in range(0, n, IVF_BLOCK):
            e = min(s + IVF_BLOCK, n)
            blk = rng.standard_normal((e - s, d), dtype=np.float32)
            blk *= np.float32(NOISE_IVF / np.sqrt(d))
            blk += centers[which[s:e]]
            yield s, e, blk

    return centers, blocks()


def ivf_queries(centers: np.ndarray, b: int):
    """kb_10m.py's held-out queries: fresh draws from the same mixture
    (rng 1_000_003), texts 't{c % 997} z{c % 89}' of their centers."""
    qrng = np.random.default_rng(1_000_003)
    qc = qrng.integers(0, len(centers), b)
    qv = qrng.standard_normal((b, centers.shape[1])).astype(np.float32)
    qv *= np.float32(NOISE_IVF / np.sqrt(centers.shape[1]))
    qv += centers[qc]
    qv /= np.linalg.norm(qv, axis=1, keepdims=True)
    return qv, [f"t{int(c) % 997} z{int(c) % 89}" for c in qc]


def ids_agree(v_a, i_a, v_b, i_b, tol: float) -> float:
    """(B, k) results a against b, where b has one column more: topk_agree
    on the host, empty slots (-1) included."""
    return topk_agree(torch.as_tensor(v_a).cpu(), torch.as_tensor(i_a).cpu(),
                      torch.as_tensor(v_b).cpu(), torch.as_tensor(i_b).cpu(),
                      tol)


def ivf_kb(device: str):
    """Phase 8's KB: KnowledgeBase(quant=True, device=device) ingests 1M
    chunks x 1024 of the 1024-center mixture in blocks of 131072 through
    add_chunks, then build_ivf() packs the int8 partition (4096 lists).
    Returns (kb, its IVF index, centers, ingest seconds, build
    seconds)."""
    from tpurag_torch import KnowledgeBase
    from tpurag_torch.core.config import EngineConfig
    from tpurag_torch.core.types import Chunk
    from tpurag_torch.kernels.runtime import round_up

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    cfg = EngineConfig()
    cfg = dataclasses.replace(
        cfg, device=dataclasses.replace(
            cfg.device, min_capacity=int(round_up(N_IVF, 2048))),
        ivf=dataclasses.replace(cfg.ivf, n_lists=N_LISTS_IVF))
    kb = KnowledgeBase("ivf", dim=DIM, config=cfg, quant=True, device=device)
    centers, blocks = ivf_corpus(N_IVF, DIM, N_CENTERS_IVF)
    t0 = time.perf_counter()
    for s, e, blk in blocks:
        kb.add_chunks([Chunk(text=f"c{i} t{i % 997} z{i % 89}",
                             doc_id=f"d{i >> 7}", doc_name=f"doc{i >> 7}")
                       for i in range(s, e)], vectors=blk)
    sync()
    ingest_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ivf = kb.build_ivf()
    sync()
    return kb, ivf, centers, ingest_s, time.perf_counter() - t0


def drive_ivf(device: str, kernels=(), card: str = "") -> dict:
    """The int8 + IVF slice at the JAX package's 1M-chunk hybrid_ivf point
    (benchmarks/kb_10m.py --n 1000000, device store): KnowledgeBase(quant=
    True, device=device) ingests 1M chunks x 1024 of the 1024-center
    mixture in blocks of 131072 through add_chunks, build_ivf() packs the
    int8 partition (4096 lists), then hybrid_ivf requests at b=32 and b=8
    and hybrid requests at b=32 (every kernel's launch count reset just
    before, read just after). One warm-up request of each mode has its
    kernel calls recorded for the replays. Then: recall@10 of mode 'ivf'
    against the full probe, the same IVF on the CPU (plain versions),
    1000 chunks added after the build (the tail goes through K1) and one
    profiled request each of hybrid_ivf and hybrid."""
    from tpurag_torch.core.types import Chunk
    from tpurag_torch.index import inverted as inverted_mod
    from tpurag_torch.kernels import ivf_scan as ivf_mod
    from tpurag_torch.kernels import quant as quant_mod
    from tpurag_torch.kernels.runtime import launch_counts

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    kb, ivf, centers, ingest_s, build_s = ivf_kb(device)
    assert len(kb) == N_IVF and ivf.emb_ivf_q8 is not None
    assert ivf.emb_ivf is not None and ivf.align == 8, ivf.align
    nprobe = int(np.ceil(ivf.config.n_probe * ivf.nprobe_scale))
    log(f"[ivf] ingest {N_IVF} x {DIM} (quant) through add_chunks: "
        f"{ingest_s:.2f}s; build_ivf: {build_s:.2f}s, n_lists "
        f"{ivf.n_lists}, c_max {ivf.c_max}, align {ivf.align}, default "
        f"nprobe {nprobe} ({card})")

    qv, qtexts = ivf_queries(centers, B_IVF)
    calls = {n: [] for n in ("dense_scan_q8", "ivf_probe_topk",
                             "rescore_topk", "combine_topk_classes")}
    # The IVF leg rescores through ivf_scan's name, the int8 dense leg
    # through quant's.
    with recording(ivf_mod, "ivf_probe_topk", calls["ivf_probe_topk"]), \
            recording(ivf_mod, "rescore_topk", calls["rescore_topk"]), \
            recording(inverted_mod, "combine_topk_classes",
                      calls["combine_topk_classes"]):
        kb.search_batch(qtexts, top_k=K_IVF, mode="hybrid_ivf", vectors=qv)
    with recording(quant_mod, "dense_scan_q8", calls["dense_scan_q8"]), \
            recording(quant_mod, "rescore_topk", calls["rescore_topk"]):
        kb.search_batch(qtexts, top_k=K_IVF, mode="hybrid", vectors=qv)
    sync()

    for name in count_names(kernels):
        launch_counts[name] = 0
    lat: dict[str, list] = {}
    answers = []
    rescores: list = []
    with recording(ivf_mod, "rescore_topk", rescores), \
            recording(quant_mod, "rescore_topk", rescores):
        for name, mode, b in (("hybrid_ivf b=32", "hybrid_ivf", B_IVF),
                              ("hybrid_ivf b=8", "hybrid_ivf", 8),
                              ("hybrid b=32", "hybrid", B_IVF)):
            lat[name] = []
            for _ in range(4):
                t0 = time.perf_counter()
                res = kb.search_batch(qtexts[:b], top_k=K_IVF, mode=mode,
                                      vectors=qv[:b])
                lat[name].append((time.perf_counter() - t0) * 1e3)
                answers.append(res)
    launches = {n: launch_counts[n] for n in count_names(kernels)}
    launches["rescore_calls"] = len(rescores)
    del rescores
    for res in answers:
        for r in res:
            ids = [x.chunk_id for x in r.results]
            assert 0 < len(ids) <= K_IVF and len(set(ids)) == len(ids)
            assert all(np.isfinite(x.score) for x in r.results)
    log(f"[ivf] 4 x search_batch each of hybrid_ivf b=32, hybrid_ivf b=8, "
        f"hybrid b=32 (top_k={K_IVF}): launches {launches} ({card})")

    # Recall@10 of mode 'ivf' at the default probe count against the full
    # probe over the same int8 layout (kb_10m.py's accounting).
    got = kb.search_batch(qtexts, top_k=K_IVF, mode="ivf", vectors=qv)
    got = [[x.chunk_id for x in r.results] for r in got]
    _, oracle = ivf.search(qv, K_IVF, nprobe=ivf.n_lists)
    oracle = oracle.cpu().numpy()
    recall = float(np.mean([len(set(g) & set(o.tolist())) / K_IVF
                            for g, o in zip(got, oracle)]))
    assert recall >= 0.95, f"ivf recall@10 {recall} below 0.95"
    log(f"[ivf] mode 'ivf' recall@{K_IVF} at nprobe {nprobe} against "
        f"nprobe {ivf.n_lists}: {recall:.4f} ({B_IVF} queries) ({card})")

    # The same partition on the CPU: the plain versions give the same ids.
    cpu = copy.copy(ivf)
    cpu.device = torch.device("cpu")
    for attr in ("centroids", "emb_ivf", "row_ids", "cluster_starts",
                 "cluster_counts", "emb_ivf_q8", "cluster_scales"):
        setattr(cpu, attr, getattr(ivf, attr).cpu())
    t0 = time.perf_counter()
    g_v, g_i = ivf.search(qv, K_IVF + 1)
    c_v, c_i = cpu.search(qv, K_IVF + 1)
    err = ids_agree(g_v[:, :K_IVF], g_i[:, :K_IVF], c_v, c_i, 1e-5)
    log(f"[ivf] the partition moved to the CPU (plain versions): top-"
        f"{K_IVF} ids equal to the card's but at near ties, max |dscore| "
        f"{err:.3e} ({time.perf_counter() - t0:.1f}s) ({card})")
    del cpu

    # 1000 chunks after the build: below the refresh threshold, so they
    # stay in the tail that K1 scans exactly.
    tail_rng = np.random.default_rng(7)
    tail = centers[tail_rng.integers(0, len(centers), 1000)] + np.float32(
        NOISE_IVF / np.sqrt(DIM)) * tail_rng.standard_normal(
            (1000, DIM)).astype(np.float32)
    kb.add_chunks([Chunk(text=f"fresh{j}", doc_id="fresh")
                   for j in range(1000)], vectors=tail)
    assert kb._ivf_built_at == N_IVF and kb._ivf_refresh_thread is None
    q_tail = qv.copy()
    q_tail[0] = tail[123] / np.linalg.norm(tail[123])
    launch_counts["dense_topk"] = launch_counts["dense_topk_sm90"] = 0
    res = kb.search_batch(qtexts, top_k=K_IVF, mode="hybrid_ivf",
                          vectors=q_tail)
    tail_launches = launch_counts["dense_topk"]
    assert tail_launches >= 1 or device != "cuda", "the tail missed K1"
    assert N_IVF + 123 in [x.chunk_id for x in res[0].results]
    log(f"[ivf] 1000 chunks after the build (tail): one hybrid_ivf request "
        f"launched K1 {tail_launches} time(s) ("
        f"{launch_counts['dense_topk_sm90']} through the TMA + wgmma body) "
        f"and found a tail row ({card})")

    profiles = {mode: device_profile(lambda: kb.search_batch(
        qtexts, top_k=K_IVF, mode=mode, vectors=qv))
        for mode in ("hybrid_ivf", "hybrid")} if device == "cuda" else None
    return {"launches": launches, "lat": lat, "ingest_s": ingest_s,
            "build_s": build_s, "calls": calls, "profiles": profiles,
            "recall": recall, "nprobe": nprobe, "kb": kb, "qv": qv,
            "tail_launches": tail_launches}


def q8_times(args) -> dict:
    """Median ms on the same inputs of K5 as routed ("ms") and of K5's
    first body ("first_ms"), timed in turns (routed, first, first, routed;
    each the mean of its two), and of torch._int_mm(q8, e8.T) followed by
    the row scale and topk ("lib_ms")."""
    from tpurag_torch.kernels.quant import (_dense_scan_q8_first_body,
                                            dense_scan_q8)

    def routed():
        return cuda_ms(lambda: dense_scan_q8(*args))

    def first():
        return cuda_ms(lambda: _dense_scan_q8_first_body(*args))

    a, b, c, d = routed(), first(), first(), routed()
    q8, _, e8, es, n_valid, k = args
    live, scale = e8[:n_valid], es[:n_valid]
    return {"ms": (a + d) / 2, "first_ms": (b + c) / 2,
            "lib_ms": cuda_ms(lambda: torch.topk(
                torch._int_mm(q8, live.T).float() * scale, k))}


def q8_bound(b: int, n_valid: int, d: int, k: int):
    """K5's bound: the codes, the row scales and the result moved once, or
    the int8 operations, whichever takes longer."""
    nbytes = b * d + n_valid * (d + 4) + b * 4 + b * k * 8
    return nbytes, 2 * b * n_valid * d


def replay_q8(calls) -> dict:
    """K5 on the main path's own inputs: bit-identical to its plain
    version, and the summed times of the kernel, its first body, its plain
    version and torch._int_mm(q8, e8.T) followed by the row scale and
    topk."""
    from tpurag_torch.kernels.quant import dense_scan_q8, dense_scan_q8_ref

    ms = first_ms = plain_ms = lib_ms = nbytes = ops = 0.0
    shapes = []
    for args, _ in calls:
        v_k, i_k = dense_scan_q8(*args)
        v_r, i_r = dense_scan_q8_ref(*args)
        torch.cuda.synchronize()
        assert torch.equal(i_k, i_r) and torch.equal(v_k, v_r), "K5 replay"
        del v_r, i_r
        t = q8_times(args)
        ms += t["ms"]
        first_ms += t["first_ms"]
        lib_ms += t["lib_ms"]
        plain_ms += cuda_ms(lambda: dense_scan_q8_ref(*args))
        q8, _, _, _, n_valid, k = args
        b, d = q8.shape
        nb, op = q8_bound(b, n_valid, d, k)
        nbytes += nb
        ops += op
        shapes.append(f"{b}x{n_valid}x{d} k={k}")
    return {"ms": ms, "first_ms": first_ms, "plain_ms": plain_ms,
            "lib_ms": lib_ms, "shapes": shapes,
            "bound": bound_ms(nbytes, ops, INT8_OPS_S)}


def replay_ivf(calls, first=None) -> dict:
    """K6 on the main path's own inputs: int8 bit-identical to its plain
    version (scores before the query scale, and ids), bf16 / fp32 within
    TOL with ids equal but at near ties; the largest score difference and
    the summed times, one launch at a time and in chains of 10 (the
    kernel's own time where the kernel outlasts the wrapper's host time,
    host_ms: the host's time to enqueue one call), of the plain version
    and (first: tools/k6_anatomy.py's build of the first design) of the
    first design. Every launch must take the row-split body. The bound
    reads each distinct probed row once (queries that probe one cluster
    share its rows) and counts one product per probed row at the storage
    type's peak; `probed_bound` reads every probed row, and `distinct` is
    the share of probed rows that are distinct."""
    from tpurag_torch.kernels.ivf_scan import (ivf_probe_topk,
                                               ivf_probe_topk_ref)
    from tpurag_torch.kernels.runtime import launch_counts

    tool = load_tool("k6_anatomy") if first is not None else None
    err = ms = chain_ms = host_ms = plain_ms = first_ms = first_chain_ms = 0.0
    nbytes = probed_bytes = ops = rows = distinct = 0
    shapes = []
    for args, kw in calls:
        q, emb, starts, counts, k = args
        before = launch_counts["ivf_probe_topk_sm90"]
        v_k, i_k = ivf_probe_topk(*args, **kw)
        assert launch_counts["ivf_probe_topk_sm90"] == before + 1, (
            "K6 replay missed the row-split body")
        if emb.dtype == torch.int8:
            v_r, i_r = ivf_probe_topk_ref(*args, **kw)
            torch.cuda.synchronize()
            assert torch.equal(i_k, i_r) and torch.equal(v_k, v_r), "K6 replay"
        else:
            v_r, i_r = ivf_probe_topk_ref(*args[:4], k + 1, **kw)
            torch.cuda.synchronize()
            assert (i_k[:, 0] < 2**30).any(), "K6 replay found no rows"
            err = max(err, topk_agree(v_k, i_k, v_r, i_r))
        ms += cuda_ms(lambda: ivf_probe_topk(*args, **kw))
        chain_ms += cuda_ms(lambda: ivf_probe_topk(*args, **kw), chain=10)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            ivf_probe_topk(*args, **kw)
        host_ms += (time.perf_counter() - t0) * 1e3 / 10
        torch.cuda.synchronize()
        plain_ms += cuda_ms(lambda: ivf_probe_topk_ref(*args, **kw))
        if tool is not None:
            qs = q if emb.dtype == torch.int8 else q.to(emb.dtype)
            run = tool.first_probe(first, qs.contiguous(), emb, starts,
                                   counts, k, kw.get("scales_sel"))
            _, f_i = run()
            torch.cuda.synchronize()
            assert torch.equal(f_i, i_k) or emb.dtype != torch.int8, (
                "K6's first design differs")
            first_ms += cuda_ms(run)
            first_chain_ms += cuda_ms(run, chain=10)
        b, d = q.shape
        n = int(counts.sum().item())
        live = counts > 0
        size = dict(zip(starts[live].tolist(), counts[live].tolist()))
        n_distinct = sum(size.values())
        distinct += n_distinct
        rows += n
        rest = b * d * q.element_size() + starts.numel() * 12 + b * k * 8
        nbytes += n_distinct * d * emb.element_size() + rest
        probed_bytes += n * d * emb.element_size() + rest
        ops += 2 * n * d
        shapes.append(f"{emb.dtype} b={b} nprobe={starts.shape[1]} "
                      f"rows={n} k={k}")
    peak = {torch.int8: INT8_OPS_S, torch.bfloat16: BF16_FLOPS_S}.get(
        emb.dtype, FP32_OPS_S)
    return {"err": err, "ms": ms, "chain_ms": chain_ms, "host_ms": host_ms,
            "plain_ms": plain_ms, "first_ms": first_ms,
            "first_chain_ms": first_chain_ms,
            "shapes": shapes, "distinct": distinct / max(rows, 1),
            "bound": bound_ms(nbytes, ops, peak),
            "probed_bound": bound_ms(probed_bytes, 2 * rows * d, peak)}


def replay_gather(calls) -> dict:
    """K8's dots (gather_scores, off the main path since the rescore
    became one launch) on the main path's own rescore inputs: within 1e-5
    of its plain version on live candidates, and the summed times, one
    launch at a time (the ctypes enqueue included) and in chains of 10
    (the kernel's own)."""
    from tpurag_torch.kernels.quant import gather_scores, gather_scores_ref

    err = ms = chain_ms = plain_ms = nbytes = ops = 0.0
    shapes = []
    for (q, emb, ids, _), _ in calls:
        args = (q, emb, ids)
        got = gather_scores(*args)
        want = gather_scores_ref(*args)
        torch.cuda.synchronize()
        live = ids >= 0
        if live.any():
            err = max(err, (got - want)[live].abs().max().item())
        assert err <= 1e-5, f"K8 replay differs by {err}"
        ms += cuda_ms(lambda: gather_scores(*args))
        chain_ms += cuda_ms(lambda: gather_scores(*args), chain=10)
        plain_ms += cuda_ms(lambda: gather_scores_ref(*args))
        b, d = q.shape
        n_live = int(live.sum().item())
        nbytes += n_live * d * emb.element_size() + b * d * 4 + ids.numel() * 8
        ops += 2 * n_live * d
        shapes.append(f"{b}x{ids.shape[1]}")
    return {"err": err, "ms": ms, "chain_ms": chain_ms, "plain_ms": plain_ms,
            "shapes": shapes, "bound": bound_ms(nbytes, ops, FP32_OPS_S)}


def host_ms(fn, n: int = 20) -> float:
    """Host milliseconds to enqueue one fn() call (n calls, no sync
    between them)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    out = (time.perf_counter() - t0) * 1e3 / n
    torch.cuda.synchronize()
    return out


def replay_fuse(calls) -> dict:
    """The fusion kernel (csrc/fuse_rrf.cu) on the main path's own inputs
    (one request's fuse_legs calls): one launch a call, held to
    fuse_legs_ref bit for bit (scores as int32 bit patterns), with the
    wrapper's whole call and the plain version timed (CUDA events) and a
    bound from the bytes a call reads and writes."""
    from tpurag_torch.kernels.fusion import fuse_legs, fuse_legs_ref
    from tpurag_torch.kernels.runtime import launch_counts

    call_ms = plain_ms = nbytes = ops = 0.0
    shapes = []
    for args, kw in calls:
        before = launch_counts["fuse_legs"]
        got = fuse_legs(*args, **kw)
        assert launch_counts["fuse_legs"] == before + 1, "fuse_legs missed"
        want = fuse_legs_ref(*args, **kw)
        assert (torch.equal(got[0].view(torch.int32),
                            want[0].view(torch.int32))
                and torch.equal(got[1], want[1])
                and torch.equal(got[2], want[2])), (
            "the fusion kernel differs from its plain version")
        _, v_i, _, k_i, mass, preset = args
        b, kv = v_i.shape
        kk = 0 if k_i is None else k_i.shape[1]
        fk = preset.final_top_k
        # Each lane's (score, id), the mass, each slot's triple.
        nbytes += b * (8 * (kv + kk) + 4 * (mass is not None) + 12 * fk)
        ops += b * (kv + kk) ** 2
        call_ms += cuda_ms(lambda: fuse_legs(*args, **kw))
        plain_ms += cuda_ms(lambda: fuse_legs_ref(*args, **kw))
        shapes.append(f"b {b}, k_v {kv}, k_k {kk}, final_k {fk}, gate "
                      f"{'on' if mass is not None else 'off'}")
    return {"call_ms": call_ms, "plain_ms": plain_ms, "shapes": shapes,
            "nbytes": nbytes, "bound": bound_ms(nbytes, ops, FP32_OPS_S)}


def replay_rescore(calls) -> dict:
    """K8's rescore (rescore_topk, one launch) on the main path's own
    inputs (the recorded calls of one hybrid_ivf and one hybrid request):
    held to rescore_topk_ref (ids away from near ties, scores 1e-5), and
    beside the rescore as it was before (K8's dots, then about a dozen
    torch launches: quant._top_unique(gather_scores(...))). Every number
    is a call's, the mean over the calls: each form's time in chains of
    10 (CUDA events), host ms and device busy ms and device operations
    (profile); the kernel's single launch and the plain version (CUDA
    events); the bound by bytes (each distinct live candidate row read
    once, the queries, the ids and the (B, k) result)."""
    from tpurag_torch.kernels.quant import (_top_unique, gather_scores,
                                            rescore_topk, rescore_topk_ref)

    def before(q, emb, ids, k):
        return _top_unique(gather_scores(q, emb, ids), ids, k)

    err = nbytes = ops = 0.0
    keys = ("chain_ms", "host_ms", "busy_ms", "ops")
    now, old = dict.fromkeys(keys, 0.0), dict.fromkeys(keys, 0.0)
    plain_ms = ms = 0.0
    shapes = []
    for args, _ in calls:
        q, emb, ids, k = args
        v_k, i_k = rescore_topk(*args)
        v_o, i_o = before(*args)
        v_r, i_r = rescore_topk_ref(q, emb, ids, k + 1)
        torch.cuda.synchronize()
        err = max(err, topk_agree(v_k, i_k, v_r, i_r, 1e-5),
                  topk_agree(v_o, i_o, v_r, i_r, 1e-5))
        for times, fn in ((now, rescore_topk), (old, before)):
            times["chain_ms"] += cuda_ms(lambda: fn(*args), chain=10)
            times["host_ms"] += host_ms(lambda: fn(*args))
            prof = device_profile(lambda: fn(*args))
            times["busy_ms"] += prof["busy_ms"]
            times["ops"] += prof["ops"]
        ms += cuda_ms(lambda: rescore_topk(*args))
        plain_ms += cuda_ms(lambda: rescore_topk_ref(*args))
        b, d = q.shape
        rows = sum(len(set(r) - {-1}) for r in ids.tolist())
        nbytes += (rows * d * emb.element_size() + b * d * 4 + ids.numel() * 4
                   + b * k * 8)
        ops += 2 * rows * d
        shapes.append(f"{b}x{ids.shape[1]} k={k}")
    n = len(calls)
    for times in (now, old):
        for key in keys:
            times[key] /= n
    return {"err": err, "ms": ms / n, "plain_ms": plain_ms / n, "now": now,
            "before": old, "shapes": shapes,
            "bound": bound_ms(nbytes / n, ops / n, FP32_OPS_S)}


def ivf_bf16_call(kb, qv):
    """check_ivf_bf16's K6 call: a bf16 IVF of the first 100k rows of the
    KB (n_lists scaled so clusters keep the 1M partition's mean size)
    probed by the queries qv at the default nprobe. Returns ((args, kw),
    the IVF, nprobe, build seconds)."""
    from tpurag_torch.index.ivf import IVFIndex
    from tpurag_torch.kernels.ivf_scan import probe_clusters

    cfg = dataclasses.replace(kb.config.ivf,
                              n_lists=N_LISTS_IVF * N_IVF_BF16 // N_IVF)
    t0 = time.perf_counter()
    sub = IVFIndex(cfg, device="cuda").build_streaming(
        kb.dense.get_rows, N_IVF_BF16, dtype=torch.bfloat16)
    build_s = time.perf_counter() - t0
    nprobe = int(np.ceil(cfg.n_probe * sub.nprobe_scale))
    q = torch.from_numpy(qv).cuda()
    probe = probe_clusters(q, sub.centroids, nprobe)
    starts = sub.cluster_starts[probe].int()
    counts = sub.cluster_counts[probe].int()
    return ((q, sub.emb_ivf, starts, counts, K_IVF), {}), sub, nprobe, build_s


def check_ivf_bf16(kb, qv, card: str, first=None) -> dict:
    """K6's bf16 form at phase 8's probe shapes: a bf16 IVF of the first
    100k rows of the KB (n_lists scaled so clusters keep the 1M
    partition's mean size), probed by the phase's queries at the default
    nprobe; held to its plain version within TOL (ids equal but at near
    ties) and timed (replay_ivf: singly, in chains of 10, beside the
    first design)."""
    call, sub, nprobe, build_s = ivf_bf16_call(kb, qv)
    r = replay_ivf([call], first)
    log(f"[K6] bf16 form on a {N_IVF_BF16}-row bf16 IVF ({sub.n_lists} "
        f"lists, built in {build_s:.1f}s), {r['shapes'][0]}, nprobe={nprobe}: "
        f"max|dscore|={r['err']:.3e} against the plain version; kernel "
        f"{r['ms']:.4f} ms ({r['chain_ms']:.4f} in chains of 10), first "
        f"design {r['first_ms']:.4f} ({r['first_chain_ms']:.4f}), plain "
        f"{r['plain_ms']:.3f} ms, bound {r['bound'][0]:.4f} ms "
        f"({r['bound'][1]}; distinct rows {r['distinct']:.4f} of those "
        f"probed, every probed row: {r['probed_bound'][0]:.4f} ms) ({card})")
    return r


def q8_standalone(kb, card: str) -> dict:
    """K5's two bodies (timed in turns), torch._int_mm(q8, e8.T) then the
    row scale and topk, and K1 on the bf16 rows, on the phase's 1M-row KB
    at b=32 (k=20, the rescore's overfetch: the 32-query tile) and b=512
    (k=8: the 128-query tile)."""
    from tpurag_torch.kernels.dense import dense_topk
    from tpurag_torch.kernels.quant import quantize_rows

    dense = kb.dense
    n = dense.n_active
    rng = np.random.default_rng(11)
    out = {}
    for b, k in ((B_IVF, 2 * K_IVF), (512, 8)):
        q = torch.from_numpy(unit_rows(rng, b, DIM)).cuda()
        q8, qs = quantize_rows(q)
        t = q8_times((q8, qs, dense._q8, dense._qscale, n, k))
        k1 = cuda_ms(lambda: dense_topk(q, dense.embeddings, n, k))
        bound = bound_ms(*q8_bound(b, n, DIM, k), INT8_OPS_S)
        out[b] = {**t, "k1_ms": k1, "bound": bound}
        log(f"[K5] standalone b={b} x {n} x {DIM} int8 k={k}: wgmma body "
            f"{t['ms']:.3f} ms, first body {t['first_ms']:.3f} ms, "
            f"torch._int_mm + scale + topk {t['lib_ms']:.3f} ms, K1 (bf16) "
            f"at the same shape {k1:.3f} ms, bound {bound[0]:.4f} ms "
            f"({bound[1]}) ({card})")
    return out


# Each port kernel's device functions (K1 has two bodies,
# dense_scan_sm90_kernel and dense_scan_kernel; K5 two,
# dense_scan_q8_sm90_kernel<TQ> and dense_scan_kernel<signed char>).
# dense_merge_kernel serves K1, K5 and K7 alike; it counts as K1's.
PORT_KERNELS = {"dense_scan_kernel": "K1", "dense_merge_kernel": "K1",
                "dense_scan_sm90_kernel": "K1", "topk_rows_kernel": "K2",
                "merge_segsum_kernel": "K2'",
                "dense_scan_q8_sm90_kernel": "K5",
                "full_rows_kernel": "K3", "combine_items_kernel": "K4",
                "ivf_scan_kernel": "K6", "ivf_rows_kernel": "K6",
                "dense_co_scan_kernel": "K7",
                "dense_co_resident_q_kernel": "K7",
                "dense_co_resident_c_kernel": "K7",
                "gather_scores_kernel": "K8",
                "rescore_topk_kernel": "K8", "fuse_rrf_kernel": "F"}


def device_fn(raw: str) -> str:
    """A profiled device function's own name and template arguments,
    without its namespace ("(anonymous namespace)::" included), return
    type and parameter list."""
    m = re.search(r"(\w+_kernel(?:<[^<>()]*(?:\(bool\)[^<>()]*)*>)?)", raw)
    return m.group(1).lstrip("_") if m else raw[:48]


def port_kernel(name: str):
    """The port kernel (K1..K8) a device function belongs to, or None."""
    if re.match(r"dense_scan_kernel<\s*(signed char|char|int8_t)\s*>", name):
        return "K5"
    return PORT_KERNELS.get(name.split("<")[0])


def device_profile(fn) -> dict:
    """One call of fn under torch.profiler: wall ms (ending in a
    synchronize), device-busy ms (the sum of the card's kernel and copy
    times), the number of those device operations, the busiest device
    functions (template arguments kept), each port kernel's device ms
    and launches (port_ops), and the ms of PyTorch's gathers
    (vectorized_gather_kernel), its elementwise kernels and the copies."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        # Every fn here runs device work: a session with none recorded
        # lost it (see TEARDOWN_CUPTI above) and is taken again.
        if any(e.device_type == DeviceType.CUDA for e in prof.events()):
            break
    by_name: dict[str, float] = {}
    ops = 0
    port_ops: dict[str, int] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ops += 1
            name = device_fn(e.name)
            by_name[name] = (by_name.get(name, 0.0)
                             + e.time_range.elapsed_us() / 1e3)
            if (kern := port_kernel(name)) is not None:
                port_ops[kern] = port_ops.get(kern, 0) + 1
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    port: dict[str, float] = {}
    for name, ms in by_name.items():
        if (kern := port_kernel(name)) is not None:
            port[kern] = port.get(kern, 0.0) + ms
    gather = sum(ms for name, ms in by_name.items()
                 if name.startswith("vectorized_gather_kernel"))
    elementwise = sum(ms for name, ms in by_name.items()
                      if "elementwise_kernel" in name)
    copies = sum(ms for name, ms in by_name.items()
                 if name.startswith("Memcpy"))
    return {"wall_ms": wall_ms, "busy_ms": busy, "ops": ops, "top": top,
            "port": dict(sorted(port.items())), "port_ops": port_ops,
            "gather_ms": gather,
            "elementwise_ms": elementwise, "copy_ms": copies}


def hybrid_chain_profile(bench_mod, iters: int = 10, reps: int = 4) -> dict:
    """Eval `hybrid`'s timed chain (`iters` steps back to back, one sync,
    as bench._chain_time runs it), per step: the chain's device span
    (CUDA events; the run with the smallest, of `reps`) and the host's
    time to enqueue that run; under the profiler, device-busy ms, device
    operations and each port kernel's ms and kernels; and the span of the
    same chain replayed as a CUDA graph, with no host work between its
    launches (None if the chain cannot be captured)."""
    x = bench_mod.hybrid_inputs(device="cuda")
    step = bench_mod.hybrid_chain_step(x)

    def chain():
        acc = torch.zeros((), dtype=torch.float32, device="cuda")
        for i in range(iters):
            acc = acc + step(i)
        return acc

    def span_ms(fn) -> tuple[float, float]:
        """(device span, host enqueue) ms per step of one run of fn."""
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        t0 = time.perf_counter()
        fn()
        end.record()
        host = (time.perf_counter() - t0) * 1e3
        end.synchronize()
        return start.elapsed_time(end) / iters, host / iters

    span_ms(chain)  # warm-up
    span, enqueue = min(span_ms(chain) for _ in range(reps))
    prof = device_profile(chain)
    graph_ms = None
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            chain()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            chain()
        span_ms(graph.replay)  # warm-up
        graph_ms = min(span_ms(graph.replay)[0] for _ in range(reps))
    except RuntimeError as e:
        log(f"[eval] hybrid chain: CUDA graph capture failed ({e})")
    return {"span_ms": span, "enqueue_ms": enqueue,
            "busy_ms": prof["busy_ms"] / iters, "ops": prof["ops"] / iters,
            "port": {n: ms / iters for n, ms in prof["port"].items()},
            "port_ops": {n: c / iters for n, c in prof["port_ops"].items()},
            "graph_ms": graph_ms}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    from tpurag_torch.index.inverted import packed_cbits
    from tpurag_torch.kernels import runtime
    from tpurag_torch.kernels.bm25_join import combine_topk
    from tpurag_torch.kernels.bm25_merge import (bm25_topk_fused,
                                                 merge_segsum_full,
                                                 merge_segsum_topk)
    from tpurag_torch.kernels.dense import dense_topk, dense_topk_co
    from tpurag_torch.kernels.fusion import fuse_legs
    from tpurag_torch.kernels.ivf_scan import ivf_probe_topk, ivf_scan
    from tpurag_torch.kernels.quant import (dense_scan_q8, gather_scores,
                                            rescore_topk)
    from tpurag_torch.kernels.runtime import launch_counts, load_kernels

    t_start = time.perf_counter()
    # -- 1. device ----------------------------------------------------------
    card = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {kind}; nvidia-smi: {card}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    # -- 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    load_kernels()
    log(f"[build] {time.perf_counter() - t0:.1f}s "
        f"(nvcc {runtime.build_info['seconds']:.1f}s) "
        f"{runtime.build_info['path']}")
    func = ""
    no_spill_bodies = ("dense_scan_sm90_kernel", "dense_scan_q8_sm90_kernel",
                    "dense_co_resident_q_kernel",
                    "dense_co_resident_c_kernel", "ivf_rows_kernel")
    spill_funcs = {body: set() for body in no_spill_bodies}
    for line in runtime.build_info["log"].splitlines():
        if m := re.search(r"(?:Compiling entry function|Function properties "
                          r"for) '?(\w+)", line):
            func = m.group(1)
        if "registers" in line or "spill" in line:
            log(f"[build] {func}: {line.strip()}")
        for body in no_spill_bodies:
            if "spill" in line and body in func:
                spill_funcs[body].add(func)
                assert re.search(r"\b0 bytes spill stores, 0 bytes spill "
                                 r"loads", line), f"{body} spills: {line}"
    # No ptxas report for a kernel means the log or its format changed,
    # and the check above saw nothing (K5's body has two tiles; K6's
    # row-split body one per storage type).
    spill_counts = {body: len(f) for body, f in spill_funcs.items()}
    assert spill_counts == {"dense_scan_sm90_kernel": 1,
                            "dense_scan_q8_sm90_kernel": 2,
                            "dense_co_resident_q_kernel": 1,
                            "dense_co_resident_c_kernel": 1,
                            "ivf_rows_kernel": 3}, (
        f"bodies with a ptxas spill report: {spill_counts}")

    # -- 3. K1 against its plain version --------------------------------------
    launch_counts["dense_topk_sm90"] = 0
    err1, t3 = check_dense(BATCH, 131_072, N_DOCS, DIM, 8, timed=True)
    assert launch_counts["dense_topk_sm90"] >= 1, "K1 missed its wgmma body"
    log(f"[K1] b={BATCH} n_valid={N_DOCS}/131072 d={DIM} bf16 k=8: "
        f"max|dscore|={err1:.3e}; TMA + wgmma body {t3['ms']:.3f} ms, first "
        f"body {t3['first_ms']:.3f} ms, plain {t3['plain_ms']:.3f} ms, "
        f"torch.topk(q @ emb.T) {t3['lib_ms']:.3f} ms ({card})")
    for i, args in enumerate(SM90_SHAPES):
        before = launch_counts["dense_topk_sm90"]
        err1 = max(err1, check_dense(*args, seed=10 + i)[0])
        assert launch_counts["dense_topk_sm90"] == before + 1, args
    err200, _ = check_dense(256, 20_480, 20_000, DIM, 200, seed=1,
                            first_body=True)
    errf32, _ = check_dense(64, 4096, 4000, 256, 40, torch.float32, seed=2)
    before = launch_counts["dense_topk_sm90"]
    err36, _ = check_dense(5, 300, 250, 36, 8, seed=3)  # unaligned D
    assert launch_counts["dense_topk_sm90"] == before, "D=36 took TMA"
    log(f"[K1] TMA + wgmma body, {len(SM90_SHAPES)} shapes (b in "
        f"{{1, 8, 130, 512}}, D in {{64, 72, 1024}}, k in {{8, 31, 40, 64, "
        f"200, 600}}, n_valid < N): max|dscore|={err1:.3e}; first body: bf16 "
        f"k=200 {err200:.3e}, fp32 k=40 {errf32:.3e}, bf16 D=36 {err36:.3e}")
    err1 = max(err1, err200, errf32, err36)

    # -- 4. K2 against its plain version --------------------------------------
    err2 = 0.0
    before = launch_counts["merge_segsum_topk"]
    for p in (64, 256, 1024, 2048):
        for t in (1, 2, 8):
            for cbits in (14, 0):
                e, _ = check_merge(256, t, p, cbits, seed=p * 10 + t, runs=2)
                err2 = max(err2, e)
    for name in K2_CASES:
        check_topk_classes(name, runs=2)
    assert launch_counts["merge_segsum_topk"] == before + 2 * (
        24 + len(K2_CASES)), "K2's checks missed a launch"
    log(f"[K2] 24 classes (p x t x packed/unpacked) of flipped rows and "
        f"{len(K2_CASES)} slot-table cases ({', '.join(K2_CASES)}), each "
        f"twice, bit-identical to the plain version ({card})")
    k2_tool = load_tool("k2_anatomy")
    k2_first = k2_tool.build_first(runtime.BUILD_DIR / "k2_first")
    for cbits in (14, 0):
        e, k2t = check_merge(BATCH, 8, 2048, cbits, first=k2_first)
        err2 = max(err2, e)
        log(f"[K2] b={BATCH} t=8 p=2048 (W=16384) "
            f"{f'packed cbits={cbits}' if cbits else 'unpacked'}: kernel "
            f"{k2t['ms']:.3f} ms, first body {k2t['first_ms']:.3f} ms, plain "
            f"{k2t['plain_ms']:.3f} ms ({card})")

    # -- 4b. K3 against its plain version ---------------------------------------
    for name in K3_CASES:
        before = launch_counts["merge_segsum_full"]
        check_full_classes(name, runs=2)
        assert launch_counts["merge_segsum_full"] == before + 2, name
    n_full = 0
    for p in (64, 256, 1024, 2048):  # narrow classes, both layouts
        for t in (2, 8):
            for cbits in (14, 0):
                check_full(64, t, p, cbits, seed=p + t)
                n_full += 1
    for p in (4096, 8192, 16384, 32768):  # wide classes of the 1M point
        for t in (2, 4):
            for cbits in ((11, 0) if t * p <= 32768 else (0,)):
                check_full(16, t, p, cbits, n_docs=N_WIDE, seed=p + t)
                n_full += 1
    _, k3w_ms, k3w_plain_ms = check_full(16, 4, 32768, 0, n_docs=N_WIDE,
                                         timed=True)
    k3_tool = load_tool("k3_anatomy")
    k3_first = k3_tool.build_first(runtime.BUILD_DIR / "k3_first")
    k3w_rows = [torch.from_numpy(x).cuda() for x in merge_rows(
        np.random.default_rng(0), 16, 4, 32768, N_WIDE, flip=False)]
    k3w_first_ms = cuda_ms(lambda: k3_tool.first_full(k3_first, *k3w_rows,
                                                      32768, 4, 0))
    log(f"[K3] {len(K3_CASES)} edge cases ({', '.join(K3_CASES)}), each "
        f"twice, and {n_full} (doc, con) row shapes (W = 128 .. 131072, "
        f"packed where it applies) bit-identical to the plain version; b=16 "
        f"t=4 p=32768 (W=131072): kernel {k3w_ms:.3f} ms, first body "
        f"{k3w_first_ms:.3f} ms, plain {k3w_plain_ms:.3f} ms ({card})")

    # -- 4c. K4 against its plain version ---------------------------------------
    for name in K4_CASES:
        for k in (1, 8, 40, 200):
            check_combine_classes(name, k, runs=2)
    check_combine_classes("mixed", 1100, runs=2)  # warp lists in HBM
    for wn in (2048, 16384):
        for ww in (4096, 32768, 131072):
            for k in (8, 40):
                check_combine(32, wn, ww, k, n_docs=N_WIDE, seed=wn + ww + k)
    _, k4w_ms, k4w_plain_ms = check_combine(64, 16384, 131072, 8,
                                            n_docs=N_WIDE, timed=True)
    k4_tool = load_tool("k4_anatomy")
    k4_first = k4_tool.build_first(runtime.BUILD_DIR / "k4_first")
    k4w_args = combine_rows(64, 16384, 131072, N_WIDE)[:4]
    k4w_first_ms = cuda_ms(lambda: k4_tool.first_combine(k4_first,
                                                         *k4w_args, 8))
    k4w_bytes, k4w_lanes = k4_live_bytes(
        *k4w_args[:2], [(*k4w_args[2:], None, None)], 8)
    k4w_bound = bound_ms(k4w_bytes, k4w_lanes, FP32_OPS_S)
    log(f"[K4] {len(K4_CASES)} edge cases ({', '.join(K4_CASES)}) x k in "
        f"{{1, 8, 40, 200}} and k=1100, each twice, and one class at narrow "
        f"W in {{2048, 16384}} x wide W in {{4096, 32768, 131072}} x k in "
        f"{{8, 40}}: bit-identical to the plain version; g=64 16384+131072 "
        f"lanes k=8: kernel {k4w_ms:.3f} ms, first body {k4w_first_ms:.3f} "
        f"ms, plain {k4w_plain_ms:.3f} ms, bound {k4w_bound[0]:.4f} ms "
        f"({k4w_bound[1]}: {k4w_bytes / 1e6:.1f} MB live) ({card})")

    # -- 5. the 100k slice ------------------------------------------------------
    run = drive_slice("cuda", (dense_topk, merge_segsum_topk, fuse_legs))
    for name, n in run["launches"].items():
        assert n > 0, f"{name} was not launched on the main path"
    assert run["launches"]["merge_segsum_topk"] == 7, (
        "K2 must launch exactly once per search (4 batches, 3 singles)")
    assert run["launches"]["fuse_legs"] == 7, (
        "the fusion kernel must launch exactly once per hybrid search")
    fs = replay_fuse(run.pop("fuse_calls"))
    log(f"[fuse] one 100k request's fusion ({'; '.join(fs['shapes'])}) "
        f"bit-identical to fuse_legs_ref: the wrapper's whole call "
        f"{fs['call_ms']:.3f} ms, plain {fs['plain_ms']:.3f} ms, bound "
        f"{fs['bound'][0]:.5f} ms ({fs['bound'][1]}: "
        f"{fs['nbytes'] / 1e3:.1f} kB) ({card})")
    k2s = replay_topk(run["calls"], k2_first)
    log(f"[K2] one 100k request's launch ({'; '.join(k2s['shapes'])}) "
        f"bit-identical to the plain version: kernel {k2s['ms']:.3f} ms (the "
        f"wrapper's whole call {k2s['call_ms']:.3f} ms), the first body's "
        f"per-class launches {k2s['first_ms']:.3f} ms, plain "
        f"{k2s['plain_ms']:.3f} ms, bound {k2s['bound'][0]:.4f} ms "
        f"({k2s['bound'][1]}: {k2s['nbytes'] / 1e6:.1f} MB; {k2s['lanes']} "
        f"live lanes) ({card})")
    prof = run["profile"]
    if prof["busy_ms"] > 0:
        assert prof["port_ops"].get("F") == 1, (
            f"the profiled 100k request ran {prof['port_ops']} port kernels")
        log(f"[perf] 100k: one profiled request: wall {prof['wall_ms']:.2f} "
            f"ms, device busy {prof['busy_ms']:.3f} ms, idle share "
            f"{1 - prof['busy_ms'] / prof['wall_ms']:.3f}, "
            f"{prof['ops']} device operations; busiest: "
            + "; ".join(f"{n} {ms:.3f} ms" for n, ms in prof["top"]))
        log("[perf] 100k: device ms by port kernel in the profiled request: "
            + ", ".join(f"{n} {ms:.3f}" for n, ms in prof["port"].items())
            + f"; vectorized_gather_kernel {prof['gather_ms']:.3f} ms, "
            f"elementwise {prof['elementwise_ms']:.3f} ms, copies "
            f"{prof['copy_ms']:.3f} ms")
    else:
        log("[perf] 100k: device busy time not measured (the profiler "
            "recorded no device events)")
    del run["calls"]

    # -- 6. times -----------------------------------------------------------------
    p50 = statistics.median(run["lat_ms"])
    log(f"[perf] search_batch b={BATCH} hybrid p50 {p50:.2f} ms (requests: "
        f"{', '.join(f'{x:.2f}' for x in run['lat_ms'])} ms); ingest "
        f"{run['ingest_s']:.2f}s ({card})")

    # -- 7. the 1M wide-term slice ------------------------------------------------
    kernels = (dense_topk, merge_segsum_topk, merge_segsum_full, combine_topk,
               fuse_legs)
    wide = drive_wide("cuda", kernels)
    launches = wide["launches"]
    for name, n in launches.items():
        assert n > 0, f"{name} was not launched on the wide path"
    assert launches["dense_topk_sm90"] == launches["dense_topk"], (
        "a 1M request's K1 launch missed the TMA + wgmma body")
    assert launches["combine_topk"] == 4 and min(wide["hard"]) > 0, (
        "K4 must launch exactly once per 1M request")
    assert launches["merge_segsum_full"] == 4, (
        "K3 must launch exactly once per 1M request")
    assert launches["merge_segsum_topk"] == 4, (
        "K2 must launch exactly once per 1M request")
    assert launches["fuse_legs"] == 4, (
        "the fusion kernel must launch exactly once per 1M request")
    calls = wide["calls"]
    k1 = replay_dense(calls["dense_topk"])
    k2 = replay_topk(calls["merge_segsum_topk_classes"], k2_first)
    k3 = replay_full(calls["merge_segsum_full_classes"], k3_first)
    k4 = replay_combine(calls["combine_topk_classes"], k4_first)
    kf = replay_fuse(calls["fuse_legs"])
    del calls, wide["calls"]
    err1 = max(err1, k1["err"], k1["first_err"])
    wide_p50 = statistics.median(wide["lat_ms"])
    log(f"[K1] one request's {len(k1['shapes'])} launch on the 1M path "
        f"({', '.join(k1['shapes'])}) against dense_topk_ref: max|dscore|="
        f"{k1['err']:.3e} (first body {k1['first_err']:.3e}); TMA + wgmma "
        f"body {k1['ms']:.3f} ms, first body {k1['first_ms']:.3f} ms, plain "
        f"{k1['plain_ms']:.3f} ms, torch.topk(q @ emb.T) {k1['lib_ms']:.3f} "
        f"ms, bound {k1['bound'][0]:.4f} ms ({k1['bound'][1]}) ({card})")
    log(f"[K2] one request's launch on the 1M path "
        f"({'; '.join(k2['shapes'])}) bit-identical to the plain version: "
        f"kernel {k2['ms']:.3f} ms (the wrapper's whole call "
        f"{k2['call_ms']:.3f} ms), the first body's per-class launches "
        f"{k2['first_ms']:.3f} ms, plain {k2['plain_ms']:.3f} ms, bound "
        f"{k2['bound'][0]:.4f} ms ({k2['bound'][1]}: "
        f"{k2['nbytes'] / 1e6:.1f} MB; {k2['lanes']} live lanes) ({card})")
    log(f"[K3] one request's launch on the 1M path "
        f"({'; '.join(k3['shapes'])}) bit-identical to the plain version: "
        f"kernel {k3['ms']:.3f} ms (the wrapper's whole call "
        f"{k3['call_ms']:.3f} ms), the first body's per-class launches "
        f"{k3['first_ms']:.3f} ms (with the gather glue it ran after "
        f"{k3['flow_ms']:.3f} ms), plain {k3['plain_ms']:.3f} ms, bound "
        f"{k3['bound'][0]:.4f} ms ({k3['bound'][1]}: "
        f"{k3['nbytes'] / 1e6:.1f} MB; {k3['lanes'][0]} live lanes read, "
        f"{k3['lanes'][1]} written) ({card})")
    log(f"[K4] one request's launch on the 1M path "
        f"({'; '.join(k4['shapes'])}) bit-identical to combine_classes_ref: "
        f"kernel {k4['ms']:.3f} ms (the wrapper's whole call "
        f"{k4['call_ms']:.3f} ms), the first body's per-class launches "
        f"{k4['first_ms']:.3f} ms, plain {k4['plain_ms']:.3f} ms, bound "
        f"{k4['bound'][0]:.4f} ms ({k4['bound'][1]}: "
        f"{k4['nbytes'] / 1e6:.1f} MB live) ({card})")
    log(f"[fuse] one 1M request's fusion ({'; '.join(kf['shapes'])}) "
        f"bit-identical to fuse_legs_ref: the wrapper's whole call "
        f"{kf['call_ms']:.3f} ms, plain {kf['plain_ms']:.3f} ms, bound "
        f"{kf['bound'][0]:.5f} ms ({kf['bound'][1]}: "
        f"{kf['nbytes'] / 1e3:.1f} kB) ({card})")
    prof = wide["profile"]
    # The fusion kernel's row takes its device time from this profile.
    kf["ms"] = prof["port"].get("F") if prof["busy_ms"] > 0 else None
    if prof["busy_ms"] > 0:
        assert prof["port_ops"].get("F") == 1, (
            f"the profiled 1M request ran {prof['port_ops']} port kernels")
        log(f"[perf] 1M: one profiled request: wall {prof['wall_ms']:.2f} ms, "
            f"device busy {prof['busy_ms']:.3f} ms, idle share "
            f"{1 - prof['busy_ms'] / prof['wall_ms']:.3f}; busiest: "
            + "; ".join(f"{n} {ms:.3f} ms" for n, ms in prof["top"]))
        log("[perf] 1M: device ms by port kernel in the profiled request: "
            + ", ".join(f"{n} {ms:.3f}" for n, ms in prof["port"].items())
            + f"; K2 share {prof['port'].get('K2', 0.0) / prof['busy_ms']:.3f}"
            f", K3 share {prof['port'].get('K3', 0.0) / prof['busy_ms']:.3f}"
            f", K4 share {prof['port'].get('K4', 0.0) / prof['busy_ms']:.3f}"
            f", vectorized_gather_kernel {prof['gather_ms']:.3f} ms (share "
            f"{prof['gather_ms'] / prof['busy_ms']:.3f}), elementwise "
            f"{prof['elementwise_ms']:.3f} ms, copies {prof['copy_ms']:.3f} "
            f"ms")
    else:
        log("[perf] 1M: device busy time not measured (the profiler "
            "recorded no device events)")
    log(f"[perf] 1M: search_batch b={BATCH_WIDE} hybrid p50 {wide_p50:.2f} ms "
        f"(requests: {', '.join(f'{x:.2f}' for x in wide['lat_ms'])} ms); "
        f"launches per request "
        f"{ {n: c / 4 for n, c in launches.items()} }; ingest "
        f"{wide['ingest_s']:.2f}s ({card})")

    del wide
    gc.collect()
    torch.cuda.empty_cache()

    # -- 8. the int8 + IVF slice at 1M --------------------------------------------
    for i, args in enumerate(Q8_SHAPES):
        before = launch_counts["dense_scan_q8_sm90"]
        check_q8(*args, seed=20 + i)
        assert launch_counts["dense_scan_q8_sm90"] == before + (
            args[3] % 16 == 0), f"K5's route at {args}"
    for args in ((B_IVF, 20_480, 20_000, DIM, 2 * K_IVF),
                 (512, 8192, 8000, DIM, 8), (3, 1000, 1000, 64, 600)):
        check_q8(*args, seed=args[0], first_body=True)
    err8 = max(check_gather(B_IVF, 2 * K_IVF, 50_000, DIM, seed=1),
               check_gather(7, 16, 300, DIM, torch.float32, seed=2),
               check_gather(3, 5, 100, 37, seed=3))
    before = launch_counts["rescore_topk"]
    err8r = max(check_rescore(name, seed=i)
                for i, name in enumerate(RESCORE_CASES))
    assert launch_counts["rescore_topk"] == before + len(RESCORE_CASES)
    err6 = 0.0
    for args in ((B_IVF, 4096, 72, DIM, 2 * K_IVF, torch.int8),
                 (8, 64, 64, 256, 10, torch.int8),
                 (5, 40, 3, 40, 50, torch.int8),
                 (B_IVF, 4096, 72, DIM, K_IVF, torch.bfloat16),
                 (4, 30, 6, 36, 8, torch.bfloat16),
                 (6, 50, 10, 64, 12, torch.float32)):
        err6 = max(err6, check_ivf(*args, seed=args[0] + args[4]))
    for i, (*args, kw) in enumerate(IVF_CASES.values()):
        err6 = max(err6, check_ivf(*args, seed=40 + i, **kw))
    log(f"[K5] {len(Q8_SHAPES)} shapes (b 1-512, D in {{40, 48, "
        f"1024, 4096}}, k 1-600, n_valid < N, k > n_valid; D=40 on the first "
        f"body, the rest on the wgmma body) and the first body at 3 aligned "
        f"shapes: bit-identical to the plain version; [K6] int8 "
        f"bit-identical, bf16 / fp32 "
        f"max|dscore|={err6:.3e} at 6 shapes (empty and small clusters; D "
        f"in {{40, 36}} on the first body, the rest on the row-split body) "
        f"and {len(IVF_CASES)} edge cases ({', '.join(IVF_CASES)}); "
        f"[K8] dots max|dscore|={err8:.3e} at 3 shapes, the rescore "
        f"max|dscore|={err8r:.3e} at {len(RESCORE_CASES)} cases "
        f"({', '.join(RESCORE_CASES)}; ids equal but at near ties), one "
        f"launch each ({card})")
    ivf_kernels = kernels + (dense_scan_q8, ivf_probe_topk, gather_scores,
                             rescore_topk)
    iv = drive_ivf("cuda", ivf_kernels, card)
    ivf_launches = iv["launches"]
    # Each query holds one narrow and one wide term: its one-term narrow
    # row needs no merge, so the keyword leg runs K4 alone.
    for name in ("ivf_probe_topk", "rescore_topk", "dense_scan_q8",
                 "combine_topk"):
        assert ivf_launches[name] > 0, f"{name} was not launched in phase 8"
    # One launch a rescore, and K8's dots no longer launched on their own.
    assert ivf_launches["rescore_topk"] == ivf_launches["rescore_calls"], (
        f"{ivf_launches['rescore_topk']} rescore launches for "
        f"{ivf_launches['rescore_calls']} rescore_topk calls")
    assert ivf_launches["gather_scores"] == 0
    assert ivf_launches["dense_scan_q8_sm90"] == ivf_launches[
        "dense_scan_q8"], "a 1M request's K5 launch missed the wgmma body"
    assert ivf_launches["ivf_probe_topk_sm90"] == ivf_launches[
        "ivf_probe_topk"], "a 1M request's K6 launch missed the row-split body"
    k5 = replay_q8(iv["calls"]["dense_scan_q8"])
    k6_first = load_tool("k6_anatomy").build_first(runtime.BUILD_DIR
                                                   / "k6_first")
    k6 = replay_ivf(iv["calls"]["ivf_probe_topk"], k6_first)
    k8 = replay_gather(iv["calls"]["rescore_topk"])
    k8r = replay_rescore(iv["calls"]["rescore_topk"])
    err8r = max(err8r, k8r["err"])
    for name, r in (("now (one launch)", k8r["now"]),
                    ("before (K8's dots + torch)", k8r["before"])):
        log(f"[K8] rescore_topk {name}, a call (the mean over one hybrid_ivf "
            f"and one hybrid request's calls, {', '.join(k8r['shapes'])}): "
            f"{r['chain_ms']:.4f} ms in chains of 10, host "
            f"{r['host_ms']:.4f} ms, device busy {r['busy_ms']:.4f} ms in "
            f"{r['ops']:.1f} device operations ({card})")
    # The profile must show the rescore as one kernel on the device a call.
    assert k8r["now"]["ops"] == 1, (
        f"a rescore_topk call ran {k8r['now']['ops']} device operations")
    log(f"[K8] rescore_topk's kernel held to rescore_topk_ref "
        f"(max|dscore|={k8r['err']:.3e}), a call: single launch "
        f"{k8r['ms']:.4f} ms, plain {k8r['plain_ms']:.3f} ms, bound "
        f"{k8r['bound'][0]:.5f} ms ({k8r['bound'][1]}) ({card})")
    k4i = replay_combine(iv["calls"]["combine_topk_classes"])
    log(f"[K4] phase 8's launch ({', '.join(k4i['shapes'])}) bit-identical "
        f"to combine_classes_ref: kernel {k4i['ms']:.3f} ms (whole call "
        f"{k4i['call_ms']:.3f} ms), plain "
        f"{k4i['plain_ms']:.3f} ms, bound {k4i['bound'][0]:.4f} ms "
        f"({k4i['bound'][1]}) ({card})")
    err8 = max(err8, k8["err"])
    del iv["calls"]
    for name, r, lib in (("K5", k5, f"first body {k5['first_ms']:.3f} ms, "
                                    "torch._int_mm + scale + topk "
                                    f"{k5['lib_ms']:.3f} ms, "),
                         ("K6", k6, f"{k6['chain_ms']:.4f} ms in chains of "
                                    f"10 (host {k6['host_ms']:.4f} ms a "
                                    "call), first design "
                                    f"{k6['first_ms']:.4f} "
                                    f"({k6['first_chain_ms']:.4f}) ms, "
                                    f"distinct rows {k6['distinct']:.4f} of "
                                    "those probed (bound over every probed "
                                    f"row {k6['probed_bound'][0]:.4f} ms), "),
                         ("K8", k8, f"{k8['chain_ms']:.4f} ms in chains of "
                                    "10, ")):
        log(f"[{name}] one request's {len(r['shapes'])} launch(es) on the 1M "
            f"path ({', '.join(r['shapes'])}) held to the plain version: "
            f"kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, {lib}"
            f"bound {r['bound'][0]:.4f} ms ({r['bound'][1]}) ({card})")
    q8_standalone(iv["kb"], card)
    bf = check_ivf_bf16(iv["kb"], iv["qv"], card, k6_first)
    err6 = max(err6, bf["err"])
    k6_ops = iv["profiles"]["hybrid_ivf"]["port_ops"].get("K6", 0)
    assert k6_ops == 1, f"a hybrid_ivf request ran {k6_ops} K6 kernels"
    k8_ops = iv["profiles"]["hybrid_ivf"]["port_ops"].get("K8", 0)
    assert k8_ops == 1, f"a hybrid_ivf request ran {k8_ops} K8 kernels"
    for mode, prof in iv["profiles"].items():
        if prof["busy_ms"] > 0:
            log(f"[perf] ivf: one profiled {mode} request (b={B_IVF}, with "
                f"the 1000-row tail): wall {prof['wall_ms']:.2f} ms, device "
                f"busy {prof['busy_ms']:.3f} ms, idle share "
                f"{1 - prof['busy_ms'] / prof['wall_ms']:.3f}; busiest: "
                + "; ".join(f"{n} {ms:.3f} ms" for n, ms in prof["top"]))
            log(f"[perf] ivf: device ms by port kernel in the profiled {mode} "
                "request: " + ", ".join(f"{n} {ms:.3f}"
                                        for n, ms in prof["port"].items()))
        else:
            log(f"[perf] ivf: {mode} device busy time not measured (the "
                "profiler recorded no device events)")
    log("[perf] ivf: search_batch p50 " + "; ".join(
        f"{name} {statistics.median(v):.2f} ms (requests: "
        f"{', '.join(f'{x:.2f}' for x in v)})" for name, v in iv["lat"].items())
        + f"; launches per request (12 requests) "
        f"{ {n: c / 12 for n, c in ivf_launches.items()} }; ingest "
        f"{iv['ingest_s']:.2f}s, build_ivf {iv['build_s']:.2f}s, recall@10 "
        f"{iv['recall']:.4f} ({card})")
    del iv
    gc.collect()
    torch.cuda.empty_cache()

    # -- 9. the eval-suite slice -------------------------------------------------
    # 9a. K2' and K7 against their plain versions.
    n_fused = 0
    for t in (1, 2, 4, 8):
        for p_max in (16, 64, 256, 2048):
            for cbits in (packed_cbits(N_DOCS), 0):
                k = 24 if t * p_max <= 16 else 8  # k past W = 16 lanes
                check_fused(64, t, p_max, cbits, k, seed=t * p_max + cbits)
                n_fused += 1
    check_fused(16, 2, 16, 0, k=40, seed=5)  # k past W = 32 lanes
    from tpurag_torch.eval import bench as bench_mod

    x = bench_mod.hybrid_inputs(device="cuda")  # the eval draw's windows
    x = {n: x[n] for n in ("starts", "lens", "idf", "post_doc",
                           "post_impact", "n_valid", "k", "p_max")}
    before = launch_counts["bm25_topk_fused"]
    for cbits in (packed_cbits(N_DOCS), 0):
        for i, name in enumerate(FUSED_CASES):
            check_fused_case(name, cbits, seed=i)
        fused_agree(list(x.values())[:5], x["n_valid"], x["k"], x["p_max"],
                    cbits)
    del x
    assert launch_counts["bm25_topk_fused"] == before + 2 * (
        len(FUSED_CASES) + 1), "a K2' check missed its one launch"
    log(f"[K2'] {n_fused + 1} shapes (t in {{1, 2, 4, 8}} x p_max in {{16, "
        f"64, 256, 2048}}, packed cbits={packed_cbits(N_DOCS)} and unpacked; "
        f"clamped starts, empty windows, docs >= n_valid, k > W) and "
        f"{len(FUSED_CASES) + 1} more ({', '.join(FUSED_CASES)}, the eval "
        f"draw's windows), packed and unpacked, one launch each: "
        f"bit-identical to the plain version ({card})")
    t0 = time.perf_counter()
    err7 = 0.0
    for i, args in enumerate(K7_SHAPES):
        before = launch_counts["dense_topk_co_sm90"]
        err7 = max(err7, check_dense_co(*args, seed=20 + i))
        assert launch_counts["dense_topk_co_sm90"] == before + 1, args
    before = launch_counts["dense_topk_co_sm90"]
    for args in ((7, 300, 300, 64, 8), (16, 5000, 4777, 128, 8),
                 (130, 2500, 2500, 96, 5), (3, 10, 4, 32, 8),
                 (9, 257, 200, 130, 3), (256, 20_480, 20_000, DIM, 200),
                 (4160, 20_480, 20_000, DIM, 8)):
        err7 = max(err7, check_dense_co(*args, seed=args[0] + args[-1]))
    assert launch_counts["dense_topk_co_sm90"] == before + 6  # D=130 not
    # The first body: fp32, D past form (ii)'s tile, an unaligned corpus.
    before = launch_counts["dense_topk_co_sm90"]
    err7 = max(err7, check_dense_co(64, 4096, 4000, 256, 40, torch.float32,
                                    seed=2),
               check_dense_co(130, 3000, 2900, 1352, 8, seed=3),
               check_dense_co(130, 3000, 2900, DIM, 8, seed=4, misalign=True),
               check_dense_co(512, 20_480, 20_000, DIM, 8, seed=5,
                              first_body=True))
    assert launch_counts["dense_topk_co_sm90"] == before, "took the wgmma body"
    log(f"[K7] Hopper body, {len(K7_SHAPES)} shapes (b in {{1, 8, "
        f"32, 33, 130, 512, 4160}}, n_valid in {{0, 5, 63, mid-tile}}, an "
        f"odd count of tiles, D in {{64, 1024, 1152, 1344}}, k in {{1, 8, "
        f"40, 200, 600}}), tests/test_dense.py's corpus-outer shapes, "
        f"b=4160 past the JAX wrapper's 4096 cap; the first body on fp32, "
        f"D=1352, a misaligned corpus and as named: "
        f"max|dscore|={err7:.3e} against the plain version, ids equal to "
        f"K1's but at near ties ({time.perf_counter() - t0:.1f}s) ({card})")

    # 9b. The five runnable eval configs at full size, each with every
    # launch count reset just before and read just after; the hybrid step's
    # K2' calls, the K1 calls of hybrid, graph and ivf_latency and
    # ivf_latency's K6 calls are recorded.
    from tpurag_torch.kernels import ivf_scan as ivf_scan_mod

    eval_kernels = ivf_kernels + (bm25_topk_fused, dense_topk_co)
    eval_calls = {"fused": [], "hybrid": [], "graph": [], "ivf_latency": [],
                  "ivf_probe": [], "ivf_scan": []}
    results, eval_launches = {}, {}
    for name in ("exact_dense", "hybrid", "memory_fusion", "graph",
                 "ivf_latency"):
        for kern in count_names(eval_kernels):
            launch_counts[kern] = 0
        with contextlib.ExitStack() as stack:
            if name in ("hybrid", "graph", "ivf_latency"):
                stack.enter_context(recording(bench_mod, "dense_topk",
                                              eval_calls[name]))
            if name == "hybrid":
                stack.enter_context(recording(bench_mod, "bm25_topk_fused",
                                              eval_calls["fused"]))
            if name == "ivf_latency":
                stack.enter_context(recording(ivf_scan_mod, "ivf_probe_topk",
                                              eval_calls["ivf_probe"]))
                stack.enter_context(recording(bench_mod, "ivf_scan",
                                              eval_calls["ivf_scan"]))
            t0 = time.perf_counter()
            results[name] = bench_mod.run_all([name], device="cuda")[0]
        eval_launches[name] = {kern: launch_counts[kern]
                               for kern in count_names(eval_kernels)
                               if launch_counts[kern]}
        log(f"[eval] {json.dumps(results[name])} launches "
            f"{eval_launches[name]} ({time.perf_counter() - t0:.1f}s) "
            f"({card})")
        gc.collect()
        torch.cuda.empty_cache()
    assert results["exact_dense"]["value"] == 1.0, results["exact_dense"]
    assert results["ivf_latency"]["recall_at_10"] >= 0.95, results[
        "ivf_latency"]
    for name, kern in (("hybrid", "bm25_topk_fused"),
                       ("hybrid", "dense_topk_sm90"),
                       ("graph", "dense_topk_sm90"),
                       ("ivf_latency", "dense_topk_sm90"),
                       ("ivf_latency", "ivf_probe_topk")):
        assert eval_launches[name].get(kern, 0) > 0, (
            f"{kern} was not launched in the eval config {name}")
    assert eval_launches["ivf_latency"].get("ivf_probe_topk_sm90") == (
        eval_launches["ivf_latency"]["ivf_probe_topk"]), (
        "an ivf_latency K6 launch missed the row-split body")
    co_launches = sum(n.get("dense_topk_co", 0)
                      for n in eval_launches.values())

    # 9c. One hybrid step's K2' call replayed against its plain version,
    # beside K2''s first body (the full network over every lane); then
    # both on rows whose every lane is live.
    k2f_first = k2_tool.first_fused(runtime.BUILD_DIR / "k2_first")
    k2f = replay_fused(eval_calls["fused"][:1], k2f_first)
    log(f"[K2'] one hybrid step's launch ({', '.join(k2f['shapes'])}) "
        f"bit-identical to the plain version (max|dscore|={k2f['err']:.3e}), "
        f"and the first body too: kernel {k2f['chain_ms']:.4f} ms in chains "
        f"of 10 ({k2f['ms']:.4f} single), first body "
        f"{k2f['first_chain_ms']:.4f} ({k2f['first_ms']:.4f}) ms, plain "
        f"{k2f['plain_ms']:.3f} ms, bound {k2f['bound'][0]:.4f} ms "
        f"({k2f['bound'][1]}, live postings; every lane's posting: "
        f"{k2f['all_lanes_ms']:.4f} ms) ({card})")
    for cbits in (packed_cbits(N_DOCS), 0):
        log(f"[K2'] every lane live (t=8 x p_max=2048, cbits={cbits}), "
            f"chains of 10: " + "; ".join(
                f"b={b} kernel {ms:.4f} ms, first body {first_ms:.4f} ms"
                for b, ms, first_ms in fused_full_times(k2f_first, cbits))
            + f" ({card})")

    # 9c'. ivf_latency's K6 scan (bf16, the tuned nprobe) replayed against
    # its plain version; its K1 calls follow in 9e.
    k6l = replay_ivf(eval_calls["ivf_probe"][-1:], k6_first)
    err6 = max(err6, k6l["err"])
    # One timed IVF step (ivf_scan: probe choice, K6, the id map) under the
    # profiler: exactly one K6 kernel on the device.
    (args, kw), = eval_calls["ivf_scan"][-1:]
    k6l_prof = device_profile(lambda: ivf_scan(*args, **kw))
    k6_ops = k6l_prof["port_ops"].get("K6", 0)
    log(f"[K6] one ivf_latency IVF step (ivf_scan) profiled: device busy "
        f"{k6l_prof['busy_ms']:.4f} ms in {k6l_prof['ops']} device "
        f"operations, {k6_ops} K6 kernel(s) "
        f"({k6l_prof['port'].get('K6', 0.0):.4f} ms); busiest: "
        + "; ".join(f"{n} {ms:.4f} ms" for n, ms in k6l_prof["top"][:5])
        + f" ({card})")
    assert k6_ops == 1, f"an ivf_latency step ran {k6_ops} K6 kernels"
    log(f"[K6] ivf_latency's timed scan ({', '.join(k6l['shapes'])}) against "
        f"the plain version: max|dscore|={k6l['err']:.3e}; kernel "
        f"{k6l['ms']:.4f} ms ({k6l['chain_ms']:.4f} in chains of 10; the "
        f"wrapper's host time {k6l['host_ms']:.4f} ms a call), first design "
        f"{k6l['first_ms']:.4f} ({k6l['first_chain_ms']:.4f}) ms, plain "
        f"{k6l['plain_ms']:.3f} ms, bound {k6l['bound'][0]:.4f} ms "
        f"({k6l['bound'][1]}; distinct rows {k6l['distinct']:.4f} of those "
        f"probed) ({card})")

    # 9d. hybrid_step at the JAX package driver's example shapes, on the
    # card and on the CPU.
    launch_counts["bm25_topk_fused"] = launch_counts["dense_topk"] = 0
    got = bench_mod.hybrid_step(**bench_mod.example_inputs(device="cuda"))
    want = bench_mod.hybrid_step(**bench_mod.example_inputs(device="cpu"))
    assert launch_counts["bm25_topk_fused"] == 1
    assert launch_counts["dense_topk"] == 1
    assert torch.equal(got[1].cpu(), want[1]), "hybrid_step ids differ"
    assert torch.allclose(got[0].cpu(), want[0], rtol=1e-6, atol=0)
    assert (want[1][:, 0] >= 0).all()
    log(f"[eval] hybrid_step at the driver's example shapes (n 2048, d 256, "
        f"b 8, T 4, p_max 64): fused top-8 on the card equal to the CPU's "
        f"({card})")

    # 9e. K1 and K7, held to the plain version and timed beside
    # torch.topk, on the main paths' dense inputs: ivf_latency's first call
    # (the oracle's 4k overfetch) and its last (a timed exact step).
    ivf_dense = eval_calls["ivf_latency"]
    k7 = {"512x1M (phase 7)": k1,
          "hybrid": replay_dense(eval_calls["hybrid"][:1]),
          "graph": replay_dense(eval_calls["graph"][:1]),
          "ivf_latency": replay_dense([ivf_dense[0], ivf_dense[-1]])}
    del eval_calls, ivf_dense
    for name, r in k7.items():
        err1 = max(err1, r["err"], r["first_err"])
        err7 = max(err7, r["co_err"])
        log(f"[K7] {name} ({', '.join(r['shapes'])}): max|dscore|="
            f"{r['co_err']:.3e} (K1 {r['err']:.3e}, K1's first body "
            f"{r['first_err']:.3e}) against the plain version; K7's Hopper "
            f"body {r['co_ms']:.3f} ms, K7's first body "
            f"{r['co_first_ms']:.3f} ms, K1 {r['ms']:.3f} ms, K1's first body "
            f"{r['first_ms']:.3f} ms, torch.topk(q @ emb.T) "
            f"{r['lib_ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, bound "
            f"{r['bound'][0]:.4f} ms ({r['bound'][1]}) ({card})")
    gc.collect()
    torch.cuda.empty_cache()

    # 9f. Where eval `hybrid`'s step time goes: the device's share of the
    # chain, and whether the host's enqueue rate sets it.
    hp = hybrid_chain_profile(bench_mod)
    # K2''s row takes its device time from this profile: one kernel a step.
    assert hp["port_ops"].get("K2'") == 1, (
        f"the hybrid chain's profile shows {hp['port_ops']} port kernels a "
        "step")
    graph_txt = ("not measured" if hp["graph_ms"] is None
                 else f"{hp['graph_ms']:.3f} ms")
    log(f"[eval] hybrid chain per step (512 x 100k): device span "
        f"{hp['span_ms']:.3f} ms (CUDA events), host enqueue "
        f"{hp['enqueue_ms']:.3f} ms, device busy {hp['busy_ms']:.3f} ms in "
        f"{hp['ops']:.1f} device operations (idle share "
        f"{1 - hp['busy_ms'] / hp['span_ms']:.3f}); by port kernel "
        + ", ".join(f"{n} {ms:.3f}" for n, ms in hp["port"].items())
        + f" ms; the chain as a CUDA graph {graph_txt} per step ({card})")
    gc.collect()
    torch.cuda.empty_cache()

    log(f"[total] {time.perf_counter() - t_start:.1f}s ({card})")
    log(json.dumps({"kernels": [
        {"name": "dense_topk", "route": "cuda",
         "source": "tpurag_torch/csrc/dense_topk_sm90.cu",
         "replaces": "tpurag/kernels/dense.py:319",
         "launches": launches["dense_topk"], "max_abs_err": err1,
         "ms": k1["ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": k1["bound"][0], "bound_by": k1["bound"][1],
         "library_ms": k1["lib_ms"]},
        {"name": "merge_segsum_topk", "route": "cuda",
         "source": "tpurag_torch/csrc/bm25_topk.cu",
         "replaces": "tpurag/kernels/bm25_pallas.py:179",
         "launches": launches["merge_segsum_topk"], "max_abs_err": err2,
         "ms": k2["ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": k2["bound"][0], "bound_by": k2["bound"][1],
         "library_ms": None},
        {"name": "merge_segsum_full", "route": "cuda",
         "source": "tpurag_torch/csrc/bm25_full.cu",
         "replaces": "tpurag/kernels/bm25_pallas.py:255",
         "launches": launches["merge_segsum_full"], "max_abs_err": 0.0,
         "ms": k3["ms"], "plain_ms": k3["plain_ms"],
         "bound_ms": k3["bound"][0], "bound_by": k3["bound"][1],
         "library_ms": None},
        {"name": "combine_topk", "route": "cuda",
         "source": "tpurag_torch/csrc/bm25_combine.cu",
         "replaces": "tpurag/kernels/bm25_join.py:182",
         "launches": launches["combine_topk"], "max_abs_err": 0.0,
         "ms": k4["ms"], "plain_ms": k4["plain_ms"],
         "bound_ms": k4["bound"][0], "bound_by": k4["bound"][1],
         "library_ms": None},
        {"name": "dense_scan_q8", "route": "cuda",
         "source": "tpurag_torch/csrc/dense_topk_q8_sm90.cu",
         "replaces": "tpurag/kernels/quant.py:80",
         "launches": ivf_launches["dense_scan_q8"], "max_abs_err": 0.0,
         "ms": k5["ms"], "plain_ms": k5["plain_ms"],
         "bound_ms": k5["bound"][0], "bound_by": k5["bound"][1],
         "library_ms": k5["lib_ms"]},
        {"name": "ivf_probe_topk", "route": "cuda",
         "source": "tpurag_torch/csrc/ivf_probe.cu",
         "replaces": "tpurag/kernels/ivf_scan.py:236",
         "launches": ivf_launches["ivf_probe_topk"], "max_abs_err": err6,
         "ms": k6["chain_ms"], "plain_ms": k6["plain_ms"],
         "bound_ms": k6["bound"][0], "bound_by": k6["bound"][1],
         "library_ms": None},
        {"name": "gather_scores", "route": "cuda",
         "source": "tpurag_torch/csrc/gather_scores.cu",
         "replaces": "tpurag/kernels/quant.py:213",
         "launches": ivf_launches["gather_scores"], "max_abs_err": err8,
         "ms": k8["chain_ms"], "plain_ms": k8["plain_ms"],
         "bound_ms": k8["bound"][0], "bound_by": k8["bound"][1],
         "library_ms": None},
        {"name": "rescore_topk", "route": "cuda",
         "source": "tpurag_torch/csrc/gather_scores.cu",
         "replaces": "tpurag/kernels/quant.py:250",
         "launches": ivf_launches["rescore_topk"], "max_abs_err": err8r,
         "ms": k8r["now"]["busy_ms"], "plain_ms": k8r["plain_ms"],
         "bound_ms": k8r["bound"][0], "bound_by": k8r["bound"][1],
         "library_ms": None},
        {"name": "bm25_topk_fused", "route": "cuda",
         "source": "tpurag_torch/csrc/bm25_merge.cu",
         "replaces": "tpurag/kernels/bm25_pallas.py:402",
         "launches": eval_launches["hybrid"]["bm25_topk_fused"],
         "max_abs_err": k2f["err"],
         "ms": hp["port"]["K2'"],
         "plain_ms": k2f["plain_ms"],
         "bound_ms": k2f["bound"][0], "bound_by": k2f["bound"][1],
         "library_ms": None},
        {"name": "dense_topk_co", "route": "cuda",
         "source": "tpurag_torch/csrc/dense_topk_co_sm90.cu",
         "replaces": "tpurag/kernels/dense.py:236",
         "launches": co_launches, "max_abs_err": err7,
         "ms": k1["co_ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": k1["bound"][0], "bound_by": k1["bound"][1],
         "library_ms": k1["lib_ms"]},
        {"name": "fuse_legs", "route": "cuda",
         "source": "tpurag_torch/csrc/fuse_rrf.cu",
         "replaces": "tpurag/engine/hybrid.py:64",
         "launches": launches["fuse_legs"], "max_abs_err": 0.0,
         "ms": kf["ms"], "plain_ms": kf["plain_ms"],
         "bound_ms": kf["bound"][0], "bound_by": kf["bound"][1],
         "library_ms": None},
    ]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
