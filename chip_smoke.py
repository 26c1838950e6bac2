#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (tpurag_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (each raises on failure; nothing catches, so any fault exits
non-zero before the result line):
  1. device: needs CUDA; prints the card's name and power limit;
  2. build: compiles tpurag_torch/csrc with nvcc (sm_90a);
  3. K1 dense_topk against dense_topk_ref on the card at the main-path
     shape (1024 queries x 100k of 131072 rows x 1024 bf16, k=8) and at
     k=200 on a smaller corpus; torch.topk(q @ emb.T) timed beside it;
  4. K2 merge_segsum_topk against merge_segsum_topk_ref for every width
     class p in {64, 256, 1024, 2048} x t in {1, 2, 8}, packed and not;
     K3 merge_segsum_full against merge_segsum_full_ref at every narrow
     class (p in {64, 256, 1024, 2048} x t in {2, 8}) and the 1M point's
     wide shapes (p in {4096 .. 32768} x t in {2, 4}, up to W = 131072),
     both layouts where packing applies; K4 combine_topk against
     combine_narrow_wide at narrow W in {2048, 16384} x wide W in {4096,
     32768, 131072} x k in {8, 40};
  5. the 100k slice: KnowledgeBase(dim=1024, device="cuda") ingests 100k
     chunks (bench.py's Zipf postings plan: df = clip(2048 (1+r)^-0.5,
     16, 2048) over a 50k vocabulary, ~1.05M postings), answers 4
     search_batch(mode="hybrid") requests of 1024 queries and 3 single
     searches, with the kernels' launch counters reset just before;
     then a save, a reload on the CPU, and 64 queries compared there;
  6. timings (CUDA events, median of >= 10) of each kernel and its plain
     version, search_batch p50 at b=1024, ingest seconds;
  7. the 1M wide-term slice (bench.py's TPURAG_BENCH_N=1000000 plan:
     vocab 158110, df up to 20480, ~16.2M postings, 1M x 1024 bf16):
     ingest through add_chunks, 4 search_batch(hybrid) requests of 512
     queries (about half hold a wide term) with every counter reset just
     before, one profiled request, 64 hard queries' keyword top-8 against
     a CPU index of the same postings; K1 (within TOL at near ties), K2,
     K3 and K4 (bit for bit) held to their plain versions and timed on
     the very inputs one request gave them.

The second-to-last stdout line is the kernel table as JSON, one row per
kernel: launches over the 1M phase's 4 requests, and times, plain times,
bounds and library times summed over one 1M request's launches; the last is
{"ok": true, "device": {...}}. Without a CUDA device, or run outside the
repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

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
# Published H100 SXM peaks (NVIDIA data sheet) for the kernels' bounds.
HBM_BYTES_S = 3.35e12
BF16_FLOPS_S = 989e12
FP32_OPS_S = 67e12  # outside the tensor cores; one compare counts as one


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Median milliseconds of fn() over `iters` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
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


def check_dense(b: int, n_rows: int, n_valid: int, d: int, k: int,
                dtype=torch.bfloat16, seed: int = 0, timed: bool = False):
    """K1 against its plain version on the card. Returns (max_abs_err,
    kernel ms, plain ms) (times None unless timed)."""
    from tpurag_torch.kernels.dense import dense_topk, dense_topk_ref

    rng = np.random.default_rng(seed)
    emb = torch.zeros((n_rows, d), dtype=dtype, device="cuda")
    emb[:n_valid] = torch.from_numpy(unit_rows(rng, n_valid, d)).cuda().to(dtype)
    q = torch.from_numpy(unit_rows(rng, b, d)).cuda()
    v_k, i_k = dense_topk(q, emb, n_valid, k)
    v_r, i_r = dense_topk_ref(q, emb, n_valid, k + 1)
    torch.cuda.synchronize()
    assert v_k.shape == (b, k) and i_k.dtype == torch.int32
    assert torch.isfinite(v_k).all()
    err = topk_agree(v_k, i_k, v_r, i_r)
    if not timed:
        return err, None, None
    return (err, cuda_ms(lambda: dense_topk(q, emb, n_valid, k)),
            cuda_ms(lambda: dense_topk_ref(q, emb, n_valid, k)))


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
                n_docs: int = N_DOCS, seed: int = 0, timed: bool = False):
    """K2 against its plain version on the card: the same network and
    the same sums, so ids and scores must be bit-identical. Returns
    (max_abs_err, kernel ms, plain ms)."""
    from tpurag_torch.kernels.bm25_merge import (merge_segsum_topk,
                                                 merge_segsum_topk_ref)

    doc, con = (torch.from_numpy(x).cuda() for x in
                merge_rows(np.random.default_rng(seed), b, t, p, n_docs))
    pp = p if t > 1 else t * p
    v_k, i_k = merge_segsum_topk(doc, con, k, pp, t, cbits)
    v_r, i_r = merge_segsum_topk_ref(doc, con, k, pp, t, cbits)
    torch.cuda.synchronize()
    assert torch.equal(i_k, i_r), f"ids differ at t={t} p={p} cbits={cbits}"
    assert torch.equal(v_k, v_r), f"scores differ at t={t} p={p} cbits={cbits}"
    assert (i_k[:, 0] >= 0).any(), "no hits at all: the case is vacuous"
    err = (v_k - v_r).abs().max().item()
    if not timed:
        return err, None, None
    return (err, cuda_ms(lambda: merge_segsum_topk(doc, con, k, pp, t, cbits)),
            cuda_ms(lambda: merge_segsum_topk_ref(doc, con, k, pp, t, cbits)))


def check_full(b: int, t: int, p: int, cbits: int, n_docs: int = N_DOCS,
               seed: int = 0, timed: bool = False):
    """K3 against its plain version on the card: same network, same sums,
    so seg and doc_s must be bit-identical. Returns (max_abs_err, kernel
    ms, plain ms)."""
    from tpurag_torch.kernels.bm25_merge import (merge_segsum_full,
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
    return (0.0, cuda_ms(lambda: merge_segsum_full(doc, con, p, t, cbits)),
            cuda_ms(lambda: merge_segsum_full_ref(doc, con, p, t, cbits)))


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
    args = (n_val, n_doc, w_seg, w_doc, k, window)
    return (0.0, cuda_ms(lambda: combine_topk(*args)),
            cuda_ms(lambda: combine_narrow_wide(*args)))


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
    KnowledgeBase(dim=1024, device=device), answer 4 search_batch(hybrid)
    requests of BATCH queries and 3 single searches (each kernel's launch
    count reset just before and read just after), check the answers, then
    save, reload on the CPU and compare 64 queries there."""
    from tpurag_torch import KnowledgeBase
    from tpurag_torch.core.types import Chunk

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
    widest = max(len(p) for p in kb.inverted._postings_doc)
    assert widest <= kb.config.bm25.wide_term_width, widest
    log(f"[kb] ingest {N_DOCS} x {DIM} bf16 + {n_post} postings: "
        f"{ingest_s:.2f}s; widest term df={widest} (narrow route only)")

    batches = []
    for _ in range(5):  # one warm-up (the first search compacts), four timed
        qv, src = query_vectors(rng, emb_rows, BATCH)
        batches.append((zipf_queries(rng, BATCH), qv, src))
    kb.search_batch(batches[0][0], mode="hybrid", vectors=batches[0][1])
    sync()

    for fn in kernels:
        fn.launches = 0
    lat, answers = [], []
    for queries, qv, _ in batches[1:]:
        t0 = time.perf_counter()
        answers.append(kb.search_batch(queries, mode="hybrid", vectors=qv))
        lat.append((time.perf_counter() - t0) * 1e3)
    singles = [kb.search(" ".join(f"w{t}" for t in rng.integers(0, 500, 3)))
               for _ in range(3)]
    launches = {fn.__name__: fn.launches for fn in kernels}
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

    from tpurag_torch.kernels.runtime import BUILD_DIR

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
    return {"launches": launches, "lat_ms": lat, "ingest_s": ingest_s}


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


def merge_stages(w: int, p: int) -> int:
    """Compare-exchange stages of the bitonic merge from block 2p to w."""
    return sum(range((2 * p).bit_length() - 1, w.bit_length()))


def bound_ms(nbytes: float, ops: float, peak_ops: float):
    """(least ms, what bounds it): bytes over the H100's 3.35 TB/s, or
    operations over `peak_ops` per second, whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def replay_dense(calls) -> dict:
    """K1 on the main path's own inputs (one request's launching calls):
    held to dense_topk_ref by topk_agree, with the summed times of the
    kernel, its plain version and torch.topk(q @ emb.T) in bf16."""
    from tpurag_torch.kernels.dense import dense_topk, dense_topk_ref

    err = ms = plain_ms = lib_ms = nbytes = ops = 0.0
    shapes = []
    for (q, emb, n_valid, k), _ in calls:
        v_k, i_k = dense_topk(q, emb, n_valid, k)
        v_r, i_r = dense_topk_ref(q, emb, n_valid, k + 1)
        torch.cuda.synchronize()
        assert torch.isfinite(v_k).all()
        err = max(err, topk_agree(v_k, i_k, v_r, i_r))
        del v_r, i_r
        ms += cuda_ms(lambda: dense_topk(q, emb, n_valid, k))
        plain_ms += cuda_ms(lambda: dense_topk_ref(q, emb, n_valid, k))
        live = emb[:n_valid]
        qb = q.to(emb.dtype)
        lib_ms += cuda_ms(lambda: torch.topk(qb @ live.T, k))
        b, d = q.shape
        nbytes += (b * d * q.element_size() + n_valid * d * emb.element_size()
                   + b * k * 8)
        ops += 2 * b * n_valid * d
        shapes.append(f"{b}x{n_valid}x{d} k={k}")
    return {"err": err, "ms": ms, "plain_ms": plain_ms, "lib_ms": lib_ms,
            "shapes": shapes, "bound": bound_ms(nbytes, ops, BF16_FLOPS_S)}


def replay_merge(calls) -> dict:
    """K2 on the main path's own inputs: bit-identical to its plain
    version, and the summed times."""
    from tpurag_torch.kernels.bm25_merge import (merge_segsum_topk,
                                                 merge_segsum_topk_ref)

    ms = plain_ms = nbytes = ops = 0.0
    shapes = []
    for (doc, con), kw in calls:
        v_k, i_k = merge_segsum_topk(doc, con, **kw)
        v_r, i_r = merge_segsum_topk_ref(doc, con, **kw)
        torch.cuda.synchronize()
        assert torch.equal(i_k, i_r) and torch.equal(v_k, v_r), kw
        ms += cuda_ms(lambda: merge_segsum_topk(doc, con, **kw))
        plain_ms += cuda_ms(lambda: merge_segsum_topk_ref(doc, con, **kw))
        b, w = doc.shape
        nbytes += b * w * 8 + b * kw["k"] * 8
        ops += b * (w // 2) * merge_stages(w, kw["p"])
        shapes.append(f"{b}x{w}")
    return {"ms": ms, "plain_ms": plain_ms, "shapes": shapes,
            "bound": bound_ms(nbytes, ops, FP32_OPS_S)}


def replay_full(calls) -> dict:
    """K3 on the main path's own inputs (one request's launching calls):
    bit-identical to the plain version, and their summed times."""
    from tpurag_torch.kernels.bm25_merge import (merge_segsum_full,
                                                 merge_segsum_full_ref)

    ms = plain_ms = nbytes = ops = 0.0
    shapes = []
    for (doc, con), kw in calls:
        if kw["t"] == 1:
            continue  # launches nothing
        seg_k, doc_k = merge_segsum_full(doc, con, **kw)
        seg_r, doc_r = merge_segsum_full_ref(doc, con, **kw)
        torch.cuda.synchronize()
        assert torch.equal(doc_k, doc_r) and torch.equal(seg_k, seg_r), kw
        ms += cuda_ms(lambda: merge_segsum_full(doc, con, **kw))
        plain_ms += cuda_ms(lambda: merge_segsum_full_ref(doc, con, **kw))
        b, w = doc.shape
        nbytes += b * w * 16  # doc + con in, seg + doc_s out
        ops += b * (w // 2) * merge_stages(w, kw["p"])
        shapes.append(f"{b}x{w}")
    return {"ms": ms, "plain_ms": plain_ms, "shapes": shapes,
            "bound": bound_ms(nbytes, ops, FP32_OPS_S)}


def replay_combine(calls) -> dict:
    """K4 on the main path's own inputs: bit-identical to
    combine_narrow_wide, and the summed times."""
    from tpurag_torch.kernels.bm25_join import (combine_narrow_wide,
                                                combine_topk)
    from tpurag_torch.kernels.runtime import NEG_INF

    ms = plain_ms = nbytes = ops = 0.0
    shapes = []
    for args, kw in calls:
        v_k, i_k = combine_topk(*args, **kw)
        v_r, i_r = combine_narrow_wide(*args, **kw)
        torch.cuda.synchronize()
        assert torch.equal(i_k, i_r) and torch.equal(v_k, v_r), kw
        ms += cuda_ms(lambda: combine_topk(*args, **kw))
        plain_ms += cuda_ms(lambda: combine_narrow_wide(*args, **kw))
        n_val, _, w_seg, _ = args
        g, wn = n_val.shape
        ww = w_seg.shape[1]
        nbytes += g * (wn + ww) * 8 + g * kw["k"] * 8
        # One compare per binary-search step of each valid lane.
        ops += ((w_seg > NEG_INF / 2).sum().item() * (wn + 1).bit_length()
                + (n_val > NEG_INF / 2).sum().item() * (ww + 1).bit_length())
        shapes.append(f"{g}x({wn}+{ww})")
    return {"ms": ms, "plain_ms": plain_ms, "shapes": shapes,
            "bound": bound_ms(nbytes, ops, FP32_OPS_S)}


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
    from tpurag_torch.index import dense as dense_mod
    from tpurag_torch.index import inverted as inverted_mod
    from tpurag_torch.index.inverted import InvertedIndex
    from tpurag_torch.kernels.runtime import BUILD_DIR

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
    calls = {n: [] for n in ("dense_topk", "merge_segsum_topk",
                             "merge_segsum_full", "combine_topk")}
    t0 = time.perf_counter()
    with recording(dense_mod, "dense_topk", calls["dense_topk"]), \
            recording(inverted_mod, "merge_segsum_topk",
                      calls["merge_segsum_topk"]), \
            recording(inverted_mod, "merge_segsum_full",
                      calls["merge_segsum_full"]), \
            recording(inverted_mod, "combine_topk", calls["combine_topk"]):
        kb.search_batch(batches[0][0], mode="hybrid", vectors=batches[0][1])
    sync()
    log(f"[wide] warm-up request (compaction included): "
        f"{time.perf_counter() - t0:.2f}s")

    for fn in kernels:
        fn.launches = 0
    lat, answers = [], []
    for queries, qv, _ in batches[1:]:
        t0 = time.perf_counter()
        answers.append(kb.search_batch(queries, mode="hybrid", vectors=qv))
        lat.append((time.perf_counter() - t0) * 1e3)
    launches = {fn.__name__: fn.launches for fn in kernels}
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


# Each port kernel's device functions (K3's rows up to one block's shared
# memory run K2's body with FULL = true: merge_segsum_kernel<PACKED, FULL>).
PORT_KERNELS = {"dense_scan_kernel": "K1", "dense_merge_kernel": "K1",
                "row_max_kernel": "K3", "tile_merge_kernel": "K3",
                "global_stage_kernel": "K3", "full_segsum_kernel": "K3",
                "combine_topk_kernel": "K4"}


def port_kernel(name: str):
    """The port kernel (K1..K4) a device function belongs to, or None."""
    m = re.match(r"merge_segsum_kernel<\s*(?:\(bool\))?\w+,\s*"
                 r"(?:\(bool\))?(\w+)\s*>", name)
    if m:
        return "K3" if m.group(1) in ("true", "1") else "K2"
    return PORT_KERNELS.get(name.split("<")[0])


def device_profile(fn) -> dict:
    """One call of fn under torch.profiler: wall ms (ending in a
    synchronize), device-busy ms (the sum of the card's kernel and copy
    times), the busiest device functions (template arguments kept) and
    each port kernel's device ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            # A kernel's own name and template arguments, without its
            # namespace, return type and parameter list.
            m = re.search(r"(\w+_kernel(?:<[^<>()]*(?:\(bool\)[^<>()]*)*>)?)",
                          e.name)
            name = m.group(1).lstrip("_") if m else e.name[:48]
            by_name[name] = (by_name.get(name, 0.0)
                             + e.time_range.elapsed_us() / 1e3)
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    port: dict[str, float] = {}
    for name, ms in by_name.items():
        if (kern := port_kernel(name)) is not None:
            port[kern] = port.get(kern, 0.0) + ms
    return {"wall_ms": wall_ms, "busy_ms": busy, "top": top,
            "port": dict(sorted(port.items()))}


def dense_library_ms(b: int, n_valid: int, d: int, k: int) -> float:
    """One PyTorch call computing K1's function: topk of the bf16 product."""
    rng = np.random.default_rng(0)
    emb = torch.from_numpy(unit_rows(rng, n_valid, d)).cuda().bfloat16()
    q = torch.from_numpy(unit_rows(rng, b, d)).cuda().bfloat16()
    return cuda_ms(lambda: torch.topk(q @ emb.T, k))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    from tpurag_torch.kernels import runtime
    from tpurag_torch.kernels.bm25_join import combine_topk
    from tpurag_torch.kernels.bm25_merge import (merge_segsum_full,
                                                 merge_segsum_topk)
    from tpurag_torch.kernels.dense import dense_topk
    from tpurag_torch.kernels.runtime import load_kernels

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
    for line in runtime.build_info["log"].splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")

    # -- 3. K1 against its plain version --------------------------------------
    err1, k1_ms, k1_plain_ms = check_dense(BATCH, 131_072, N_DOCS, DIM, 8,
                                           timed=True)
    k1_lib_ms = dense_library_ms(BATCH, N_DOCS, DIM, 8)
    log(f"[K1] b={BATCH} n_valid={N_DOCS}/131072 d={DIM} bf16 k=8: "
        f"max|dscore|={err1:.3e} kernel {k1_ms:.3f} ms, plain "
        f"{k1_plain_ms:.3f} ms, torch.topk(q @ emb.T) {k1_lib_ms:.3f} ms "
        f"({card})")
    err200, _, _ = check_dense(256, 20_480, 20_000, DIM, 200, seed=1)
    errf32, _, _ = check_dense(64, 4096, 4000, 256, 40, torch.float32, seed=2)
    log(f"[K1] k=200 (b=256, n=20000): max|dscore|={err200:.3e}; "
        f"fp32 k=40: max|dscore|={errf32:.3e}")
    err1 = max(err1, err200, errf32)

    # -- 4. K2 against its plain version --------------------------------------
    err2 = 0.0
    for p in (64, 256, 1024, 2048):
        for t in (1, 2, 8):
            for cbits in (14, 0):
                e, _, _ = check_merge(256, t, p, cbits, seed=p * 10 + t)
                err2 = max(err2, e)
    log(f"[K2] 24 classes (p x t x packed/unpacked) bit-identical to the "
        f"plain version")
    e, k2_ms, k2_plain_ms = check_merge(BATCH, 8, 2048, 14, timed=True)
    e0, k2u_ms, k2u_plain_ms = check_merge(BATCH, 8, 2048, 0, timed=True)
    err2 = max(err2, e, e0)
    log(f"[K2] b={BATCH} t=8 p=2048 (W=16384) packed cbits=14: kernel "
        f"{k2_ms:.3f} ms, plain {k2_plain_ms:.3f} ms; unpacked: kernel "
        f"{k2u_ms:.3f} ms, plain {k2u_plain_ms:.3f} ms ({card})")

    # -- 4b. K3 against its plain version ---------------------------------------
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
    log(f"[K3] {n_full} shapes (W = 128 .. 131072, packed where it applies) "
        f"bit-identical to the plain version; b=16 t=4 p=32768 (W=131072): "
        f"kernel {k3w_ms:.3f} ms, plain {k3w_plain_ms:.3f} ms ({card})")

    # -- 4c. K4 against its plain version ---------------------------------------
    for wn in (2048, 16384):
        for ww in (4096, 32768, 131072):
            for k in (8, 40):
                check_combine(32, wn, ww, k, n_docs=N_WIDE, seed=wn + ww + k)
    _, k4w_ms, k4w_plain_ms = check_combine(64, 16384, 131072, 8,
                                            n_docs=N_WIDE, timed=True)
    log(f"[K4] narrow W in {{2048, 16384}} x wide W in {{4096, 32768, "
        f"131072}} x k in {{8, 40}} bit-identical to combine_narrow_wide; "
        f"g=64 16384+131072 lanes k=8: kernel {k4w_ms:.3f} ms, plain "
        f"{k4w_plain_ms:.3f} ms ({card})")

    # -- 5. the 100k slice ------------------------------------------------------
    run = drive_slice("cuda", (dense_topk, merge_segsum_topk))
    for name, n in run["launches"].items():
        assert n > 0, f"{name} was not launched on the main path"

    # -- 6. times -----------------------------------------------------------------
    p50 = statistics.median(run["lat_ms"])
    log(f"[perf] search_batch b={BATCH} hybrid p50 {p50:.2f} ms (requests: "
        f"{', '.join(f'{x:.2f}' for x in run['lat_ms'])} ms); ingest "
        f"{run['ingest_s']:.2f}s ({card})")

    # -- 7. the 1M wide-term slice ------------------------------------------------
    kernels = (dense_topk, merge_segsum_topk, merge_segsum_full, combine_topk)
    wide = drive_wide("cuda", kernels)
    launches = wide["launches"]
    for name, n in launches.items():
        assert n > 0, f"{name} was not launched on the wide path"
    calls = wide["calls"]
    k1 = replay_dense(calls["dense_topk"])
    k2 = replay_merge(calls["merge_segsum_topk"])
    k3 = replay_full(calls["merge_segsum_full"])
    k4 = replay_combine(calls["combine_topk"])
    del calls, wide["calls"]
    err1 = max(err1, k1["err"])
    wide_p50 = statistics.median(wide["lat_ms"])
    log(f"[K1] one request's {len(k1['shapes'])} launch on the 1M path "
        f"({', '.join(k1['shapes'])}) against dense_topk_ref: max|dscore|="
        f"{k1['err']:.3e}; kernel {k1['ms']:.3f} ms, plain "
        f"{k1['plain_ms']:.3f} ms, torch.topk(q @ emb.T) {k1['lib_ms']:.3f} "
        f"ms, bound {k1['bound'][0]:.4f} ms ({k1['bound'][1]}) ({card})")
    log(f"[K2] one request's {len(k2['shapes'])} launches on the 1M path "
        f"({', '.join(k2['shapes'])}) bit-identical to the plain version: "
        f"kernel {k2['ms']:.3f} ms, plain {k2['plain_ms']:.3f} ms, bound "
        f"{k2['bound'][0]:.4f} ms ({k2['bound'][1]}) ({card})")
    log(f"[K3] one request's {len(k3['shapes'])} launches on the 1M path "
        f"({', '.join(k3['shapes'])}) bit-identical to the plain version: "
        f"kernel {k3['ms']:.3f} ms, plain {k3['plain_ms']:.3f} ms, bound "
        f"{k3['bound'][0]:.4f} ms ({k3['bound'][1]}) ({card})")
    log(f"[K4] one request's {len(k4['shapes'])} launches on the 1M path "
        f"({', '.join(k4['shapes'])}) bit-identical to combine_narrow_wide: "
        f"kernel {k4['ms']:.3f} ms, plain {k4['plain_ms']:.3f} ms, bound "
        f"{k4['bound'][0]:.4f} ms ({k4['bound'][1]}) ({card})")
    prof = wide["profile"]
    if prof["busy_ms"] > 0:
        log(f"[perf] 1M: one profiled request: wall {prof['wall_ms']:.2f} ms, "
            f"device busy {prof['busy_ms']:.3f} ms, idle share "
            f"{1 - prof['busy_ms'] / prof['wall_ms']:.3f}; busiest: "
            + "; ".join(f"{n} {ms:.3f} ms" for n, ms in prof["top"]))
        log("[perf] 1M: device ms by port kernel in the profiled request: "
            + ", ".join(f"{n} {ms:.3f}" for n, ms in prof["port"].items()))
    else:
        log("[perf] 1M: device busy time not measured (the profiler "
            "recorded no device events)")
    log(f"[perf] 1M: search_batch b={BATCH_WIDE} hybrid p50 {wide_p50:.2f} ms "
        f"(requests: {', '.join(f'{x:.2f}' for x in wide['lat_ms'])} ms); "
        f"launches per request "
        f"{ {n: c / 4 for n, c in launches.items()} }; ingest "
        f"{wide['ingest_s']:.2f}s ({card})")

    log(f"[total] {time.perf_counter() - t_start:.1f}s")
    log(json.dumps({"kernels": [
        {"name": "dense_topk", "route": "cuda",
         "source": "tpurag_torch/csrc/dense_topk.cu",
         "replaces": "tpurag/kernels/dense.py:319",
         "launches": launches["dense_topk"], "max_abs_err": err1,
         "ms": k1["ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": k1["bound"][0], "bound_by": k1["bound"][1],
         "library_ms": k1["lib_ms"]},
        {"name": "merge_segsum_topk", "route": "cuda",
         "source": "tpurag_torch/csrc/bm25_merge.cu",
         "replaces": "tpurag/kernels/bm25_pallas.py:179",
         "launches": launches["merge_segsum_topk"], "max_abs_err": err2,
         "ms": k2["ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": k2["bound"][0], "bound_by": k2["bound"][1],
         "library_ms": None},
        {"name": "merge_segsum_full", "route": "cuda",
         "source": "tpurag_torch/csrc/bm25_merge.cu",
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
    ]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
