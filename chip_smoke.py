#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (tpurag_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (each raises on failure; nothing catches, so any fault exits
non-zero before the result line):
  1. device: needs CUDA; prints the card's name and power limit;
  2. build: compiles tpurag_torch/csrc with nvcc (sm_90a);
  3. K1 dense_topk against dense_topk_ref on the card at the main-path
     shape (1024 queries x 100k of 131072 rows x 1024 bf16, k=8) and at
     k=200 on a smaller corpus;
  4. K2 merge_segsum_topk against merge_segsum_topk_ref for every width
     class p in {64, 256, 1024, 2048} x t in {1, 2, 8}, packed and not;
  5. the slice: KnowledgeBase(dim=1024, device="cuda") ingests 100k
     chunks (bench.py's Zipf postings plan: df = clip(2048 (1+r)^-0.5,
     16, 2048) over a 50k vocabulary, ~1.05M postings), answers 4
     search_batch(mode="hybrid") requests of 1024 queries and 3 single
     searches, with the kernels' launch counters reset just before;
     then a save, a reload on the CPU, and 64 queries compared there;
  6. timings (CUDA events, median of >= 10) of each kernel and its plain
     version, search_batch p50 at b=1024, ingest seconds.

The second-to-last stdout line is the kernel table as JSON; the last is
{"ok": true, "device": {...}}. Without a CUDA device, or run outside the
repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
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


def merge_rows(rng, b: int, t: int, p: int, n_docs: int):
    """(B, t*p) host arrays in the fused merge's input contract: t slots
    of p lanes, each slot doc-ascending (unique docs, random fill, pads at
    2^30 with contribution 0), odd slots flipped."""
    step = max(2 * n_docs // p, 2)
    doc = np.cumsum(rng.integers(1, step, (b, t, p)), axis=2) - 1
    fill = rng.integers(0, p + 1, (b, t, 1))
    pad = (np.arange(p)[None, None, :] >= fill) | (doc >= n_docs)
    doc = np.where(pad, 2**30, doc).astype(np.int32)
    con = np.where(pad, 0.0, rng.uniform(0.05, 4.0, (b, t, p))).astype(
        np.float32)
    if t > 1:
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


def zipf_corpus(rng):
    """bench.py's postings plan as texts: term r ('w<r>') lands in
    df[r] distinct random docs. Returns (texts, n_postings)."""
    df = np.clip(DF_MAX * (1 + np.arange(VOCAB)) ** -0.5, 16,
                 DF_MAX).astype(np.int64)
    docs = np.concatenate([rng.choice(N_DOCS, int(m), replace=False)
                           for m in df])
    terms = np.repeat(np.arange(VOCAB), df)
    order = np.argsort(docs, kind="stable")
    docs, terms = docs[order], terms[order]
    bounds = np.searchsorted(docs, np.arange(N_DOCS + 1))
    words = np.char.add("w", terms.astype(str)).tolist()
    texts = [" ".join(words[bounds[i]:bounds[i + 1]]) for i in range(N_DOCS)]
    return texts, len(docs)


def zipf_queries(rng, n: int) -> list[str]:
    """bench.py's query plan: 8 terms each, P(r) ~ (1 + r)^-0.7."""
    w = (1 + np.arange(VOCAB)) ** -0.7
    tid = rng.choice(VOCAB, size=(n, QUERY_TERMS), p=w / w.sum())
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    from tpurag_torch.kernels import runtime
    from tpurag_torch.kernels.bm25_merge import merge_segsum_topk
    from tpurag_torch.kernels.dense import dense_topk
    from tpurag_torch.kernels.runtime import load_kernels

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
    log(f"[K1] b={BATCH} n_valid={N_DOCS}/131072 d={DIM} bf16 k=8: "
        f"max|dscore|={err1:.3e} kernel {k1_ms:.3f} ms, plain "
        f"{k1_plain_ms:.3f} ms ({card})")
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

    # -- 5. the slice ---------------------------------------------------------
    kernels = (dense_topk, merge_segsum_topk)
    run = drive_slice("cuda", kernels)
    launches = run["launches"]
    for name, n in launches.items():
        assert n > 0, f"{name} was not launched on the main path"

    # -- 6. times ---------------------------------------------------------------
    p50 = statistics.median(run["lat_ms"])
    log(f"[perf] search_batch b={BATCH} hybrid p50 {p50:.2f} ms (requests: "
        f"{', '.join(f'{x:.2f}' for x in run['lat_ms'])} ms); ingest "
        f"{run['ingest_s']:.2f}s ({card})")
    log(json.dumps({"kernels": [
        {"name": "dense_topk", "route": "cuda",
         "source": "tpurag_torch/csrc/dense_topk.cu",
         "replaces": "tpurag/kernels/dense.py:319",
         "launches": launches["dense_topk"], "max_abs_err": err1,
         "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "merge_segsum_topk", "route": "cuda",
         "source": "tpurag_torch/csrc/bm25_merge.cu",
         "replaces": "tpurag/kernels/bm25_pallas.py:179",
         "launches": launches["merge_segsum_topk"], "max_abs_err": err2,
         "ms": k2_ms, "plain_ms": k2_plain_ms},
    ]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
