# Ported from tpurag/eval/bench.py (configs 1-4 and 7, run_all, CONFIGS;
# configs 5, 6 and 8 raise until their modules are ported).
"""Performance benchmark suite driven by BASELINE.json's configs.

Each config returns a {"metric", "value", "unit", ...} dict with the
JAX package's keys, drawn from ``numpy.random.default_rng(seed)`` in the
JAX package's order. ``device="cuda"`` (the default) runs the JAX
package's accelerator sizes on the card; ``device="cpu"`` its CPU sizes
through the plain versions, which is a smoke run and measures nothing of
the card.

Timing (``_chain_time``): `iters` steps, each on rotated inputs, are
enqueued back to back between two CUDA events, their scalars summed on
the device, then one host sync; the time per step is the smallest of
`reps` runs divided by `iters`. On the CPU the host clock stands in for
the events.

``hybrid_step`` is the hybrid forward step (dense top-k + fused BM25 top-k
+ RRF fusion, the composition of the JAX package's
``__graft_entry__._hybrid_forward``); ``hybrid_inputs`` builds config 2's
inputs for it, ``example_inputs`` the driver's example shapes.
"""

from __future__ import annotations

import functools
import time
from typing import Optional

import numpy as np
import torch

from tpurag_torch.core.config import IVFConfig
from tpurag_torch.index.inverted import packed_cbits
from tpurag_torch.index.ivf import IVFIndex
from tpurag_torch.kernels.bm25_merge import bm25_topk_fused
from tpurag_torch.kernels.dense import dense_topk
from tpurag_torch.kernels.fusion import rrf_fuse
from tpurag_torch.kernels.graphops import expand_neighbors
from tpurag_torch.kernels.ivf_scan import ivf_scan
from tpurag_torch.memory.freshness import (combined_memory_scores,
                                           freshness_scores)


def _on_card(device) -> bool:
    return torch.device(device).type == "cuda"


def _chain_time(step_fn, device, iters: int = 10, reps: int = 4) -> float:
    """Seconds per step of `step_fn(i) -> 0-d tensor`, `iters` steps back
    to back (the smallest of `reps` runs, after one warm-up run)."""
    card = _on_card(device)

    def run() -> float:
        acc = torch.zeros((), dtype=torch.float32, device=device)
        if card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        for i in range(iters):
            acc = acc + step_fn(i)
        if card:
            end.record()
        float(acc)  # the one sync: ends after the last step
        if card:
            return start.elapsed_time(end) / 1e3
        return time.perf_counter() - t0

    run()
    return min(run() for _ in range(reps)) / iters


def _random_corpus(rng, n, d):
    emb = rng.standard_normal((n, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    return emb


def config1_exact_dense(seed: int = 0, device="cuda") -> dict:
    """Single KB ~1k chunks, fp32 cosine top-3, exactness vs numpy. (The
    JAX package scores it with its XLA oracle; on the card the port runs
    K1's fp32 form, since plain versions stay off card paths.)"""
    rng = np.random.default_rng(seed)
    n, d, b, k = 1024, 1024, 64, 3
    emb = _random_corpus(rng, n, d)
    q = _random_corpus(rng, b, d)
    emb_dev = torch.from_numpy(emb).to(device)
    q_dev = torch.from_numpy(q).to(device)
    _, ids = dense_topk(q_dev, emb_dev, n, k)
    ids = ids.cpu().numpy()
    ref_ids = np.argsort(-(q @ emb.T), axis=1, kind="stable")[:, :k]
    recall = float(np.mean([
        len(set(ids[i]) & set(ref_ids[i])) / k for i in range(b)]))

    def step(i):
        v, _ = dense_topk(q_dev * (1 + i * 1e-7), emb_dev, n, k)
        return v.sum()

    sec = _chain_time(step, device)
    return {"metric": "exact_dense_recall", "value": recall,
            "unit": "recall@3", "qps": b / sec, "p50_ms": sec * 1e3}


def hybrid_inputs(seed: int = 0, n: Optional[int] = None,
                  device="cuda") -> dict:
    """Config 2's inputs as hybrid_step's keyword arguments: random unit
    corpus and queries, Zipf document frequencies clip(p_max (1+r)^-0.5,
    16, p_max), CSR postings of globally sorted random doc ids (so a doc
    can repeat inside one term's window), 8 random terms per query."""
    card = _on_card(device)
    rng = np.random.default_rng(seed)
    n = n or (100_000 if card else 8_192)
    d = 1024 if card else 256
    b = 512 if card else 32
    vocab = 50_000 if card else 2_000
    p_max, tq, k = (2048 if card else 128), 8, 8

    emb = torch.from_numpy(_random_corpus(rng, n, d)).to(device).to(
        torch.bfloat16 if card else torch.float32)
    q = torch.from_numpy(_random_corpus(rng, b, d)).to(device)
    df = np.clip((p_max * (1 + np.arange(vocab)) ** -0.5), 16,
                 p_max).astype(np.int64)
    sh = np.zeros(vocab + 1, np.int64)
    np.cumsum(df, out=sh[1:])
    nnz = int(sh[-1])
    pd = np.sort(rng.integers(0, n, (nnz + p_max,)).astype(np.int32))
    pi = rng.uniform(0.3, 2.2, (nnz + p_max,)).astype(np.float32)
    tid = rng.integers(0, vocab, (b, tq))
    qi = rng.uniform(0.5, 3.0, (b, tq)).astype(np.float32)

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    return {"q": q, "emb": emb, "n_valid": n,
            "starts": dev(sh[tid].astype(np.int32)),
            "lens": dev(df[tid].astype(np.int32)), "idf": dev(qi),
            "post_doc": dev(pd), "post_impact": dev(pi), "k": k,
            "p_max": p_max, "cbits": packed_cbits(n)}


def example_inputs(n: int = 2048, d: int = 256, b: int = 8, vocab: int = 512,
                   p: int = 16, device="cuda") -> dict:
    """The JAX package driver's example step (``__graft_entry__.
    _example_args`` and ``_hybrid_forward``'s k=8, p_max=64) as
    hybrid_step's keyword arguments: the same draws, bf16 corpus."""
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((n, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    q = rng.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    nnz = vocab * p
    starts = rng.integers(0, nnz - p, (b, 4)).astype(np.int32)
    lens = rng.integers(1, p, (b, 4)).astype(np.int32)
    idf = rng.uniform(0.5, 3.0, (b, 4)).astype(np.float32)
    post_doc = np.sort(rng.integers(0, n, (nnz + 64,))).astype(np.int32)
    post_impact = rng.uniform(0.5, 2.0, (nnz + 64,)).astype(np.float32)

    def dev(x):
        return torch.from_numpy(x).to(device)

    return {"q": dev(q), "emb": dev(emb).to(torch.bfloat16), "n_valid": n,
            "starts": dev(starts), "lens": dev(lens), "idf": dev(idf),
            "post_doc": dev(post_doc), "post_impact": dev(post_impact),
            "k": 8, "p_max": 64, "cbits": packed_cbits(n)}


def hybrid_step(q, emb, n_valid, starts, lens, idf, post_doc, post_impact,
                k: int = 8, p_max: int = 64, cbits: int = 0):
    """One hybrid forward step: dense top-k (K1 on the card) and the
    fused BM25 top-k of CSR windows (K2' on the card), fused by RRF.
    Returns ((B, k) fused scores, (B, k) ids)."""
    _, v_i = dense_topk(q, emb, n_valid, k)
    _, k_i = bm25_topk_fused(starts, lens, idf, post_doc, post_impact,
                             n_valid, k=k, p_max=p_max, cbits=cbits)
    s, i, _ = rrf_fuse((v_i, k_i), weights=(1.0, 1.0), final_k=k)
    return s, i


def hybrid_chain_step(x: dict):
    """Config 2's timed step on hybrid_inputs `x`: step(i) runs hybrid_step
    on the queries scaled by 1 + i * 1e-7 and the query terms rolled by i,
    and returns the fused scores' sum as a 0-d tensor."""
    def step(i):
        s, _ = hybrid_step(
            x["q"] * (1.0 + i * 1e-7), x["emb"], x["n_valid"],
            *(torch.roll(x[name], i, dims=0)
              for name in ("starts", "lens", "idf")),
            x["post_doc"], x["post_impact"], k=x["k"], p_max=x["p_max"],
            cbits=x["cbits"])
        return s.sum()

    return step


def config2_hybrid(seed: int = 0, n: Optional[int] = None,
                   device="cuda") -> dict:
    """Hybrid top-8 dense + BM25 + RRF (the JAX package's headline)."""
    x = hybrid_inputs(seed, n, device)
    b = x["q"].shape[0]
    sec = _chain_time(hybrid_chain_step(x), device,
                      iters=10 if _on_card(device) else 3)
    return {"metric": "hybrid_qps_per_chip", "value": b / sec, "unit": "QPS",
            "p50_ms": sec * 1e3, "n": x["n_valid"], "batch": b}


def config3_memory_fusion(seed: int = 0, device="cuda") -> dict:
    """Unified memory + RAG: 3-source RRF with freshness-decay weighting."""
    rng = np.random.default_rng(seed)
    b, k = 256, 8
    now = 1.7e9

    def ids(width):
        return torch.from_numpy(rng.integers(0, 1000, (b, width)).astype(
            np.int32)).to(device)

    mem_ids, rag_ids, hist_ids = ids(8), ids(8), ids(4)
    conf = rng.uniform(0.5, 1.0, 64).astype(np.float32)
    last = now - rng.uniform(0, 100, 64) * 3600
    cnt = rng.integers(0, 20, 64)
    fresh = freshness_scores(conf, last, cnt, now, device=device)
    combined_memory_scores(np.full(64, 0.8, np.float32), fresh, device=device)

    def step(i):
        s, _, _ = rrf_fuse(
            (torch.roll(mem_ids, i, dims=0), torch.roll(rag_ids, i, dims=0),
             torch.roll(hist_ids, i, dims=0)),
            weights=(1.2, 1.0, 0.6), final_k=k)  # merger.ts:18-23 weights
        return s.sum()

    sec = _chain_time(step, device)
    return {"metric": "memory_fusion_qps", "value": b / sec, "unit": "QPS",
            "p50_ms": sec * 1e3}


def config4_graph(seed: int = 0, device="cuda") -> dict:
    """Entity kNN + 1-hop expansion at scale (1M entities on the card)."""
    card = _on_card(device)
    rng = np.random.default_rng(seed)
    n_ent = 1_000_000 if card else 10_000
    d = 1024 if card else 128
    b, k, max_nbr = 256 if card else 16, 16, 32
    emb = torch.from_numpy(_random_corpus(rng, n_ent, d)).to(device).to(
        torch.bfloat16 if card else torch.float32)
    q = torch.from_numpy(_random_corpus(rng, b, d)).to(device)
    deg = rng.integers(1, max_nbr, n_ent)
    off = np.zeros(n_ent + 1, np.int64)
    np.cumsum(deg, out=off[1:])
    flat = torch.from_numpy(rng.integers(0, n_ent, int(off[-1])).astype(
        np.int32)).to(device)
    offs = torch.from_numpy(off.astype(np.int32)).to(device)

    def step(i):
        _, ids = dense_topk(q * (1.0 + i * 1e-7), emb, n_ent, k)
        nbrs = expand_neighbors(ids, offs, flat, max_nbr)
        return (nbrs >= 0).sum().float()

    sec = _chain_time(step, device, iters=5)
    return {"metric": "graph_search_qps", "value": b / sec, "unit": "QPS",
            "n_entities": n_ent, "p50_ms": sec * 1e3}


def config5_sharded(seed: int = 0, device="cuda") -> dict:
    raise NotImplementedError(
        "config5_sharded needs the sharded IVF over a mesh: not ported yet "
        "(ROADMAP Queue 1 item 8, sharding)")


def config6_ingest(seed: int = 0, shape: str = "small",
                   device="cuda") -> dict:
    raise NotImplementedError(
        "config6_ingest needs the on-card encoder and the ingest pipeline: "
        "not ported yet (ROADMAP Queue 1 item 7, encoder)")


def config7_ivf_latency(seed: int = 0, device="cuda") -> dict:
    """Small-batch latency: IVF probe-scan (K6) vs the exact scan (K1) over
    the same cluster-major rows. 2M x 1024 bf16 on the card; small shapes
    on the CPU."""
    card = _on_card(device)
    rng = np.random.default_rng(seed)
    if card:
        n, d, b, k = 2_000_000, 1024, 8, 10
        cfg = IVFConfig(n_lists=2048, kmeans_iters=6, sample_size=262_144)
        n_centers = 2048
    else:
        n, d, b, k = 65_536, 128, 8, 10
        cfg = IVFConfig(n_lists=256, kmeans_iters=4, sample_size=16_384)
        n_centers = 128

    centers = _random_corpus(rng, n_centers, d)
    which = rng.integers(0, n_centers, n)
    emb = centers[which] + 0.3 * _random_corpus(rng, n, d)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    q = (emb[rng.choice(n, b, replace=False)]
         + 0.1 * _random_corpus(rng, b, d))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q_dev = torch.from_numpy(q).to(device)

    dtype = torch.bfloat16 if card else torch.float32
    idx = IVFIndex(cfg, device=device).build(emb, dtype=dtype, seed=seed)
    del emb, which
    # The exact baseline scans the same cluster-major matrix; its aligned
    # layout interleaves zero padding rows (row_ids -1) that score 0.0, so
    # the oracle overfetches and drops them.
    emb_dev = idx.emb_ivf
    npad = emb_dev.shape[0]
    _, rows = dense_topk(q_dev, emb_dev, npad, 4 * k)
    rows = rows.cpu().numpy()
    rid = idx.row_ids.cpu().numpy()
    exact_ids = np.empty((b, k), np.int32)
    for bi in range(b):
        live = rows[bi][rid[rows[bi]] >= 0]
        assert len(live) >= k, "oracle overfetch exhausted by padding"
        exact_ids[bi] = rid[live[:k]]
    nprobe = idx.tune_nprobe(q, exact_ids, k=k, target_recall=0.95)
    _, ids = idx.search(q, k=k, nprobe=nprobe)
    ids = ids.cpu().numpy()
    recall = float(np.mean([len(set(ids[i]) & set(exact_ids[i])) / k
                            for i in range(b)]))

    def exact_step(i):
        s, _ = dense_topk(q_dev * (1.0 + i * 1e-7), emb_dev, npad, k)
        return s.sum()

    def ivf_step(i):
        s, _ = ivf_scan(q_dev * (1.0 + i * 1e-7), idx.centroids, idx.emb_ivf,
                        idx.cluster_starts, idx.cluster_counts, idx.row_ids,
                        k=k, nprobe=nprobe)
        return s.sum()

    t_exact = _chain_time(exact_step, device, reps=3)
    t_ivf = _chain_time(ivf_step, device, reps=3)
    return {"metric": "ivf_speedup_smallbatch",
            "value": t_exact / max(t_ivf, 1e-9), "unit": "x vs exact scan",
            "n": n, "batch": b, "nprobe": nprobe, "n_lists": idx.n_lists,
            "recall_at_10": recall,
            "exact_p50_ms": t_exact * 1e3, "ivf_p50_ms": t_ivf * 1e3}


def config8_chat(seed: int = 0, device="cuda") -> dict:
    raise NotImplementedError(
        "config8_chat needs the serving path (batching executor, chat "
        "latency driver): not ported yet (ROADMAP Queue 1 item 4, serving "
        "and CLI)")


CONFIGS = {
    "exact_dense": config1_exact_dense,
    "hybrid": config2_hybrid,
    "memory_fusion": config3_memory_fusion,
    "graph": config4_graph,
    "sharded": config5_sharded,
    "ingest": config6_ingest,
    "ingest_base": functools.partial(config6_ingest, shape="base"),
    "ivf_latency": config7_ivf_latency,
    "chat": config8_chat,
}


def run_all(names: Optional[list[str]] = None, device="cuda") -> list[dict]:
    out = []
    for name in (names or list(CONFIGS)):
        out.append({"config": name, **CONFIGS[name](device=device)})
    return out
