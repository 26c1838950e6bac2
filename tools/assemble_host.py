"""Host time of a search's assembly: ``KnowledgeBase._assemble``, which
turns one call's (scores, ids, bits) into ``SearchResponse`` objects.

    python tools/assemble_host.py [--root DIR] [--n-chunks N] [--calls N]

Imports tpurag_torch from --root (default: this checkout), so that two
checkouts can be timed side by side. Fills a CPU KnowledgeBase's chunk
store with --n-chunks (default 100,000) chunks of kb100k-bf16's Zipf
texts (~1,965 characters, ``portbench/traffic.py``; nothing is indexed)
and times ``_assemble`` on synthetic triples at (512, 8) and (1, 8):
ids uniform over the store, descending fp32 scores, source bits keyword
in 7 of 8 results, one empty slot (NEG_INF, -1) in 16; the queries are
zipf8-hybrid-b512's. Each shape runs with the highlighter stubbed and
not, and with the cyclic collector on and off; each case gives the median
and min ms a call over --calls calls after 3 warm-ups, and the
collections the collector ran over them by generation. Before timing,
every shape's responses are held with ``==`` to the per-result assembly
over ``kb.chunks[i]`` views (below, ``spec_assemble``). One JSON line a
case; a CPU time, not a device metric.
"""

from __future__ import annotations

import argparse
import gc
import json
import pathlib
import statistics
import sys
import time

import numpy as np

HERE = pathlib.Path(__file__).resolve().parents[1]


def spec_assemble(kb, queries, scores, ids, bits):
    """The assembly written per result, over ``kb.chunks[i]`` views."""
    from tpurag_torch.api import knowledge_base as kbm
    from tpurag_torch.core.types import SearchResponse, SearchResult
    from tpurag_torch.engine.hybrid import decode_bits
    from tpurag_torch.ingest.tokenizer import tokenize_query
    from tpurag_torch.kernels.runtime import NEG_INF

    out, marked, texts, which, qtoks = [], [], [], [], []
    for b, query in enumerate(queries):
        qtoks.append(tokenize_query(query))
        results = []
        for s, i, bt in zip(scores[b], ids[b], bits[b]):
            i = int(i)
            if i < 0 or s <= NEG_INF / 2:
                continue
            c = kb.chunks[i]
            if c.metadata.get("deleted"):
                continue
            found_in = decode_bits(int(bt))
            r = SearchResult(chunk_id=i, score=float(s), text=c.text,
                             doc_name=c.doc_name, source=c.source,
                             found_in=found_in, metadata=c.metadata)
            if "keyword" in found_in:
                marked.append(r)
                texts.append(c.text)
                which.append(b)
            results.append(r)
        stats = {"total": len(results), "by_source": {}}
        for r in results:
            for src in (r.found_in or (r.source,)):
                stats["by_source"][src] = stats["by_source"].get(src, 0) + 1
        out.append(SearchResponse(results=results, query=query, stats=stats))
    strings, _ = kbm.highlight_batch(texts, qtoks, which)
    for r, h in zip(marked, strings):
        r.highlighted = h
    return out


def triple(rng, n: int, b: int, k: int = 8):
    from tpurag_torch.kernels.runtime import NEG_INF

    ids = rng.integers(0, n, (b, k)).astype(np.int64)
    scores = np.sort(rng.random((b, k), dtype=np.float32), axis=1)[:, ::-1]
    scores = np.ascontiguousarray(scores)
    bits = np.where(rng.random((b, k)) < 0.875,
                    rng.choice([2, 3], (b, k)), 1).astype(np.int64)
    empty = rng.random((b, k)) < 1 / 16
    ids[empty], scores[empty], bits[empty] = -1, NEG_INF, 0
    return scores, ids, bits


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--n-chunks", type=int, default=100_000)
    ap.add_argument("--calls", type=int, default=40)
    ap.add_argument("--seed", type=int, default=2000000001)
    args = ap.parse_args()
    sys.path.insert(0, str(HERE))  # portbench: the corpus and the queries
    sys.path.insert(0, str(pathlib.Path(args.root).resolve()))
    from portbench import harness, traffic
    from tpurag_torch import Chunk, KnowledgeBase
    from tpurag_torch.api import knowledge_base as kbm

    cell = harness.load_cell("kb100k-hybrid-b512")
    gen = traffic.ZipfChunks(cell["config"]["corpus"]["texts"],
                             args.n_chunks, args.seed)
    kb = KnowledgeBase("assemble", device="cpu")
    for i, text in enumerate(gen.texts):
        kb.chunks.append(Chunk(text=text, doc_id=gen.doc_ids[i],
                               doc_name=gen.doc_names[i]))
    queries = gen.queries(cell["traffic"]["queries"], 0, 512, args.seed)
    rng = np.random.default_rng(args.seed)
    native = kbm.highlight_batch

    def stub(texts, tokens, which, mark="**"):
        return [""] * len(texts), 0

    collections = [0, 0, 0]

    def count(phase, info):
        if phase == "start":
            collections[info["generation"]] += 1

    gc.callbacks.append(count)
    for b in (512, 1):
        qs = queries[:b]
        calls = [triple(rng, args.n_chunks, b) for _ in range(4)]
        want = spec_assemble(kb, qs, *calls[0])
        if kb._assemble(qs, *calls[0]) != want:
            raise SystemExit(f"b={b}: _assemble differs from the spec")
        for highlighter in ("native", "stubbed"):
            kbm.highlight_batch = native if highlighter == "native" else stub
            for collector in ("on", "off"):
                (gc.enable if collector == "on" else gc.disable)()
                for j in range(3):
                    kb._assemble(qs, *calls[j % len(calls)])
                ms = []
                collections[:] = [0, 0, 0]
                for j in range(args.calls):
                    c = calls[j % len(calls)]
                    t0 = time.perf_counter_ns()
                    kb._assemble(qs, *c)
                    ms.append((time.perf_counter_ns() - t0) / 1e6)
                gc.enable()
                print(json.dumps({
                    "root": args.root, "n_chunks": args.n_chunks,
                    "shape": [b, 8], "highlighter": highlighter,
                    "collector": collector, "calls": args.calls,
                    "median_ms": round(statistics.median(ms), 3),
                    "min_ms": round(min(ms), 3),
                    "collections": collections[:]}), flush=True)
        kbm.highlight_batch = native


if __name__ == "__main__":
    main()
