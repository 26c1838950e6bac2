"""Host time of the keyword leg on the main path's requests, for holding
two checkouts of the repository side by side on the same card.

    python tools/k2_host.py [--root DIR] [--data DIR] [--reps N]

Imports tpurag_torch from --root (default: this checkout) and builds an
InvertedIndex on the card from the postings plans of chip_smoke.py's
phases 5 (100k docs) and 7 (1M docs): the same draws of its zipf_corpus
(seeds 0 and 1), turned into postings arrays instead of texts, with the
vocabulary in the order add_chunks gives it. The queries are the phase's
first timed request (its draws replayed without the embeddings). Times,
on the host clock after 2 warm-ups, `search(queries, 8, as_device=True)`
and a sync, as the hybrid path calls the keyword leg: the tokenizing, the
host's width classing and table work, the kernels and the glue; median
and min of --reps. At 1M also the request's queries that hold no wide
term alone (the narrow path: one K2 call).

--data caches the drawn postings and queries (npz) so that a second
checkout, or a second run, times the very same request without drawing
it again. Prints one line per cell with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = pathlib.Path(__file__).resolve().parents[1]


def _smoke():
    """chip_smoke.py of this checkout, loaded by path (its directory stays
    off sys.path, so tpurag_torch comes from --root)."""
    spec = importlib.util.spec_from_file_location("k2_host_smoke",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def draw_cell(sm, seed: int, n_docs: int, vocab: int, df_max: int,
              batch: int) -> dict:
    """chip_smoke's corpus plan and first timed request for one phase, as
    postings: term r ('w<r>') in df[r] distinct docs; tid by first
    appearance over docs in order (add_chunks' order)."""
    rng = np.random.default_rng(seed)
    df = sm.zipf_df(vocab, df_max)
    docs = np.concatenate([rng.choice(n_docs, int(m), replace=False)
                           for m in df])
    terms = np.repeat(np.arange(vocab), df)
    # zipf_corpus's texts go here; unit_rows' draws follow, chunked.
    for lo in range(0, n_docs, 65536):
        rng.standard_normal((min(65536, n_docs - lo), sm.DIM),
                            dtype=np.float32)
    request = None
    for i in range(2):  # the warm-up request, then the first timed one
        rng.integers(0, n_docs, (batch, 3))
        rng.standard_normal((batch, sm.DIM), dtype=np.float32)
        request = sm.zipf_queries(rng, batch, vocab)
    first_doc = np.full(vocab, n_docs, np.int64)
    np.minimum.at(first_doc, terms, docs)
    rank = np.empty(vocab, np.int64)
    rank[np.lexsort((np.arange(vocab), first_doc))] = np.arange(vocab)
    order = np.lexsort((docs, rank[terms]))  # by tid, then doc
    offsets = np.zeros(vocab + 1, np.int64)
    np.cumsum(np.bincount(rank[terms], minlength=vocab), out=offsets[1:])
    return {"rank": rank, "doc_len": np.bincount(docs, minlength=n_docs),
            "post_offsets": offsets, "post_doc": docs[order].astype(np.int32),
            "queries": np.array(request)}


def build(cell: dict, device: str):
    from tpurag_torch.core.config import BM25Config
    from tpurag_torch.index.inverted import InvertedIndex

    rank = cell["rank"]
    vocab = {f"w{r}": int(rank[r]) for r in range(len(rank))}
    n = len(cell["doc_len"])
    return InvertedIndex.from_numpy(
        vocab, cell["doc_len"], n, int(cell["doc_len"].sum()),
        cell["post_offsets"], cell["post_doc"],
        np.ones_like(cell["post_doc"]), config=BM25Config(), device=device)


def time_search(idx, queries: list[str], reps: int) -> dict:
    import torch

    host = []
    for i in range(reps + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        idx.search(queries, 8, as_device=True)
        torch.cuda.synchronize()
        if i >= 2:
            host.append((time.perf_counter() - t0) * 1e3)
    return {"host_ms": statistics.median(host), "host_min": min(host)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--data", default=None)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("k2_host: no CUDA device", file=sys.stderr)
        return 2
    sm = _smoke()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    cells = {"100k": (0, sm.N_DOCS, sm.VOCAB, sm.DF_MAX, sm.BATCH),
             "1M": (1, sm.N_WIDE, sm.VOCAB_WIDE, sm.DF_MAX_WIDE,
                    sm.BATCH_WIDE)}
    for name, plan in cells.items():
        path = (pathlib.Path(args.data) / f"k2_host_{name}.npz"
                if args.data else None)
        t0 = time.perf_counter()
        if path is not None and path.exists():
            cell = dict(np.load(path))
        else:
            cell = draw_cell(sm, *plan)
            if path is not None:
                path.parent.mkdir(parents=True, exist_ok=True)
                np.savez(path, **cell)
        idx = build(cell, "cuda")
        queries = [str(q) for q in cell["queries"]]
        idx.search(queries[:4], 8)  # compaction
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        runs = {"all": time_search(idx, queries, args.reps)}
        wide = idx.config.wide_term_width
        df = np.diff(cell["post_offsets"])
        narrow = [q for q in queries
                  if all(df[cell["rank"][int(w[1:])]] <= wide
                         for w in q.split())]
        if len(narrow) < len(queries):
            runs["narrow"] = time_search(idx, narrow, args.reps)
        parts = "; ".join(
            f"{k} ({len(queries) if k == 'all' else len(narrow)} queries) "
            f"{r['host_ms']:.3f} ms (min {r['host_min']:.3f})"
            for k, r in runs.items())
        print(f"[k2_host] root={root.name} {name} request: {parts}; set-up "
              f"{setup:.1f}s ({card})", flush=True)
        del idx
    return 0


if __name__ == "__main__":
    sys.exit(main())
