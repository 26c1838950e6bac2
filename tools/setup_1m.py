"""Set-up of the 1M-chunk int8 + IVF knowledge base, phase by phase.

Builds the KB that PERF.md §7 row 0 describes for the benchmark's 1M
cells: kb100k-bf16's 512/50 chunks and preset at 1,000,000 chunks, int8
(``quant``), a mixture of 1,024 centers with noise 0.3 as the vectors,
``n_lists`` 4,096. It runs ``portbench.harness.build_kb`` as a run of
the benchmark would (``add_chunks`` a block of vectors at a time, then
``build_ivf``), then a first ``hybrid_ivf`` search of 32 queries (the
keyword index's compaction), then full collections of the cyclic
collector with the KB and the corpus alive, as in a window. Prints one
JSON line: the phases' seconds, the ingest counters (documents on the
native and on the Python path), the postings, and peak host and device
memory.

    python tools/setup_1m.py                      # the card, ~4-6 min
    python tools/setup_1m.py --device cpu --n-chunks 20000 \\
        --n-centers 64 --n-lists 64               # a CPU smoke run
"""

from __future__ import annotations

import argparse
import copy
import gc
import json
import pathlib
import resource
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from portbench import harness, traffic  # noqa: E402
from tpurag_torch.utils import tracing  # noqa: E402


def config_1m(n_chunks: int, n_centers: int, n_lists: int,
              block_rows: int) -> tuple[dict, dict]:
    """kb100k-bf16 at n_chunks, int8 + IVF over mixture vectors, and a
    hybrid_ivf traffic of 32 queries of the b512 plan's 8 Zipf terms."""
    cell = harness.load_cell("kb100k-hybrid-b512")
    config = copy.deepcopy(cell["config"])
    config["name"] = "kb1m-q8-ivf"
    config["corpus"]["n_chunks"] = n_chunks
    config["corpus"]["vectors"] = {"kind": "mixture", "n_centers": n_centers,
                                   "noise": 0.3, "block_rows": block_rows}
    config["quant"] = True
    config["ivf"] = {"n_lists": n_lists}
    tr = copy.deepcopy(cell["traffic"])
    tr.update(mode="hybrid_ivf", batch=32, top_k=10)
    tr["queries"]["vectors"] = {"kind": "mixture"}
    return config, tr


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "no nvidia-smi"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-chunks", type=int, default=1_000_000)
    ap.add_argument("--n-centers", type=int, default=1024)
    ap.add_argument("--n-lists", type=int, default=4096)
    ap.add_argument("--block-rows", type=int, default=65536)
    ap.add_argument("--seed", type=int, default=1700000001)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--collections", type=int, default=3)
    args = ap.parse_args()

    import torch

    config, tr = config_1m(args.n_chunks, args.n_centers, args.n_lists,
                           args.block_rows)
    cuda = torch.device(args.device).type == "cuda"
    out = {"device": torch.cuda.get_device_name(0) if cuda else "cpu",
           "card": card() if cuda else "", "seed": args.seed,
           "n_chunks": args.n_chunks, "n_lists": args.n_lists}
    tracing.clear()
    t0 = time.perf_counter()
    corpus = traffic.make_corpus(config, args.seed, args.device)
    out["corpus_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    kb = harness.build_kb(config, corpus, args.device)
    harness.sync(args.device)
    out["build_kb_s"] = time.perf_counter() - t0
    c = dict(tracing.counters)
    out["ingest_s"] = c.get("ingest_ns", 0) / 1e9
    out["ingest_keyword_s"] = c.get("ingest_keyword_ns", 0) / 1e9
    out["ingest_calls"] = c.get("ingest_calls", 0)
    out["build_ivf_s"] = out["build_kb_s"] - out["ingest_s"]
    out["native_docs"] = c.get("ingest_native_docs", 0)
    out["python_docs"] = c.get("ingest_python_docs", 0)

    stream = traffic.QueryStream(corpus, tr, args.seed)
    stream.draw(2)
    kw = dict(top_k=tr["top_k"], mode=tr["mode"],
              preset=config["preset"]["name"])
    for i, (texts, qv, _) in enumerate(stream.batches[:2]):
        t0 = time.perf_counter()
        kb.search_batch(texts, vectors=qv, **kw)
        harness.sync(args.device)
        out[f"search_{i}_s"] = time.perf_counter() - t0
    out["compact_s"] = tracing.counters.get("compact_ns", 0) / 1e9
    out["compactions"] = tracing.counters.get("compactions", 0)
    inv = kb.inverted
    out["terms"] = len(inv.vocab)
    out["postings"] = sum(map(len, inv._postings_doc)) // 4
    out["gc_tracked_objects"] = len(gc.get_objects())
    full = []
    for _ in range(args.collections):
        t0 = time.perf_counter()
        gc.collect()
        full.append(time.perf_counter() - t0)
    out["gc_full_s"] = full
    out["host_peak_rss_gib"] = (resource.getrusage(resource.RUSAGE_SELF)
                                .ru_maxrss / 2**20)
    if cuda:
        out["device_peak_bytes"] = torch.cuda.max_memory_allocated()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
