"""Differential check of the batched highlighter on a benchmark window.

Builds a cell's KB as ``portbench`` does (same corpus, same seed, same
query stream), runs its closed loop for ``--seconds``, and compares the
``highlighted`` string of every result of every call with
``index.inverted.highlight`` on the result's text and its query's
tokens (a result that is not keyword-found must carry ""). Counts the
results compared, the mismatches and the fallbacks
(``highlight_batch``'s own count of results that took the Python
version), and prints them as one JSON line.

    python tools/highlight_diff.py --workload kb100k-hybrid-b512 \\
        --seed 1600000001 --seconds 30

``--n-chunks`` cuts the corpus for a smoke run on the CPU
(``--device cpu``).
"""

from __future__ import annotations

import argparse
import copy
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from portbench import harness, traffic  # noqa: E402
from tpurag_torch.api import knowledge_base  # noqa: E402
from tpurag_torch.index.inverted import highlight  # noqa: E402
from tpurag_torch.ingest.tokenizer import tokenize_query  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="kb100k-hybrid-b512")
    ap.add_argument("--seed", type=int, default=1600000001)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-chunks", type=int, default=None)
    args = ap.parse_args()

    cell = harness.load_cell(args.workload)
    config, tr = cell["config"], cell["traffic"]
    if args.n_chunks:
        config = copy.deepcopy(config)
        config["corpus"]["n_chunks"] = args.n_chunks
    t0 = time.perf_counter()
    corpus = traffic.make_corpus(config, args.seed, args.device)
    kb = harness.build_kb(config, corpus, args.device)
    stream = traffic.QueryStream(corpus, tr, args.seed)
    kw = dict(top_k=tr["top_k"], mode=tr["mode"],
              preset=config["preset"]["name"])
    stream.draw(tr["warmup_batches"])
    for texts, qv, _ in stream.batches:
        kb.search_batch(texts, vectors=qv, **kw)
    setup_s = time.perf_counter() - t0

    seen = {"calls": 0, "highlights": 0, "fallbacks": 0}
    native = knowledge_base.highlight_batch

    def counted(texts, tokens, which, mark="**"):
        out, fallbacks = native(texts, tokens, which, mark)
        seen["highlights"] += len(texts)
        seen["fallbacks"] += fallbacks
        return out, fallbacks

    knowledge_base.highlight_batch = counted
    compared = mismatches = keyword = 0
    first_bad = None
    j, call_s, check_s = tr["warmup_batches"], [], 0.0
    t_open = time.perf_counter()
    while time.perf_counter() - t_open < args.seconds:
        if j == len(stream.batches):
            stream.draw(j + 16)
        texts, qv, _ = stream.batches[j]
        j += 1
        t1 = time.perf_counter()
        out = kb.search_batch(texts, vectors=qv, **kw)
        t2 = time.perf_counter()
        call_s.append(t2 - t1)
        seen["calls"] += 1
        for query, resp in zip(texts, out):
            toks = tokenize_query(query)
            for r in resp.results:
                hit = "keyword" in r.found_in
                want = highlight(r.text, toks) if hit else ""
                keyword += hit
                compared += 1
                if r.highlighted != want:
                    mismatches += 1
                    if first_bad is None:
                        first_bad = {"query": query, "chunk_id": r.chunk_id}
        check_s += time.perf_counter() - t2
    knowledge_base.highlight_batch = native

    call_s.sort()
    line = {"workload": args.workload, "seed": args.seed,
            "n_chunks": corpus.n, "device": args.device,
            "setup_s": round(setup_s, 3), "calls": seen["calls"],
            "results_compared": compared, "keyword_found": keyword,
            "highlights": seen["highlights"],
            "fallbacks": seen["fallbacks"], "mismatches": mismatches,
            "first_mismatch": first_bad,
            "call_p50_ms": round(1e3 * call_s[len(call_s) // 2], 3)
            if call_s else None,
            "python_check_s": round(check_s, 3)}
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
