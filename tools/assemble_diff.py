"""Differential check of a search's responses between two checkouts.

Builds kb100k-bf16's KB as ``portbench`` does (same corpus, same seed)
with the ``tpurag_torch`` of ``--root``, then runs the query streams of
``kb100k-hybrid-b512`` (``--b512-calls`` calls) and ``kb100k-hybrid-b1``
(``--b1-calls`` calls) through ``KnowledgeBase.search_batch``. With
``--out`` it pickles every ``SearchResponse``; with ``--against`` it
holds each to the pickled one of another checkout by ``==`` on the
dataclasses and counts the unequal ones. One JSON line.

    PYTHONHASHSEED=0 python tools/assemble_diff.py --root _tree/parent \\
        --seed 2000000001 --out _tree/parent.pkl
    PYTHONHASHSEED=0 python tools/assemble_diff.py --root _tree/change \\
        --seed 2000000001 --against _tree/parent.pkl

``--n-chunks`` cuts the corpus for a smoke run on the CPU (``--device
cpu``).
"""

from __future__ import annotations

import argparse
import copy
import json
import pathlib
import pickle
import sys
import time
import types

HERE = pathlib.Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--seed", type=int, default=2000000001)
    ap.add_argument("--b512-calls", type=int, default=20)
    ap.add_argument("--b1-calls", type=int, default=1000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-chunks", type=int, default=None)
    ap.add_argument("--out")
    ap.add_argument("--against")
    args = ap.parse_args()
    sys.path.insert(0, str(HERE))  # portbench: the corpus and the queries
    sys.path.insert(0, str(pathlib.Path(args.root).resolve()))
    import torch

    from portbench import harness, traffic
    from tpurag_torch.core import chunkstore

    t0 = time.perf_counter()
    cells = [(harness.load_cell(name), n) for name, n in
             (("kb100k-hybrid-b512", args.b512_calls),
              ("kb100k-hybrid-b1", args.b1_calls))]
    config = copy.deepcopy(cells[0][0]["config"])
    if args.n_chunks:
        config["corpus"]["n_chunks"] = args.n_chunks
    corpus = traffic.make_corpus(config, args.seed, args.device)
    # Each chunk's `indexed_at` metadata is the clock at its ingest: one
    # fixed clock for the ingest, so that two processes' results can match.
    clock, chunkstore.time = chunkstore.time, types.SimpleNamespace(
        time=lambda: 1.0)
    try:
        kb = harness.build_kb(config, corpus, args.device)
    finally:
        chunkstore.time = clock
    setup_s = time.perf_counter() - t0

    got = []
    for cell, calls in cells:
        tr = cell["traffic"]
        stream = traffic.QueryStream(corpus, tr, args.seed)
        stream.draw(calls)
        for texts, qv, _ in stream.batches[:calls]:
            got.append(kb.search_batch(texts, vectors=qv, top_k=tr["top_k"],
                                       mode=tr["mode"],
                                       preset=config["preset"]["name"]))
    line = {"root": args.root, "seed": args.seed, "n_chunks": corpus.n,
            "device": args.device,
            "device_name": (torch.cuda.get_device_name(0)
                            if args.device == "cuda" else "cpu"),
            "setup_s": round(setup_s, 3), "calls": len(got),
            "responses": sum(map(len, got)),
            "results": sum(len(r.results) for call in got for r in call),
            "highlighted": sum(bool(x.highlighted) for call in got
                               for r in call for x in r.results)}
    if args.out:
        with open(args.out, "wb") as f:
            pickle.dump(got, f, protocol=pickle.HIGHEST_PROTOCOL)
    if args.against:
        with open(args.against, "rb") as f:
            want = pickle.load(f)
        pairs = [(g, w) for gc, wc in zip(got, want) for g, w in zip(gc, wc)]
        bad = [j for j, (g, w) in enumerate(pairs) if g != w]
        line.update(compared=len(pairs),
                    calls_match=[len(c) for c in got] == [len(c) for c in want],
                    unequal=len(bad), first_unequal=bad[:5])
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
