#!/usr/bin/env python3
"""The control of a cell's comparison: the plain reference put in the
program's place, computed one precision below the configuration's, must
come out not correct.

    python3 portbench/control.py --workload NAME[,NAME...] --seeds 1,2,3 [--device cuda]

For each seed it draws the cell's corpus and as many of its window's
queries as a run compares (harness.SAMPLE_QUERIES), answers them with the
reference at the lower precision (dense scores from int8 rows and
queries, the configuration's bf16 or fp32 products below; BM25
contributions and sums rounded to bf16, the configuration's float
arithmetic below), and prints the numbers the comparison reads of those
answers beside the cell's limits, and beside them the readings of the
reference's own answers at the configuration's precision. Workloads of
one configuration share each seed's corpus. The benchmark's runs never
run this.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def readings(cell: dict, seed: int, device, n_queries: int,
             corpus=None) -> dict:
    import numpy as np
    import torch

    from portbench import check, traffic as traffic_mod
    from portbench.reference.dense import DenseReference

    config, traffic = cell["config"], cell["traffic"]
    if corpus is None:
        corpus = traffic_mod.make_corpus(config, seed, device)
    stream = traffic_mod.QueryStream(corpus, traffic, seed)
    warm = traffic["warmup_batches"]
    stream.draw(warm + -(-n_queries // traffic["batch"]))
    batches = stream.batches[warm:]
    texts = [t for b in batches for t in b[0]][:n_queries]
    qv = np.concatenate([b[1] for b in batches])[:n_queries]
    bm = corpus.bm25(config["bm25"]["k1"], config["bm25"]["b"], texts)
    dense = DenseReference(corpus.vector_blocks(), device)
    ccell = check.Cell(config, traffic)
    out = {}
    for name, prec, kw in (("control", "int8", torch.bfloat16),
                           ("reference", ccell.precision, None)):
        ans = check.as_answers(*check.reference_answers(
            ccell, qv, texts, dense, bm, prec, kw))
        out[name] = check.compare(ccell, ans, qv, texts, dense, bm,
                                  corpus.n)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    from portbench import harness

    from portbench import traffic

    cells = [harness.load_cell(w, ROOT) for w in args.workload.split(",")]
    for seed in (int(s) for s in args.seeds.split(",")):
        corpora: dict = {}
        for cell in cells:
            name = cell["config"]["name"]
            if name not in corpora:
                corpora = {name: traffic.make_corpus(cell["config"], seed,
                                                     args.device)}
            r = readings(cell, seed, args.device, harness.SAMPLE_QUERIES,
                         corpora[name])
            print(json.dumps({"workload": cell["workload"]["name"],
                              "seed": seed, "limits": cell["limits"], **r}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
