"""Differential check of the hybrid fusion kernel on a benchmark window.

Builds a cell's KB as ``portbench`` does (same corpus, same seed, same
query stream), runs its closed loop for ``--seconds``, and in every call
puts the legs that ``hybrid_search`` hands to ``kernels.fusion.fuse_legs``
through both its paths: ``fuse_legs`` itself (on the card, one launch of
csrc/fuse_rrf.cu) and its plain version ``fuse_legs_ref``, on the same
device tensors. A row mismatches when its (scores as bit patterns, ids,
source bits) differ. Prints the calls, rows and mismatches, and the
fusion's counts (kernel launches and plain calls), as one JSON line.

    python tools/fuse_diff.py --workload kb100k-hybrid-b1 \\
        --seed 1800000001 --seconds 30

``--n-chunks`` cuts the corpus for a smoke run on the CPU
(``--device cpu``, where both paths are the plain version).
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

import torch  # noqa: E402

from portbench import harness, traffic  # noqa: E402
from tpurag_torch.engine import hybrid  # noqa: E402
from tpurag_torch.kernels.fusion import fuse_legs_ref  # noqa: E402
from tpurag_torch.utils import tracing  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="kb100k-hybrid-b1")
    ap.add_argument("--seed", type=int, default=1800000001)
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

    seen = {"calls": 0, "rows": 0, "mismatched_rows": 0, "kept": 0}
    first_bad = []
    real = hybrid.fuse_legs

    def both(v_scores, v_ids, k_scores, k_ids, mass, preset):
        got = real(v_scores, v_ids, k_scores, k_ids, mass, preset)
        want = fuse_legs_ref(v_scores, v_ids, k_scores, k_ids, mass, preset)
        bad = ((got[0].view(torch.int32) != want[0].view(torch.int32))
               | (got[1] != want[1]) | (got[2] != want[2])).any(dim=1)
        seen["calls"] += 1
        seen["rows"] += int(bad.numel())
        seen["mismatched_rows"] += int(bad.sum())
        seen["kept"] += int((want[1] >= 0).sum())
        if bad.any() and not first_bad:
            r = int(bad.nonzero()[0, 0])
            first_bad.append({"row": r, "got": [x[r].tolist() for x in got],
                              "want": [x[r].tolist() for x in want]})
        return got

    tracing.clear()
    launched = tracing.launch_counts["fuse_legs"]
    hybrid.fuse_legs = both
    j, t_open = tr["warmup_batches"], time.perf_counter()
    try:
        while time.perf_counter() - t_open < args.seconds:
            if j == len(stream.batches):
                stream.draw(j + 16)
            texts, qv, _ = stream.batches[j]
            j += 1
            kb.search_batch(texts, vectors=qv, **kw)
    finally:
        hybrid.fuse_legs = real

    line = {"workload": args.workload, "seed": args.seed,
            "n_chunks": corpus.n, "device": args.device,
            "device_name": (torch.cuda.get_device_name(0)
                            if args.device == "cuda" else "cpu"),
            "setup_s": round(setup_s, 3), **seen,
            "fuse_launches": tracing.launch_counts["fuse_legs"] - launched,
            "fuse_plain": tracing.counters["fuse_plain"],
            "first_mismatch": first_bad[0] if first_bad else None}
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
