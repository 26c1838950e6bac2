"""Hunts for faults in the port's pipelined kernels, on the card.

  1. runs the card tests of K1, K5, K7 and K2 (tests/test_torch_cuda.py
     -k "dense or int8 or merge or topk": the TMA + wgmma bodies at every
     edge shape; K2 on flipped rows and at K2_CASES; K3's merge tests ride
     along) --loops times, each run under `timeout`, and counts the runs
     that pass, fail and hang;
  2. runs small cases of K1's, K5's and K7's TMA + wgmma bodies, of K2 and
     of K3 (which shares K2's staging and merge code) once under
     compute-sanitizer --tool racecheck and once under --tool synccheck,
     and prints each tool's summary lines.

Run on a machine with the card, from the repository root (the kernels are
built by the first test run and reused):

    python tools/fault_hunt.py [--loops 20] [--sanitize-timeout 900]

`--cases` runs the small cases alone (what the sanitizer wraps).
"""

from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
SANITIZER = "/usr/local/cuda/bin/compute-sanitizer"
TESTS = ["python", "-m", "pytest", "--noconftest", "tests/test_torch_cuda.py",
         "-q", "-p", "no:cacheprovider", "-k",
         "dense or int8 or merge or topk"]


def cases() -> None:
    """One small shape of each pipelined body, held to its plain version."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from tpurag_torch.kernels.runtime import launch_counts

    cs.check_dense(130, 3000, 2900, 64, 8, seed=1)          # K1, wgmma
    cs.check_dense(8, 1000, 999, 1024, 40, seed=2)
    cs.check_q8(32, 3000, 2900, 1024, 20, seed=3)           # K5, 32 queries
    cs.check_q8(33, 3000, 2900, 1024, 32, seed=4)           # K5, 128 queries
    cs.check_dense_co(8, 1000, 999, 1024, 40, seed=5)       # K7, form (i)
    cs.check_dense_co(130, 320, 300, 1024, 40, seed=6)      # K7, form (ii)
    for name in ("t1", "empty", "ties", "sparse"):          # K2
        cs.check_topk_classes(name, runs=1)
    cs.check_merge(8, 8, 64, 14, n_docs=5000)
    cs.check_full_classes("straddle", runs=1)               # K3
    # K7's checks also run K1 (as routed) on their inputs.
    assert launch_counts["dense_topk_sm90"] == 4
    assert launch_counts["dense_scan_q8_sm90"] == 2
    assert launch_counts["dense_topk_co_sm90"] == 2
    print("cases: all held to their plain versions", flush=True)


def loop(n: int, limit: int) -> None:
    outcomes = {"passed": 0, "failed": 0, "hung": 0}
    for i in range(n):
        t0 = time.perf_counter()
        try:
            run = subprocess.run(TESTS, cwd=ROOT, capture_output=True,
                                 text=True, timeout=limit)
            key = "passed" if run.returncode == 0 else "failed"
            last = run.stdout.strip().splitlines()[-1:]
        except subprocess.TimeoutExpired:
            key, last = "hung", ["(cut at the time limit)"]
        outcomes[key] += 1
        print(f"[loop] run {i + 1}/{n}: {key} in "
              f"{time.perf_counter() - t0:.1f}s: {' '.join(last)}",
              flush=True)
        if key == "failed":
            print(run.stdout[-3000:], flush=True)
    print(f"[loop] {n} runs of {' '.join(TESTS[2:])}: {outcomes}",
          flush=True)


def sanitize(limit: int) -> None:
    for tool in ("racecheck", "synccheck"):
        t0 = time.perf_counter()
        cmd = [SANITIZER, "--tool", tool, "--print-limit", "20",
               sys.executable, __file__, "--cases"]
        try:
            run = subprocess.run(cmd, cwd=ROOT, capture_output=True,
                                 text=True, timeout=limit)
            text = run.stdout + run.stderr
            rc = run.returncode
        except subprocess.TimeoutExpired as e:
            text = (e.stdout or b"").decode() + (e.stderr or b"").decode()
            rc = "cut at the time limit"
        lines = [x for x in text.splitlines() if "SUMMARY" in x
                 or "cases:" in x or "Error" in x or "error" in x]
        print(f"[sanitize] {tool}: exit {rc} in "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
        for x in (lines or text.splitlines()[-15:])[:40]:
            print(f"[sanitize] {tool}: {x}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", action="store_true")
    ap.add_argument("--loops", type=int, default=20)
    ap.add_argument("--loop-timeout", type=int, default=300)
    ap.add_argument("--sanitize-timeout", type=int, default=900)
    args = ap.parse_args()
    if args.cases:
        cases()
        return 0
    loop(args.loops, args.loop_timeout)
    sanitize(args.sanitize_timeout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
