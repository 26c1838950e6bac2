"""What a span of tpurag_torch.utils.tracing costs on this host.

Enters ``with tracing.span("x"):`` N times with no profiler session open,
then N times inside a torch.profiler session (CPU activity, and CUDA
where a card is present), best of three rounds each, and prints one JSON
line: ns a span each way, the torch version and whether torch has the
profiler flag that spans test. From the repository root:

    python tools/span_cost.py [--n 20000]
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import time

os.environ.setdefault("TEARDOWN_CUPTI", "1")  # as portbench/run.py

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from tpurag_torch.utils import tracing  # noqa: E402


def per_span_ns(n: int) -> float:
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with tracing.span("x"):
                pass
        best = min(best, (time.perf_counter_ns() - t0) / n)
    return best


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=20000)
    n = ap.parse_args().n
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
        torch.ones(1, device="cuda").sum().item()
    off = per_span_ns(n)
    with profile(activities=acts):
        on = per_span_ns(n)
    tracing.clear()
    print(json.dumps({
        "off_ns": off, "on_ns": on, "n": n, "torch": torch.__version__,
        "profiler_flag": hasattr(torch.autograd.profiler,
                                 "_is_profiler_enabled"),
        "device": (torch.cuda.get_device_name(0)
                   if torch.cuda.is_available() else "cpu")}), flush=True)


if __name__ == "__main__":
    main()
    # CUPTI's teardown at the interpreter's exit may hang after a session
    # (portbench/run.py): leave without it.
    os._exit(0)
