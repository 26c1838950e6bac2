#!/usr/bin/env python3
"""Run one cell of the port's benchmark on this machine's card.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout (BENCHMARK.json names the cells). Without a
CUDA card, or with fewer cards than the cell asks for, it exits non-zero
and prints no result; it never falls back to the CPU. Progress and, as
its last lines, each number the answers were compared on beside its
limit go to standard error; the result is the last line of standard
output, one JSON object. With --trace 0 its metrics are the cell's
end-to-end metrics, with --trace 1 its per-layer metrics.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

# One layout of the interpreter's str hashes in every run: the program's
# dicts and sets of terms then probe and iterate alike from run to run.
# The process re-executes itself once with the hash seed fixed; set-up
# still counts from the first start (perf_counter is the machine's
# monotonic clock).
if __name__ == "__main__" and os.environ.get("PYTHONHASHSEED") != "0":
    os.execve(sys.executable, [sys.executable] + sys.argv,
              dict(os.environ, PYTHONHASHSEED="0",
                   PORTBENCH_T_START=repr(T_START)))
T_START = float(os.environ.get("PORTBENCH_T_START", T_START))

ROOT = pathlib.Path(__file__).resolve().parent.parent
CACHE = ROOT / ".portbench_cache"
# torch.profiler loses device records when CUPTI stays set up between
# sessions (portbench/trace.py): tear it down after each, before torch
# is imported.
os.environ["TEARDOWN_CUPTI"] = "1"
# Every compile cache inside the checkout, at fixed paths (the port's own
# nvcc build lives in tpurag_torch/_build).
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels")):
    os.environ[var] = str(CACHE / sub)
sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "tpurag")


def loaded_forbidden() -> list[str]:
    """Modules whose top-level name is jax's, jaxlib's, flax's or the JAX
    package's (whole names: tpurag_torch is not tpurag)."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi unavailable ({e})"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    from portbench import harness

    cell = harness.load_cell(args.workload, ROOT)
    import torch

    chips = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        harness.log(f"portbench: needs {chips} CUDA card(s), found "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
                    "; no CPU fallback")
        return 2
    kind = torch.cuda.get_device_name(0)
    harness.log(f"[device] {kind}; {torch.cuda.device_count()} card(s); "
                f"{power_limit()}; torch {torch.__version__} CUDA "
                f"{torch.version.cuda}; CPU threads: torch "
                f"{torch.get_num_threads()}, os.cpu_count {os.cpu_count()}, "
                f"OMP_NUM_THREADS={os.environ.get('OMP_NUM_THREADS')}; "
                f"PYTHONHASHSEED={os.environ.get('PYTHONHASHSEED')}")
    harness.log(f"[cell] {args.workload}: seed {args.seed}, "
                f"{args.seconds:g} s, trace {args.trace}")
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), "cuda", T_START)
    bad = loaded_forbidden()
    if bad:
        harness.log(f"portbench: the process loaded {', '.join(bad)}; "
                    "no result")
        return 3
    result["device"] = {"platform": "gpu", "kind": kind, "count": chips,
                        **result["device"]}
    for name, c in result["compared"].items():
        harness.log(f"{name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    rc = main()
    sys.stdout.flush()
    sys.stderr.flush()
    # Past the result, nothing is left to do: skip the interpreter's
    # teardown, where CUPTI's may hang after profiler sessions.
    os._exit(rc)
