"""The hybrid fusion step on the card: its kernel against its plain version.

Times ``kernels.fusion.fuse_legs`` (one launch of csrc/fuse_rrf.cu) and
``fuse_legs_ref`` (the floor, the gate and ``rrf_fuse`` in plain
PyTorch) on the same CUDA legs, the ``document`` preset with the gate on
(k_v = k_k = final_k = 8), at B = 1 and B = 512:

  host_ms     wall ms a call over a chain of --calls calls, ending in a
              synchronize (both paths are host-bound: this is the enqueue);
  device_ms   the device time a call of the operations it launched
              (torch.profiler, one session over --profiled calls);
  device_ops  those operations a call (kernels, copies, memsets);
  bound_ms    the kernel's least time, bytes: the legs, the masses and
              the results once each over 3.35 TB/s.

Each measurement runs plain, kernel, kernel, plain in turn; the line
gives each side's two readings. ``--ops`` instead prints the names of
the device operations of one ``fuse_legs`` call at B = 1 (the card tests
read it). Run from the repository root on a machine with the card:

    python tools/fuse_anatomy.py [--ops]

The process ends without the interpreter's teardown, where CUPTI may
hang after profiler sessions (portbench/run.py does the same).
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import time

# A profiler session may lose its records when CUPTI stays set up between
# sessions (chip_smoke.py): torn down after each, a session that recorded
# nothing is taken again.
os.environ["TEARDOWN_CUPTI"] = "1"

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import torch  # noqa: E402

import fuse_cases  # noqa: E402
from tpurag_torch.core.config import PRESETS  # noqa: E402
from tpurag_torch.kernels.fusion import fuse_legs, fuse_legs_ref  # noqa: E402

HBM_BYTES_S = 3.35e12


def host_ms(fn, calls: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / calls


def device(fn, calls: int):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if ops:
            break
    us = sum(e.time_range.elapsed_us() for e in ops)
    return us / 1e3 / calls, len(ops) / calls, [e.name for e in ops]


def legs_of(b: int, p):
    """b rows of tests/fuse_cases.py's legs on the card, and their masses."""
    v_s, v_i, k_s, k_i, mass = fuse_cases.legs(
        b, max(b, 4), p.vector_top_k, p.keyword_top_k, p.min_vector_score,
        p.min_keyword_coverage)
    return ([torch.from_numpy(x[:b]).cuda() for x in (v_s, v_i, k_s, k_i)],
            mass[:b])


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--calls", type=int, default=500)
    ap.add_argument("--profiled", type=int, default=50)
    ap.add_argument("--ops", action="store_true")
    args = ap.parse_args()
    p = PRESETS["document"]
    kv, kk, fk = p.vector_top_k, p.keyword_top_k, p.final_top_k
    if args.ops:
        legs, mass = legs_of(1, p)
        fuse_legs(*legs, mass, p)  # the library's build and first launch
        print(json.dumps({"ops": device(lambda: fuse_legs(*legs, mass, p),
                                        1)[2]}), flush=True)
        return
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    for b in (1, 512):
        legs, mass = legs_of(b, p)
        paths = {"kernel": lambda: fuse_legs(*legs, mass, p),
                 "plain": lambda: fuse_legs_ref(*legs, mass, p)}
        for fn in paths.values():  # build, load, warm
            for _ in range(20):
                fn()
        got = {k: {"host_ms": [], "device_ms": [], "device_ops": []}
               for k in paths}
        names = {}
        for side in ("plain", "kernel", "kernel", "plain"):
            got[side]["host_ms"].append(round(host_ms(paths[side],
                                                      args.calls), 5))
            ms, ops, names[side] = device(paths[side], args.profiled)
            got[side]["device_ms"].append(round(ms, 6))
            got[side]["device_ops"].append(round(ops, 2))
        nbytes = b * ((kv + kk) * 8 + 4 + fk * 12)
        print(json.dumps({"b": b, "card": card.strip(),
                          "bound_ms": nbytes / HBM_BYTES_S * 1e3,
                          "bytes": nbytes, **got,
                          "kernel_ops": sorted(set(names["kernel"]))}),
              flush=True)


if __name__ == "__main__":
    main()
    sys.stdout.flush()
    os._exit(0)
