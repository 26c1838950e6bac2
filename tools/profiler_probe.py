"""Does torch.profiler record every device operation, session after session?

chip_smoke.py reads device time and device operations from short
torch.profiler sessions (device_profile). This script takes many such
sessions in one process, between stretches of busy matmul work, and
prints for each round and each way of taking a session the (device
operations, port kernels) that each of three sessions recorded:

  alone      one rescore_topk call (one K8 launch, no PyTorch kernel);
  sandwich   a PyTorch kernel, rescore_topk, another PyTorch kernel;
  ivf_scan   one ivf_scan call (centroid product, probe sort, K6, id map).

A complete session records 1, 3 and 21 operations, one of them the port's
kernel. --spin-ms enqueues a spin kernel of about that many ms
(torch.cuda._sleep, not counted) first in the session, so the session's
kernels start on the device well after the host launched them. Kineto's
TEARDOWN_CUPTI is taken from the environment (chip_smoke.py sets it to 1;
this script does not import chip_smoke). Run on a machine with the card,
from the repository root:

    TEARDOWN_CUPTI=0 python tools/profiler_probe.py --spin-ms 0 2 20
    TEARDOWN_CUPTI=1 python tools/profiler_probe.py
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from tpurag_torch.kernels.ivf_scan import ivf_scan  # noqa: E402
from tpurag_torch.kernels.quant import rescore_topk  # noqa: E402
from tpurag_torch.kernels.runtime import load_kernels  # noqa: E402

PORT_KERNELS = ("rescore_topk_kernel", "ivf_rows_kernel")


def inputs(seed: int = 0):
    """rescore_topk's (32 x 16 candidates of 50k x 1024 fp32, k=8) and
    ivf_scan's (8 queries, 256 clusters of 160 bf16 rows) arguments."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(32, 1024, device="cuda", generator=g)
    emb = torch.randn(50_000, 1024, device="cuda", generator=g)
    ids = torch.randint(-1, 50_000, (32, 16), device="cuda", generator=g,
                        dtype=torch.int32)
    cents = torch.randn(256, 1024, device="cuda", generator=g)
    rows = torch.randn(40_960, 1024, device="cuda", generator=g).bfloat16()
    starts = torch.arange(0, 40_960, 160, device="cuda", dtype=torch.int32)
    counts = torch.full((256,), 160, device="cuda", dtype=torch.int32)
    row_ids = torch.arange(40_960, device="cuda", dtype=torch.int64)
    ivf = (q[:8].contiguous(), cents, rows, starts, counts, row_ids)
    return (q, emb, ids, 8), ivf


def session(fn, spin_ms: float) -> tuple[int, int]:
    """One session around fn() and a synchronize: (device operations, port
    kernels) recorded."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        if spin_ms:
            torch.cuda._sleep(int(spin_ms * 2e6))
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA
             and "spin_kernel" not in e.name]
    return len(names), sum(any(k in n for k in PORT_KERNELS) for n in names)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--busy-s", type=float, default=8.0)
    ap.add_argument("--spin-ms", type=float, nargs="+", default=[0.0])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profiler_probe: no CUDA device", file=sys.stderr)
        return 2
    load_kernels()
    resc, ivf = inputs()
    x = torch.ones(1024, device="cuda")
    a = torch.randn(4096, 4096, device="cuda")

    def sandwich():
        y = x * 2
        rescore_topk(*resc)
        return y + 1

    ways = {"alone": lambda: rescore_topk(*resc), "sandwich": sandwich,
            "ivf_scan": lambda: ivf_scan(*ivf, 8, 10)}
    for fn in ways.values():
        fn()
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    for r in range(args.rounds):
        out = {"round": r, "t_s": round(time.perf_counter() - t_start, 1),
               "TEARDOWN_CUPTI": os.environ.get("TEARDOWN_CUPTI")}
        for name, fn in ways.items():
            for spin_ms in args.spin_ms:
                out[f"{name}/spin{spin_ms}"] = [session(fn, spin_ms)
                                                for _ in range(3)]
        print(json.dumps(out), flush=True)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < args.busy_s:
            for _ in range(20):
                a = torch.tanh(a @ a * 1e-3)
            torch.cuda.synchronize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
