"""Where the time of K1's TMA + wgmma body goes, on the card.

Builds copies of tpurag_torch/csrc/dense_topk_sm90.cu with one part of the
body cut out by a textual patch (the library's source has no switch for
it), links each with csrc/dense_topk.cu (the merge pass) and times each at
the main path's dense shapes beside the full body and
torch.topk(q @ emb.T):

  no_mma   the wgmma products (the TMA ring and the fold still run);
  no_tma   the ring's refills (products read the first stages again);
  no_fold  the fold into the running lists;
  mma_only no refills and no fold: the products and the score-tile store.

A copy's results are wrong by design; only its time means anything. A
patch whose anchor is not found once in the source stops the tool, so a
changed kernel cannot be timed as if it were cut. Run on a machine with
the card, from the repository root:

    python tools/k1_anatomy.py
"""

from __future__ import annotations

import ctypes
import pathlib
import statistics
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from tpurag_torch.kernels.dense import sm90_splits  # noqa: E402
from tpurag_torch.kernels.runtime import (CSRC_DIR, NVCC_FLAGS,  # noqa: E402
                                          find_nvcc)

# (anchor in the kernel source, its replacement) for each cut.
NO_MMA = [("wgmma_m64n128k16(acc, da + 2 * kk, db + 2 * kk, ks | kk);", ";")]
NO_TMA = [("mbar_wait(&full[slot], (L / STAGES) & 1);",
           "if (L < STAGES) mbar_wait(&full[slot], (L / STAGES) & 1);"),
          ("if (lane == 0) mbar_arrive(&empty[slot]);\n"
           "      if (threadIdx.x == 0 && L + STAGES < total)",
           "if (false)")]
NO_FOLD = [("tr::warp_fold_row<TN>(", "if (false) tr::warp_fold_row<TN>(")]
PROBES = {"full": [], "no_mma": NO_MMA, "no_tma": NO_TMA, "no_fold": NO_FOLD,
          "mma_only": NO_TMA + NO_FOLD}
# (queries, corpus rows, k): phase 7's request, phase 3's, eval graph's,
# eval ivf_latency's timed exact call and its oracle's call (k=40: lists
# in device memory).
SHAPES = ((512, 1_000_000, 8), (1024, 100_000, 8), (256, 1_000_000, 16),
          (8, 2_111_232, 10), (8, 2_111_232, 40))
DIM = 1024


def patched(patches) -> str:
    src = (CSRC_DIR / "dense_topk_sm90.cu").read_text()
    for old, new in patches:
        if src.count(old) != 1:
            raise RuntimeError(f"anchor found {src.count(old)} times: {old!r}")
        src = src.replace(old, new)
    return src


def build(out: pathlib.Path) -> dict:
    """One shared library per probe, compiled in parallel."""
    nvcc = find_nvcc()
    jobs = {"merge": [nvcc, *NVCC_FLAGS, "-c", str(CSRC_DIR / "dense_topk.cu"),
                      "-o", str(out / "merge.o")]}
    for name, patches in PROBES.items():
        src = out / f"{name}.cu"
        src.write_text(patched(patches))
        jobs[name] = [nvcc, *NVCC_FLAGS, f"-I{CSRC_DIR}", "-c", str(src),
                      "-o", str(out / f"{name}.o")]
    procs = {n: subprocess.Popen(c, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
             for n, c in jobs.items()}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-4000:]}")
    fns = {}
    for name in PROBES:
        so = out / f"lib{name}.so"
        subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(so),
                        str(out / f"{name}.o"), str(out / "merge.o")],
                       check=True)
        fn = ctypes.CDLL(str(so)).tr_dense_topk_sm90
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p] * 5)
        fns[name] = fn
    return fns


def median_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        print("k1_anatomy: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    with tempfile.TemporaryDirectory() as tmp:
        fns = build(pathlib.Path(tmp))
        gen = torch.Generator(device="cuda").manual_seed(0)
        n_max = max(n for _, n, _ in SHAPES)
        emb = torch.randn((n_max, DIM), device="cuda", generator=gen)
        emb = (emb / emb.norm(dim=1, keepdim=True)).bfloat16()
        for b, n, k in SHAPES:
            q = torch.randn((b, DIM), device="cuda", generator=gen).bfloat16()
            s = sm90_splits(b, n, k)
            part_v = torch.empty((b, s, k), device="cuda")
            part_i = torch.empty((b, s, k), device="cuda", dtype=torch.int32)
            out_v = torch.empty((b, k), device="cuda")
            out_i = torch.empty((b, k), device="cuda", dtype=torch.int32)
            stream = torch.cuda.current_stream().cuda_stream
            row = []
            for name, fn in fns.items():
                def launch(fn=fn):
                    err = fn(q.data_ptr(), emb.data_ptr(), b, n_max, DIM, n,
                             k, s, part_v.data_ptr(), part_i.data_ptr(),
                             out_v.data_ptr(), out_i.data_ptr(), stream)
                    assert err == 0, f"{name}: CUDA error {err}"
                row.append(f"{name} {median_ms(launch):.3f}")
            live = emb[:n]
            lib = median_ms(lambda: torch.topk(q @ live.T, k))
            print(f"[K1 anatomy] {b}x{n}x{DIM} k={k}: " + ", ".join(row)
                  + f" ms; torch.topk(q @ emb.T) {lib:.3f} ms ({card})",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
