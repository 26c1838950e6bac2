"""Where the time of K5's TMA + int8 wgmma body goes, on the card.

Builds copies of tpurag_torch/csrc/dense_topk_q8_sm90.cu, each with one
textual patch of the source (the library's source has no switch for it),
links each with csrc/dense_topk.cu (the merge pass) and times each at the
main path's int8 shapes beside the first body (the int8 form of
csrc/dense_topk.cu, as the library builds it) and torch._int_mm(q8,
e8.T) followed by the row scale and topk:

  stagesN  the ring at depth N (the source's is 4; at 32 queries only:
           the 128-query tile's deeper rings do not fit);
  no_mma   the wgmma products (the TMA ring and the fold still run);
  no_fold  the fold into the running lists;
  stream   no products and no fold: the ring's corpus stream alone
           (streamN: at depth N).

A cut copy's results are wrong by design; only its time means anything
(the depth variants compute the same function). A patch whose anchor is
not found once in the source stops the tool, so a changed kernel cannot be
timed as if it were cut. Run on a machine with the card, from the
repository root:

    python tools/k5_anatomy.py
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
from tpurag_torch.kernels.quant import (  # noqa: E402
    _dense_scan_q8_first_body, q8_sm90_tile, quantize_rows)
from tpurag_torch.kernels.runtime import (CSRC_DIR, NVCC_FLAGS,  # noqa: E402
                                          find_nvcc)

# (anchor in the kernel source, its replacement) for each probe.
DEPTH = "constexpr int STAGES = 4;"
NO_MMA = [("wgmma_s8(acc, da + 2 * kk, db + 2 * kk, ks | kk);", ";")]
NO_FOLD = [("tr::warp_fold_row<TN>(", "if (false) tr::warp_fold_row<TN>(")]


def depth(n: int):
    return [(DEPTH, DEPTH.replace("4", str(n)))]


DEPTHS = ("stages6", "stages8", "stages10", "stream8", "stream10")
PROBES = {"full": [], "stages6": depth(6), "stages8": depth(8),
          "stages10": depth(10), "no_mma": NO_MMA, "no_fold": NO_FOLD,
          "stream": NO_MMA + NO_FOLD, "stream8": NO_MMA + NO_FOLD + depth(8),
          "stream10": NO_MMA + NO_FOLD + depth(10)}
# (queries, corpus rows, k): a hybrid request on phase 8's 1M quant KB
# (top_k 10, overfetched to 20), 512 queries at k=8 (phase 7's batch), and
# the batches either side of the tiles' edge (8: a quarter of the 32-query
# tile; 64: half the 128-query one), where the route must still win.
SHAPES = ((32, 1_000_000, 20), (512, 1_000_000, 8), (8, 1_000_000, 20),
          (64, 1_000_000, 20))
DIM = 1024


def patched(patches) -> str:
    src = (CSRC_DIR / "dense_topk_q8_sm90.cu").read_text()
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
        fn = ctypes.CDLL(str(so)).tr_dense_topk_q8_sm90
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
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
        print("k5_anatomy: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    with tempfile.TemporaryDirectory() as tmp:
        fns = build(pathlib.Path(tmp))
        gen = torch.Generator(device="cuda").manual_seed(0)
        n_max = max(n for _, n, _ in SHAPES)
        e8 = torch.empty((n_max, DIM), dtype=torch.int8, device="cuda")
        es = torch.empty((n_max,), device="cuda")
        for s in range(0, n_max, 1 << 17):  # unit rows, 128k at a time
            x = torch.randn((min(1 << 17, n_max - s), DIM), device="cuda",
                            generator=gen)
            e8[s:s + len(x)], es[s:s + len(x)] = quantize_rows(
                x / x.norm(dim=1, keepdim=True))
        for b, n, k in SHAPES:
            q = torch.randn((b, DIM), device="cuda", generator=gen)
            q8, qs = quantize_rows(q / q.norm(dim=1, keepdim=True))
            s = sm90_splits(b, n, k)
            tile = q8_sm90_tile(b, DIM)
            part_v = torch.empty((b, s, k), device="cuda")
            part_i = torch.empty((b, s, k), device="cuda", dtype=torch.int32)
            out_v = torch.empty((b, k), device="cuda")
            out_i = torch.empty((b, k), device="cuda", dtype=torch.int32)
            stream = torch.cuda.current_stream().cuda_stream
            row = []
            for name, fn in fns.items():
                if tile != 32 and name in DEPTHS:
                    continue
                def launch(fn=fn):
                    err = fn(q8.data_ptr(), e8.data_ptr(), es.data_ptr(), b,
                             n_max, DIM, n, k, tile, s, part_v.data_ptr(),
                             part_i.data_ptr(), out_v.data_ptr(),
                             out_i.data_ptr(), stream)
                    assert err == 0, f"{name}: CUDA error {err}"
                row.append(f"{name} {median_ms(launch):.3f}")
            first = median_ms(lambda: _dense_scan_q8_first_body(
                q8, qs, e8, es, n, k))
            live, scale = e8[:n], es[:n]

            def int_mm():
                return torch.topk(torch._int_mm(q8, live.T).float() * scale,
                                  k)

            # torch._int_mm takes more than 16 rows.
            lib = f"{median_ms(int_mm):.3f} ms" if b > 16 else "not measured"
            print(f"[K5 anatomy] {b}x{n}x{DIM} int8 k={k} (tile {tile}, "
                  f"{s} splits): " + ", ".join(row) + f" ms; first body "
                  f"{first:.3f} ms; torch._int_mm + scale + topk {lib} "
                  f"({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
