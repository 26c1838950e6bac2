"""Where the time of K2' (csrc/bm25_merge.cu) goes, on the card.

Builds copies of tpurag_torch/csrc/bm25_merge.cu, each with one textual
patch of the source (the library's source has no switch for it), and
times each beside K2''s first body (tools/bm25_merge_first.cu: the full
network over every lane of every row):

  full        the source as it is;
  one_block   always the build without a register cap (one 1024-thread
              block an SM), past the SM count too;
  two_blocks  always the build for two blocks an SM (32 registers a
              thread), at or under the SM count too;
  topk_smem   warp 0's top-k reads the positive sums from shared memory
              every pass, never from registers;
  no_network  the live-lane route skips the network (sums and top-k run
              on the row as loaded);
  no_topk     the live-lane route skips the top-k (its result is not
              written);
  load_only   the live-lane route stops once its live lanes are listed.

Inputs: eval `hybrid`'s step (tpurag_torch/eval/bench.hybrid_inputs, 512
rows x T = 8 x p_max = 2048, packed, ~168 live lanes a row: the live-lane
route), and rows whose every lane is live (chip_smoke.fused_case "full":
the full route) at b = 16 and 512, packed and unpacked. Times are of the
launch alone, through ctypes with no wrapper around it, in chains of 10
launches (CUDA events, median of 10), so the host's enqueue does not set
them; each probe runs three times in turn with the others.

A cut copy's results are wrong by design (one_block's, two_blocks' and
topk_smem's are right); only its time means anything. A patch whose
anchor is not found once in the source stops the tool, so a changed
kernel cannot be timed as if it were cut. Run on a machine with the card,
from the repository root:

    python tools/k2f_anatomy.py
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sys
import tempfile

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from tpurag_torch.kernels.runtime import (CSRC_DIR, NVCC_FLAGS,  # noqa: E402
                                          cuda_stream, find_nvcc)

SOURCE = CSRC_DIR / "bm25_merge.cu"
FIRST_SOURCE = ROOT / "tools" / "bm25_merge_first.cu"
PROBES = {
    "full": [],
    "one_block": [("return fit >= 2 ? launch<PACKED, 2>",
                   "return false ? launch<PACKED, 2>")],
    "two_blocks": [("return fit >= 2 ? launch<PACKED, 2>",
                    "return true ? launch<PACKED, 2>")],
    "topk_smem": [("const bool in_regs = nc <= 32 * CAND_REGS;",
                   "const bool in_regs = false;")],
    "no_network": [("  live_network<PACKED>(key, cs, pos, RL, W, 2 * p, "
                    "threads);\n", "")],
    "no_topk": [("  if (warp == 0) warp_topk(cand_v, cand_d, sc.n_cand, k, "
                 "ov, oi);\n", "")],
    "load_only": [("  const int n = sc.n_live;\n",
                   "  const int n = sc.n_live;\n  if (n >= 0) return;\n")],
}
CHAIN = 10


def patched(patches) -> str:
    src = SOURCE.read_text()
    for old, new in patches:
        if src.count(old) != 1:
            raise RuntimeError(f"anchor found {src.count(old)} times: {old!r}")
        src = src.replace(old, new)
    return src


def build(out: pathlib.Path) -> dict:
    """{probe or "first": tr_bm25_topk_fused of its library}, nvcc runs in
    parallel."""
    jobs = {name: out / f"{name}.cu" for name in PROBES}
    for name, path in jobs.items():
        path.write_text(patched(PROBES[name]))
    jobs["first"] = FIRST_SOURCE
    procs = {n: subprocess.Popen(
        [find_nvcc(), *NVCC_FLAGS, f"-I{CSRC_DIR}", "-shared", str(src), "-o",
         str(out / f"lib{n}.so")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for n, src in jobs.items()}
    fns = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-4000:]}")
        fn = ctypes.CDLL(str(out / f"lib{name}.so")).tr_bm25_topk_fused
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p] * 3)
        fns[name] = fn
    return fns


def chain_ms(fn, args, n_valid: int, p_max: int, cbits: int,
             k: int = 8) -> float:
    """Median ms of one launch in chains of CHAIN launches."""
    import chip_smoke

    b, t = args[0].shape
    out_v = torch.empty((b, k), dtype=torch.float32, device="cuda")
    out_i = torch.empty((b, k), dtype=torch.int32, device="cuda")
    ptrs = [x.data_ptr() for x in args]
    stream = cuda_stream(out_v.device)

    def launch():
        err = fn(*ptrs, args[3].shape[0], n_valid, b, t, p_max, cbits, k,
                 out_v.data_ptr(), out_i.data_ptr(), stream)
        assert err == 0, f"CUDA error {err}"

    return chip_smoke.cuda_ms(launch, chain=CHAIN)


def inputs() -> list:
    """[(label, tensors, n_valid, p_max, cbits)]: the eval step's call and
    the fully live rows."""
    import chip_smoke
    from tpurag_torch.eval import bench

    x = bench.hybrid_inputs(device="cuda")
    cases = [("eval step 512x8x2048 packed",
              [x[n] for n in ("starts", "lens", "idf", "post_doc",
                              "post_impact")], x["n_valid"], x["p_max"],
              x["cbits"])]
    for b in (16, 512):
        *arrays, n_valid, p_max = chip_smoke.fused_case("full", seed=b, b=b)
        tensors = [torch.from_numpy(a).cuda() for a in arrays]
        for cbits in (x["cbits"], 0):
            cases.append((f"every lane live b={b} "
                          f"{'packed' if cbits else 'unpacked'}", tensors,
                          n_valid, p_max, cbits))
    return cases


def main() -> int:
    if not torch.cuda.is_available():
        print("k2f_anatomy: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    with tempfile.TemporaryDirectory() as tmp:
        fns = build(pathlib.Path(tmp))
        cases = inputs()
        times = {name: {label: [] for label, *_ in cases} for name in fns}
        for _ in range(3):
            for name, fn in fns.items():
                for label, args, n_valid, p_max, cbits in cases:
                    times[name][label].append(
                        chain_ms(fn, args, n_valid, p_max, cbits))
    print(f"K2' in chains of {CHAIN} launches, ms a launch (three runs, in "
          f"turn) ({card})")
    for label, *_ in cases:
        print(f"{label}:")
        for name in fns:
            print(f"  {name:>10} " + " ".join(
                f"{ms:.4f}" for ms in times[name][label]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
