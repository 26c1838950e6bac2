"""Where the time of K7's Hopper body goes, on the card.

Builds copies of tpurag_torch/csrc/dense_topk_co_sm90.cu with one part of
both forms cut out, or form (ii)'s ring held shallow, by a textual patch (the library's source has no switch
for it), links each with csrc/dense_topk.cu (the merge pass) and times
each at K7's recorded dense shapes, with form (ii)'s query tiles dealt
to 1, 2 and 4 blocks per corpus split where the batch takes that form,
beside K1 as routed, K7's first body and torch.topk(q @ emb.T, k):

  no_mma   the wgmma products (the TMA ring and the fold still run);
  no_tma   the refills: the ring's boxes after the first stages and
           form (ii)'s corpus tiles after the first (products re-read
           them);
  no_fold  the fold into the running lists (form (ii): the check of each
           row against its list too);
  mma_only no refills and no fold: the products (and form (i)'s score-tile
           store);
  ring_3   nothing: form (ii)'s ring held at 3 stages (5 at D = 1024).

A cut copy's results are wrong by design (ring_3's are right); only its
time means anything. A patch whose anchor is not found once in the
source stops the tool, so a changed kernel cannot be timed as if it were
cut. Run on a machine with the card, from the repository root:

    python tools/k7_anatomy.py
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

from tpurag_torch.kernels import dense  # noqa: E402
from tpurag_torch.kernels.runtime import (CSRC_DIR, NVCC_FLAGS,  # noqa: E402
                                          cdiv, find_nvcc)

# (anchor in the kernel source, its replacement) for each cut; each form
# has its own anchor.
NO_MMA = [("wgmma_m64n32k16(acc, da + 2 * kk, db + 2 * kk, ks | kk);", ";"),
          ("wgmma_m64n64k16(acc, da + 2 * kk, db + 2 * kk, ks | kk);", ";")]
NO_TMA = [("mbar_wait(&full[slot], (L / STAGES) & 1);\n      const",
           "if (L < STAGES) mbar_wait(&full[slot], (L / STAGES) & 1);\n"
           "      const"),
          ("if (threadIdx.x == 0 && L + STAGES < total) produce(L + STAGES);",
           ";"),
          # Form (ii): the producer warp issues the first stages' loads and
          # then stops (it no longer waits on the "empty" barriers, which
          # the consumers may run phases past); the consumers wait only
          # for those loads and the first corpus tile.
          ("for (int p = 0; p < total + stages; ++p) {",
           "for (int p = 0; p < min(total, stages); ++p) {"),
          ("mbar_wait(&full[slot], phase);",
           "if (step * per_step + qt * ks_n + ks < stages)\n"
           "          mbar_wait(&full[slot], phase);"),
          ("if (qt == 0) mbar_wait(&c_full[ks], step & 1);",
           "if (qt == 0 && step == 0) mbar_wait(&c_full[ks], 0);")]
NO_FOLD = [("tr::warp_fold_row<F::TN>(sc + r * F::LDS, t * F::TN",
            "if (false) tr::warp_fold_row<F::TN>(sc + r * F::LDS, t * F::TN"),
           # Form (ii) without its fold reads no accumulator, and ptxas
           # would drop the products: keep them live with a sum.
           ("fold_acc(acc, n0, n_valid",
            "float sink = 0.f;\n#pragma unroll\n"
            "      for (int r = 0; r < 32; ++r) sink += acc[r];\n"
            "      if (sink == -1.f) buf[lane] = sink;\n"
            "      if (false) fold_acc(acc, n0, n_valid")]
# Form (ii)'s ring at its least depth, 3 stages (else as many as fit).
RING_3 = [("while (stages < F::MAX_STAGES &&", "while (stages < F::STAGES &&")]
PROBES = {"full": [], "no_mma": NO_MMA, "no_fold": NO_FOLD, "no_tma": NO_TMA,
          "mma_only": NO_TMA + NO_FOLD, "ring_3": RING_3}
# (queries, corpus rows, k): phase 7's request (chip_smoke.py), eval
# hybrid's, eval graph's, eval ivf_latency's timed exact call and its
# oracle's call.
SHAPES = ((512, 1_000_000, 8), (512, 100_000, 8), (256, 1_000_000, 16),
          (8, 2_111_232, 10), (8, 2_111_232, 40))
DIM = 1024
# Form (ii)'s query groups (blocks per corpus split).
GROUPS = (1, 2, 4)


def patched(patches) -> str:
    src = (CSRC_DIR / "dense_topk_co_sm90.cu").read_text()
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
        fn = ctypes.CDLL(str(so)).tr_dense_topk_co_sm90
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 7
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
        print("k7_anatomy: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    with tempfile.TemporaryDirectory() as tmp:
        fns = build(pathlib.Path(tmp))
        device = torch.device("cuda")
        gen = torch.Generator(device="cuda").manual_seed(0)
        n_max = max(n for _, n, _ in SHAPES)
        emb = torch.empty((n_max, DIM), dtype=torch.bfloat16, device="cuda")
        for s in range(0, n_max, 1 << 18):  # unit rows, 256k at a time
            x = torch.randn((min(1 << 18, n_max - s), DIM), device="cuda",
                            generator=gen)
            emb[s:s + len(x)] = (x / x.norm(dim=1, keepdim=True)).bfloat16()
        stream = torch.cuda.current_stream().cuda_stream
        for b, n, k in SHAPES:
            q = torch.randn((b, DIM), device="cuda", generator=gen)
            q = (q / q.norm(dim=1, keepdim=True)).bfloat16()
            form = dense.co_sm90_form(b, DIM)
            rows = dense.CO_FORMS[form][0]
            out_v = torch.empty((b, k), device="cuda")
            out_i = torch.empty((b, k), device="cuda", dtype=torch.int32)
            head = f"[K7 anatomy] {b}x{n}x{DIM} k={k} (form {'i' * form})"
            slots = dense._sm_count(device)
            for grp in sorted({dense.co_sm90_groups(b, form, g)
                               for g in GROUPS}):
                s = dense.co_sm90_splits(cdiv(n, rows), k, slots // grp)
                part_v = torch.empty((b, s, k), device="cuda")
                part_i = torch.empty((b, s, k), device="cuda",
                                     dtype=torch.int32)
                for name, fn in fns.items():
                    def launch(fn=fn, g=grp, s=s, part_v=part_v,
                               part_i=part_i):
                        err = fn(q.data_ptr(), emb.data_ptr(), b, n_max, DIM,
                                 n, k, g, s, part_v.data_ptr(),
                                 part_i.data_ptr(), out_v.data_ptr(),
                                 out_i.data_ptr(), stream)
                        assert err == 0, f"{name}: CUDA error {err}"
                    print(f"{head} G={grp} S={s} (slots {slots}) "
                          f"{name} {median_ms(launch):.3f} ms ({card})",
                          flush=True)
            k1 = median_ms(lambda: dense.dense_topk(q, emb, n, k))
            first = median_ms(lambda: dense._dense_topk_co_first_body(
                q, emb, n, k), iters=3, warmup=1)
            live = emb[:n]
            lib = median_ms(lambda: torch.topk(q @ live.T, k))
            print(f"{head}: K1 {k1:.3f} ms, K7's first body {first:.3f} ms, "
                  f"torch.topk(q @ emb.T) {lib:.3f} ms ({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
