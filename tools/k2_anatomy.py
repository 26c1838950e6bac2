"""Where the time of K2 (csrc/bm25_topk.cu) goes, on the card.

Builds copies of tpurag_torch/csrc/bm25_topk.cu, each with one textual
patch of the source (the library's source has no switch for it), and
times each beside K2's first body (tools/bm25_merge_first.cu, no longer on
any path: the TPU kernel's bitonic network over every lane of rows that
torch code gathers, pads, scales and flips beforehand, one launch per
class) and the plain version:

  stage_only  each row stages its lists and stops (the table, the cuts at
              parked docs, the bulk copies, the packed row max);
  no_merge    the merge tree is skipped (the sums and the top-k run on the
              lists one after the other);
  one_pick    one argmax pass instead of k (the sums still run).

Times are of the launch alone (the table prepared and uploaded once; the
kernel leaves it unchanged), in chains of 10 launches so that the host's
enqueue (tens of microseconds through ctypes) does not set them, and of
the whole wrapper call, the host's table build and the two result
buffers' allocation included (`call`). The first body is timed on rows
gathered beforehand (`first`, its launches alone, chained the same way).

A cut copy's results are wrong by design; only its time means anything. A
patch whose anchor is not found once in the source stops the tool, so a
changed kernel cannot be timed as if it were cut. Inputs, k = 8:
  - a synthetic stand-in for one 1M request's narrow classes: bucket
    matrices of random postings over 1M docs (tools/k3_anatomy.
    bucket_mats), random slots at the class shapes chip_smoke.py's phase
    7 recorded (REQUEST: rows, t, p_max); its live lanes are drawn, so
    their count differs from a recorded request's; unpacked, and packed
    (cbits 11: every doc of 1M fits);
  - phase 4's rows (chip_smoke.merge_rows, b=1024, t=8, p=2048, seed 0)
    through one block class, packed (cbits 14) and unpacked.
Run on a machine with the card, from the repository root:

    python tools/k2_anatomy.py
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

from k3_anatomy import _compile, bucket_mats  # noqa: E402
from tpurag_torch.kernels.bm25_merge import (  # noqa: E402
    _k2_prepare, _k2_run, flip_odd_blocks, merge_segsum_topk_classes_ref,
    slot_rows)
from tpurag_torch.kernels.runtime import CSRC_DIR, cuda_stream  # noqa: E402

FIRST_SOURCE = ROOT / "tools" / "bm25_merge_first.cu"
STAGE_ONLY = [("  sm90::mbar_wait(&bar, 0);\n  __syncthreads();\n",
               "  sm90::mbar_wait(&bar, 0);\n  __syncthreads();\n  return;\n")]
NO_MERGE = [("for (int w = 1; w < t; w <<= 1) {",
             "for (int w = 1; w < 1; w <<= 1) {")]
ONE_PICK = [("for (int pass = 0; pass < k; ++pass) {",
             "for (int pass = 0; pass < 1; ++pass) {")]
PROBES = {"full": [], "stage_only": STAGE_ONLY, "no_merge": NO_MERGE,
          "one_pick": ONE_PICK}
# The narrow classes of one 1M request of chip_smoke.py's phase 7: (rows,
# t, p_max).
REQUEST = ((144, 8, 1024), (108, 8, 2048), (11, 8, 256))
K = 8


def patched(patches) -> str:
    src = (CSRC_DIR / "bm25_topk.cu").read_text()
    for old, new in patches:
        if src.count(old) != 1:
            raise RuntimeError(f"anchor found {src.count(old)} times: {old!r}")
        src = src.replace(old, new)
    return src


def build_first(out: pathlib.Path):
    """The first body's C entry, tr_merge_segsum_topk."""
    out.mkdir(parents=True, exist_ok=True)
    fn = _compile({"k2_first": FIRST_SOURCE},
                  out)["k2_first"].tr_merge_segsum_topk
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p] * 3)
    return fn


def first_fused(out: pathlib.Path):
    """K2''s first body's C entry, tr_bm25_topk_fused, from the library
    that build_first(out) built."""
    fn = ctypes.CDLL(str(out / "libk2_first.so")).tr_bm25_topk_fused
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p] * 3)
    return fn


def first_fused_topk(fn, starts, lens, idf, post_doc, post_impact,
                     n_valid: int, k: int, p_max: int, cbits: int = 0):
    """bm25_topk_fused's arguments (contiguous CUDA tensors, T * p_max <=
    16384) through K2''s first body; returns (out_v, out_i)."""
    b, t = starts.shape
    out_v = torch.empty((b, k), dtype=torch.float32, device=starts.device)
    out_i = torch.empty((b, k), dtype=torch.int32, device=starts.device)
    err = fn(*(x.data_ptr() for x in (starts, lens, idf, post_doc,
                                      post_impact)),
             post_doc.shape[0], int(n_valid), b, t, p_max, cbits, k,
             out_v.data_ptr(), out_i.data_ptr(), cuda_stream(starts.device))
    assert err == 0, f"K2''s first body: CUDA error {err}"
    return out_v, out_i


def first_topk(fn, doc, con, k: int, p: int, t: int, cbits: int):
    """One class's flipped (B, W) candidate rows through the first body;
    returns (out_v, out_i)."""
    b, w = doc.shape
    out_v = torch.empty((b, k), dtype=torch.float32, device=doc.device)
    out_i = torch.empty((b, k), dtype=torch.int32, device=doc.device)
    err = fn(doc.data_ptr(), con.data_ptr(), b, w, p, t, cbits, k,
             out_v.data_ptr(), out_i.data_ptr(), cuda_stream(doc.device))
    assert err == 0, f"first body: CUDA error {err}"
    return out_v, out_i


def first_launches(fn, widths, mats, classes, k: int):
    """The first body's launches (one per class) on rows gathered, scaled
    and flipped beforehand, as index/inverted.py fed it. Returns a function
    that launches them all."""
    rows = []
    for p_max, t, cbits, _, bucketw, rowid, live, idf in classes:
        doc, con = slot_rows(widths, mats, np.asarray(bucketw), rowid, live,
                             idf, p_max, t)
        if t > 1:
            doc = flip_odd_blocks(doc, p_max, t)
            con = flip_odd_blocks(con, p_max, t)
        rows.append((doc.contiguous(), con.contiguous(),
                     p_max if t > 1 else t * p_max, t, cbits))
    return lambda: [first_topk(fn, d, c, k, p, t, cb)
                    for d, c, p, t, cb in rows]


def request_classes(rng, live, cbits: int = 0, n_rows: int = 8):
    """REQUEST's classes over bucket_mats: t slots of widths 16 .. p_max,
    the first at p_max; rows permuted. Returns (classes, h)."""
    h = sum(g for g, _, _ in REQUEST)
    perm = rng.permutation(h)
    classes, at = [], 0
    for g, t, p_max in REQUEST:
        ws = [w for w in live if w <= p_max]
        bucketw = rng.choice(ws, (g, t)).astype(np.int32)
        bucketw[:, 0] = p_max
        rowid = rng.integers(1, n_rows + 1, (g, t)).astype(np.int32)
        lv = np.vectorize(lambda w, r: live[int(w)][int(r)])(bucketw, rowid)
        idf = rng.uniform(0.5, 3.0, (g, t)).astype(np.float32)
        classes.append((p_max, t, cbits, perm[at:at + g], bucketw, rowid,
                        lv.astype(np.int32), idf))
        at += g
    return classes, h


def inputs(widths, mats, live):
    """(label, widths, mats, classes, rows, parked) of each input the tool
    times; parked: the given lanes that hold no doc (phase 4's rows give
    every lane of a block), which the bound does not read."""
    from chip_smoke import BATCH, N_DOCS, merge_rows
    from tpurag_torch.kernels.bm25_merge import block_classes

    out = []
    for cbits in (0, 11):
        classes, h = request_classes(np.random.default_rng(1), live, cbits)
        out.append(("1M stand-in ("
                    + ", ".join(f"{g}x{t}x{p}" for g, t, p in REQUEST)
                    + f"), cbits={cbits}", widths, mats, classes, h, 0))
    doc, con = (torch.from_numpy(x).cuda() for x in merge_rows(
        np.random.default_rng(0), BATCH, 8, 2048, N_DOCS, flip=False))
    for cbits in (14, 0):
        w, m, spec = block_classes(doc, con, 2048, 8, cbits)
        out.append((f"phase 4 b={BATCH} t=8 p=2048, cbits={cbits}", w, m,
                    [spec], BATCH, int((doc >= 2**30).sum())))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("k2_anatomy: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    from chip_smoke import cuda_ms, k2_bytes

    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as tmp:
        out = pathlib.Path(tmp)
        jobs = {}
        for name, patches in PROBES.items():
            jobs[name] = out / f"{name}.cu"
            jobs[name].write_text(patched(patches))
        libs = _compile(jobs, out)
        first = build_first(out)
        for label, widths, mats, classes, h, parked in inputs(
                *bucket_mats(rng)):

            def buffers():
                return (torch.full((h, K), -3.0e38, device="cuda"),
                        torch.full((h, K), -1, dtype=torch.int32,
                                   device="cuda"))

            want = merge_segsum_topk_classes_ref(widths, mats, classes,
                                                 *buffers())
            row = []
            for name, lib in libs.items():
                got = buffers()
                prep = _k2_prepare(widths, mats, classes, *got)
                fn = lib.tr_topk_rows

                def launch(fn=fn, prep=prep):
                    err = _k2_run(fn, prep)
                    assert err == 0, f"{name}: CUDA error {err}"
                launch()
                if name == "full":
                    torch.cuda.synchronize()
                    assert all(torch.equal(g, w) for g, w in zip(got, want))
                row.append(f"{name} {cuda_ms(launch, chain=10):.3f}")

            def call():
                _k2_run(libs["full"].tr_topk_rows,
                        _k2_prepare(widths, mats, classes, *buffers()))
            row.append(f"call {cuda_ms(call):.3f}")
            old = cuda_ms(first_launches(first, widths, mats, classes, K),
                          chain=10)
            plain = cuda_ms(lambda: merge_segsum_topk_classes_ref(
                widths, mats, classes, *buffers()), iters=3, warmup=1)
            nbytes, n_live = k2_bytes(classes, h, K)
            nbytes, n_live = nbytes - 8 * parked, n_live - parked
            print(f"[K2 anatomy] {label}, k={K}: {n_live} live lanes (bound "
                  f"{nbytes / 3.35e9:.4f} ms, bytes); " + ", ".join(row)
                  + f" ms; first body ({len(classes)} launches) {old:.3f} "
                  f"ms; plain {plain:.3f} ms ({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
