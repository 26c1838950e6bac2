"""Where the time of K4 (csrc/bm25_combine.cu) goes, on the card.

Builds copies of tpurag_torch/csrc/bm25_combine.cu, each with one textual
patch of the source (the library's source has no switch for it), and
times each beside K4's first body (tools/bm25_combine_first.cu, no
longer on any path: one block per row, one launch per wide class, binary
searches in device memory) and the plain version:

  no_join       the merge-path walk cut: rows staged, nothing joined (the
                stream and the searches alone);
  no_item_topk  the join runs, but no candidate enters a warp list;
  no_row_merge  each row's last item skips the merge of the row's lists;
  chunkN        work items of N wide lanes (the source's CHUNK is 4096);
  ntileN        narrow tiles of N lanes (the source's NTILE is 2048; the
                fewer, the less shared memory a block takes);
  threadsN      N threads a block (the source's THREADS is 256).

Times are of the launch alone (the table prepared and uploaded once, as
the kernel leaves it reusable), and of the whole wrapper call, the host's
table build included (`call`).

A cut copy's results are wrong by design; only its time means anything
(the chunk variants compute the same function, and are checked). A patch
whose anchor is not found once in the source stops the tool, so a changed
kernel cannot be timed as if it were cut. Inputs: one 1M request's wide
classes as phase 7 of chip_smoke.py recorded them (12 classes, 249 rows,
Ww 4096 .. 131072, narrow rows of 16384 lanes, each member's own narrow
width 2048 .. 16384), and 64 rows of 16384 + 131072 lanes, both full-row
merges of random postings over 1M docs. Run on a machine with the card,
from the repository root:

    python tools/k4_anatomy.py
"""

from __future__ import annotations

import ctypes
import pathlib
import statistics
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from tpurag_torch.kernels.bm25_join import (  # noqa: E402
    _K4_CHUNK, _k4_prepare, _k4_run, _members, combine_classes_ref)
from tpurag_torch.kernels.bm25_merge import merge_segsum_full_ref  # noqa: E402
from tpurag_torch.kernels.runtime import (CSRC_DIR, NVCC_FLAGS,  # noqa: E402
                                          cuda_stream, find_nvcc)

FIRST_SOURCE = ROOT / "tools" / "bm25_combine_first.cu"
CHUNK = "constexpr int CHUNK = 4096;"
NO_JOIN = [("const int steps = (n + THREADS - 1) / THREADS;",
            "const int steps = 0;")]
NO_ITEM_TOPK = [("        tr::warp_key_offer(has, key, my_list, k, kth);",
                 "        if (has && key == 1ull) my_list[0] = key;")]
NO_ROW_MERGE = [("  if (!s_last) return;", "  return;")]


NTILE = "constexpr int NTILE = 2048;"
THREADS = "constexpr int THREADS = 256;"


def chunk(n: int):
    return [(CHUNK, CHUNK.replace("4096", str(n)))]


def ntile(n: int):
    return [(NTILE, NTILE.replace("2048", str(n)))]


def threads(n: int):
    return [(THREADS, THREADS.replace("256", str(n)))]


PROBES = {"full": [], "no_join": NO_JOIN, "no_item_topk": NO_ITEM_TOPK,
          "no_row_merge": NO_ROW_MERGE, "chunk2048": chunk(2048),
          "chunk8192": chunk(8192), "ntile1024": ntile(1024),
          "ntile4096": ntile(4096), "threads128": threads(128),
          "threads128_ntile1024": threads(128) + ntile(1024)}
CHUNK_OF = {"chunk2048": 2048, "chunk8192": 8192}
# One 1M request of chip_smoke.py's phase 7 as it was recorded: (rows, Ww)
# per wide class, narrow rows of 16384 lanes.
REQUEST = ((76, 4096), (3, 131072), (18, 32768), (18, 65536), (6, 65536),
           (35, 16384), (45, 8192), (17, 32768), (14, 8192), (13, 16384),
           (2, 16384), (2, 32768))
WN_MAX = 16384
N_DOCS = 1_000_000


def patched(patches) -> str:
    src = (CSRC_DIR / "bm25_combine.cu").read_text()
    for old, new in patches:
        if src.count(old) != 1:
            raise RuntimeError(f"anchor found {src.count(old)} times: {old!r}")
        src = src.replace(old, new)
    return src


def _compile(jobs: dict, out: pathlib.Path) -> dict:
    """{name: source path} -> {name: loaded CDLL}, nvcc runs in parallel."""
    nvcc = find_nvcc()
    procs = {n: subprocess.Popen(
        [nvcc, *NVCC_FLAGS, f"-I{CSRC_DIR}", "-shared", str(src), "-o",
         str(out / f"lib{n}.so")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for n, src in jobs.items()}
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-4000:]}")
        libs[name] = ctypes.CDLL(str(out / f"lib{name}.so"))
    return libs


def build_first(out: pathlib.Path):
    """The first body's C entry, tr_combine_topk."""
    out.mkdir(parents=True, exist_ok=True)
    fn = _compile({"k4_first": FIRST_SOURCE}, out)["k4_first"].tr_combine_topk
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p] * 5)
    return fn


def first_combine(fn, n_val, n_doc, w_seg, w_doc, k: int):
    """One wide class through the first body (its wrapper as it was)."""
    g, wn = n_val.shape
    ww = w_seg.shape[1]
    dev = n_val.device
    out_v = torch.empty((g, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((g, k), dtype=torch.int32, device=dev)
    list_v = torch.empty((g, 32, k), dtype=torch.float32, device=dev)
    list_i = torch.empty((g, 32, k), dtype=torch.int32, device=dev)
    err = fn(n_val.data_ptr(), n_doc.data_ptr(), g, wn, w_seg.data_ptr(),
             w_doc.data_ptr(), ww, k, list_v.data_ptr(), list_i.data_ptr(),
             out_v.data_ptr(), out_i.data_ptr(), cuda_stream(dev))
    assert err == 0, f"first body: CUDA error {err}"
    return out_v, out_i


def first_classes(fn, n_val, n_doc, classes, k: int):
    """The first body's flow on pre-gathered narrow rows: one launch per
    class. Returns a function that launches them all."""
    args = []
    for w_seg, w_doc, sel, _ in classes:
        rows = torch.as_tensor(_members(sel, w_seg.shape[0]),
                               device=n_val.device)
        args.append((n_val[rows].contiguous(), n_doc[rows].contiguous(),
                     w_seg, w_doc))
    return lambda: [first_combine(fn, *a, k) for a in args]


def full_rows(rng, g: int, w: int, t: int):
    """(g, w) full rows on the card: full-row merges of t random
    doc-sorted term slots of w / t postings over N_DOCS docs."""
    from chip_smoke import merge_rows

    doc, con = (torch.from_numpy(x).cuda() for x in merge_rows(
        rng, g, t, w // t, N_DOCS, flip=False))
    seg, doc_s = merge_segsum_full_ref(doc, con, w // t, t)
    return seg.contiguous(), doc_s.contiguous()


def request_inputs(seed: int = 0):
    """(n_val, n_doc, classes, window) at REQUEST's shapes."""
    rng = np.random.default_rng(seed)
    h = sum(g for g, _ in REQUEST)
    own = rng.choice([2048, 4096, 8192, 16384], h)
    n_val = torch.full((h, WN_MAX), -3.0e38, device="cuda")
    n_doc = torch.full((h, WN_MAX), 2**30, dtype=torch.int32, device="cuda")
    for w in np.unique(own):
        rows = np.flatnonzero(own == w)
        seg, doc_s = full_rows(rng, len(rows), int(w), 8)
        idx = torch.as_tensor(rows, device="cuda")
        n_val[idx, :w] = seg
        n_doc[idx, :w] = doc_s
    perm = rng.permutation(h)
    classes, at = [], 0
    for g, ww in REQUEST:
        t = max(1, min(4, ww // 16384))
        sel = perm[at:at + g]
        classes.append((*full_rows(rng, g, ww, t), sel, own[sel]))
        at += g
    return n_val, n_doc, classes, 12


def wide64_inputs(seed: int = 1):
    """64 rows of 16384 narrow + 131072 wide lanes (phase 4c's shape)."""
    rng = np.random.default_rng(seed)
    n_val, n_doc = full_rows(rng, 64, WN_MAX, 8)
    w_seg, w_doc = full_rows(rng, 64, 131072, 4)
    return n_val, n_doc, [(w_seg, w_doc, None, None)], 12


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
        print("k4_anatomy: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    with tempfile.TemporaryDirectory() as tmp:
        out = pathlib.Path(tmp)
        jobs = {}
        for name, patches in PROBES.items():
            jobs[name] = out / f"{name}.cu"
            jobs[name].write_text(patched(patches))
        libs = _compile(jobs, out)
        fns = {n: lib.tr_combine_topk_classes for n, lib in libs.items()}
        first = build_first(out)
        for label, make in (("1M request", request_inputs),
                            ("g=64 16384+131072", wide64_inputs)):
            n_val, n_doc, classes, window = make()
            k = 8
            v_r, i_r = combine_classes_ref(n_val, n_doc, classes, k, window)
            row = []
            for name, fn in fns.items():
                prep = _k4_prepare(n_val, classes, k,
                                   CHUNK_OF.get(name, _K4_CHUNK))

                def launch(fn=fn, prep=prep):
                    err = _k4_run(fn, prep, n_val, n_doc)
                    assert err == 0, f"{name}: CUDA error {err}"
                launch()
                if not name.startswith("no_"):  # the same function
                    torch.cuda.synchronize()
                    assert torch.equal(prep["out_i"], i_r), name
                    assert torch.equal(prep["out_v"], v_r), name
                row.append(f"{name} {median_ms(launch):.3f}")

            def call():
                prep = _k4_prepare(n_val, classes, k)
                _k4_run(fns["full"], prep, n_val, n_doc)
            row.append(f"call {median_ms(call):.3f}")
            old = median_ms(first_classes(first, n_val, n_doc, classes, k))
            plain = median_ms(lambda: combine_classes_ref(
                n_val, n_doc, classes, k, window), iters=3, warmup=1)
            n_items = sum(-(-w.shape[1] // _K4_CHUNK) * w.shape[0]
                          for w, *_ in classes)
            print(f"[K4 anatomy] {label}: {len(classes)} classes, "
                  f"{n_val.shape[0]} rows, C = {_K4_CHUNK}, {n_items} items; "
                  + ", ".join(row) + f" ms; first body ({len(classes)} "
                  f"launches) {old:.3f} ms; plain {plain:.3f} ms ({card})",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
