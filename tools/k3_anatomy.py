"""Where the time of K3 (csrc/bm25_full.cu) goes, on the card.

Builds copies of tpurag_torch/csrc/bm25_full.cu, each with one textual
patch of the source (the library's source has no switch for it), and
times each beside K3's first body (tools/bm25_full_first.cu, no longer on
any path: a bitonic network per class, one block per row up to 16384
lanes, a chain of launches over device-memory scratch past it, fed by
rows that torch code gathers from the bucket matrices) and the plain
version:

  search_only  each item finds its splits and stops (descriptors, live
               lanes, the parked tail written, the two split searches);
  no_merge     the lists staged as well, then the item stops (search and
               staging alone);
  no_sums      the merge runs, but each segment-end lane takes its own
               contribution without the walk back over the doc's lanes;
  chunkN       work items of N output lanes (the source's CHUNK is 4096).

Times are of the launch alone (the table prepared and uploaded once; the
kernel leaves it unchanged), and of the whole wrapper call, the host's
table build included (`call`). The first body is timed on rows gathered
beforehand (`first`, its launches alone) and as the flow it replaced
(`first flow`: the per-class gather, pageable input copies, launches and
the narrow rows' scatter).

A cut copy's results are wrong by design; only its time means anything
(the chunk variants compute the same function, and are checked). A patch
whose anchor is not found once in the source stops the tool, so a changed
kernel cannot be timed as if it were cut. Inputs: bucket matrices of
random postings over 1M docs, and one 1M request's classes at the shapes
chip_smoke.py's phase 7 recorded (K4's REQUEST: 12 wide classes, 249 rows,
W 4096 .. 131072; narrow rows of 2048 .. 16384 lanes, p_max 2048). Run on
a machine with the card, from the repository root:

    python tools/k3_anatomy.py
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

from tpurag_torch.kernels.bm25_merge import (  # noqa: E402
    _K3_CHUNK, _k3_prepare, _k3_run, merge_segsum_full_classes_ref, slot_rows)
from tpurag_torch.kernels.runtime import (CSRC_DIR, NVCC_FLAGS,  # noqa: E402
                                          cuda_stream, find_nvcc)

FIRST_SOURCE = ROOT / "tools" / "bm25_full_first.cu"
CHUNK = "constexpr int CHUNK = 4096;"
SEARCH_ONLY = [("  // 3. Staging: list s's lanes [lo, b + (b < m)) at "
                "stage_off[s].\n", "  return;\n")]
NO_MERGE = [("  sm90::mbar_wait(&bar, 0);\n  __syncthreads();\n",
             "  sm90::mbar_wait(&bar, 0);\n  __syncthreads();\n  return;\n")]
NO_SUMS = [("for (int j = 1; j < t && j <= x && cur_doc[x - j] == d; ++j)",
            "for (int j = 1; j < 1; ++j)")]


def chunk(n: int):
    return [(CHUNK, CHUNK.replace("4096", str(n)))]


PROBES = {"full": [], "search_only": SEARCH_ONLY, "no_merge": NO_MERGE,
          "no_sums": NO_SUMS, "chunk2048": chunk(2048),
          "chunk8192": chunk(8192)}
CHUNK_OF = {"chunk2048": 2048, "chunk8192": 8192}
# One 1M request of chip_smoke.py's phase 7 (tools/k4_anatomy.REQUEST):
# (rows, W) per wide class; t = 1 up to 16384 lanes, 2 at 32768, else 4.
REQUEST = ((76, 4096), (3, 131072), (18, 32768), (18, 65536), (6, 65536),
           (35, 16384), (45, 8192), (17, 32768), (14, 8192), (13, 16384),
           (2, 16384), (2, 32768))
WN_MAX = 16384
N_DOCS = 1_000_000
NARROW_P = 2048


def patched(patches) -> str:
    src = (CSRC_DIR / "bm25_full.cu").read_text()
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
    """The first body's C entry, tr_merge_segsum_full."""
    out.mkdir(parents=True, exist_ok=True)
    fn = _compile({"k3_first": FIRST_SOURCE},
                  out)["k3_first"].tr_merge_segsum_full
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p] * 6)
    return fn


def first_full(fn, doc, con, p: int, t: int, cbits: int):
    """One class's (B, W) rows through the first body (its wrapper as it
    was; t == 1 launches nothing)."""
    if t == 1:
        return torch.where(doc < 2**30, con, -3.0e38), doc
    b, w = doc.shape
    dev = doc.device
    seg = torch.empty((b, w), dtype=torch.float32, device=dev)
    doc_s = torch.empty((b, w), dtype=torch.int32, device=dev)
    scratch = [None, None, None]
    if w > 16384:
        scratch[0] = torch.empty((b, w), dtype=torch.int32, device=dev)
        if cbits:
            scratch[2] = torch.empty((b,), dtype=torch.float32, device=dev)
        else:
            scratch[1] = torch.empty((b, w), dtype=torch.float32, device=dev)
    err = fn(doc.data_ptr(), con.data_ptr(), b, w, p, t, cbits,
             seg.data_ptr(), doc_s.data_ptr(),
             *(0 if x is None else x.data_ptr() for x in scratch),
             cuda_stream(dev))
    assert err == 0, f"first body: CUDA error {err}"
    return seg, doc_s


def first_launches(fn, widths, mats, narrow, wide, h: int, wn_max: int):
    """The first body's launches on rows gathered beforehand (one per class
    with t > 1). Returns a function that launches them all."""
    rows = []
    for p_max, t, cbits, _, bucketw, rowid, live, idf in [*narrow, *wide]:
        doc, con = slot_rows(widths, mats, np.asarray(bucketw), rowid, live,
                             idf, p_max, t)
        rows.append((doc.contiguous(), con.contiguous(), p_max, t, cbits))
    return lambda: [first_full(fn, *r) for r in rows]


def first_flow(fn, widths, mats, narrow, wide, h: int, wn_max: int):
    """The flow the first body ran in (index/inverted.py before K3 took the
    gather in): per class, pageable copies of the slot arrays, the row
    gather (slot_rows, the plain version's, as index/inverted._assemble
    did it), the first body, and the narrow rows' scatter into (h, wn_max)
    buffers."""
    dev = mats[0][0].device

    def run():
        n_val = torch.full((h, wn_max), -3.0e38, device=dev)
        n_doc = torch.full((h, wn_max), 2**30, dtype=torch.int32, device=dev)
        for i, cls in enumerate([*narrow, *wide]):
            p_max, t, cbits, sel, bucketw, rowid, live, idf = cls
            doc, con = slot_rows(widths, mats, np.asarray(bucketw), rowid,
                                 live, idf, p_max, t)
            g = doc.shape[0]
            seg, doc_s = first_full(fn, doc.reshape(g, -1).contiguous(),
                                    con.reshape(g, -1).contiguous(), p_max,
                                    t, cbits)
            if i < len(narrow):
                sel_t = torch.as_tensor(sel, device=dev)
                n_val[sel_t, :seg.shape[1]] = seg
                n_doc[sel_t, :seg.shape[1]] = doc_s
    return run


def bucket_mats(rng, n_rows: int = 8, device="cuda"):
    """Bucket matrices of widths 16 .. 32768 (n_rows term rows each, as
    index/inverted.py lays them out: row 0 the pad row, each row's docs
    sorted, (w/2, w] of them) on `device`, and each row's live lanes."""
    widths = tuple(1 << i for i in range(4, 16))
    mats, live = [], {}
    for w in widths:
        doc = np.full((n_rows + 1, w), 2**30, np.int32)
        imp = np.zeros((n_rows + 1, w), np.float32)
        live[w] = np.zeros(n_rows + 1, np.int32)
        for r in range(1, n_rows + 1):
            m = int(rng.integers(w // 2 + 1, w + 1))
            doc[r, :m] = np.sort(rng.choice(N_DOCS, m, replace=False))
            imp[r, :m] = rng.uniform(0.2, 2.0, m)
            live[w][r] = m
        mats.append((torch.from_numpy(doc).to(device),
                     torch.from_numpy(imp).to(device)))
    return widths, tuple(mats), live


def request_classes(rng, live, n_rows: int = 8):
    """REQUEST's classes over bucket_mats: narrow rows of t = 1 .. 8 slots
    at p_max 2048 (slot widths 16 .. 2048), wide classes of t slots whose
    first takes the class's width p_max and the rest widths 4096 .. p_max;
    rows permuted."""
    h = sum(g for g, _ in REQUEST)
    t_of = rng.choice([1, 2, 4, 8], h)

    def cls(p_max, t, g, sel, lo):
        ws = [w for w in live if lo <= w <= p_max]
        bucketw = rng.choice(ws, (g, t)).astype(np.int32)
        if lo > 16:
            bucketw[:, 0] = p_max
        rowid = rng.integers(1, n_rows + 1, (g, t)).astype(np.int32)
        lv = np.vectorize(lambda w, r: live[int(w)][int(r)])(bucketw, rowid)
        idf = rng.uniform(0.5, 3.0, (g, t)).astype(np.float32)
        return (p_max, t, 0, sel, bucketw, rowid, lv.astype(np.int32), idf)

    perm = rng.permutation(h)
    narrow = [cls(NARROW_P, int(t), int((t_of == t).sum()),
                  perm[np.flatnonzero(t_of == t)], 16)
              for t in (1, 2, 4, 8) if (t_of == t).any()]
    wide = []
    for g, w in REQUEST:
        t = 1 if w <= 16384 else 2 if w == 32768 else 4
        wide.append(cls(w // t, t, g, None, 4096))
    return narrow, wide, h


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
        print("k3_anatomy: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    from chip_smoke import k3_bytes

    rng = np.random.default_rng(0)
    widths, mats, live = bucket_mats(rng)
    narrow, wide, h = request_classes(rng, live)
    args = (widths, mats, narrow, wide, h, WN_MAX)
    with tempfile.TemporaryDirectory() as tmp:
        out = pathlib.Path(tmp)
        jobs = {}
        for name, patches in PROBES.items():
            jobs[name] = out / f"{name}.cu"
            jobs[name].write_text(patched(patches))
        libs = _compile(jobs, out)
        first = build_first(out)
        want = merge_segsum_full_classes_ref(*args)
        want = [want[0], want[1], *[x for pair in want[2] for x in pair]]
        row = []
        for name, lib in libs.items():
            prep = _k3_prepare(*args, chunk=CHUNK_OF.get(name, _K3_CHUNK))
            fn = lib.tr_full_rows

            def launch(fn=fn, prep=prep):
                err = _k3_run(fn, prep)
                assert err == 0, f"{name}: CUDA error {err}"
            launch()
            if name == "full" or name in CHUNK_OF:  # the same function
                torch.cuda.synchronize()
                got = [prep["n_val"], prep["n_doc"],
                       *[x for pair in prep["wide"] for x in pair]]
                assert all(torch.equal(g, w) for g, w in zip(got, want)), name
            row.append(f"{name} {median_ms(launch):.3f}")

        def call():
            _k3_run(libs["full"].tr_full_rows, _k3_prepare(*args))
        row.append(f"call {median_ms(call):.3f}")
        old = median_ms(first_launches(first, *args))
        flow = median_ms(first_flow(first, *args))
        plain = median_ms(lambda: merge_segsum_full_classes_ref(*args),
                          iters=3, warmup=1)
        prep = _k3_prepare(*args)
        nbytes, live, out = k3_bytes(args)
        print(f"[K3 anatomy] 1M request: {len(narrow)} narrow and "
              f"{len(wide)} wide classes, {h} + "
              f"{sum(len(c[4]) for c in wide)} rows, C = {_K3_CHUNK}, "
              f"{prep['n_items']} items, {live} live lanes read, {out} "
              f"written (bound {nbytes / 3.35e9:.4f} ms); " + ", ".join(row)
              + f" ms; first body ({len(narrow) + len(wide)} classes) "
              f"{old:.3f} ms, first flow {flow:.3f} ms; plain {plain:.3f} "
              f"ms ({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
