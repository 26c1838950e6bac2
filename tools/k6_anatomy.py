"""Where the time of K6's row-split body (csrc/ivf_probe.cu) goes, on the card.

Builds copies of tpurag_torch/csrc/ivf_probe.cu, each with textual patches
of the source (the library's source has no switch for them), and times
each beside K6's first design (tools/ivf_probe_first.cu: a (B, S) grid of
probe slices and a merge kernel), one launch at a time and in chains of 10
launches (a launch's ctypes enqueue, ~20 us, is as long as a small
kernel):

  full       the body as built;
  no_fold    every row scored, but no score enters a warp list (the scores
             stay live: a never-true test reads them);
  stream     the consumers release each stage unread: the ring's stream,
             the setup scan and the partial-list merges alone;
  no_merge   the last block of a query skips the fold of its partial lists
             (the result row is not written);
  mem_lists  every warp list in shared memory (the source keeps lists of
             k <= 32 one key a lane, in registers);
  stagesN    a ring of N stages (the source's STAGES is 3);
  stageNk    stages of N KB (the source's are 32 KB; the rows of a chunk
             follow);
  blocks2    registers held to what two blocks an SM allow (the source's
             bounds ask for one).

The grid follows the blocks per SM that shared memory and registers allow
(tr_ivf_rows_config of each copy).

A cut copy's results are wrong by design; only its time means anything
(every other copy computes the same function and is checked against the
full body, and the full body against the library's K6). A patch whose
anchor is not found once in the source stops the tool, so a changed
kernel cannot be timed as if it were cut. The inputs are the K6 calls that
chip_smoke.py replays, made by the main path at full size (chip_smoke.py's
own builders and draws) and recorded at ivf_probe_topk:

  phase 8    the first hybrid_ivf request's call on phase 8's 1M-chunk
             quant KB (int8, b=32, the default nprobe, k=16);
  bf16 100k  phase 8's bf16 check (check_ivf_bf16: a bf16 IVF of the KB's
             first 100k rows, the same queries);
  latency    the last IVF step of eval ivf_latency (bf16, 2M rows, b=8,
             the tuned nprobe, k=10).

Run on a machine with the card, from the repository root:

    python tools/k6_anatomy.py [--against OTHER/ivf_probe.cu]

--against also builds another copy of the source (a parent's, say) as it
stands and times it beside the probes as "against".
"""

from __future__ import annotations

import argparse
import ctypes
import gc
import importlib.util
import pathlib
import subprocess
import sys
import tempfile

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from tpurag_torch.kernels.ivf_scan import _STORE_CODE, ROWS_WARPS  # noqa: E402
from tpurag_torch.kernels.runtime import (CSRC_DIR, NVCC_FLAGS,  # noqa: E402
                                          cdiv, cuda_stream, find_nvcc)

FIRST_SOURCE = ROOT / "tools" / "ivf_probe_first.cu"
STREAM = [("    score_stage<T>(ring + (size_t)s * stage_bytes, qv, n_vec, h, "
           "reg, my_list,\n                   k, kth);", "    (void)h;")]
NO_FOLD = [("  offer(has, has ? tr::make_key(my_v, my_id) : 0ull, reg, list, "
            "k, kth);",
            "  if (__any_sync(tr::kFullMask, has && my_v == 1.2345e-30f))\n"
            "    offer(has, tr::make_key(my_v, my_id), reg, list, k, kth);")]
NO_MERGE = [("        if (s_last) {\n", "        if (false) {\n")]
REG_K = "constexpr int REG_K = 32;"
STAGES = "constexpr int STAGES = 3;"
STAGE_BYTES = "constexpr int STAGE_BYTES = 32768;"
BOUNDS = "__launch_bounds__(ROWS_THREADS, 1)"


def stages(n: int):
    return [(STAGES, STAGES.replace("3", str(n)))]


def stage_bytes(n: int):
    return [(STAGE_BYTES, STAGE_BYTES.replace("32768", str(n)))]


PROBES = {"full": [], "no_fold": NO_FOLD, "stream": STREAM,
          "no_merge": NO_MERGE,
          "mem_lists": [(REG_K, REG_K.replace("32", "0"))],
          "stages2": stages(2), "stages4": stages(4), "stages6": stages(6),
          "stage16k": stage_bytes(16384), "stage64k": stage_bytes(65536),
          "blocks2": [(BOUNDS, BOUNDS.replace(", 1)", ", 2)"))]}
CUT = ("no_fold", "stream", "no_merge")


def patched(patches) -> str:
    src = (CSRC_DIR / "ivf_probe.cu").read_text()
    for old, new in patches:
        if src.count(old) != 1:
            raise RuntimeError(f"anchor found {src.count(old)} times: {old!r}")
        src = src.replace(old, new)
    return src


def _start(jobs: dict, out: pathlib.Path) -> dict:
    """{name: source path} -> {name: running nvcc}, all started at once."""
    nvcc = find_nvcc()
    return {n: subprocess.Popen(
        [nvcc, *NVCC_FLAGS, f"-I{CSRC_DIR}", "-shared", str(src), "-o",
         str(out / f"lib{n}.so")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for n, src in jobs.items()}


def _finish(procs: dict, out: pathlib.Path) -> dict:
    """{name: running nvcc} -> {name: loaded CDLL}."""
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-4000:]}")
        libs[name] = ctypes.CDLL(str(out / f"lib{name}.so"))
        func = ""
        for line in log.splitlines():  # ptxas -v: the body's registers
            if "Function properties for" in line:
                func = (line.split("ivf_rows_kernel")[1][:4]
                        if "ivf_rows_kernel" in line else "")
            if func and ("registers" in line or "spill" in line):
                print(f"[K6 anatomy] ptxas {name} {func}: {line.strip()}")
    return libs


def _first_entry(lib):
    fn = lib.tr_ivf_probe_topk
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p] * 5)
    return fn


def build_first(out: pathlib.Path):
    """The first design's C entry, tr_ivf_probe_topk (scan + merge)."""
    out.mkdir(parents=True, exist_ok=True)
    procs = _start({"k6_first": FIRST_SOURCE}, out)
    return _first_entry(_finish(procs, out)["k6_first"])


def first_probe(fn, q, emb, starts, counts, k: int, scales=None):
    """A function that runs the first design as its wrapper did: q in the
    storage type (int8 codes with scales), S = min(ceil(264 / B), n_probe,
    8192 / k) probe slices, then the merge."""
    b, d = q.shape
    n_probe = starts.shape[1]
    s = max(1, min(cdiv(264, b), n_probe, 8192 // k))
    dev = q.device
    part_v = torch.empty((b, s, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((b, s, k), dtype=torch.int32, device=dev)
    out_v = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    stream = cuda_stream(dev)

    def run():
        err = fn(q.data_ptr(), emb.data_ptr(), _STORE_CODE[emb.dtype],
                 starts.data_ptr(), counts.data_ptr(),
                 None if scales is None else scales.data_ptr(), b, n_probe,
                 d, k, s, part_v.data_ptr(), part_i.data_ptr(),
                 out_v.data_ptr(), out_i.data_ptr(), stream)
        assert err == 0, f"first design: CUDA error {err}"
        return out_v, out_i
    return run


def rows_launch(lib, q, emb, starts, counts, k: int, scales=None):
    """A function that launches a (patched) row-split body as the wrapper
    does, and its grid."""
    fn = lib.tr_ivf_probe_rows
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p] * 6)
    cfg = (ctypes.c_int * 3)()
    code = _STORE_CODE[emb.dtype]
    b, d = q.shape
    assert lib.tr_ivf_rows_config(code, d, k, cfg) == 0
    grid, global_lists = cfg[0], cfg[2]
    dev = q.device
    part = torch.empty((grid + b) * k, dtype=torch.int64, device=dev)
    glists = (torch.empty(grid * ROWS_WARPS * k, dtype=torch.int64,
                          device=dev) if global_lists else None)
    state = torch.zeros(4 * b, dtype=torch.int32, device=dev)
    out_v = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    stream = cuda_stream(dev)

    def run():
        err = fn(q.data_ptr(), emb.data_ptr(), code, starts.data_ptr(),
                 counts.data_ptr(), None if scales is None else
                 scales.data_ptr(), b, starts.shape[1], d, k, grid,
                 part.data_ptr(), state.data_ptr(),
                 None if glists is None else glists.data_ptr(),
                 out_v.data_ptr(), out_i.data_ptr(), stream)
        assert err == 0, f"row-split body: CUDA error {err}"
        return out_v, out_i
    return run, grid


def load_smoke():
    """chip_smoke.py of this checkout, loaded by path."""
    spec = importlib.util.spec_from_file_location("k6_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def recorded_calls(smoke) -> dict:
    """{label: (args, kw)}: the K6 calls chip_smoke.py replays, made by
    the main path at full size and recorded at ivf_probe_topk."""
    from tpurag_torch.eval import bench
    from tpurag_torch.kernels import ivf_scan as ivf_mod

    out = {}
    kb, _, centers, _, _ = smoke.ivf_kb("cuda")
    qv, qtexts = smoke.ivf_queries(centers, smoke.B_IVF)
    calls = []
    with smoke.recording(ivf_mod, "ivf_probe_topk", calls):
        kb.search_batch(qtexts, top_k=smoke.K_IVF, mode="hybrid_ivf",
                        vectors=qv)
    assert len(calls) == 1, f"{len(calls)} K6 calls in a hybrid_ivf request"
    out["phase 8"] = calls[0]
    out["bf16 100k"] = smoke.ivf_bf16_call(kb, qv)[0]
    del kb
    gc.collect()
    torch.cuda.empty_cache()
    calls = []
    with smoke.recording(ivf_mod, "ivf_probe_topk", calls):
        bench.config7_ivf_latency(device="cuda")
    out["latency"] = calls[-1]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", type=pathlib.Path,
                    help="another ivf_probe.cu, timed as it stands")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k6_anatomy: no CUDA device", file=sys.stderr)
        return 2
    from tpurag_torch.kernels.ivf_scan import ivf_probe_topk

    smoke = load_smoke()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    with tempfile.TemporaryDirectory() as tmp:
        out = pathlib.Path(tmp)
        jobs = {"k6_first": FIRST_SOURCE}
        for name, patches in PROBES.items():
            jobs[name] = out / f"{name}.cu"
            jobs[name].write_text(patched(patches))
        if args.against is not None:
            jobs["against"] = out / "against.cu"
            jobs["against"].write_text(args.against.read_text())
        procs = _start(jobs, out)  # the builds run while the inputs are made
        calls = recorded_calls(smoke)
        libs = _finish(procs, out)
        first = _first_entry(libs.pop("k6_first"))
        for label, (call, kw) in calls.items():
            q, emb, st, ct, k = call
            sc = kw.get("scales_sel")
            qs = (q if sc is not None else q.to(emb.dtype)).contiguous()
            lib_out = ivf_probe_topk(*call, **kw)
            row = []
            for name, lib in libs.items():
                run, grid = rows_launch(lib, qs, emb, st, ct, k, sc)
                got = run()
                torch.cuda.synchronize()
                if name not in CUT:
                    assert all(torch.equal(x, y) for x, y in zip(got, lib_out)
                               ), name
                row.append(f"{name} {smoke.cuda_ms(run):.4f} / "
                           f"{smoke.cuda_ms(run, chain=10):.4f} (grid {grid})")
            old = first_probe(first, qs, emb, st, ct, k, sc)
            got = old()
            torch.cuda.synchronize()
            assert torch.equal(got[1], lib_out[1]) or sc is None
            rows = int(ct.sum().item())
            nbytes = rows * emb.shape[1] * emb.element_size()
            print(f"[K6 anatomy] {label}: {emb.dtype} b={q.shape[0]} x "
                  f"{st.shape[1]} probes ({st.numel()} table entries), "
                  f"{rows} rows, k={k}; ms single / chain of 10: "
                  + ", ".join(row) + f"; first design "
                  f"{smoke.cuda_ms(old):.4f} / "
                  f"{smoke.cuda_ms(old, chain=10):.4f}; bound "
                  f"{nbytes / smoke.HBM_BYTES_S * 1e3:.4f} ms (bytes of "
                  f"every probed row) ({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
