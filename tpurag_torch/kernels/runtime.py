# Ported from tpurag/kernels/runtime.py; the build/load helpers are new.
"""Kernel runtime helpers: tiling math, the CUDA kernel library and the
host C++ library.

The hand-written kernels live in ``tpurag_torch/csrc`` as CUDA C++ with a
plain C interface. ``load_kernels()`` compiles them with ``nvcc`` for
Hopper (``sm_90a``), one process per source file, all started together,
links the objects into one shared library at first use and loads it
with ctypes. The library lands in ``tpurag_torch/_build`` under a name
keyed on a hash of the sources and flags, so a source edit rebuilds and
an unchanged tree reuses the build. Nothing here runs at import time:
the CPU-only test box imports every module without nvcc.

``load_host_library()`` does the same for ``tpurag_torch/csrc/host/*.cc``,
plain C++17 with a C interface and no CUDA, built by the system's C++
compiler on any machine (the CPU test box and the card's host alike), or
None where there is none: its callers keep their Python versions.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

NEG_INF = -3.0e38

PACKAGE_DIR = pathlib.Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")
HOST_CSRC_DIR = CSRC_DIR / "host"
CXX_FLAGS = ("-std=c++17", "-O3", "-fPIC", "-shared", "-pthread")

_lib = None
_lib_lock = threading.Lock()
build_info: dict = {}  # path, seconds (0.0 when reused), ptxas log
_host_lib = None  # the loaded library, or False once a build failed
_host_lock = threading.Lock()
host_build_info: dict = {}  # path, seconds, or error
# Launches by wrapper name: each wrapper adds one where it launches its
# kernel, and nowhere else. Keyed by name, so a stand-in swapped over a
# wrapper (a call recorder) leaves the count where it is.
launch_counts: collections.Counter = collections.Counter()


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return cdiv(x, m) * m


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (pathlib.Path(cand) / "bin" / "nvcc").exists():
            return str(pathlib.Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                           "(set CUDA_HOME or put nvcc on PATH)")
    return found


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def load_kernels() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for src in _sources():
            digest.update(src.name.encode())
            digest.update(src.read_bytes())
        so = BUILD_DIR / f"libtpurag_kernels_{digest.hexdigest()[:16]}.so"
        log = so.with_suffix(".log")
        seconds = 0.0
        if not so.exists():
            t0 = time.perf_counter()
            _build(so, log)
            seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(so))
        lib.tr_error_string.restype = ctypes.c_char_p
        lib.tr_error_string.argtypes = [ctypes.c_int]
        build_info.update(path=str(so), seconds=seconds,
                          log=log.read_text() if log.exists() else "")
        _lib = lib
        return lib


def _build(so: pathlib.Path, log: pathlib.Path) -> None:
    """Compile every csrc/*.cu in parallel, then link the shared library
    (written under a temporary name, renamed when complete)."""
    nvcc = find_nvcc()
    work = so.with_suffix(f".objs{os.getpid()}")
    work.mkdir(parents=True, exist_ok=True)
    try:
        procs = []
        for src in sorted(CSRC_DIR.glob("*.cu")):
            obj = work / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        outs = []
        for obj, p in procs:  # waits for every process, failed or not
            out, err = p.communicate()
            outs.append((obj, p.returncode, out, err))
        failed = [(obj, rc, err) for obj, rc, _, err in outs if rc != 0]
        text = "".join(out + err for _, _, out, err in outs)
        if not failed:
            tmp = so.with_suffix(f".tmp{os.getpid()}")
            link = subprocess.run(
                [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                 *[str(obj) for obj, *_ in outs]],
                capture_output=True, text=True)
            text += link.stdout + link.stderr
            if link.returncode != 0:
                failed = [(so, link.returncode, link.stderr)]
        log.write_text(text)
        if failed:
            obj, rc, err = failed[0]
            raise RuntimeError(f"nvcc failed ({rc}) for {obj.stem}:\n"
                               f"{err[-4000:]}")
        os.replace(tmp, so)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def load_host_library() -> ctypes.CDLL | None:
    """Build (once per source hash) and load the host library, or None
    when it cannot be built or loaded (the reason: host_build_info). It
    holds the host's native paths: the batched highlighter
    (``csrc/host/highlight.cc``) and the batched keyword tokenizer
    (``csrc/host/tokenizer.cc``)."""
    global _host_lib
    with _host_lock:
        if _host_lib is None:
            _host_lib = _load_host_library() or False
        return _host_lib or None


def _load_host_library() -> ctypes.CDLL | None:
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        host_build_info.update(error="no C++ compiler")
        return None
    srcs = sorted(HOST_CSRC_DIR.glob("*.cc"))
    digest = hashlib.sha256(" ".join((cxx, *CXX_FLAGS)).encode())
    for src in srcs:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    so = BUILD_DIR / f"libtpurag_host_{digest.hexdigest()[:16]}.so"
    seconds = 0.0
    try:
        if not so.exists():
            t0 = time.perf_counter()
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".tmp{os.getpid()}")
            done = subprocess.run(
                [cxx, *CXX_FLAGS, "-o", str(tmp), *map(str, srcs)],
                capture_output=True, text=True)
            if done.returncode != 0:
                tmp.unlink(missing_ok=True)
                host_build_info.update(error=done.stderr[-4000:])
                return None
            os.replace(tmp, so)
            seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(so))
    except OSError as e:
        host_build_info.update(error=str(e))
        return None
    host_build_info.update(path=str(so), seconds=seconds)
    return lib


def check_launch(err: int, name: str) -> None:
    """Raise if a kernel's C entry point returned a cudaError_t != 0."""
    if err:
        msg = load_kernels().tr_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")


def cuda_stream(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
