# Ported from tpurag/kernels/runtime.py; the CUDA build/load helper is new.
"""Kernel runtime helpers: tiling math and the CUDA kernel library.

The hand-written kernels live in ``tpurag_torch/csrc`` as CUDA C++ with a
plain C interface. ``load_kernels()`` compiles them with ``nvcc`` for
Hopper (``sm_90a``) into one shared library at first use and loads it
with ctypes. The library lands in ``tpurag_torch/_build`` under a name
keyed on a hash of the sources and flags, so a source edit rebuilds and
an unchanged tree reuses the build. Nothing here runs at import time:
the CPU-only test box imports every module without nvcc.
"""

from __future__ import annotations

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
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lib = None
_lib_lock = threading.Lock()
build_info: dict = {}  # path, seconds (0.0 when reused), ptxas log


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
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".tmp{os.getpid()}")
            cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   *[str(s) for s in sorted(CSRC_DIR.glob("*.cu"))]]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            log.write_text(proc.stdout + proc.stderr)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{proc.stderr[-4000:]}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        lib.tr_error_string.restype = ctypes.c_char_p
        lib.tr_error_string.argtypes = [ctypes.c_int]
        build_info.update(path=str(so), seconds=seconds,
                          log=log.read_text() if log.exists() else "")
        _lib = lib
        return lib


def check_launch(err: int, name: str) -> None:
    """Raise if a kernel's C entry point returned a cudaError_t != 0."""
    if err:
        msg = load_kernels().tr_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")


def cuda_stream(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
