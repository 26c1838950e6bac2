"""What the process and the card were doing around a window, for the
log: the process's CPU time as a share of the window (one core = 1), the
card's SM clock sampled through NVML every SAMPLE_S seconds by a thread
that holds the interpreter for microseconds a sample, and the cyclic
collector's full collections (count, seconds, longest). None of it feeds
a metric; it tells a slow process from a slow card or a pause of the
interpreter.
"""

from __future__ import annotations

import ctypes
import gc
import os
import statistics
import threading
import time

SAMPLE_S = 0.25
NVML_CLOCK_SM = 1


class _SmClock:
    """The SM clock of device 0 through NVML, or nothing where NVML is
    missing."""

    def __init__(self):
        self.ok = False
        try:
            lib = ctypes.CDLL("libnvidia-ml.so.1")
            lib.nvmlInit_v2.argtypes = []
            lib.nvmlDeviceGetHandleByIndex_v2.argtypes = [
                ctypes.c_uint, ctypes.POINTER(ctypes.c_void_p)]
            lib.nvmlDeviceGetClockInfo.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_uint)]
            for f in (lib.nvmlInit_v2, lib.nvmlDeviceGetHandleByIndex_v2,
                      lib.nvmlDeviceGetClockInfo):
                f.restype = ctypes.c_int
            self.lib, self.handle = lib, ctypes.c_void_p()
            self.ok = (lib.nvmlInit_v2() == 0 and
                       lib.nvmlDeviceGetHandleByIndex_v2(
                           0, ctypes.byref(self.handle)) == 0)
        except (OSError, AttributeError, ctypes.ArgumentError):
            pass

    def read(self):
        mhz = ctypes.c_uint()
        got = self.lib.nvmlDeviceGetClockInfo(self.handle, NVML_CLOCK_SM,
                                              ctypes.byref(mhz))
        return mhz.value if got == 0 else None


class Sampler:
    """start() before the window, stop() after it; stop() returns the
    log line's fields."""

    def start(self) -> "Sampler":
        self._clock = _SmClock()
        self._mhz: list = []
        self._full: list = []
        self._stop = threading.Event()
        self._t0, self._c0 = time.perf_counter(), time.process_time()
        gc.callbacks.append(self._gc)
        if self._clock.ok:
            self._thread = threading.Thread(target=self._run, daemon=True)
            self._thread.start()
        return self

    def _gc(self, phase: str, info: dict) -> None:
        if info.get("generation") == 2:
            if phase == "start":
                self._gc_t = time.perf_counter()
            else:
                self._full.append(time.perf_counter() - self._gc_t)

    def _run(self) -> None:
        while not self._stop.wait(SAMPLE_S):
            v = self._clock.read()
            if v is not None:
                self._mhz.append(v)

    def stop(self) -> dict:
        wall = time.perf_counter() - self._t0
        cpu = time.process_time() - self._c0
        gc.callbacks.remove(self._gc)
        self._stop.set()
        if self._clock.ok:
            self._thread.join()
        out = {"cpu_share": cpu / wall if wall > 0 else 0.0,
               "cores": len(os.sched_getaffinity(0)),
               "full_collections": (len(self._full), sum(self._full),
                                    max(self._full, default=0.0))}
        if self._mhz:
            out["sm_mhz"] = (min(self._mhz), statistics.median(self._mhz),
                             max(self._mhz), len(self._mhz))
        return out


def describe(d: dict) -> str:
    parts = [f"process CPU {d['cpu_share']:.3f} of a core over the window",
             f"{d['cores']} cores",
             "full collections {} taking {:.3f}s, longest {:.3f}s".format(
                 *d["full_collections"])]
    if "sm_mhz" in d:
        lo, med, hi, n = d["sm_mhz"]
        parts.append(f"SM MHz min/median/max {lo}/{med}/{hi} ({n} samples)")
    else:
        parts.append("SM clock not read")
    return "; ".join(parts)
