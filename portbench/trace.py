"""Spans around the calls into the program's layers, and the device trace
of a slice of a traced run.

Spans are ``torch.profiler.record_function`` ranges that the benchmark
opens from its own files around the KnowledgeBase methods its per-layer
metrics name. A device operation belongs to the innermost span open on
the launching thread when the operation was launched (its runtime call,
matched by CUPTI's correlation id), whatever the kernel is called.

torch.profiler on the H100 machine loses device records when CUPTI stays
set up between sessions (tools/profiler_probe.py): run.py sets
TEARDOWN_CUPTI=1 before torch is imported, and a session that recorded
no device operation is taken again (chip_smoke.py's device_profile does
the same; its kernel-name rule is copied here).
"""

from __future__ import annotations

import bisect
import functools
import json
import os
import re
import tempfile

FACADE = "search_batch"
PREFIX = "portbench."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def install_spans(kb, spans: dict) -> None:
    """Wrap each 'attr.method' path of `spans` ({name: paths}) on the KB
    instance in a span called PREFIX + name. A path whose object the KB
    does not have (no IVF built) is skipped."""
    from torch.profiler import record_function

    for name, paths in spans.items():
        for path in paths:
            owner_name, method = path.rsplit(".", 1)
            owner = getattr(kb, owner_name, None)
            if owner is None:
                continue
            real = getattr(owner, method)

            @functools.wraps(real)
            def wrapped(*a, _real=real, _name=PREFIX + name, **kw):
                with record_function(_name):
                    return _real(*a, **kw)

            setattr(owner, method, wrapped)


def facade_span():
    from torch.profiler import record_function

    return record_function(PREFIX + FACADE)


def session():
    """A profiler session over the CPU and the device."""
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def settle(call, tries: int = 4) -> None:
    """Profile single calls until a session records no device operation.

    The first session of a process pays CUPTI's set-up (about 10 s on an
    H100 with torch 2.11), and a slice opened as a process's first session
    kept only one of its calls there; with CUPTI torn down, sessions then
    alternate between complete and empty on the device. So a traced run
    pays the set-up here and leaves the next session a complete one."""
    for _ in range(tries):
        with session() as prof:
            call()
        if not device_ops(prof):
            return


def device_ops(prof) -> bool:
    from torch.autograd import DeviceType

    return any(e.device_type == DeviceType.CUDA for e in prof.events())


def read_profile(prof) -> "Trace | None":
    """The session's chrome trace, parsed; None if it recorded no device
    operation."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    trace = Trace(events)
    return trace if trace.ops else None


def short_name(name: str) -> str:
    """A kernel's own name and template arguments, without namespace,
    return type and parameters."""
    m = re.search(r"(\w+_kernel(?:<[^<>()]*(?:\(bool\)[^<>()]*)*>)?)", name)
    return m.group(1).lstrip("_") if m else name[:64]


class Trace:
    """One slice of calls: host spans, device operations and what each
    operation was launched inside. Times in microseconds."""

    def __init__(self, events):
        spans, launches, ops = [], {}, []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, args = e.get("cat", ""), e.get("args") or {}
            if cat == "user_annotation" and e["name"].startswith(PREFIX):
                spans.append((e["name"][len(PREFIX):], float(e["ts"]),
                              float(e["ts"]) + float(e["dur"]), e["tid"]))
            elif cat in LAUNCH_CATS and "correlation" in args:
                launches[args["correlation"]] = (float(e["ts"]), e["tid"])
            elif cat in DEVICE_CATS:
                ops.append((short_name(e["name"]), float(e["ts"]),
                            float(e["dur"]), args.get("correlation")))
        spans.sort(key=lambda s: s[1])
        self.calls = [s for s in spans if s[0] == FACADE]
        self.children = [[] for _ in self.calls]
        starts = [c[1] for c in self.calls]
        for s in spans:
            if s[0] == FACADE:
                continue
            j = bisect.bisect_right(starts, s[1]) - 1
            if j >= 0 and s[2] <= self.calls[j][2] and s[3] == self.calls[j][3]:
                self.children[j].append(s)
        self._starts = starts
        self.t0 = self.calls[0][1] if self.calls else 0.0
        self.t1 = self.calls[-1][2] if self.calls else 0.0
        self.ops = []  # (name, start, dur, span name or None)
        for name, ts, dur, corr in ops:
            if ts + dur < self.t0 or ts > self.t1:
                continue
            self.ops.append((name, ts, dur,
                             self._span_at(*launches.get(corr, (None, None)))))

    def _span_at(self, ts, tid):
        if ts is None:
            return None
        j = bisect.bisect_right(self._starts, ts) - 1
        if j < 0 or ts > self.calls[j][2] or tid != self.calls[j][3]:
            return None
        for name, lo, hi, _ in self.children[j]:
            if lo <= ts <= hi:
                return name
        return FACADE

    @property
    def n_calls(self) -> int:
        return len(self.calls)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def host_ms(self, name: str) -> float:
        """Mean host ms a call inside spans called `name`."""
        total = sum(hi - lo for ch in self.children
                    for n, lo, hi, _ in ch if n == name)
        return total / 1e3 / max(self.n_calls, 1)

    def self_host_ms(self) -> float:
        """Mean host ms a call in the facade span outside its children."""
        total = sum((c[2] - c[1]) - sum(hi - lo for _, lo, hi, _ in ch)
                    for c, ch in zip(self.calls, self.children))
        return total / 1e3 / max(self.n_calls, 1)

    def device_ms(self, name: str) -> float:
        """Mean device ms a call of the operations launched in `name`."""
        return (sum(dur for _, _, dur, span in self.ops if span == name)
                / 1e3 / max(self.n_calls, 1))

    def busy_s(self) -> float:
        """Seconds in which some device operation ran, within the slice."""
        return sum(hi - lo for lo, hi in self._union()) / 1e6

    def _union(self):
        out = []
        for _, ts, dur, _ in sorted(self.ops, key=lambda o: o[1]):
            lo, hi = max(ts, self.t0), min(ts + dur, self.t1)
            if hi <= lo:
                continue
            if out and lo <= out[-1][1]:
                out[-1][1] = max(out[-1][1], hi)
            else:
                out.append([lo, hi])
        return out

    def top_ops(self, n: int = 10):
        """[[name, seconds]] of the n device functions that took most."""
        by: dict = {}
        for name, _, dur, _ in self.ops:
            by[name] = by.get(name, 0.0) + dur / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:n]]

    def _host_segments(self):
        """(start, end, what the host did) covering the slice: each call's
        child spans, the facade's own time between them, and the time
        between calls."""
        segs, prev = [], self.t0
        for (_, lo, hi, _), ch in zip(self.calls, self.children):
            if lo > prev:
                segs.append((prev, lo, "between calls"))
            at = lo
            for name, clo, chi, _ in sorted(ch, key=lambda c: c[1]):
                if clo > at:
                    segs.append((at, clo, FACADE))
                segs.append((clo, chi, name))
                at = max(at, chi)
            if hi > at:
                segs.append((at, hi, FACADE))
            prev = max(prev, hi)
        return segs

    def idle_gaps(self, n: int = 10):
        """[[what the host was doing, seconds]] of the n longest stretches
        in which the device ran nothing, each stretch cut where the host
        moved from one span to another ('between calls' outside them)."""
        segs = self._host_segments()
        pieces, prev, k = [], self.t0, 0
        for lo, hi in self._union() + [[self.t1, self.t1]]:
            if lo > prev:
                while k < len(segs) and segs[k][1] <= prev:
                    k += 1
                m = k
                while m < len(segs) and segs[m][0] < lo:
                    a, b = max(prev, segs[m][0]), min(lo, segs[m][1])
                    if b > a:
                        pieces.append((b - a, segs[m][2]))
                    m += 1
            prev = max(prev, hi)
        pieces.sort(key=lambda p: -p[0])
        return [[what, dur / 1e6] for dur, what in pieces[:n]]
