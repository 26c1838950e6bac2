"""The program's own spans and counters, read for the per-layer metrics of
a traced run and put on the clock of the slice's device trace.

The program (``tpurag_torch.utils.tracing``) records its spans while a
profiler session is open, each with start and end in ``time.time_ns()``,
and keeps always-on counters. A program without that module gives
nothing, and every reader here then returns None.

Placing: the records of the newest profiler session are the slice's. The
last ``Trace.n_calls`` root ``search_batch`` spans pair in order with the
trace's calls (the harness's own ``search_batch`` span, opened just
outside the program's root). The offset from the program's clock to the
trace's is the median over the pairs of (call start - root start). A
root that then lies outside its call by more than TOLERANCE_US means the
pairing or the clocks are wrong: nothing is read, and the log says why.

Times in microseconds on the trace's clock; "ms" metrics are means a
call over the slice, as trace.py's are.
"""

from __future__ import annotations

import bisect
import sys
import weakref

ROOT = "search_batch"
TOLERANCE_US = 100.0
IDLE_ROWS = 10
FACADE_PARTS = ("assemble", "fetch", "fuse")
LEGS = ("dense", "keyword")

_placed: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def program():
    """The program's tracing module, or None where it has none."""
    try:
        from tpurag_torch.utils import tracing
    except ImportError:
        return None
    return tracing


def counter_s(ns_key: str, calls_key: str):
    """Seconds in counters[ns_key], or None before any counted call."""
    tr = program()
    if tr is None or not tr.counters.get(calls_key):
        return None
    return tr.counters.get(ns_key, 0) / 1e9


def placed(run) -> "Placed | None":
    """The slice's program spans on the trace's clock, once a run."""
    trace = run.trace
    if trace is None:
        return None
    if trace not in _placed:
        tr = program()
        if tr is None:
            log("[progspans] the program has no tracing module: nothing read")
            _placed[trace] = None
        else:
            _placed[trace] = place(trace, tr.spans())
    return _placed[trace]


def place(trace, records) -> "Placed | None":
    """Pair `records` (the program's, any sessions) with the trace's
    calls; None, logged, where they do not line up."""
    n = trace.n_calls
    if not records or not n:
        log(f"[progspans] {len(records)} program records, {n} calls: "
            "nothing read")
        return None
    newest = max(r.session for r in records)
    recs = [r for r in records if r.session == newest]
    roots = sorted((r for r in recs if r.name == ROOT and not r.parent_id),
                   key=lambda r: r.start_ns)
    if len(roots) < n:
        log(f"[progspans] {len(roots)} program roots in the newest session "
            f"for {n} calls: nothing read")
        return None
    roots = roots[-n:]
    base = roots[0].start_ns
    diffs = sorted(c[1] - (r.start_ns - base) / 1e3
                   for c, r in zip(trace.calls, roots))
    offset = (diffs[(n - 1) // 2] + diffs[n // 2]) / 2
    residuals = []
    for c, r in zip(trace.calls, roots):
        lo = (r.start_ns - base) / 1e3 + offset
        hi = (r.end_ns - base) / 1e3 + offset
        if lo < c[1] - TOLERANCE_US or hi > c[2] + TOLERANCE_US:
            log(f"[progspans] a root at [{lo:.1f}, {hi:.1f}] us lies outside "
                f"its call [{c[1]:.1f}, {c[2]:.1f}] by more than "
                f"{TOLERANCE_US:g} us: nothing read")
            return None
        residuals.append(c[1] - lo)
    mags = sorted(map(abs, residuals))
    worst = max(range(n), key=lambda i: abs(residuals[i]))
    log(f"[progspans] {n} calls paired, offset {offset:.1f} us; residual "
        f"|call start - root start - offset| p90 "
        f"{mags[min(n - 1, int(0.9 * n))]:.1f} us, max {mags[-1]:.1f} us "
        f"(call {worst} of {n}: {residuals[worst]:+.1f} us)")
    out = Placed(trace, recs, roots, base, offset, residuals)
    n_gc = sum(s[0] == "gc" for s in out.mine)
    loose = [s for s in out.all if s[0] == "gc" and s[3] == 0]
    log(f"[progspans] program spans a call: {len(out.mine) / n:.1f}, gc "
        f"{n_gc / n:.1f} of them; {len(loose)} gc spans under no program "
        f"span ({sum(s[2] - s[1] for s in loose) / 1e3:.3f} ms)")
    own = trace.self_host_ms()
    if own > 0:
        log(f"[progspans] the facade's own host time {own:.3f} ms a call: "
            f"{100.0 * out.facade_cover_ms() / own:.1f}% of it under "
            f"{', '.join(FACADE_PARTS)} or gc spans outside them and the legs")
    return out


class Placed:
    """The slice's program spans but the roots, each (name, lo, hi,
    depth, attrs) on the trace's clock: of the paired calls (`mine`) and
    all of them (`all`: gc spans outside every program span too)."""

    def __init__(self, trace, recs, roots, base, offset, residuals):
        self.trace, self.n_calls = trace, trace.n_calls
        self.residuals = residuals  # us a call: (call - root start) - offset
        parent = {r.span_id: r.parent_id for r in recs}
        name = {r.span_id: r.name for r in recs}
        self._gc_in_facade = 0.0

        def depth_of(i):
            d, j = 0, i
            while parent.get(j):
                j = parent[j]
                d += 1
            return d

        def in_facade(i):
            """Outside the facade's parts and the legs."""
            while parent.get(i):
                i = parent[i]
                if name.get(i) in FACADE_PARTS + LEGS:
                    return False
            return True

        calls = {r.call_id for r in roots}
        self.all, self.mine = [], []
        for r in recs:
            if r.name == ROOT and not r.parent_id:
                continue
            s = (r.name, (r.start_ns - base) / 1e3 + offset,
                 (r.end_ns - base) / 1e3 + offset, depth_of(r.span_id),
                 r.attrs)
            self.all.append(s)
            if r.call_id in calls:
                self.mine.append(s)
                if r.name == "gc" and in_facade(r.span_id):
                    self._gc_in_facade += s[2] - s[1]
        self.all.sort(key=lambda s: s[1])
        self._idle = None

    def span_ms(self, name: str) -> float:
        """Mean ms a call inside spans called `name`."""
        return (sum(hi - lo for n, lo, hi, _, _ in self.mine if n == name)
                / 1e3 / self.n_calls)

    def facade_cover_ms(self) -> float:
        """Mean ms a call of the facade's own host time that its parts'
        spans cover, and gc spans outside those and the legs."""
        return (sum(self.span_ms(n) for n in FACADE_PARTS)
                + self._gc_in_facade / 1e3 / self.n_calls)

    def attr_ms(self, name: str, key: str) -> float:
        """Mean ms a call of the nanoseconds in attribute `key` of the
        spans called `name`."""
        return (sum(a.get(key, 0) for n, _, _, _, a in self.mine
                    if n == name) / 1e6 / self.n_calls)

    def idle(self):
        """(idle us, of it under no program span below the root, pieces):
        the device's idle time inside the calls, cut by the program's
        spans; pieces are (us, innermost span's name) with ROOT where no
        span below the root covers the stretch."""
        if self._idle is None:
            busy = _union(self.trace.ops)
            busy_lo = [a for a, _ in busy]
            starts = [s[1] for s in self.all]
            longest = max((s[2] - s[1] for s in self.all), default=0.0)
            total = uncovered = 0.0
            pieces = []
            for c in self.trace.calls:
                lo_c, hi_c = c[1], c[2]
                inside = [s for s in self.all[
                    bisect.bisect_left(starts, lo_c - longest):
                    bisect.bisect_left(starts, hi_c)] if s[2] > lo_c]
                near = busy[max(bisect.bisect_left(busy_lo, lo_c) - 1, 0):
                            bisect.bisect_left(busy_lo, hi_c)]
                for lo, hi in _gaps(near, lo_c, hi_c):
                    for a, b, name in _labelled(inside, lo, hi):
                        total += b - a
                        if name is None:
                            uncovered += b - a
                        pieces.append((b - a, name or ROOT))
            self._idle = (total, uncovered, pieces)
        return self._idle

    def idle_unattributed(self):
        total, uncovered, pieces = self.idle()
        if total <= 0:
            return None
        by: dict = {}
        for us, name in pieces:
            by[name] = by.get(name, 0.0) + us
        log(f"[progspans] device idle inside the calls: {total / 1e3:.3f} ms"
            f" over {self.n_calls} calls; by innermost program span (ms a "
            "call): " + ", ".join(
                f"{n} {us / 1e3 / self.n_calls:.3f}"
                for n, us in sorted(by.items(), key=lambda kv: -kv[1])))
        log("[progspans] longest idle stretches (ms, innermost span): " +
            ", ".join(f"{us / 1e3:.3f} {n}" for us, n in
                      sorted(pieces, key=lambda p: -p[0])[:IDLE_ROWS]))
        return 100.0 * uncovered / total


def _union(ops):
    """The device operations' intervals, merged and sorted."""
    out = []
    for _, ts, dur, _ in sorted(ops, key=lambda o: o[1]):
        if out and ts <= out[-1][1]:
            out[-1][1] = max(out[-1][1], ts + dur)
        else:
            out.append([ts, ts + dur])
    return out


def _gaps(busy, lo: float, hi: float):
    """The stretches of [lo, hi] outside the sorted, merged `busy`."""
    at = lo
    for a, b in busy:
        if b <= lo or a >= hi:
            continue
        if a > at:
            yield at, a
        at = max(at, b)
    if hi > at:
        yield at, hi


def _labelled(spans, lo: float, hi: float):
    """[lo, hi] cut where a span starts or ends, each piece named by the
    deepest span covering it (the latest started among equals), or None."""
    cuts = sorted({lo, hi} | {x for s in spans for x in s[1:3]
                              if lo < x < hi})
    out = []
    for a, b in zip(cuts, cuts[1:]):
        best = None
        for s in spans:
            if s[1] <= a and s[2] >= b and (
                    best is None or (s[3], s[1]) > (best[3], best[1])):
                best = s
        name = best[0] if best is not None else None
        if out and out[-1][2] == name and out[-1][1] == a:
            out[-1] = (out[-1][0], b, name)
        else:
            out.append((a, b, name))
    return out
