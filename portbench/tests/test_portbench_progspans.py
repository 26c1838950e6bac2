"""portbench/progspans.py on a synthetic trace: the harness's calls as
chrome events, the program's records on a clock of their own (unix ns,
a known offset from the trace's microseconds)."""

import pytest

from portbench import harness, progspans, trace as trace_mod
from tpurag_torch.utils.tracing import Record

CLOCK_NS = 1_790_000_000_123_456_789  # program ns at the trace's 0 us
CALL_US = 1000.0
SPAN_METRICS = ("facade.assemble_ms", "facade.highlight_ms",
                "facade.fetch_ms", "facade.fuse_ms",
                "device.idle_unattributed")
COUNTER_METRICS = {"ingest.host_s": 40.0, "ingest.keyword_s": 30.0,
                   "keyword.compact_s": 4.0}
# One call's children at trace us from its start: (name, lo, hi, parent).
# Device busy [100, 200] and [600, 700]; idle [0, 100], [200, 600],
# [700, 1000], 800 us, of which no span below the root covers [0, 50],
# [400, 450] and [950, 1000]: 150 us.
CHILDREN = [("dispatch", 50, 400, "search_batch"),
            ("fuse", 300, 400, "dispatch"),
            ("finalize", 450, 950, "search_batch"),
            ("fetch", 450, 620, "finalize"),
            ("assemble", 700, 950, "finalize"),
            ("gc", 800, 850, "assemble")]
BUSY = [(100, 100), (600, 100)]


def _trace(starts):
    ev = []
    for c, t in enumerate(starts):
        ev.append({"ph": "X", "cat": "user_annotation",
                   "name": "portbench.search_batch", "ts": t,
                   "dur": CALL_US, "tid": 1})
        for j, (lo, dur) in enumerate(BUSY):
            corr = 10 * c + j
            ev += [{"ph": "X", "cat": "cuda_runtime",
                    "name": "cudaLaunchKernel", "ts": t + lo - 20, "dur": 5,
                    "tid": 1, "args": {"correlation": corr}},
                   {"ph": "X", "cat": "kernel", "name": "k_kernel",
                    "ts": t + lo, "dur": dur, "args": {"correlation": corr}}]
    return trace_mod.Trace(ev)


def _records(starts, root_delay_us=(), session=3):
    """The program's records of calls at trace `starts`: each root opens
    as its call does and closes 10 us before it, the call's spans all
    root_delay_us[c] (0 by default) later."""
    recs, sid = [], 100
    for c, t in enumerate(starts):
        d = root_delay_us[c] if c < len(root_delay_us) else 0.0

        def ns(us):
            return CLOCK_NS + int(round((t + us + d) * 1000))

        root = sid
        ids = {"search_batch": root}
        recs.append(Record("search_batch", ns(0), ns(CALL_US - 10), root,
                           0, root, 1, session, {"batch": 4}))
        for name, lo, hi, parent in CHILDREN:
            sid += 1
            ids[name] = sid
            attrs = {"highlight_ns": 120_000} if name == "assemble" else {}
            recs.append(Record(name, ns(lo), ns(hi), sid, ids[parent], root,
                               1, session, attrs))
        sid += 1
    return recs


class _Program:
    def __init__(self, records, counters=None):
        self._records = records
        self.counters = counters or {}

    def spans(self):
        return list(self._records)


def _read(monkeypatch, trace, program):
    monkeypatch.setattr(progspans, "program", lambda: program)
    run = harness.Run(config={}, traffic={}, trace=trace)
    return {m: harness.load_reader(m).read(run)
            for m in SPAN_METRICS + tuple(COUNTER_METRICS)}


def test_pairing_recovers_the_offset():
    starts = [0.0, 5000.0, 9000.0]
    trace = _trace(starts)
    # An older session's call and a root opened 2-40 us after its call.
    old = _records([-50000.0], session=2)
    p = progspans.place(trace, old + _records(starts, (0.0, 2.0, 40.0)))
    assert p is not None and p.n_calls == 3
    assert p.residuals == pytest.approx([2.0, 0.0, -38.0])
    fuse = sorted(s[1] for s in p.mine if s[0] == "fuse")
    assert fuse == pytest.approx([300.0 - 2, 5300.0, 9300.0 + 38])
    assert len(p.mine) == 3 * len(CHILDREN)


def test_exact_layout_reads_exact_metrics(monkeypatch):
    starts = [0.0, 2000.0]
    got = _read(monkeypatch, _trace(starts), _Program(
        _records(starts), {"ingest_ns": 40e9, "ingest_calls": 2,
                           "ingest_keyword_ns": 30e9,
                           "compact_ns": 4e9, "compactions": 1}))
    assert got["facade.assemble_ms"] == pytest.approx(0.25)
    assert got["facade.highlight_ms"] == pytest.approx(0.12)
    assert got["facade.fetch_ms"] == pytest.approx(0.17)
    assert got["facade.fuse_ms"] == pytest.approx(0.1)
    assert got["device.idle_unattributed"] == pytest.approx(
        100.0 * 150 / 800)
    for name, value in COUNTER_METRICS.items():
        assert got[name] == pytest.approx(value)


def test_idle_pieces_name_the_innermost_span():
    starts = [0.0]
    p = progspans.place(_trace(starts), _records(starts))
    total, uncovered, pieces = p.idle()
    assert (total, uncovered) == pytest.approx((800.0, 150.0))
    by = {}
    for us, name in pieces:
        by[name] = by.get(name, 0.0) + us
    assert by == pytest.approx({"search_batch": 150.0, "dispatch": 150.0,
                                "fuse": 100.0, "fetch": 150.0,
                                "assemble": 200.0, "gc": 50.0})


def test_root_outside_its_call_reads_nothing(monkeypatch):
    starts = [0.0, 2000.0, 4000.0]
    got = _read(monkeypatch, _trace(starts), _Program(
        _records(starts, (0.0, 0.0, 500.0)), {"ingest_ns": 1e9,
                                              "ingest_calls": 1}))
    assert all(got[m] is None for m in SPAN_METRICS), got
    assert got["ingest.host_s"] == pytest.approx(1.0)
    assert got["keyword.compact_s"] is None


def test_fewer_roots_than_calls_reads_nothing():
    starts = [0.0, 2000.0]
    assert progspans.place(_trace(starts), _records(starts[:1])) is None


def test_program_without_tracing_reads_nothing(monkeypatch):
    starts = [0.0]
    got = _read(monkeypatch, _trace(starts), None)
    assert all(v is None for v in got.values()), got
