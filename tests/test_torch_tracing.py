"""tpurag_torch.utils.tracing: the port's spans and counters, on the CPU.

A KB of a few hundred chunks on the CPU, every chunk holding the term
``common`` (a wide term at wide_term_width=64) and a few of ``w0..w299``.
With no profiler session open a search records nothing; inside one it
records the span tree of the module's docstring, on the chrome trace's
clock.
"""

import dataclasses
import gc
import json
import timeit

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tpurag_torch import Chunk, EngineConfig, KnowledgeBase
from tpurag_torch.engine import hybrid
from tpurag_torch.utils import tracing

DIM = 32
N_CHUNKS = 300
WIDE_QUERY = "common w3"     # a wide term: keyword.wide
NARROW_QUERY = "w5 w7"       # narrow terms only: keyword.classed
# Each span's parent, as the module's docstring lays them out.
PARENT = {"dispatch": "search_batch", "dense": "dispatch",
          "keyword": "dispatch", "keyword.classed": "keyword",
          "keyword.wide": "keyword", "fuse": "dispatch",
          "finalize": "search_batch", "fetch": "finalize",
          "assemble": "finalize"}


def _chunks(rng):
    return [Chunk(text=" ".join(["common"] + [f"w{rng.integers(0, 300)}"
                                              for _ in range(20)]),
                  doc_id=f"d{i // 10}", doc_name=f"doc{i // 10}")
            for i in range(N_CHUNKS)]


def _kb():
    cfg = EngineConfig()
    cfg = dataclasses.replace(cfg, bm25=dataclasses.replace(
        cfg.bm25, wide_term_width=64))
    kb = KnowledgeBase("traced", dim=DIM, config=cfg, device="cpu")
    rng = np.random.default_rng(0)
    kb.add_chunks(_chunks(rng), vectors=rng.standard_normal(
        (N_CHUNKS, DIM)).astype(np.float32))
    return kb


@pytest.fixture(scope="module")
def kb():
    kb = _kb()
    kb.search("w1")  # the first search compacts: out of every test's way
    return kb


def _vectors(b, seed=1):
    return np.random.default_rng(seed).standard_normal((b, DIM)).astype(
        np.float32)


def _profiled(fn):
    """fn() inside a profiler session, with the collector's automatic
    collections held off: a collection the environment's allocations
    happen to trigger is no span of the search (the gc span has a test
    of its own, which collects explicitly)."""
    tracing.clear()
    gc.collect()
    gc.disable()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            out = fn()
    finally:
        gc.enable()
    return out, tracing.spans(), prof


def _hybrid(kb):
    return kb.search_batch([WIDE_QUERY, NARROW_QUERY], top_k=8,
                           vectors=_vectors(2))


def test_no_profiler_records_nothing(kb, monkeypatch):
    entered = []
    monkeypatch.setattr(tracing, "record_function",
                        lambda name: entered.append(name))
    tracing.clear()
    out = _hybrid(kb)
    assert len(out) == 2 and out[0].results
    assert tracing.spans() == [] and entered == []


def test_profiled_search_records_the_span_tree(kb):
    out, recs, _ = _profiled(lambda: _hybrid(kb))
    by_id = {r.span_id: r for r in recs}
    names = [r.name for r in recs]
    assert set(names) == set(PARENT) | {"search_batch"}, names
    assert names.count("search_batch") == 1
    assert len({r.call_id for r in recs}) == 1
    root = next(r for r in recs if r.name == "search_batch")
    assert root.parent_id == 0
    assert root.attrs == {"batch": 2, "mode": "hybrid"}
    for r in recs:
        if r is root:
            continue
        parent = by_id[r.parent_id]
        assert parent.name == PARENT[r.name], (r.name, parent.name)
        assert parent.start_ns <= r.start_ns <= r.end_ns <= parent.end_ns
    assemble = next(r for r in recs if r.name == "assemble")
    found = [x for resp in out for x in resp.results]
    assert assemble.attrs["results"] == len(found)
    assert assemble.attrs["highlights"] == sum(
        "keyword" in x.found_in for x in found) > 0
    assert assemble.attrs["highlight_fallbacks"] == 0
    assert 0 < assemble.attrs["highlight_ns"] <= (assemble.end_ns
                                                  - assemble.start_ns)


@pytest.mark.parametrize("traced", [False, True])
def test_fuse_counts_each_plain_call_once(kb, traced):
    def calls():
        for b in (1, 3):
            kb.search_batch([NARROW_QUERY] * b, vectors=_vectors(b))
        kb.search_batch([NARROW_QUERY], vectors=_vectors(1), mode="vector")

    launches = tracing.launch_counts["fuse_legs"]
    if traced:
        _profiled(calls)
    else:
        tracing.clear()
        calls()
    assert tracing.counters["fuse_plain"] == 2  # CPU tensors: no kernel
    assert tracing.launch_counts["fuse_legs"] == launches


@pytest.mark.parametrize("query,leg", [(WIDE_QUERY, "keyword.wide"),
                                       (NARROW_QUERY, "keyword.classed")])
def test_keyword_span_names_the_scoring_path(kb, query, leg):
    _, recs, _ = _profiled(lambda: kb.search_batch([query],
                                                   vectors=_vectors(1)))
    names = {r.name for r in recs}
    assert leg in names
    assert not names & ({"keyword.wide", "keyword.classed"} - {leg})


def test_chrome_trace_holds_each_range_on_the_records_clock(kb, tmp_path):
    _, recs, prof = _profiled(lambda: _hybrid(kb))
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    data = json.loads(path.read_text())
    base = data["baseTimeNanoseconds"]
    ranges: dict = {}
    for e in data["traceEvents"]:
        if e.get("ph") == "X" and e.get("name", "").startswith(
                tracing.PREFIX):
            ranges.setdefault(e["name"], []).append(e)
    for name, evs in ranges.items():
        mine = sorted(r.start_ns for r in recs
                      if tracing.PREFIX + r.name == name)
        assert len(mine) == len(evs), name
        for start, e in zip(mine, sorted(evs, key=lambda e: e["ts"])):
            assert abs(base + 1000 * e["ts"] - start) < 1e6, name
    assert {tracing.PREFIX + r.name for r in recs} == set(ranges)


def test_collection_inside_a_call_is_a_gc_span(kb, monkeypatch):
    real = hybrid.fuse_legs

    def collecting(*a, **kw):
        gc.collect()
        return real(*a, **kw)

    monkeypatch.setattr(hybrid, "fuse_legs", collecting)
    _, recs, _ = _profiled(lambda: _hybrid(kb))
    by_id = {r.span_id: r for r in recs}
    full = [r for r in recs if r.name == "gc"
            and r.attrs["generation"] == 2]
    assert len(full) == 1
    fuse = by_id[full[0].parent_id]
    assert fuse.name == "fuse" and full[0].call_id == fuse.call_id
    assert fuse.start_ns <= full[0].start_ns <= full[0].end_ns <= fuse.end_ns


def test_dispatch_and_finalize_share_a_call_without_a_root(kb):
    def dispatched():
        return kb.search_batch_dispatch([NARROW_QUERY],
                                        vectors=_vectors(1))()

    _, recs, _ = _profiled(dispatched)
    names = {r.name for r in recs}
    assert "search_batch" not in names and {"dispatch", "finalize"} <= names
    assert len({r.call_id for r in recs if r.name != "gc"}) == 1
    assert all(r.parent_id == 0 for r in recs
               if r.name in ("dispatch", "finalize"))


def test_ingest_and_compaction_counters():
    tracing.clear()
    kb = _kb()
    c = dict(tracing.counters)
    assert c["ingest_calls"] == 1
    assert 0 < c["ingest_keyword_ns"] <= c["ingest_ns"]
    assert "compactions" not in c
    kb.search("w1")
    assert tracing.counters["compactions"] == 1
    assert tracing.counters["compact_ns"] > 0
    kb.search("w2")
    assert tracing.counters["compactions"] == 1
    assert tracing.counters["ingest_calls"] == 1


def test_session_ordinal_separates_sessions(kb):
    tracing.clear()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU]):
            kb.search(NARROW_QUERY)
        kb.search(NARROW_QUERY)  # off: no record
    roots = [r for r in tracing.spans() if r.name == "search_batch"]
    assert len(roots) == 2
    assert roots[1].session == roots[0].session + 1
    assert all(r.session == roots[0].session for r in tracing.spans()
               if r.call_id == roots[0].call_id)


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return None


def test_disabled_span_costs_under_a_microsecond():
    """With no profiler session a span is the shared no-op and keeps no
    record. Its cost is held to a bare `with` of a no-op context manager
    timed in the same process, the runs interleaved, so that the bound
    measures the span and not how loaded the machine is (under 2.5x on an
    idle host, where the span takes about half a microsecond)."""
    assert not torch.autograd.profiler._is_profiler_enabled
    assert tracing.span("x") is tracing._OFF
    noop = _Noop()

    def entered():
        with tracing.span("x"):
            pass

    def bare():
        with noop:
            pass

    tracing.clear()
    span_s, bare_s = [], []
    for _ in range(7):
        span_s.append(timeit.timeit(entered, number=20000))
        bare_s.append(timeit.timeit(bare, number=20000))
    assert min(span_s) <= 4 * min(bare_s), (min(span_s), min(bare_s))
    assert tracing.spans() == []


def test_launch_counts_is_the_one_counter_of_launches():
    from tpurag_torch.kernels import runtime

    assert tracing.launch_counts is runtime.launch_counts
