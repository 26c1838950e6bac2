# The port's counterpart of tpurag/utils/tracing.py, built on torch.profiler.
"""Spans and counters of the port, on the clock of torch.profiler's trace.

Spans
-----
A span names one phase of a call into the port. It records only while a
``torch.profiler`` session is open: the test is the profiler's own
enabled flag, so there is nothing to switch on. With no session open,
entering a span reads that flag and does nothing else.

Inside a session a span does two things:

- it opens ``torch.profiler.record_function("tpurag.<name>")``, so the
  phase shows in the chrome trace (``prof.export_chrome_trace``) and in
  TensorBoard, on the same clock as the device's kernels and copies, and
  every operation launched inside it sits under it;
- it appends a :class:`Record` to a bounded in-memory buffer
  (:func:`spans`): name, start and end in ``time.time_ns()``, span id,
  parent id, call id, thread id, the session's ordinal and attributes.

The spans of one search, from the facade down (``KnowledgeBase``):

==========================  ===============================================
``search_batch``            the whole call; attrs ``batch``, ``mode``
 ``dispatch``               the query path under the read lock: both legs
                            and fusion enqueued
  ``dense``                 ``DenseIndex.search`` or the IVF leg: the
                            query upload and the dense kernels
  ``keyword``               ``InvertedIndex.search``: tokenizing,
                            resolving the terms against each segment
                            once, scoring
   ``keyword.compact``      the lazy compaction a search may run first
   ``keyword.classed``      queries without wide terms: width classes,
                            the merge + top-k kernel
   ``keyword.wide``         queries with wide terms: classes, the
                            full-row merge and the combine kernels
  ``fuse``                  score floor, keyword gate (the queries' idf
                            mass), reciprocal-rank fusion
 ``finalize``               the host half: ``fetch`` then ``assemble``
  ``fetch``                 the host copy of the fused (scores, ids,
                            bits): the host waits on the device here
  ``assemble``              every query's response: the chunk store's
                            columns read, highlighting; attrs ``results``,
                            ``highlights``, ``highlight_fallbacks`` (the
                            highlights that took the Python version) and
                            ``highlight_ns`` (the batched highlighter's
                            share of it: encode, native call, decode)
``gc``                      a collection of the cyclic collector, under
                            the span it interrupted; attr ``generation``
==========================  ===============================================

Spans of one call share its call id; a caller of
``search_batch_dispatch`` gets ``dispatch`` and ``finalize`` spans with
one call id and no ``search_batch`` root. The session ordinal goes up
when a span finds the profiler on after it last saw it off, so a reader
can keep the newest session's records alone.

Counters
--------
:data:`counters` is always on and counts per call, never per query:

- ``ingest_ns``, ``ingest_calls``: ``KnowledgeBase.add_chunks``;
- ``ingest_keyword_ns``: ``InvertedIndex.add_batch`` (tokenizing and the
  postings), inside the former;
- ``ingest_native_docs``, ``ingest_python_docs``: the documents
  ``InvertedIndex.add_batch`` indexed through the native batched call
  and through ``InvertedIndex.add``, one at a time;
- ``compact_ns``, ``compactions``: ``InvertedIndex.compact``, the
  keyword index's rebuild onto the device (a KB's first search runs one);
- ``fuse_plain``: the hybrid fusion calls (``kernels.fusion.fuse_legs``)
  that took its plain version, on CPU tensors; on the card each launches
  the kernel, counted in ``launch_counts["fuse_legs"]``.

Kernel launches are counted by wrapper name in
``kernels.runtime.launch_counts``, re-exported here; it is the only
counter of launches.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import gc
import itertools
import threading
import time
from typing import NamedTuple

import torch.autograd.profiler as _profiler
from torch.autograd.profiler import record_function

from tpurag_torch.kernels.runtime import launch_counts  # noqa: F401

PREFIX = "tpurag."
MAX_RECORDS = 1 << 17

counters: collections.Counter = collections.Counter()


class Record(NamedTuple):
    name: str
    start_ns: int     # time.time_ns() just before the range opened
    end_ns: int       # ... just after it closed
    span_id: int
    parent_id: int    # 0 at a root
    call_id: int
    thread_id: int
    session: int
    attrs: dict


_records: collections.deque = collections.deque(maxlen=MAX_RECORDS)
_ids = itertools.count(1)
_local = threading.local()
_session = 0
_seen_off = True


class _Span:
    __slots__ = ("name", "attrs", "span_id", "parent_id", "call_id",
                 "start_ns", "_range")

    def __init__(self, name: str, call_id, attrs: dict):
        self.name = name
        self.attrs = attrs
        self.call_id = call_id

    def __enter__(self) -> "_Span":
        global _session, _seen_off
        if _seen_off:
            _session += 1
            _seen_off = False
        stack = _stack()
        parent = stack[-1] if stack else None
        self.span_id = next(_ids)
        self.parent_id = parent.span_id if parent is not None else 0
        if self.call_id is None:
            self.call_id = (parent.call_id if parent is not None
                            else self.span_id)
        self.start_ns = time.time_ns()
        self._range = record_function(PREFIX + self.name)
        self._range.__enter__()
        stack.append(self)
        return self

    def __exit__(self, *exc) -> None:
        self._range.__exit__(*exc)
        end = time.time_ns()
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        _records.append(Record(self.name, self.start_ns, end, self.span_id,
                               self.parent_id, self.call_id,
                               threading.get_ident(), _session, self.attrs))


class _Off:
    """What a span is with no session open."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> None:
        return None


_OFF = _Off()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def span(name: str, call_id: int | None = None, **attrs):
    """``with span(name, **attrs) as s:`` -- s is the open span (attrs
    may be added to ``s.attrs`` before it closes), or None with no
    profiler session open. call_id joins a span to a call opened
    earlier (a dispatched search's finalize)."""
    global _seen_off
    if not _profiler._is_profiler_enabled:
        _seen_off = True
        return _OFF
    return _Span(name, call_id, attrs)


def spanned(name: str):
    """Decorator: the whole function as one span called `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def traced(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return traced
    return wrap


@contextlib.contextmanager
def timed(ns_key: str, calls_key: str | None = None):
    """Add the block's perf_counter nanoseconds to counters[ns_key] (and
    one to counters[calls_key]), profiler or not."""
    t0 = time.perf_counter_ns()
    try:
        yield
    finally:
        counters[ns_key] += time.perf_counter_ns() - t0
        if calls_key:
            counters[calls_key] += 1


def _on_gc(phase: str, info: dict) -> None:
    """gc.callbacks hook: each collection inside a session as a `gc`
    span under the span it interrupted."""
    if not _profiler._is_profiler_enabled:
        return
    if phase == "start":
        s = _Span("gc", None, {"generation": info.get("generation")})
        s.__enter__()
        _local.gc_span = s
    else:
        s = getattr(_local, "gc_span", None)
        if s is not None:
            _local.gc_span = None
            s.__exit__(None, None, None)


gc.callbacks.append(_on_gc)


def spans() -> list[Record]:
    """The buffered records, oldest first (at most MAX_RECORDS)."""
    return list(_records)


def clear() -> None:
    """Drop the buffered records and zero `counters` (launch_counts is
    left as it is)."""
    _records.clear()
    counters.clear()
