# Copied from tpurag/utils/locks.py (the JAX package's copy is the reference).
"""Reader-writer lock for the KnowledgeBase facade.

Round-2 verdict item 6: the KB's single RLock serialized READERS against
readers, capping a multi-core host at one in-flight search. Searches are
reads (device arrays are immutable once built; layout swaps rebind
references atomically) — they may overlap; mutations (ingest, delete,
IVF rebuild, save) take the exclusive side.

Semantics:
- many concurrent readers OR one writer;
- reentrant for the owning writer (write inside write), and a writer may
  enter read sections it already covers;
- reader-preference (mutations are rare and amortized; a starved writer
  waits for a read gap — acceptable for ingest-style writes).
"""

from __future__ import annotations

import threading
from contextlib import contextmanager


class RWLock:
    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._readers = 0
        self._writer: int | None = None
        self._depth = 0

    @contextmanager
    def read(self):
        me = threading.get_ident()
        with self._cond:
            if self._writer == me:      # writer reading inside its section
                nested = True
            else:
                while self._writer is not None:
                    self._cond.wait()
                self._readers += 1
                nested = False
        try:
            yield
        finally:
            if not nested:
                with self._cond:
                    self._readers -= 1
                    if self._readers == 0:
                        self._cond.notify_all()

    @contextmanager
    def write(self):
        me = threading.get_ident()
        with self._cond:
            if self._writer == me:
                self._depth += 1
            else:
                while self._writer is not None or self._readers:
                    self._cond.wait()
                self._writer = me
                self._depth = 1
        try:
            yield
        finally:
            with self._cond:
                self._depth -= 1
                if self._depth == 0:
                    self._writer = None
                    self._cond.notify_all()
