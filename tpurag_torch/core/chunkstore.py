# Copied from tpurag/core/chunkstore.py (the JAX package's copy is the reference).
"""Columnar chunk storage.

The reference keeps every indexed chunk as a JS object inside LlamaIndex's
JSON-persisted store (src/lib/llm/index-manager.ts:75-117) — fine at 10k
chunks, fatal at 10M: one Python ``Chunk`` dataclass + its metadata dict
costs ~700 bytes, so 10M chunks would burn ~7 GB of host RAM on object
headers alone. This store keeps the corpus as parallel columns (lists of
interned strings + sparse metadata) at ~100-150 bytes/chunk and
materializes ``Chunk`` views on access, so ``kb.chunks[i]`` / iteration /
slicing keep working unchanged.

Mutation goes through the store (``mark_deleted`` / ``set_meta``), not
through a materialized view's ``metadata`` dict — views are snapshots.
"""

from __future__ import annotations

import sys
import time
from typing import Iterator, Optional

from tpurag_torch.core.types import Chunk


class ChunkStore:
    __slots__ = ("texts", "_doc_ids", "_doc_names", "_chunk_index",
                 "_sources", "_indexed_at", "_meta", "_deleted")

    def __init__(self) -> None:
        self.texts: list[str] = []
        self._doc_ids: list[str] = []
        self._doc_names: list[str] = []
        self._chunk_index: list[int] = []
        self._sources: list[str] = []
        self._indexed_at: list[float] = []
        self._meta: dict[int, dict] = {}     # sparse: only non-empty
        self._deleted: set[int] = set()

    # -- mutation ----------------------------------------------------------

    def append(self, c: Chunk) -> int:
        cid = len(self.texts)
        self.texts.append(c.text)
        self._doc_ids.append(sys.intern(c.doc_id))
        self._doc_names.append(sys.intern(c.doc_name))
        self._chunk_index.append(int(c.chunk_index))
        self._sources.append(sys.intern(c.source))
        md = dict(c.metadata) if c.metadata else {}
        if md.pop("deleted", None):
            self._deleted.add(cid)
        self._indexed_at.append(float(md.pop("indexed_at", 0.0))
                                or time.time())
        if md:
            self._meta[cid] = md
        return cid

    def mark_deleted(self, cid: int) -> None:
        self._deleted.add(int(cid))

    def is_deleted(self, cid: int) -> bool:
        return int(cid) in self._deleted

    def set_meta(self, cid: int, key: str, value) -> None:
        if key == "deleted":
            if value:
                self._deleted.add(int(cid))
            else:
                self._deleted.discard(int(cid))
            return
        self._meta.setdefault(int(cid), {})[key] = value

    # -- access ------------------------------------------------------------

    def _materialize(self, i: int) -> Chunk:
        md = dict(self._meta.get(i, ()))
        md["indexed_at"] = self._indexed_at[i]
        if i in self._deleted:
            md["deleted"] = True
        return Chunk(text=self.texts[i], doc_id=self._doc_ids[i],
                     doc_name=self._doc_names[i],
                     chunk_index=self._chunk_index[i],
                     source=self._sources[i], metadata=md)

    def result_fields(self, ids) -> Iterator[Optional[tuple]]:
        """For each id in turn, (text, doc_name, source, metadata) as a
        search result carries them, straight from the columns, or None
        for a deleted chunk. metadata is a new dict per id, equal to the
        view's: the sparse metadata, then ``indexed_at``. A generator, so
        that each tuple dies as soon as it is read and no call's worth of
        them lives on into the collector's older generations."""
        texts, names, sources = self.texts, self._doc_names, self._sources
        meta, at, deleted = self._meta, self._indexed_at, self._deleted
        for i in ids:
            if i in deleted:
                yield None
            elif i in meta:
                yield (texts[i], names[i], sources[i],
                       {**meta[i], "indexed_at": at[i]})
            else:
                yield texts[i], names[i], sources[i], {"indexed_at": at[i]}

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self._materialize(j)
                    for j in range(*i.indices(len(self.texts)))]
        n = len(self.texts)
        if i < 0:
            i += n
        if not 0 <= i < n:
            raise IndexError(i)
        return self._materialize(i)

    def __len__(self) -> int:
        return len(self.texts)

    def __iter__(self) -> Iterator[Chunk]:
        for i in range(len(self.texts)):
            yield self._materialize(i)

    def __bool__(self) -> bool:
        return bool(self.texts)

    # -- persistence helpers (kb.json schema unchanged) ---------------------

    def to_dicts(self) -> Iterator[dict]:
        """Streaming save: one dict per chunk, identical schema to the
        old list[Chunk] serialization."""
        for i in range(len(self.texts)):
            c = self._materialize(i)
            yield {"text": c.text, "doc_id": c.doc_id,
                   "doc_name": c.doc_name, "chunk_index": c.chunk_index,
                   "source": c.source, "metadata": c.metadata}

    @classmethod
    def from_dicts(cls, dicts) -> "ChunkStore":
        store = cls()
        for d in dicts:
            store.append(Chunk(**d))
        return store

    @classmethod
    def from_chunks(cls, chunks) -> "ChunkStore":
        store = cls()
        for c in chunks:
            store.append(c)
        return store
