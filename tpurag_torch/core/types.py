# Copied from tpurag/core/types.py (the JAX package's copy is the reference).
"""Core host-side data types.

Device-side data is plain torch tensors; these types are the host metadata that
travels alongside them (chunk text, document names, sources). Mirrors the
reference's SearchResult / ContextChunk shapes (src/lib/context/types.ts)
without the LlamaIndex node machinery.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Any, Optional


def content_key(text: str) -> str:
    """Stable dedup key for a chunk's content.

    The reference dedups fused results on the first 100 chars of content
    (src/lib/hybrid-search.ts:149); a content hash is the id-based
    equivalent that survives device round-trips.
    """
    return hashlib.blake2b(text.encode("utf-8"), digest_size=16).hexdigest()


@dataclasses.dataclass
class Chunk:
    """One indexed unit of text."""

    text: str
    doc_id: str = ""
    doc_name: str = ""
    chunk_index: int = 0
    source: str = "document"          # document | memory | code | entity | relation
    metadata: dict = dataclasses.field(default_factory=dict)

    @property
    def key(self) -> str:
        return content_key(self.text)

    def display_text(self) -> str:
        """The reference prepends a '【文档: name】' header to every doc chunk
        (src/lib/llm/index-manager.ts:75-97)."""
        if self.doc_name and self.source == "document":
            return f"【文档: {self.doc_name}】\n{self.text}"
        return self.text


@dataclasses.dataclass
class SearchResult:
    """One retrieval hit."""

    chunk_id: int
    score: float
    text: str = ""
    doc_name: str = ""
    source: str = "document"          # which index produced it
    found_in: tuple[str, ...] = ()    # sources that hit it (for RRF both-bonus)
    highlighted: str = ""             # **-marked match text for keyword hits
    #                                   (meilisearch.ts:222-233 _formatted)
    metadata: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class SearchResponse:
    """A batch-of-one query response with per-source stats.

    Mirrors getSourceStats (src/lib/hybrid-search.ts:378-399)."""

    results: list[SearchResult]
    query: str = ""
    stats: dict = dataclasses.field(default_factory=dict)

    def format(self, max_results: int = 3) -> str:
        """Human-readable result block, mirrors formatSearchResults
        (src/lib/hybrid-search.ts:364-376)."""
        lines = []
        for i, r in enumerate(self.results[:max_results]):
            head = f"[{i + 1}] (score={r.score:.3f}"
            if r.doc_name:
                head += f", doc={r.doc_name}"
            head += f", via={'+'.join(r.found_in) or r.source})"
            lines.append(head)
            lines.append(r.text)
        return "\n".join(lines)


@dataclasses.dataclass
class MemoryEntry:
    """A stored memory (mem0-style).

    Reference: prisma Memory model (prisma/schema.prisma:87-106) +
    src/lib/memory/store.ts."""

    content: str
    memory_type: str = "fact"          # preference | fact | context | instruction
    confidence: float = 1.0
    access_count: int = 0
    created_at: float = dataclasses.field(default_factory=time.time)
    last_accessed_at: float = dataclasses.field(default_factory=time.time)
    memory_id: int = -1
    metadata: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Entity:
    """Graph node (entity) — reference: LightRAG vdb_entities."""

    name: str
    entity_type: str = ""
    description: str = ""
    entity_id: int = -1
    source_chunk_ids: list[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Relation:
    """Graph edge — reference: LightRAG vdb_relations + GraphML edges."""

    src: str
    dst: str
    description: str = ""
    keywords: str = ""
    weight: float = 1.0
    relation_id: int = -1
    source_chunk_ids: list[int] = dataclasses.field(default_factory=list)


Metadata = dict[str, Any]
OptionalFloat = Optional[float]
