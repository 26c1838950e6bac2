# Ported from tpurag/api/knowledge_base.py (single device, device store,
# modes vector / keyword / hybrid).
"""KnowledgeBase, the user-facing facade.

One object owning the dense index, the inverted index and host-side
chunk metadata, with ingest, hybrid/dense/keyword search and save/load.
Both indexes live on an explicit ``device`` ("cuda" by default; pass
"cpu" to run the plain versions of the kernels). The save format is the
JAX package's, so a KB saved by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from tpurag_torch.core.chunkstore import ChunkStore
from tpurag_torch.core.config import EngineConfig, HybridPreset, PRESETS
from tpurag_torch.core.types import Chunk, SearchResponse, SearchResult
from tpurag_torch.engine.hybrid import decode_bits, hybrid_search
from tpurag_torch.index.dense import DenseIndex, not_ported
from tpurag_torch.index.inverted import InvertedIndex, highlight
from tpurag_torch.ingest.chunker import chunk_text
from tpurag_torch.ingest.embedder import HashEmbedder
from tpurag_torch.ingest.tokenizer import tokenize_query
from tpurag_torch.kernels.runtime import NEG_INF
from tpurag_torch.utils.locks import RWLock

Embedder = Callable[[list[str]], np.ndarray]


class KnowledgeBase:
    def __init__(
        self,
        name: str = "kb",
        embedder: Optional[Embedder] = None,
        config: Optional[EngineConfig] = None,
        dim: Optional[int] = None,
        mesh=None,
        quant: bool = False,
        store: str = "device",
        backing=None,
        device="cuda",
    ):
        """device: where both indexes live ("cuda" or "cpu"); nothing
        falls back to the CPU on its own. mesh / quant / store='host' are
        the JAX package's options that this port does not have yet."""
        if mesh is not None:
            raise not_ported("KnowledgeBase(mesh=...) (Queue 1, 'Sharding')")
        if quant:
            raise not_ported("KnowledgeBase(quant=True) (Queue 1, "
                             "'int8 slice')")
        if store != "device" or backing is not None:
            raise not_ported("KnowledgeBase(store='host') (Queue 1, "
                             "'host store')")
        self.name = name
        self.config = config or EngineConfig()
        self.embedder = embedder or HashEmbedder(dim or 256)
        self.dim = dim or getattr(self.embedder, "dim", self.config.device.dim)
        self.device = torch.device(device)
        self.dense = DenseIndex(self.dim, dtype=self.config.device.dtype,
                                capacity=self.config.device.min_capacity,
                                device=self.device)
        self.inverted = InvertedIndex(self.config.bm25, device=self.device)
        self.chunks = ChunkStore()
        self._doc_chunks: dict[str, list[int]] = {}
        # Searches are READS and run concurrently; mutations take the
        # exclusive side.
        self._mutex = RWLock()

    # -- ingest --------------------------------------------------------------

    def add_document(self, name: str, text: str, doc_id: str = "",
                     source: str = "document",
                     metadata: dict | None = None) -> list[int]:
        """Chunk + embed + index one document. Returns chunk ids."""
        doc_id = doc_id or name
        pieces = chunk_text(text, self.config.chunking)
        chunks = [
            Chunk(text=p, doc_id=doc_id, doc_name=name, chunk_index=i,
                  source=source, metadata=dict(metadata or {}))
            for i, p in enumerate(pieces)
        ]
        return self.add_chunks(chunks)

    def add_chunks(self, chunks: Sequence[Chunk],
                   vectors: Optional[np.ndarray] = None) -> list[int]:
        """Index pre-chunked units (vectors optional: embedded here if
        absent). The indexed text includes the '【文档: name】' header the
        reference prepends, so doc names are keyword-searchable."""
        if not chunks:
            return []
        with self._mutex.write():
            texts = [c.display_text() for c in chunks]
            if vectors is None:
                vectors = self.embedder(texts)
            ids = self.dense.add(vectors)
            for cid, chunk in zip(ids, chunks):
                got = self.chunks.append(chunk)  # stamps indexed_at
                assert got == int(cid)
                self._doc_chunks.setdefault(chunk.doc_id, []).append(int(cid))
            self.inverted.add_batch([int(i) for i in ids], texts)
            return [int(i) for i in ids]

    def delete_document(self, doc_id: str) -> int:
        """Delete all chunks of a document from BOTH indexes (tombstones
        with overfetch until the next compaction)."""
        with self._mutex.write():
            ids = self._doc_chunks.pop(doc_id, [])
            if ids:
                self.dense.delete(ids)
                self.inverted.delete_docs(ids)
                for cid in ids:
                    self.chunks.mark_deleted(cid)
            return len(ids)

    # -- query ---------------------------------------------------------------

    def _preset(self, preset: str | HybridPreset | None,
                top_k: int | None) -> HybridPreset:
        p = preset if isinstance(preset, HybridPreset) else PRESETS[
            preset or self.config.preset]
        if top_k is not None:
            p = dataclasses.replace(p, final_top_k=top_k)
        return p

    def search(self, query: str, top_k: int | None = None,
               mode: str = "hybrid",
               preset: str | HybridPreset | None = None) -> SearchResponse:
        return self.search_batch([query], top_k=top_k, mode=mode,
                                 preset=preset)[0]

    def search_batch(self, queries: list[str], top_k: int | None = None,
                     mode: str = "hybrid",
                     preset: str | HybridPreset | None = None,
                     vectors=None) -> list[SearchResponse]:
        """vectors: optional (B, dim) pre-computed query embeddings; skips
        the embedder (texts still drive the keyword leg and highlights)."""
        return self.search_batch_dispatch(queries, top_k=top_k, mode=mode,
                                          preset=preset, vectors=vectors)()

    def search_batch_dispatch(self, queries: list[str],
                              top_k: int | None = None,
                              mode: str = "hybrid",
                              preset: str | HybridPreset | None = None,
                              vectors=None):
        """Phase-split search for pipelined serving: does the host-side
        prep and QUEUES the device work, returning a zero-arg finalize()
        that pays the one host transfer and assembles responses. Device
        work runs in stream order, so a later mutation's writes land
        after this batch's kernels; finalize re-takes the read lock for
        the chunk-store assembly (deleted chunks drop out)."""
        p = self._preset(preset, top_k)
        with self._mutex.read():
            triple = self._dispatch_locked(queries, p, mode, vectors)

        def finalize() -> list[SearchResponse]:
            scores, ids, bits = (x.cpu().numpy() for x in triple)
            with self._mutex.read():
                return [self._assemble(q, scores[b], ids[b], bits[b])
                        for b, q in enumerate(queries)]

        return finalize

    def _dispatch_locked(self, queries, p, mode, vectors=None):
        """Queue the device computation for one search batch; returns the
        (scores, ids, bits) triple as device tensors."""
        if mode in ("ivf", "hybrid_ivf"):
            raise not_ported(f"mode={mode!r} (Queue 1, 'IVF slice')")
        if mode not in ("hybrid", "vector", "keyword"):
            raise ValueError(f"unknown mode {mode!r}")
        if mode == "keyword":
            qv = None  # the keyword leg never embeds
        elif vectors is not None:
            qv = vectors
        else:
            qv = self.embedder(queries)
        if mode == "hybrid":
            return hybrid_search(self.dense, self.inverted, qv, queries, p)
        if mode == "vector":
            s, i = self.dense.search(qv, p.final_top_k)
            keep = s >= p.min_vector_score
            ids = torch.where(keep, i, -1)
            return (torch.where(keep, s, NEG_INF), ids,
                    torch.where(ids >= 0, 1, 0))
        scores, ids = self.inverted.search(queries, p.final_top_k,
                                           as_device=True)
        return scores, ids, torch.where(ids >= 0, 2, 0)

    def _assemble(self, query: str, scores, ids, bits) -> SearchResponse:
        qtoks = tokenize_query(query)
        results = []
        for s, i, bt in zip(scores, ids, bits):
            i = int(i)
            if i < 0 or s <= NEG_INF / 2:
                continue
            c = self.chunks[i]
            if c.metadata.get("deleted"):
                continue
            found_in = decode_bits(int(bt))
            results.append(SearchResult(
                chunk_id=i, score=float(s), text=c.text, doc_name=c.doc_name,
                source=c.source, found_in=found_in,
                highlighted=(highlight(c.text, qtoks)
                             if "keyword" in found_in else ""),
                metadata=c.metadata,
            ))
        stats = {"total": len(results), "by_source": {}}
        for r in results:
            for src in (r.found_in or (r.source,)):
                stats["by_source"][src] = stats["by_source"].get(src, 0) + 1
        return SearchResponse(results=results, query=query, stats=stats)

    def build_ivf(self, seed: int = 0):
        raise not_ported("KnowledgeBase.build_ivf (Queue 1, 'IVF slice')")

    # -- persistence -----------------------------------------------------------

    def save(self, directory) -> None:
        """Write the JAX package's KB layout: dense.*, inverted.npz,
        kb.json and chunks.jsonl."""
        with self._mutex.write():  # a consistent snapshot across indexes
            d = pathlib.Path(directory)
            d.mkdir(parents=True, exist_ok=True)
            self.dense.save(d / "dense")
            self.inverted.save(d / "inverted")
            emb_info: dict = {"kind": "custom"}
            if isinstance(self.embedder, HashEmbedder):
                emb_info = {"kind": "hash", "dim": self.embedder.dim,
                            "seed": self.embedder.seed}
            bm = self.config.bm25
            meta = {
                "name": self.name,
                "dim": self.dim,
                "quant": False,
                "store": "device",
                # Scoring-semantics config travels with the index.
                "bm25": {"k1": bm.k1, "b": bm.b,
                         "rank_compat_scores": bm.rank_compat_scores,
                         "max_df_ratio": bm.max_df_ratio,
                         "head_m": bm.head_m,
                         "exact_scoring": bm.exact_scoring},
                "embedder": emb_info,
                "ivf": None,
                "ivf_built_at": 0,
                "ivf_seed": 0,
                "chunks_file": "chunks.jsonl",
                "doc_chunks": self._doc_chunks,
            }
            (d / "kb.json").write_text(json.dumps(meta, ensure_ascii=False))
            with open(d / "chunks.jsonl", "w", encoding="utf-8") as f:
                for cd in self.chunks.to_dicts():
                    f.write(json.dumps(cd, ensure_ascii=False))
                    f.write("\n")

    @classmethod
    def load(cls, directory, embedder: Optional[Embedder] = None,
             config: Optional[EngineConfig] = None,
             device="cuda") -> "KnowledgeBase":
        """Load a KB saved by this package or by the JAX package (single
        device, device or host store: the artifacts are the same)."""
        d = pathlib.Path(directory)
        meta = json.loads((d / "kb.json").read_text())
        if embedder is None:
            info = meta.get("embedder") or {}
            if info.get("kind") == "hash":
                embedder = HashEmbedder(info["dim"], seed=info.get("seed", 0))
            elif info.get("kind") == "encoder":
                raise not_ported("loading an encoder KB (Queue 1, 'Encoder')")
        if meta.get("quant"):
            raise not_ported("loading a quant=True KB (Queue 1, "
                             "'int8 slice')")
        if (d / "inverted").is_dir():
            raise not_ported("loading a sharded keyword index (Queue 1, "
                             "'Sharding')")
        if config is None and meta.get("bm25"):
            base = EngineConfig()
            config = dataclasses.replace(
                base, bm25=dataclasses.replace(base.bm25, **meta["bm25"]))
        kb = cls(meta["name"], embedder=embedder, config=config,
                 dim=meta["dim"], device=device)
        kb.dense = DenseIndex.load(d / "dense", device=device)
        kb.inverted = InvertedIndex.load(d / "inverted", kb.config.bm25,
                                         device=device)
        kb.chunks = ChunkStore()
        with open(d / meta["chunks_file"], encoding="utf-8") as f:
            for line in f:
                kb.chunks.append(Chunk(**json.loads(line)))
        kb._doc_chunks = {k: [int(x) for x in v]
                          for k, v in meta["doc_chunks"].items()}
        return kb

    def __len__(self) -> int:
        return len(self.dense)
