# Ported from tpurag/api/knowledge_base.py (single device, device store).
"""KnowledgeBase, the user-facing facade.

One object owning the dense index, the inverted index, an optional IVF
partition and host-side chunk metadata, with ingest, search in modes
hybrid / vector / keyword / ivf / hybrid_ivf, and save/load. Every index
lives on an explicit ``device`` ("cuda" by default; pass "cpu" to run
the plain versions of the kernels). The save format is the JAX
package's, so a KB saved by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import pathlib
import threading
import time
import traceback
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from tpurag_torch.core.chunkstore import ChunkStore
from tpurag_torch.core.config import EngineConfig, HybridPreset, PRESETS
from tpurag_torch.core.types import Chunk, SearchResponse, SearchResult
from tpurag_torch.engine.hybrid import SOURCE_BITS, decode_bits, hybrid_search
from tpurag_torch.index.dense import DenseIndex, l2_normalize, not_ported
from tpurag_torch.index.highlighter import highlight_batch
from tpurag_torch.index.inverted import InvertedIndex
from tpurag_torch.index.ivf import IVFIndex
from tpurag_torch.ingest.chunker import chunk_text
from tpurag_torch.ingest.embedder import HashEmbedder
from tpurag_torch.ingest.tokenizer import tokenize_query
from tpurag_torch.kernels.dense import dense_topk
from tpurag_torch.kernels.runtime import NEG_INF
from tpurag_torch.kernels.topk import merge_topk
from tpurag_torch.utils import tracing
from tpurag_torch.utils.locks import RWLock

Embedder = Callable[[list[str]], np.ndarray]

# A result's found_in for each value of its source bits (decode_bits
# reads no higher bit), shared by every result.
_SOURCE_MASK = (1 << len(SOURCE_BITS)) - 1
_FOUND_IN = tuple(decode_bits(v) for v in range(_SOURCE_MASK + 1))


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
        """device: where the indexes live ("cuda" or "cpu"); nothing
        falls back to the CPU on its own. quant: int8-sidecar dense scans
        with an exact rescore (index/dense.py); build_ivf() then packs an
        int8 partition too. mesh / store='host' are the JAX package's
        options that this port does not have yet."""
        if mesh is not None:
            raise not_ported("KnowledgeBase(mesh=...) (Queue 1, 'Sharding')")
        if store != "device" or backing is not None:
            raise not_ported("KnowledgeBase(store='host') (Queue 1, "
                             "'host store')")
        self.name = name
        self.config = config or EngineConfig()
        self.embedder = embedder or HashEmbedder(dim or 256)
        self.dim = dim or getattr(self.embedder, "dim", self.config.device.dim)
        self.device = torch.device(device)
        self.quant = bool(quant)
        self.dense = DenseIndex(self.dim, dtype=self.config.device.dtype,
                                capacity=self.config.device.min_capacity,
                                device=self.device, quant=self.quant)
        self.inverted = InvertedIndex(self.config.bm25, device=self.device)
        self.chunks = ChunkStore()
        self._doc_chunks: dict[str, list[int]] = {}
        self._ivf: Optional[IVFIndex] = None
        self._ivf_built_at = 0  # n_active snapshot the IVF was built from
        self._ivf_seed = 0      # seed of the last build, reused on refresh
        self._ivf_refreshing = False  # single-flight background rebuild
        self._ivf_refresh_flag = threading.Lock()
        self._ivf_refresh_thread: Optional[threading.Thread] = None
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
        with self._mutex.write(), tracing.timed("ingest_ns", "ingest_calls"):
            texts = [c.display_text() for c in chunks]
            if vectors is None:
                vectors = self.embedder(texts)
            ids = self.dense.add(vectors)
            for cid, chunk in zip(ids, chunks):
                got = self.chunks.append(chunk)  # stamps indexed_at
                assert got == int(cid)
                self._doc_chunks.setdefault(chunk.doc_id, []).append(int(cid))
            self.inverted.add_batch([int(i) for i in ids], texts)
            self._maybe_refresh_ivf_locked()
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
        with tracing.span("search_batch", batch=len(queries), mode=mode):
            return self.search_batch_dispatch(queries, top_k=top_k,
                                              mode=mode, preset=preset,
                                              vectors=vectors)()

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
        with self._mutex.read(), tracing.span("dispatch") as sp:
            triple = self._dispatch_locked(queries, p, mode, vectors)
        call_id = sp.call_id if sp is not None else None

        def finalize() -> list[SearchResponse]:
            with tracing.span("finalize", call_id):
                with tracing.span("fetch"):
                    scores, ids, bits = (x.cpu().numpy() for x in triple)
                with self._mutex.read(), tracing.span("assemble") as asm:
                    return self._assemble(queries, scores, ids, bits, asm)

        return finalize

    def _dispatch_locked(self, queries, p, mode, vectors=None):
        """Queue the device computation for one search batch; returns the
        (scores, ids, bits) triple as device tensors."""
        if mode not in ("hybrid", "vector", "keyword", "ivf", "hybrid_ivf"):
            raise ValueError(f"unknown mode {mode!r}")
        if mode == "keyword":
            qv = None  # the keyword leg never embeds
        elif vectors is not None:
            qv = vectors
        else:
            qv = self.embedder(queries)
        if mode == "hybrid":
            return hybrid_search(self.dense, self.inverted, qv, queries, p)
        if mode == "hybrid_ivf":
            # The >= 1M-corpus hybrid point: the same BM25 leg and RRF as
            # mode='hybrid', dense candidates from the IVF partition plus
            # the exact scan of the post-build tail.
            return hybrid_search(self.dense, self.inverted, qv, queries, p,
                                 dense_search=self._ivf_leg)
        if mode in ("vector", "ivf"):
            s, i = (self.dense.search if mode == "vector"
                    else self._ivf_leg)(qv, p.final_top_k)
            keep = s >= p.min_vector_score
            ids = torch.where(keep, i, -1)
            return (torch.where(keep, s, NEG_INF), ids,
                    torch.where(ids >= 0, 1, 0))
        scores, ids = self.inverted.search(queries, p.final_top_k,
                                           as_device=True)
        return scores, ids, torch.where(ids >= 0, 2, 0)

    @tracing.spanned("dense")
    def _ivf_leg(self, qv, k: int):
        """Dense leg over the IVF partition, k candidates: the probe-scan
        plus an exact K1 scan of the rows added after the build (the
        growable-segment design: partition + active tail, compacted by
        build_ivf()). Returns (scores, ids) on the KB's device."""
        if self._ivf is None:
            raise ValueError("no IVF index: call kb.build_ivf() first")
        s, i = self._ivf.search(qv, k=k)
        tail = self.dense.n_active - self._ivf_built_at
        if tail <= 0:
            return s, i
        # The capacity slice stays on the device (a view, no copy).
        tail_emb = self.dense.embeddings[self._ivf_built_at:]
        kk = min(k, tail)
        q = l2_normalize(torch.as_tensor(qv).to(self.device))
        t_s, t_i = dense_topk(q.reshape(-1, self.dim), tail_emb, tail, kk)
        t_i = torch.where(t_i >= 0, t_i + self._ivf_built_at, -1)
        if kk < k:
            t_s = torch.nn.functional.pad(t_s, (0, k - kk), value=NEG_INF)
            t_i = torch.nn.functional.pad(t_i, (0, k - kk), value=-1)
        return merge_topk(s, i, t_s, t_i, k)

    def _assemble(self, queries: list[str], scores, ids, bits,
                  asm=None) -> list[SearchResponse]:
        """Every query's response, read from the chunk store's columns
        (one conversion of the host triple a call); the keyword-found
        results' highlights in one batched call
        (index/highlighter.highlight_batch). asm: the profiled
        `assemble` span to count into, or None."""
        # NaN scores pass, as `s <= NEG_INF / 2` lets them.
        keep = (ids >= 0) & ~(scores <= NEG_INF / 2)
        kept = ids[keep].tolist()
        rows = zip(kept, scores[keep].tolist(),
                   (bits[keep] & _SOURCE_MASK).tolist(),
                   self.chunks.result_fields(kept))
        out, marked, texts, which, qtoks = [], [], [], [], []
        for b, (query, n) in enumerate(zip(queries, keep.sum(1).tolist())):
            qtoks.append(tokenize_query(query))
            results, by_source = [], {}
            for i, s, bt, fields in itertools.islice(rows, n):
                if fields is None:  # deleted since the search ran
                    continue
                text, doc_name, source, metadata = fields
                found_in = _FOUND_IN[bt]
                r = SearchResult(i, s, text, doc_name, source, found_in, "",
                                 metadata)
                if "keyword" in found_in:
                    marked.append(r)
                    texts.append(text)
                    which.append(b)
                results.append(r)
                for src in found_in or (source,):
                    by_source[src] = by_source.get(src, 0) + 1
            out.append(SearchResponse(
                results, query, {"total": len(results),
                                 "by_source": by_source}))
        t0 = time.perf_counter_ns()
        strings, fallbacks = highlight_batch(texts, qtoks, which)
        for r, h in zip(marked, strings):
            r.highlighted = h
        if asm is not None:
            asm.attrs.update(
                results=sum(len(r.results) for r in out),
                highlights=len(texts), highlight_fallbacks=fallbacks,
                highlight_ns=time.perf_counter_ns() - t0)
        return out

    def build_ivf(self, seed: int = 0) -> IVFIndex:
        """Snapshot the dense corpus into an IVF partition for modes
        'ivf' and 'hybrid_ivf'; rows added afterwards stay searchable
        through an exact tail scan until the next rebuild."""
        with self._mutex.write():
            n = self.dense.n_active
            self._ivf = self._build_ivf_partition(n, seed)
            self._ivf_built_at = n
            self._ivf_seed = seed
            return self._ivf

    def _build_ivf_partition(self, n: int, seed: int) -> IVFIndex:
        """An IVF partition over dense rows [0, n), built without touching
        KB state: the streaming build reads bounded row blocks through
        dense.get_rows. Safe outside the lock, since rows below a
        snapshotted n never move."""
        return IVFIndex(self.config.ivf, device=self.device).build_streaming(
            self.dense.get_rows, n, dtype=self.dense.dtype, seed=seed,
            quant=self.quant)

    # -- IVF auto-refresh ------------------------------------------------------

    def _maybe_refresh_ivf_locked(self) -> None:
        """Write-lock-held ingest hook: when the exact-scanned tail
        outgrows the partition by auto_refresh_ratio (and the churn
        floor), start a single-flight background rebuild."""
        ratio = self.config.ivf.auto_refresh_ratio
        if self._ivf is None or not ratio:
            return
        tail = self.dense.n_active - self._ivf_built_at
        if tail < max(self.config.ivf.auto_refresh_min_rows,
                      ratio * max(self._ivf_built_at, 1)):
            return
        with self._ivf_refresh_flag:
            if self._ivf_refreshing:
                return
            self._ivf_refreshing = True
        t = threading.Thread(target=self._ivf_refresh_worker, daemon=True)
        self._ivf_refresh_thread = t
        t.start()

    def _ivf_refresh_worker(self) -> None:
        try:
            with self._mutex.read():
                n = self.dense.n_active
                if n <= self._ivf_built_at:
                    return  # raced with a manual build_ivf()
            # The original build's seed: a refresh keeps the partitions
            # of a custom-seeded KB reproducible.
            new_ivf = self._build_ivf_partition(n, seed=self._ivf_seed)
            with self._mutex.write():
                if self._ivf_built_at >= n:
                    return  # a newer partition won the race
                self._ivf = new_ivf
                self._ivf_built_at = n
        except Exception:  # background upkeep: slower searches, no crash
            traceback.print_exc()
        finally:
            with self._ivf_refresh_flag:
                self._ivf_refreshing = False

    def wait_ivf_refresh(self, timeout: float | None = 30.0) -> None:
        """Block until any in-flight background IVF rebuild finishes."""
        t = self._ivf_refresh_thread
        if t is not None:
            t.join(timeout=timeout)

    # -- persistence -----------------------------------------------------------

    def save(self, directory) -> None:
        """Write the JAX package's KB layout: dense.*, inverted.npz,
        kb.json and chunks.jsonl."""
        with self._mutex.write():  # a consistent snapshot across indexes
            d = pathlib.Path(directory)
            d.mkdir(parents=True, exist_ok=True)
            self.dense.save(d / "dense")
            self.inverted.save(d / "inverted")
            if self._ivf is not None:
                self._ivf.save(d / "ivf")
            emb_info: dict = {"kind": "custom"}
            if isinstance(self.embedder, HashEmbedder):
                emb_info = {"kind": "hash", "dim": self.embedder.dim,
                            "seed": self.embedder.seed}
            bm = self.config.bm25
            meta = {
                "name": self.name,
                "dim": self.dim,
                "quant": self.quant,
                "store": "device",
                # Scoring-semantics config travels with the index.
                "bm25": {"k1": bm.k1, "b": bm.b,
                         "rank_compat_scores": bm.rank_compat_scores,
                         "max_df_ratio": bm.max_df_ratio,
                         "head_m": bm.head_m,
                         "exact_scoring": bm.exact_scoring},
                "embedder": emb_info,
                "ivf": "single" if self._ivf is not None else None,
                "ivf_built_at": self._ivf_built_at,
                "ivf_seed": self._ivf_seed,
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
        if meta.get("ivf") == "sharded":
            raise not_ported("loading a sharded IVF partition (Queue 1, "
                             "'Sharding')")
        if (d / "inverted").is_dir():
            raise not_ported("loading a sharded keyword index (Queue 1, "
                             "'Sharding')")
        if config is None and meta.get("bm25"):
            base = EngineConfig()
            config = dataclasses.replace(
                base, bm25=dataclasses.replace(base.bm25, **meta["bm25"]))
        quant = bool(meta.get("quant", False))
        kb = cls(meta["name"], embedder=embedder, config=config,
                 dim=meta["dim"], device=device, quant=quant)
        kb.dense = DenseIndex.load(d / "dense", device=device, quant=quant)
        kb.inverted = InvertedIndex.load(d / "inverted", kb.config.bm25,
                                         device=device)
        if meta.get("chunks_file"):
            kb.chunks = ChunkStore()
            with open(d / meta["chunks_file"], encoding="utf-8") as f:
                for line in f:
                    kb.chunks.append(Chunk(**json.loads(line)))
        else:  # legacy inline-list saves
            kb.chunks = ChunkStore.from_dicts(meta["chunks"])
        kb._doc_chunks = {k: [int(x) for x in v]
                          for k, v in meta["doc_chunks"].items()}
        if meta.get("ivf") == "single":
            kb._ivf = IVFIndex.load(d / "ivf", config=kb.config.ivf,
                                    dtype=kb.dense.dtype, device=device)
            kb._ivf_built_at = int(meta.get("ivf_built_at", 0))
            kb._ivf_seed = int(meta.get("ivf_seed", 0))
        # else: modes 'ivf' / 'hybrid_ivf' need build_ivf() after load.
        return kb

    def __len__(self) -> int:
        return len(self.dense)
