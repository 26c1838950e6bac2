# Ported from tpurag/index/inverted.py (single device).
"""Inverted index (keyword search).

Host side: vocabulary + per-term postings accumulated incrementally,
each term's doc ids and term frequencies in a bytearray of int32 (the
.npz format's width; the collector neither tracks nor walks them).
``add_batch`` tokenizes, counts and groups a batch by term in native
calls (index/postings.py) and appends each term's postings at once;
``add`` is the plain path, a document at a time.

Device layout (same as the JAX package):
- postings live in per-width BUCKET MATRICES on the index's device: each
  term's doc-sorted postings (+ build-time precomputed BM25 impacts)
  occupy one row of the (n_terms_w + 1, w) matrix for its power-of-two
  width bucket, padded with doc=2^30 / impact=0; row 0 is the pad row;
- queries are width-classed: a search resolves each query's terms
  against a segment once (``InvertedIndex._resolve``) and one routine
  (``_classes``) groups the resolved rows, each query running at the max
  bucket width of its own terms, rounded up to BM25Config.width_ladder;
- scoring tail = merge + segment sum + top-k of every class of a search in
  one call that reads the bucket rows' live lanes itself
  (kernels/bm25_merge.merge_segsum_topk_classes, K2: one CUDA launch per
  search on the card, its plain version on the CPU), each query's result
  written straight into the search's (B, k) buffers; classes wider than
  its limit take kernels/bm25.segsum_topk_candidates;
- queries holding a term whose bucket is wider than ``wide_term_width``
  split additively: their narrow terms and their wide terms each merge
  into full doc-sorted rows of per-doc partial sums, every class of the
  search in one call that reads the bucket rows itself
  (kernels/bm25_merge.merge_segsum_full_classes, K3, one launch per
  search), and one call joins every wide class with its members' narrow
  rows into an exact top-k (kernels/bm25_join.combine_topk_classes, K4,
  one launch per search);
- ``BM25Config.head_m`` > 0 keeps only a term's head_m highest-impact
  postings (approximate; exact_scoring=True turns it off).

Mutability: adds after the first build land in a TAIL segment; deletes
tombstone ids (candidate overfetch + filter); compact() rebuilds.
The class tables reach the card as one non-blocking copy from pinned
memory per kernel, so a search queues its work without waiting on the
device.

save/load use the JAX package's ``.npz`` format.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import math
import pathlib
import re
import struct
import threading

import numpy as np
import torch

from tpurag_torch.core.config import BM25Config
from tpurag_torch.index import postings
from tpurag_torch.ingest.tokenizer import tokenize, tokenize_query
from tpurag_torch.kernels.bm25 import rank_compat, segsum_topk_candidates
from tpurag_torch.kernels.bm25_join import combine_topk_classes
from tpurag_torch.kernels.bm25_merge import (merge_ok,
                                             merge_segsum_full_classes,
                                             merge_segsum_topk_classes,
                                             slot_rows)
from tpurag_torch.kernels.runtime import NEG_INF, round_up
from tpurag_torch.kernels.topk import merge_topk
from tpurag_torch.utils import tracing

_BIG = 2**30
_INT = struct.Struct("i")  # one doc id or term frequency of a posting
NATIVE_MIN_DOCS = 8  # smaller batches take add(): the native call's set-up


def _ints(buf) -> np.ndarray:
    """A postings buffer as int32: a view, so the buffer cannot grow
    while it lives."""
    return np.frombuffer(buf, np.int32)


def _buf(values) -> bytearray:
    """A postings buffer holding `values` as int32."""
    return bytearray(np.ascontiguousarray(values, np.int32))


def _joined(bufs: list, tids, ranges) -> np.ndarray:
    """bufs[t]'s postings ranges[t] = (start, end), for t in tids, end
    to end as one int32 array."""
    w = _INT.size
    return np.frombuffer(b"".join(
        memoryview(bufs[t])[w * ranges[t][0]:w * ranges[t][1]]
        for t in tids), np.int32)


def _next_pow2(x: int) -> int:
    return 1 << max(x - 1, 1).bit_length() if x > 2 else max(x, 1)


def packed_cbits(n_docs: int, enabled: bool = True) -> int:
    """Contribution bits for the packed merge (kernels/bm25_merge.py):
    31 - doc-id bits, 0 (= unpacked) when fewer than 12 bits remain."""
    if not enabled:
        return 0
    c = 31 - max(int(n_docs) + 1, 2).bit_length()
    return c if c >= 12 else 0


def full_cbits(w: int, t: int, cbits: int) -> int:
    """The packing a (B, w) full-row class merges with: the JAX package
    packs full rows only on its Pallas route (bm25_pallas.wide_merge_ok:
    up to 16384 lanes, or 32768 when packed or t >= 4) and merges the
    rest unpacked, so the port packs exactly where it does."""
    if w <= 1 << 14 or (w <= 1 << 15 and (cbits > 0 or t >= 4)):
        return cbits
    return 0


def _front(slots, keep):
    """The slots `keep` marks, moved to the front of their row in order
    (the others emptied to 0), and each row's count of them."""
    front = (np.arange(len(keep))[:, None],
             np.argsort(~keep, axis=1, kind="stable"))
    kept = keep[front]
    return [x[front] * kept for x in slots], kept.sum(axis=1)


def _classes(slots, counts, sel, ladder=()):
    """Group resolved query rows into classes of one key (p_max, t_max).

    slots: (bucketw, rowid, live, idf) (n, t) host arrays as
    ``InvertedIndex._resolve`` or ``_front`` give them; counts: (n,) each
    row's slots; sel: (n,) int64, each row's row in the output. p_max is
    the row's largest bucket width (16 with none) rounded up `ladder`,
    t_max the next power of two of its count. Returns [(p_max, t_max,
    sel, bucketw, rowid, live, idf)] with (g, t_max) arrays, classes in
    the order of their first row and members in row order."""
    groups: dict[tuple[int, int], list[int]] = {}
    for i, (p, n) in enumerate(zip(
            np.maximum(slots[0].max(axis=1), 16).tolist(), counts.tolist())):
        key = (min((w for w in ladder if w >= p), default=p), _next_pow2(n))
        groups.setdefault(key, []).append(i)
    out = []
    for (p, t), members in groups.items():
        m = np.asarray(members, np.int64)
        out.append((p, t, sel[m], *(x[m, :t] for x in slots)))
    return out


def wide_flow(n_classes, w_classes, h: int, kk: int, layout: "_Layout",
              cbits: int):
    """Device flow for queries holding wide terms.

    n_classes / w_classes: the narrow and the wide side's classes of the
    h rows (``_classes``). One merge_segsum_full_classes call (one K3
    launch) merges every class straight from the bucket matrices: the
    narrow classes into one (h, widest narrow class) full-row buffer, each
    wide class into rows of its own; one combine_topk_classes call (one K4
    launch) joins every wide class with its members' narrow rows, each
    member reading only its own narrow class's width. Returns (h, kk)
    scores / ids."""
    def spec(cls):
        p_max, t, *rest = cls
        return (p_max, t, full_cbits(t * p_max, t, cbits), *rest)

    n_width = np.zeros(h, np.int64)
    for p_max, t, sel, *_ in n_classes:
        n_width[sel] = p_max * t
    n_val, n_doc, wides = merge_segsum_full_classes(
        layout.widths, layout.mats, [spec(c) for c in n_classes],
        [spec(c) for c in w_classes], h, int(n_width.max()))
    classes = [(w_seg, w_doc, cls[2], n_width[cls[2]])
               for (w_seg, w_doc), cls in zip(wides, w_classes)]
    # One doc spans at most max narrow t + wide t lanes across the two
    # merged sides: the window of the plain version's segment sum.
    window = max(2, max(c[1] for c in n_classes)
                 + max(c[1] for c in w_classes))
    return combine_topk_classes(n_val, n_doc, classes, k=kk, window=window)


@dataclasses.dataclass
class _Layout:
    """One device-resident postings segment."""

    widths: tuple
    mats: tuple               # ((doc, imp) tensor pairs) aligned with widths
    term_bucket: np.ndarray   # (V,) int32 bucket width, 0 = term absent
    term_row: np.ndarray      # (V,) int32 row index (0 = pad row)
    term_len: np.ndarray      # (V,) int32 postings in the term's row
    device: torch.device
    nnz: int = 0


def highlight(text: str, query_tokens: list[str],
              mark: str = "**") -> str:
    """Wrap query-term matches in `mark` (meilisearch.ts:222-233
    _formatted content with highlightPreTag/PostTag)."""
    toks = sorted({t for t in query_tokens if t}, key=len, reverse=True)
    if not toks:
        return text
    pat = re.compile("|".join(re.escape(t) for t in toks), re.IGNORECASE)
    return pat.sub(lambda m: f"{mark}{m.group(0)}{mark}", text)


class InvertedIndex:
    # Auto-compaction policy (tail/delete growth bounds).
    TAIL_COMPACT_RATIO = 0.25
    TAIL_COMPACT_MIN = 4096
    DEAD_COMPACT_RATIO = 0.10
    DEAD_COMPACT_MIN = 64

    def __init__(self, config: BM25Config | None = None, device="cuda"):
        self.config = config or BM25Config()
        self.device = torch.device(device)
        self.vocab: dict[str, int] = {}
        self._postings_doc: list[bytearray] = []   # per-term doc ids
        self._postings_tf: list[bytearray] = []    # per-term frequencies
        self.doc_len: list[int] = []               # tokens per doc id
        self.n_docs = 0                            # live docs
        self._total_tokens = 0                     # live token count
        self._main: _Layout | None = None
        self._main_count: list[int] = []  # per-term postings in main
        self._tail: _Layout | None = None
        self._tail_nnz = 0
        self._dead: set[int] = set()      # deleted ids still in layouts
        self._builds = 0                  # full compactions (observable)
        # Searches are reads under the KB's RWLock, but a read can
        # trigger the lazy compaction: single-flight it.
        self._build_lock = threading.Lock()

    # -- build ---------------------------------------------------------------

    def add(self, doc_id: int, text: str) -> None:
        """Index one document under external integer id `doc_id` (the
        dense-index row id, so RRF fusion matches candidates by id)."""
        counts: dict[str, int] = {}
        for tok in tokenize(text):
            counts[tok] = counts.get(tok, 0) + 1
        total = 0
        for term, c in counts.items():
            tid = self.vocab.get(term)
            if tid is None:
                tid = self._new_term(term)
            self._postings_doc[tid] += _INT.pack(doc_id)
            self._postings_tf[tid] += _INT.pack(c)
            total += c
        while len(self.doc_len) <= doc_id:
            self.doc_len.append(0)
        self.doc_len[doc_id] = total
        self.n_docs += 1
        self._total_tokens += total
        if self._main is not None:
            self._tail_nnz += len(counts)
            self._tail = None  # lazily rebuilt (O(tail_nnz))

    def _new_term(self, term: str) -> int:
        tid = self.vocab[term] = len(self.vocab)
        self._postings_doc.append(bytearray())
        self._postings_tf.append(bytearray())
        self._main_count.append(0)
        return tid

    def add_batch(self, ids, texts) -> None:
        """Index a batch, as add() one document after another would. From
        NATIVE_MIN_DOCS documents on, native calls tokenize, count and
        group the batch by term, and each term's postings are appended
        at once; smaller batches, batches with a text too long for one
        native call, and every batch where the host library cannot be
        built take add()."""
        with tracing.timed("ingest_keyword_ns"):
            ids = [int(i) for i in ids]
            texts = list(texts)
            lib = (postings.library() if len(ids) >= NATIVE_MIN_DOCS
                   and postings.fits(texts) else None)
            if lib is None:
                for i, t in zip(ids, texts):
                    self.add(i, t)
                tracing.counters["ingest_python_docs"] += len(ids)
                return
            self._add_native(lib, ids, texts)
            tracing.counters["ingest_native_docs"] += len(ids)

    def _add_native(self, lib, ids: list[int], texts: list[str]) -> None:
        top = max(ids)
        if len(self.doc_len) <= top:
            self.doc_len.extend([0] * (top + 1 - len(self.doc_len)))
        batch_ids = np.asarray(ids, np.int32)
        pairs = 0
        for part in postings.batch_postings(lib, texts):
            doc = memoryview(batch_ids[part.lo + part.doc]).cast("B")
            tf = memoryview(part.tf).cast("B")
            a = 0
            for term, n in zip(part.terms, part.term_docs.tolist()):
                tid = self.vocab.get(term)
                if tid is None:
                    tid = self._new_term(term)
                b = a + _INT.size * n
                self._postings_doc[tid] += doc[a:b]
                self._postings_tf[tid] += tf[a:b]
                a = b
            for i, total in zip(ids[part.lo:part.hi],
                                part.doc_total.tolist()):
                self.doc_len[i] = total
            self._total_tokens += int(part.doc_total.sum())
            pairs += len(part.doc)
        self.n_docs += len(ids)
        if self._main is not None:
            self._tail_nnz += pairs
            self._tail = None  # lazily rebuilt (O(tail_nnz))

    def delete_doc(self, doc_id: int) -> None:
        """Tombstone one document. Search overfetches past dead ids until
        the next compaction physically drops the postings."""
        doc_id = int(doc_id)
        if doc_id in self._dead or doc_id >= len(self.doc_len):
            return
        self._dead.add(doc_id)
        self.n_docs = max(self.n_docs - 1, 0)
        self._total_tokens -= self.doc_len[doc_id]

    def delete_docs(self, ids) -> None:
        for i in np.atleast_1d(ids):
            self.delete_doc(int(i))

    @property
    def _avgdl(self) -> float:
        return max(self._total_tokens / max(self.n_docs, 1), 1.0)

    def _dnorm(self) -> np.ndarray:
        n = len(self.doc_len)
        dl = np.asarray(self.doc_len, np.float32) if n else np.zeros(
            1, np.float32)
        k1, b = self.config.k1, self.config.b
        return np.maximum(k1 * (1.0 - b + b * dl / self._avgdl), 1e-6)

    def _df(self, tid: int) -> int:
        """Postings of term `tid`, dead ones included."""
        return len(self._postings_doc[tid]) // _INT.size

    def _impacts(self, tid: int, start: int, end: int, dnorm: np.ndarray):
        docs = _ints(self._postings_doc[tid])[start:end].astype(np.int64)
        tfs = _ints(self._postings_tf[tid])[start:end].astype(np.float32)
        k1 = self.config.k1
        return docs, tfs * (k1 + 1.0) / (tfs + dnorm[docs])

    def _build_layout(self, ranges: list[tuple[int, int]]) -> _Layout:
        """Build one segment layout from per-term posting ranges (one flat
        scatter per width bucket; postings arrive doc-ascending). With
        head_m > 0 a term keeps its head_m highest-impact postings
        (per-term loop, only for buckets holding such a term)."""
        v = len(self._postings_doc)
        dnorm = self._dnorm()
        head_m = self.config.head_m if not self.config.exact_scoring else 0
        term_bucket = np.zeros(v, np.int32)
        term_row = np.zeros(v, np.int32)
        term_len = np.zeros(v, np.int32)
        by_width: dict[int, list[int]] = {}
        nnz = 0
        for tid in range(v):
            s, e = ranges[tid]
            cnt = e - s
            if cnt <= 0:
                continue
            eff = min(cnt, head_m) if head_m > 0 else cnt
            w = _next_pow2(max(eff, 16))
            term_bucket[tid] = w
            term_row[tid] = len(by_width.setdefault(w, []))
            term_len[tid] = min(cnt, w)
            by_width[w].append(tid)
            nnz += cnt
        k1 = self.config.k1
        mats = []
        widths = tuple(sorted(by_width))
        for w in widths:
            tids = by_width[w]
            doc_mat = np.full((len(tids) + 1, w), _BIG, np.int32)
            imp_mat = np.zeros((len(tids) + 1, w), np.float32)
            if head_m > 0 and any(ranges[t][1] - ranges[t][0] > w
                                  for t in tids):
                for row, tid in enumerate(tids):
                    docs, imps = self._impacts(tid, *ranges[tid], dnorm)
                    if len(docs) > w:
                        # Impact-ordered head: keep the top w by impact,
                        # doc-sorted (approximate; BM25Config.head_m).
                        top = np.argpartition(-imps, w - 1)[:w]
                        top = top[np.argsort(docs[top], kind="stable")]
                        docs, imps = docs[top], imps[top]
                    doc_mat[row + 1, :len(docs)] = docs
                    imp_mat[row + 1, :len(imps)] = imps
                mats.append((torch.from_numpy(doc_mat).to(self.device),
                             torch.from_numpy(imp_mat).to(self.device)))
                continue
            lens = np.fromiter(
                (ranges[t][1] - ranges[t][0] for t in tids), np.int64,
                len(tids))
            total = int(lens.sum())
            docs = _joined(self._postings_doc, tids, ranges).astype(np.int64)
            tfs = _joined(self._postings_tf, tids, ranges).astype(np.float32)
            rows = np.repeat(np.arange(1, len(tids) + 1), lens)
            # Rows must be doc-sorted for the bitonic merge; adds are
            # normally monotone: verify, lexsort otherwise.
            if total > 1 and not np.all((np.diff(docs) >= 0)
                                        | (np.diff(rows) != 0)):
                order = np.lexsort((docs, rows))
                docs, tfs = docs[order], tfs[order]
            imps = tfs * (k1 + 1.0) / (tfs + dnorm[docs])
            offs = np.concatenate(([0], np.cumsum(lens)[:-1]))
            cols = np.arange(total) - np.repeat(offs, lens)
            doc_mat[rows, cols] = docs
            imp_mat[rows, cols] = imps
            mats.append((torch.from_numpy(doc_mat).to(self.device),
                         torch.from_numpy(imp_mat).to(self.device)))
        return _Layout(widths=widths, mats=tuple(mats),
                       term_bucket=term_bucket, term_row=term_row,
                       term_len=term_len,
                       device=self.device, nnz=nnz)

    @tracing.timed("compact_ns", "compactions")
    def compact(self) -> None:
        """Full rebuild: drop dead postings, absorb the tail, refresh
        BM25 global stats."""
        if self._dead:
            dead = np.zeros(len(self.doc_len), bool)
            dead[list(self._dead)] = True
            for tid in range(len(self._postings_doc)):
                docs = _ints(self._postings_doc[tid])
                keep = ~dead[docs]
                if keep.all():
                    continue
                self._postings_doc[tid] = _buf(docs[keep])
                self._postings_tf[tid] = _buf(
                    _ints(self._postings_tf[tid])[keep])
            for d in self._dead:
                self.doc_len[d] = 0
            self._dead = set()
        self._main_count = [len(p) // _INT.size for p in self._postings_doc]
        self._main = self._build_layout(
            [(0, c) for c in self._main_count])
        self._tail = None
        self._tail_nnz = 0
        self._builds += 1

    def _needs_compact(self) -> bool:
        if self._main is None:
            return True
        if self._tail_nnz > max(self.TAIL_COMPACT_MIN,
                                self.TAIL_COMPACT_RATIO * self._main.nnz):
            return True
        if len(self._dead) > max(self.DEAD_COMPACT_MIN,
                                 self.DEAD_COMPACT_RATIO * max(self.n_docs, 1)):
            return True
        return False

    def _tail_layout(self) -> _Layout:
        if self._tail is None:
            self._tail = self._build_layout(
                [(c, self._df(t)) for t, c in enumerate(self._main_count)])
        return self._tail

    # -- query ---------------------------------------------------------------

    def _idf(self, tid: int | None) -> float:
        """Okapi idf of term `tid` (None: out of vocabulary, df 0) in double
        precision, one math.log a term as the JAX package takes it. df
        counts dead postings until compaction: it is clamped to the live
        doc count so the idf stays positive."""
        n = max(self.n_docs, 1)
        df = 0 if tid is None else min(self._df(tid), n)
        return math.log(1.0 + (n - df + 0.5) / (df + 0.5))

    def query_idf_mass(self, queries: list[str]) -> np.ndarray:
        """Per-query total idf mass: sum of idf over ALL query tokens,
        including out-of-vocabulary ones (df=0 -> the Okapi maximum). The
        hybrid engine's keyword-coverage gate thresholds the best BM25
        score against it (engine/hybrid.py)."""
        out = np.zeros(len(queries), np.float32)
        for qi, q in enumerate(queries):
            out[qi] = sum(self._idf(self.vocab.get(tok))
                          for tok in tokenize_query(q))
        return out

    def search(self, queries: list[str], k: int, as_device: bool = False):
        """BM25 top-k for a batch of text queries.

        Returns (scores, ids) as (B, k) float32/int32 numpy arrays;
        empty slots are (NEG_INF, -1). as_device=True returns tensors on
        the index's device (for callers that fuse further, e.g. RRF)."""
        with tracing.span("keyword"):
            bqueries = [tokenize_query(q) for q in queries]
            return self.search_tokens(bqueries, k, as_device=as_device)

    def _resolve(self, rows: list[list[int]], layout: _Layout):
        """Each query's term slots in `layout`: (lens, (bucketw, rowid,
        live, idf)), lens the rows' term counts and the slots (len(rows),
        t) host arrays with t the next power of two of the longest row,
        slot j the row's j-th term: its bucket width (0 = empty: a term
        absent from the layout, or no term), matrix row (+1 past the pad
        row), postings and fp32 idf."""
        lens = np.fromiter(map(len, rows), np.int64, len(rows))
        t = _next_pow2(int(lens.max()))
        tid = np.full((len(rows), t), -1, np.int64)
        tid[np.arange(t) < lens[:, None]] = np.fromiter(
            itertools.chain.from_iterable(rows), np.int64, int(lens.sum()))
        tb = layout.term_bucket
        v = len(tb)  # terms born after this layout was built are absent
        ok = (tid >= 0) & (tid < v)
        safe = np.where(ok, tid, 0)
        ok &= tb[safe] > 0
        terms = np.unique(tid[ok])
        idf = np.zeros(tid.shape, np.float32)
        idf[ok] = np.array([self._idf(x) for x in terms.tolist()],
                           np.float32)[np.searchsorted(terms, tid[ok])]
        return lens, (tb[safe] * ok, (layout.term_row[safe] + 1) * ok,
                      layout.term_len[safe] * ok, idf)

    def _score(self, rows: list[list[int]], kk: int, layout: _Layout):
        """Score one segment: resolve the queries' terms against this
        layout once and class them (``_classes``). Queries without wide
        terms (bucket width > wide_term_width) take one
        merge_segsum_topk_classes call (one K2 launch), classes past its
        MAX_MERGE_LANES segsum_topk_candidates; queries holding wide terms
        split into a narrow and a wide side combined exactly
        (``wide_flow``)."""
        bsz = len(rows)
        scores = torch.full((bsz, kk), NEG_INF, dtype=torch.float32,
                            device=self.device)
        ids = torch.full((bsz, kk), -1, dtype=torch.int32, device=self.device)
        if not layout.mats or not bsz:
            return scores, ids
        lens, slots = self._resolve(rows, layout)
        wide = slots[0] > self.config.wide_term_width
        hard = wide.any(axis=1)
        ladder = self.config.width_ladder
        cbits = packed_cbits(len(self.doc_len), self.config.packed_merge)
        if not hard.all():
            with tracing.span("keyword.classed"):
                simple = np.flatnonzero(~hard)
                fused, sorted_ = [], []
                for p_max, t_max, *rest in _classes(
                        [x[simple] for x in slots], lens[simple], simple,
                        ladder):
                    (fused if merge_ok(t_max * p_max) else sorted_).append(
                        (p_max, t_max, cbits, *rest))
                merge_segsum_topk_classes(layout.widths, layout.mats, fused,
                                          scores, ids)
                for p_max, t_max, _, sel, bucketw, rowid, live, idf in sorted_:
                    doc, con = slot_rows(layout.widths, layout.mats, bucketw,
                                         rowid, live, idf, p_max, t_max)
                    # A class can't yield more candidates than it has lanes.
                    s, i = segsum_topk_candidates(doc, con,
                                                  k=min(kk, t_max * p_max))
                    sel = torch.as_tensor(sel, device=self.device)
                    scores[sel, :s.shape[1]] = s
                    ids[sel, :i.shape[1]] = i
        if hard.any():
            sel = np.flatnonzero(hard)
            with tracing.span("keyword.wide"):
                # Each term runs at its own bucket width: a df-20k term
                # does not pad the query's narrow terms to 32768 lanes.
                slots, wide = [x[sel] for x in slots], wide[sel]
                at = np.arange(len(sel))  # rows of wide_flow's output
                s, i = wide_flow(
                    _classes(*_front(slots, (slots[0] > 0) & ~wide), at,
                             ladder),
                    _classes(*_front(slots, wide), at), len(sel), kk, layout,
                    cbits)
            sel = torch.as_tensor(sel, device=self.device)
            scores[sel] = s[:, :kk]
            ids[sel] = i[:, :kk]
        return scores, ids

    def search_tokens(self, token_lists: list[list[str]], k: int,
                      as_device: bool = False):
        bsz = len(token_lists)
        with self._build_lock:  # single-flight the lazy compaction
            if self._needs_compact():
                with tracing.span("keyword.compact"):
                    self.compact()
            main, tail_nnz = self._main, self._tail_nnz
        n = len(self.doc_len)
        if n == 0 or self.n_docs == 0:
            empty_s = torch.full((bsz, k), NEG_INF, dtype=torch.float32)
            empty_i = torch.full((bsz, k), -1, dtype=torch.int32)
            if as_device:
                return empty_s.to(self.device), empty_i.to(self.device)
            return empty_s.numpy(), empty_i.numpy()
        df_cap = int(self.config.max_df_ratio * max(self.n_docs, 1))
        rows = []
        for toks in token_lists:
            tids = [self.vocab[t] for t in toks if t in self.vocab]
            if self.config.max_df_ratio < 1.0:
                tids = [t for t in tids if self._df(t) <= df_cap]
            rows.append(tids)

        # Overfetch past tombstones (dead ids filtered below), rounded
        # to bound the number of distinct k values.
        extra = round_up(len(self._dead), 8) if self._dead else 0
        kk = min(k + extra, max(n, 1))

        scores, ids = self._score(rows, kk, main)
        if tail_nnz:
            with self._build_lock:
                tail = self._tail_layout()
            s2, i2 = self._score(rows, kk, tail)
            # Main/tail doc sets are disjoint: plain candidate merge.
            scores, ids = merge_topk(scores, ids, s2, i2, kk)
            ids = torch.where(scores <= NEG_INF / 2, -1, ids)
        if self._dead:
            dead = torch.isin(ids, torch.as_tensor(
                sorted(self._dead), dtype=torch.int32, device=self.device))
            scores = torch.where(dead, NEG_INF, scores)
            order = torch.argsort(-scores, dim=1, stable=True)
            scores = torch.gather(scores, 1, order)
            ids = torch.gather(ids, 1, order)
            ids = torch.where(scores <= NEG_INF / 2, -1, ids)
        scores, ids = scores[:, :k], ids[:, :k]
        if scores.shape[1] < k:
            scores = torch.nn.functional.pad(scores, (0, k - scores.shape[1]),
                                             value=NEG_INF)
            ids = torch.nn.functional.pad(ids, (0, k - ids.shape[1]),
                                          value=-1)
        if self.config.rank_compat_scores:
            scores = rank_compat(scores)
        if as_device:
            return scores, ids
        return scores.cpu().numpy(), ids.cpu().numpy()

    def __len__(self) -> int:
        return self.n_docs

    # -- persistence (binary postings) ---------------------------------------

    def save(self, path) -> None:
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        offsets = np.zeros(len(self._postings_doc) + 1, np.int64)
        np.cumsum([len(p) // _INT.size for p in self._postings_doc],
                  out=offsets[1:])
        flat_doc = np.frombuffer(b"".join(self._postings_doc), np.int32)
        flat_tf = np.frombuffer(b"".join(self._postings_tf), np.int32)
        np.savez(
            path,
            vocab=json.dumps(self.vocab, ensure_ascii=False),
            doc_len=np.asarray(self.doc_len, np.int32),
            n_docs=self.n_docs,
            total_tokens=self._total_tokens,
            post_offsets=offsets,
            post_doc=flat_doc,
            post_tf=flat_tf,
            dead=np.fromiter(self._dead, np.int32, len(self._dead)),
        )

    @classmethod
    def from_numpy(cls, vocab: dict, doc_len, n_docs: int, total_tokens: int,
                   post_offsets, post_doc, post_tf, dead=(),
                   config: BM25Config | None = None,
                   device="cuda") -> "InvertedIndex":
        """An index from flat postings arrays (the .npz layout): term tid's
        postings are post_doc/post_tf[post_offsets[tid]:post_offsets[tid+1]]."""
        idx = cls(config, device=device)
        idx.vocab = dict(vocab)
        idx.doc_len = [int(x) for x in doc_len]
        idx.n_docs = int(n_docs)
        offs = np.asarray(post_offsets).tolist()
        fd = np.ascontiguousarray(post_doc, np.int32)
        ft = np.ascontiguousarray(post_tf, np.int32)
        idx._postings_doc = [_buf(fd[a:b]) for a, b in zip(offs, offs[1:])]
        idx._postings_tf = [_buf(ft[a:b]) for a, b in zip(offs, offs[1:])]
        idx._total_tokens = int(total_tokens)
        idx._dead = {int(x) for x in dead}
        idx._main_count = [0] * len(idx._postings_doc)
        return idx

    @classmethod
    def load(cls, path, config: BM25Config | None = None,
             device="cuda") -> "InvertedIndex":
        data = np.load(pathlib.Path(path).with_suffix(".npz"),
                       allow_pickle=False)
        if "post_offsets" not in data:  # round-1 format: JSON postings
            idx = cls(config, device=device)
            idx.vocab = json.loads(str(data["vocab"]))
            idx.doc_len = [int(x) for x in data["doc_len"]]
            idx.n_docs = int(data["n_docs"])
            p = json.loads(str(data["postings"]))
            idx._postings_doc = [_buf(x) for x in p["doc"]]
            idx._postings_tf = [_buf(x) for x in p["tf"]]
            idx._total_tokens = sum(idx.doc_len)
            idx._main_count = [0] * len(idx._postings_doc)
            return idx
        return cls.from_numpy(
            json.loads(str(data["vocab"])), data["doc_len"],
            int(data["n_docs"]), int(data["total_tokens"]),
            data["post_offsets"], data["post_doc"], data["post_tf"],
            data["dead"], config=config, device=device)
