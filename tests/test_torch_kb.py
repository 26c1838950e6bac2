"""The slice as a whole: tpurag_torch.KnowledgeBase(device="cpu") against
tpurag.KnowledgeBase on the same documents, both with packed_merge=False.

Every document has its own length, so no two documents tie on a BM25
score. Chunk ids and found_in must be equal; RRF scores within 1e-6;
cosine scores within 2e-3 (bf16 storage: both sides round the same
normalized rows to bf16, up to the last bit of the normalization);
BM25 scores within 1e-4 relative (see tests/test_torch_bm25.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

import tpurag
import tpurag_torch
from tpurag.core.config import BM25Config as JaxBM25Config
from tpurag.core.config import EngineConfig as JaxEngineConfig
from tpurag_torch.core.chunkstore import ChunkStore
from tpurag_torch.core.config import BM25Config, EngineConfig
from tpurag_torch.core.types import Chunk, SearchResponse, SearchResult
from tpurag_torch.engine.hybrid import decode_bits
from tpurag_torch.index.inverted import highlight
from tpurag_torch.ingest.tokenizer import tokenize_query
from tpurag_torch.kernels.runtime import NEG_INF

N_DOCS = 60
WORDS = [f"w{i}" for i in range(150)]


def _docs():
    rng = np.random.default_rng(0)
    p = 1.0 / np.arange(1, len(WORDS) + 1)
    lengths = 20 + rng.permutation(N_DOCS) * 2
    return {f"doc{j}": " ".join(rng.choice(WORDS, m, p=p / p.sum()))
            for j, m in enumerate(lengths)}


def _queries():
    rng = np.random.default_rng(1)
    p = 1.0 / np.arange(1, len(WORDS) + 1) ** 0.5
    return [" ".join(rng.choice(WORDS, 3, replace=False, p=p / p.sum()))
            for _ in range(24)]


def _build(deleted: bool):
    jkb = tpurag.KnowledgeBase("kb", config=dataclasses.replace(
        JaxEngineConfig(), bm25=JaxBM25Config(packed_merge=False)))
    tkb = tpurag_torch.KnowledgeBase("kb", config=dataclasses.replace(
        EngineConfig(), bm25=BM25Config(packed_merge=False)), device="cpu")
    for kb in (jkb, tkb):
        for name, text in _docs().items():
            kb.add_document(name, text)
        if deleted:
            assert kb.delete_document("doc7") == 1
            assert kb.delete_document("doc20") == 1
    return jkb, tkb


_CACHE = {}


@pytest.fixture
def kbs(request):
    deleted = request.param
    if deleted not in _CACHE:
        _CACHE[deleted] = _build(deleted)
    return _CACHE[deleted]


def _assert_same(got, want, mode):
    assert len(got) == len(want)
    hits = 0
    for g, w in zip(got, want):
        assert [r.chunk_id for r in g.results] == [r.chunk_id for r in w.results]
        assert [r.found_in for r in g.results] == [r.found_in for r in w.results]
        assert [r.highlighted for r in g.results] == [r.highlighted for r in w.results]
        gs = np.asarray([r.score for r in g.results])
        ws = np.asarray([r.score for r in w.results])
        if mode == "hybrid":
            np.testing.assert_allclose(gs, ws, rtol=0, atol=1e-6)
        elif mode == "vector":
            np.testing.assert_allclose(gs, ws, rtol=0, atol=2e-3)
        else:
            np.testing.assert_allclose(gs, ws, rtol=1e-4)
        assert g.stats == w.stats
        hits += len(g.results)
    assert hits > 0


@pytest.mark.parametrize("kbs", [False, True], indirect=True,
                         ids=["live", "after_delete"])
@pytest.mark.parametrize("preset", ["document", "code"])
@pytest.mark.parametrize("mode", ["hybrid", "vector", "keyword"])
def test_kb_results_match_jax(kbs, mode, preset):
    jkb, tkb = kbs
    queries = _queries()
    got = tkb.search_batch(queries, mode=mode, preset=preset)
    want = jkb.search_batch(queries, mode=mode, preset=preset)
    _assert_same(got, want, mode)
    if mode == "hybrid":
        assert any("keyword" in r.found_in for resp in got for r in resp.results)
        assert any("vector" in r.found_in for resp in got for r in resp.results)


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_kb_save_load_across_packages(tmp_path, direction):
    jkb, tkb = _build(deleted=True)
    queries = _queries()
    if direction == "jax_to_torch":
        jkb.save(tmp_path / "kb")
        src, dst = jkb, tpurag_torch.KnowledgeBase.load(tmp_path / "kb",
                                                        device="cpu")
    else:
        tkb.save(tmp_path / "kb")
        src, dst = tkb, tpurag.KnowledgeBase.load(tmp_path / "kb")
    assert len(dst) == len(src) and len(dst.chunks) == len(src.chunks)
    # Loaded KBs take the persisted BM25 semantics with the default
    # (packed) merge; compare the top-8 ids, which packing keeps here.
    for mode in ("hybrid", "keyword", "vector"):
        got = dst.search_batch(queries, mode=mode)
        want = src.search_batch(queries, mode=mode)
        for g, w in zip(got, want):
            assert [r.chunk_id for r in g.results] == [r.chunk_id for r in w.results]


def test_single_search_and_dispatch_match():
    jkb, tkb = _build(deleted=False)
    q = _queries()[0]
    _assert_same([tkb.search(q)], [jkb.search(q)], "hybrid")
    finalize = tkb.search_batch_dispatch([q, q], mode="keyword")
    _assert_same(finalize(), jkb.search_batch([q, q], mode="keyword"),
                 "keyword")


def test_kb_options_not_ported_raise():
    for kw in ({"store": "host"}, {"mesh": object()}):
        with pytest.raises(NotImplementedError):
            tpurag_torch.KnowledgeBase("x", device="cpu", **kw)
    kb = tpurag_torch.KnowledgeBase("x", device="cpu")
    kb.add_document("a", "alpha beta gamma")
    for mode in ("ivf", "hybrid_ivf"):  # ported; they need build_ivf()
        with pytest.raises(ValueError, match="build_ivf"):
            kb.search("alpha", mode=mode)
    with pytest.raises(ValueError):
        kb.search("alpha", mode="bogus")
    with pytest.raises(NotImplementedError):
        tpurag_torch.ingest.embedder.EncoderEmbedder()


# -- assembly from the chunk store's columns ---------------------------------
#
# `_assemble` reads the store's columns once a call; the spec below is the
# assembly written per result over `kb.chunks[i]` views, fed the very
# (scores, ids, bits) the search produced.


def _spec_assemble(kb, queries, scores, ids, bits):
    out = []
    for b, query in enumerate(queries):
        toks = tokenize_query(query)
        results = []
        for s, i, bt in zip(scores[b], ids[b], bits[b]):
            i = int(i)
            if i < 0 or s <= NEG_INF / 2:
                continue
            c = kb.chunks[i]
            if c.metadata.get("deleted"):
                continue
            found_in = decode_bits(int(bt))
            results.append(SearchResult(
                chunk_id=i, score=float(s), text=c.text,
                doc_name=c.doc_name, source=c.source, found_in=found_in,
                highlighted=(highlight(c.text, toks)
                             if "keyword" in found_in else ""),
                metadata=c.metadata))
        stats = {"total": len(results), "by_source": {}}
        for r in results:
            for src in (r.found_in or (r.source,)):
                stats["by_source"][src] = stats["by_source"].get(src, 0) + 1
        out.append(SearchResponse(results=results, query=query, stats=stats))
    return out


STORE_DELETED = 5  # doc5's chunk: the first hybrid hit of _queries()[0]


def _columns_kb():
    """A CPU KB with every case the assembly meets: chunks of another
    source, sparse metadata (one overriding `indexed_at`), two deleted
    documents and one chunk deleted in the store alone, so the indexes
    still return it."""
    kb = tpurag_torch.KnowledgeBase("kb", device="cpu")
    for name, text in _docs().items():
        kb.add_document(name, text)
    kb.add_chunks([Chunk(text=f"note {w} {w}", doc_id=f"m{j}",
                         doc_name=f"note{j}", source="memory")
                   for j, w in enumerate(WORDS[:6])])
    for cid in range(0, len(kb.chunks), 3):
        kb.chunks.set_meta(cid, "tag", f"t{cid}")
    kb.chunks.set_meta(3, "indexed_at", 123.0)
    kb.chunks.set_meta(3, "lang", "en")
    assert kb.delete_document("doc7") == 1
    assert kb.delete_document("doc20") == 1
    kb.chunks.set_meta(STORE_DELETED, "deleted", True)
    return kb


def _handmade_triple(kb):
    """-1 ids, NEG_INF and NaN scores, every source-bits value 0-3 and two
    with a higher bit set, chunks deleted and of another source."""
    n = len(kb.chunks)
    doc7 = 7  # doc7's one chunk, deleted with its document
    memory = n - 1
    ids = np.array([[0, 1, -1, 4, doc7, memory, 3, 9],
                    [memory, 2, STORE_DELETED, -1, -1, 6, 12, 15],
                    [8, 8, 10, 11, 13, 14, 16, 17]], np.int64)
    scores = np.array([[0.9, 0.8, 0.7, 0.6, 0.5, 0.4, np.nan, NEG_INF],
                       [0.9, NEG_INF / 2, NEG_INF / 3, 0.5, NEG_INF, 0.4,
                        0.3, 0.2],
                       [1.0, 1.0, 0.9, 0.8, 0.7, 0.6, 0.5, 0.4]], np.float32)
    bits = np.array([[3, 1, 2, 2, 3, 0, 3, 1],
                     [0, 1, 2, 3, 0, 6, 5, 2],
                     [2, 2, 1, 0, 3, 3, 2, 4]], np.int64)
    return tuple(torch.from_numpy(x) for x in (scores, ids, bits))


def _comparable(responses):
    """The responses with NaN scores spelled out, so `==` holds NaN to NaN."""
    return [dataclasses.replace(resp, results=[
        dataclasses.replace(r, score="nan") if r.score != r.score else r
        for r in resp.results]) for resp in responses]


@pytest.mark.parametrize("case", ["hybrid", "vector", "keyword", "handmade",
                                  "dispatch_then_delete"])
def test_assemble_equals_per_result_spec(monkeypatch, case):
    kb = _columns_kb()
    queries = _queries()
    seen, made = [], 0
    real_dispatch = kb._dispatch_locked

    def dispatch(qs, p, mode, vectors=None):
        if case == "handmade":
            triple = _handmade_triple(kb)
        else:
            triple = real_dispatch(qs, p, mode, vectors)
        seen.append(tuple(x.cpu().numpy() for x in triple))
        return triple

    def counting(self, i):
        nonlocal made
        made += 1
        return real_materialize(self, i)

    real_materialize = ChunkStore._materialize
    monkeypatch.setattr(kb, "_dispatch_locked", dispatch)
    monkeypatch.setattr(ChunkStore, "_materialize", counting)
    if case == "handmade":
        queries = queries[:3]
        got = kb.search_batch(queries)
    elif case == "dispatch_then_delete":
        finalize = kb.search_batch_dispatch(queries, mode="hybrid")
        assert kb.delete_document("doc3") == 1
        got = finalize()
    else:
        got = kb.search_batch(queries, mode=case)
    assert made == 0  # the search path reads the columns, no views
    want = _spec_assemble(kb, queries, *seen[0])
    assert _comparable(got) == _comparable(want)
    assert [list(r.stats["by_source"]) for r in got] == [
        list(r.stats["by_source"]) for r in want]
    for resp in got:
        for r in resp.results:
            assert type(r.chunk_id) is int and type(r.score) is float
    n = sum(len(r.results) for r in got)
    assert n > 0
    if case == "handmade":
        assert [len(r.results) for r in got] == [5, 4, 8]
        assert [r.found_in for r in got[1].results] == [
            (), ("keyword",), ("vector",), ("keyword",)]
        assert got[0].stats["by_source"] == {
            "vector": 3, "keyword": 3, "memory": 1}
        assert got[0].results[4].score != got[0].results[4].score  # NaN
    if case == "hybrid":
        assert STORE_DELETED in seen[0][1]
    if case == "dispatch_then_delete":
        assert 3 in seen[0][1]  # doc3's chunk, found, then deleted
        assert all(r.doc_name != "doc3" for resp in got for r in resp.results)


def test_assemble_metadata_is_a_fresh_dict_per_result():
    kb = _columns_kb()
    q = _queries()[1]
    got = kb.search_batch([q, q])
    a, b = got[0].results, got[1].results
    assert [r.chunk_id for r in a] == [r.chunk_id for r in b]
    dicts = [r.metadata for resp in got for r in resp.results]
    assert len({id(d) for d in dicts}) == len(dicts)
    for ra, rb in zip(a, b):
        assert ra.metadata == rb.metadata == kb.chunks[ra.chunk_id].metadata
        ra.metadata["edited"] = True
        assert "edited" not in rb.metadata
        assert "edited" not in kb.chunks[ra.chunk_id].metadata
        assert "edited" not in kb.search_batch([q])[0].results[0].metadata


def test_result_fields_equal_the_views():
    kb = _columns_kb()
    store = kb.chunks
    ids = list(range(len(store))) + [3, 0]
    got = list(store.result_fields(ids))
    for i, fields in zip(ids, got):
        c = store[i]
        if c.metadata.get("deleted"):
            assert fields is None
            continue
        text, doc_name, source, md = fields
        assert (text, doc_name, source) == (c.text, c.doc_name, c.source)
        assert md == c.metadata and list(md) == list(c.metadata)
    assert got[-2] == got[3] and got[-2][3] is not got[3][3]
    assert list(got[3][3]) == ["tag", "indexed_at", "lang"]
