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

import tpurag
import tpurag_torch
from tpurag.core.config import BM25Config as JaxBM25Config
from tpurag.core.config import EngineConfig as JaxEngineConfig
from tpurag_torch.core.config import BM25Config, EngineConfig

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
