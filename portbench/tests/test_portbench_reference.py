"""The plain reference against the port's plain path (CPU tensors take
each kernel's plain version) on the same generated inputs."""

import dataclasses

import numpy as np
import pytest
import torch

from portbench import check, traffic
from portbench.reference import fusion, tokenizer
from portbench.reference.bm25 import BM25, top
from portbench.reference.dense import DenseReference, l2_normalize

CELLS = ["kb100k-hybrid-b512", "kb100k-hybrid-b1"]


def _cell(tiny_cell, variant_cell, name):
    """A committed cell, or the b512 cell's files on an int8 KB with an
    IVF partition (the path no committed cell takes yet)."""
    if name == "int8-ivf-hybrid_ivf":
        return variant_cell("hybrid_ivf", True, True)
    if name == "int8-hybrid":
        return variant_cell("hybrid", True, False)
    return tiny_cell(name)


@pytest.mark.parametrize("name", CELLS)
def test_config_states_the_programs_preset_and_bm25(tiny_cell, name):
    from tpurag_torch.core.config import PRESETS, BM25Config

    cfg = tiny_cell(name)["config"]
    p = PRESETS[cfg["preset"]["name"]]
    for key, value in cfg["preset"].items():
        assert getattr(p, key) == value, key
    assert cfg["bm25"] == {"k1": BM25Config().k1, "b": BM25Config().b}


def test_tokenizer_and_normalize_are_the_programs():
    from tpurag_torch.index.dense import l2_normalize as prog_norm
    from tpurag_torch.ingest import tokenizer as prog

    for s in ["【文档: doc12】\nc1 t1 z1", "Hello 世界你好 w12 w12 ABC_d", "",
              "한국어 テスト x"]:
        assert tokenizer.tokenize(s) == prog.tokenize(s)
        assert tokenizer.tokenize_query(s) == prog.tokenize_query(s)
    x = torch.randn(64, 48, generator=torch.Generator().manual_seed(0))
    assert torch.equal(l2_normalize(x), prog_norm(x))


def test_fusion_matches_rrf_fuse_bit_for_bit():
    from tpurag_torch.core.config import PRESETS
    from tpurag_torch.kernels.fusion import rrf_fuse

    rng = np.random.default_rng(0)
    for preset in ("document", "code"):
        p = dataclasses.asdict(PRESETS[preset])
        v = rng.integers(-1, 30, (64, p["vector_top_k"]))
        k = rng.integers(-1, 30, (64, p["keyword_top_k"]))
        v = np.where(v >= 0, v, -1)
        for row in list(v) + list(k):  # ids distinct within a leg
            seen = set()
            for j, x in enumerate(row):
                if x in seen:
                    row[j] = -1
                seen.add(x)
        ids, s, bits = fusion.rrf(v, k, p, 8)
        ws = (p["vector_weight"], p["keyword_weight"])
        pv, pi, pb = rrf_fuse((torch.as_tensor(v, dtype=torch.int32),
                               torch.as_tensor(k, dtype=torch.int32)),
                              weights=ws, final_k=8, rrf_k=p["rrf_k"],
                              both_bonus=p["both_bonus"])
        live = pi.numpy() >= 0
        assert np.array_equal(ids, np.where(live, pi.numpy(), -1))
        assert np.array_equal(s[live], pv.numpy()[live])
        assert np.array_equal(bits, pb.numpy())


@pytest.mark.parametrize("name", CELLS)
def test_bm25_matches_the_inverted_index(tiny_cell, name):
    from tpurag_torch.core.config import BM25Config
    from tpurag_torch.index.inverted import InvertedIndex

    cfg = tiny_cell(name)["config"]
    corpus = traffic.make_corpus(cfg, 5, "cpu")
    texts = [traffic.indexed_text(t, n)
             for t, n in zip(corpus.texts, corpus.doc_names)]
    stream = traffic.QueryStream(corpus, tiny_cell(name)["traffic"], 5)
    stream.draw(4)
    queries = [t for b in stream.batches for t in b[0]]
    idx = InvertedIndex(BM25Config(packed_merge=False), device="cpu")
    idx.add_batch(range(len(texts)), texts)
    got_s, got_i = idx.search(queries, 8)
    bm = BM25(texts, cfg["bm25"]["k1"], cfg["bm25"]["b"], queries)
    for q, gs, gi in zip(queries, got_s, got_i):
        docs, scores = bm.scores(q)
        ref_s, _ = top(docs, scores, 8)
        live = gi >= 0
        assert live.sum() == len(ref_s)
        np.testing.assert_allclose(gs[live], ref_s, rtol=1e-5)
        pos = np.searchsorted(docs, gi[live])
        np.testing.assert_allclose(scores[pos], ref_s, rtol=1e-5)
        assert np.isclose(bm.idf_mass(q), idx.query_idf_mass([q])[0],
                          rtol=1e-5)


def test_bm25_from_the_drawn_words_is_the_bm25_of_the_texts(tiny_cell):
    """The harness's bulk count over the words each chunk was drawn from
    gives the statistics the frozen tokenizer gives over the indexed
    texts, header tokens included."""
    cell = tiny_cell("kb100k-hybrid-b512")
    corpus = traffic.make_corpus(cell["config"], 11, "cpu")
    stream = traffic.QueryStream(corpus, cell["traffic"], 11)
    stream.draw(2)
    queries = [t for b in stream.batches for t in b[0]] + ["文档 doc3 w1"]
    a = BM25([traffic.indexed_text(t, n)
              for t, n in zip(corpus.texts, corpus.doc_names)], 1.2, 0.75,
             queries)
    b = corpus.bm25(1.2, 0.75, queries)
    assert np.array_equal(a.dl, b.dl)
    assert a._post.keys() == b._post.keys() and len(a._post) > 100
    for tok, (d, tf) in a._post.items():
        assert np.array_equal(d, b._post[tok][0]), tok
        assert np.array_equal(tf, b._post[tok][1]), tok


@pytest.mark.parametrize("name", ["kb100k-hybrid-b512", "int8-hybrid"])
def test_dense_reference_matches_the_dense_index(tiny_cell, variant_cell,
                                                 name):
    from tpurag_torch.index.dense import DenseIndex

    cell = _cell(tiny_cell, variant_cell, name)
    cfg = cell["config"]
    corpus = traffic.make_corpus(cfg, 9, "cpu")
    idx = DenseIndex(cfg["dim"], capacity=corpus.n, device="cpu",
                     quant=cfg["quant"])
    for _, _, blk in corpus.vector_blocks():
        idx.add(blk)
    stream = traffic.QueryStream(corpus, cell["traffic"], 9)
    stream.draw(2)
    qv = np.concatenate([b[1] for b in stream.batches])
    got_s, got_i = idx.search(torch.as_tensor(qv), 8)
    ref = DenseReference(corpus.vector_blocks(), "cpu")
    prec = check.Cell(cfg, cell["traffic"]).precision
    ref_s, _ = ref.top(qv, 8, prec)
    if cfg["quant"]:  # int8 candidates: approximate, never above the best
        assert (got_s.numpy() <= ref_s + 2e-6).all()
        assert np.isclose(got_s.numpy(), ref_s, atol=2e-6).mean() > 0.99
    else:
        np.testing.assert_allclose(got_s.numpy(), ref_s, atol=2e-6)
    mine = ref.scores_of(qv, got_i.numpy(), prec)
    np.testing.assert_allclose(mine, got_s.numpy(), atol=2e-6)


@pytest.mark.parametrize("name", CELLS + ["int8-ivf-hybrid_ivf"])
def test_control_comes_out_not_correct(tiny_cell, variant_cell, name):
    """The control (dense scores from int8, BM25 contributions in bf16, in
    the program's place) breaks at least one of the cell's limits on every
    seed; the reference at the configuration's precision breaks none."""
    from portbench import control

    cell = _cell(tiny_cell, variant_cell, name)
    for seed in (1, 2, 3):
        r = control.readings(cell, seed, "cpu", 1024)
        assert any(r["control"][k] > lim for k, lim in cell["limits"].items())
        assert all(r["reference"][k] <= lim
                   for k, lim in cell["limits"].items()), r
