"""The generators are deterministic in --seed, take seeds past 32 bits,
and give the same stream however many batches a run draws."""

import numpy as np
import pytest

from portbench import traffic

BIG = 2**31 + 12345


@pytest.mark.parametrize("name", ["kb100k-hybrid-b512", "mixture"])
def test_same_seed_same_inputs(tiny_cell, variant_cell, name):
    cell = (variant_cell("hybrid_ivf", True, True) if name == "mixture"
            else tiny_cell(name))
    cfg, tr = cell["config"], cell["traffic"]

    def draw(seed, n):
        c = traffic.make_corpus(cfg, seed, "cpu")
        blocks = [b.clone() for _, _, b in c.vector_blocks()]
        s = traffic.QueryStream(c, tr, seed)
        s.draw(n)
        return c.texts, blocks, s.batches

    t1, b1, q1 = draw(BIG, 3)
    t2, b2, q2 = draw(BIG, 200)
    assert t1 == t2
    assert all((x == y).all() for x, y in zip(b1, b2))
    for (a, va, ua), (b, vb, ub) in zip(q1, q2):
        assert a == b and np.array_equal(va, vb) and np.array_equal(ua, ub)
    t3, b3, q3 = draw(BIG + 1, 3)
    assert not np.array_equal(q1[0][1], q3[0][1])
    assert not all((x == y).all() for x, y in zip(b1, b3))


def test_blocks_repeat_on_a_second_pass(variant_cell):
    cfg = variant_cell("hybrid_ivf", True, True)["config"]
    c = traffic.make_corpus(cfg, 7, "cpu")
    first = [b.clone() for _, _, b in c.vector_blocks()]
    second = [b for _, _, b in c.vector_blocks()]
    assert len(first) == 3
    assert all((x == y).all() for x, y in zip(first, second))


def test_chunks_are_the_sources_chunker(tiny_cell):
    """Each generated document, cut by the program's copy of rag-era's
    SentenceSplitter(512, 50), gives the generated chunks, and every
    configuration's chunk width is the source's."""
    from tpurag_torch.core.config import ChunkingConfig
    from tpurag_torch.ingest.chunker import chunk_text, estimate_tokens

    spec = tiny_cell("kb100k-hybrid-b512")["config"]["corpus"]["texts"]
    assert (spec["chunk_tokens"], spec["overlap_tokens"]) == (
        ChunkingConfig().chunk_size, ChunkingConfig().chunk_overlap)
    gen = traffic.ZipfChunks(spec, 100, BIG, keep_documents=True)
    per = spec["doc_chunks"]
    assert len(gen.texts) == 100 and len(gen.documents) == -(-100 // per)
    for d, doc in enumerate(gen.documents):
        assert chunk_text(doc) == gen.texts[d * per:(d + 1) * per]
    assert all(estimate_tokens(t) <= spec["chunk_tokens"] for t in gen.texts)
    assert min(estimate_tokens(t) for t in gen.texts[:-1]) > 400
    assert gen.doc_names[per] == "doc1" and gen.doc_ids[per - 1] == "d0"


def test_word_draws_follow_the_cdf():
    cdf = traffic.zipf_cdf(5000, 1.0)
    u = np.random.default_rng(0).random(200_000)
    assert np.array_equal(traffic.Ranks(cdf)(u),
                          np.minimum(np.searchsorted(cdf, u), 4999))
