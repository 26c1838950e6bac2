"""tpurag_torch BM25 scoring against the JAX package.

merge_segsum_topk_ref (the plain version of the CUDA merge kernel, and
its CPU path) merges the term slots by (doc, slot) and sums each doc from
its last slot down, where the Pallas kernel's bitonic network adds the
same lanes in its own order, so it matches JAX's merge_segsum_topk in
interpret mode to float32 rounding: ids exactly, scores within 1e-5
unpacked and 1e-6 relative packed (the same quantization).

InvertedIndex: the same texts go into both packages with
packed_merge=False (JAX on the CPU scores through its unpacked sort
path). Every document has its own length, so no two documents tie on a
score and ids must match exactly. Scores agree within 1e-4 relative: JAX
on the CPU takes a document's score as a difference of running prefix
sums over the whole candidate row, whose rounding grows with the row's
total (1.3e-5 relative observed), where the port adds the document's
own terms.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tpurag.core.config import BM25Config as JaxBM25Config
from tpurag.index.inverted import InvertedIndex as JaxInvertedIndex
from tpurag.kernels.bm25_pallas import merge_segsum_topk as jax_merge
from tpurag_torch.core.config import BM25Config
from tpurag_torch.index.inverted import InvertedIndex, packed_cbits
from tpurag_torch.kernels import bm25_merge
from tpurag_torch.kernels.bm25_merge import merge_segsum_topk_ref
from tpurag_torch.kernels.runtime import launch_counts


@pytest.mark.parametrize("cbits", [0, 12, 20])
@pytest.mark.parametrize("p", [16, 64])
@pytest.mark.parametrize("t", [1, 2, 4, 8])
def test_merge_ref_matches_pallas_interpret(t, p, cbits):
    rng = np.random.default_rng(t * 100 + p + cbits)
    doc, con = chip_smoke.merge_rows(rng, 6, t, p, n_docs=2000)
    pp = p if t > 1 else t * p
    k = 8
    wv, wi = jax_merge(jnp.asarray(doc), jnp.asarray(con), k=k, p=pp, t=t,
                       cbits=cbits, interpret=True)
    gv, gi = merge_segsum_topk_ref(torch.from_numpy(doc),
                                   torch.from_numpy(con), k, pp, t, cbits)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    if cbits:
        np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=1e-6)
    else:
        np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=1e-5)
    assert (gi.numpy()[:, 0] >= 0).all()


def test_merge_wrapper_cpu_path_and_launch_count():
    doc, con = chip_smoke.merge_rows(np.random.default_rng(0), 3, 4, 16, 500)
    before = launch_counts["merge_segsum_topk"]
    got = bm25_merge.merge_segsum_topk(torch.from_numpy(doc),
                                       torch.from_numpy(con), 8, 16, 4, 0)
    want = merge_segsum_topk_ref(torch.from_numpy(doc),
                                 torch.from_numpy(con), 8, 16, 4, 0)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert launch_counts["merge_segsum_topk"] == before  # no kernel on CPU


def test_packed_cbits_matches_jax():
    from tpurag.index.inverted import packed_cbits as jax_cbits

    for n in (0, 1, 62, 63, 1000, 100_000, 2**19, 2**20):
        assert packed_cbits(n) == jax_cbits(n)
        assert packed_cbits(n, False) == 0


def _texts(rng, n, vocab=120, start=0):
    """Docs of distinct lengths (so no two tie on a BM25 score) over a
    Zipf-weighted vocabulary."""
    w = 1.0 / np.arange(1, vocab + 1)
    lengths = 8 + rng.permutation(n) + start
    return [" ".join(f"t{j}" for j in rng.choice(vocab, m, p=w / w.sum()))
            for m in lengths]


def _queries(rng, n, vocab=120):
    """Four distinct terms each: one term-slot class (t=4) per width, which
    keeps the JAX side's compiles few."""
    w = 1.0 / np.arange(1, vocab + 1) ** 0.5
    return [" ".join(f"t{j}" for j in rng.choice(vocab, 4, replace=False,
                                                  p=w / w.sum()))
            for _ in range(n)]


def _pair(**cfg):
    return (JaxInvertedIndex(JaxBM25Config(packed_merge=False, **cfg)),
            InvertedIndex(BM25Config(packed_merge=False, **cfg),
                          device="cpu"))


def _assert_same_search(jidx, tidx, queries, k=8):
    wv, wi = jidx.search(queries, k)
    gv, gi = tidx.search(queries, k)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gv, wv, rtol=1e-4)
    assert (gi[:, 0] >= 0).mean() > 0.9  # the queries do hit


def test_inverted_search_tail_deletes_compact_match_jax():
    rng = np.random.default_rng(11)
    jidx, tidx = _pair()
    texts = _texts(rng, 180)
    for idx in (jidx, tidx):
        idx.add_batch(range(180), texts)
    queries = _queries(rng, 40)
    _assert_same_search(jidx, tidx, queries)
    assert tidx._builds == 1

    more = _texts(rng, 60, start=180)  # tail segment
    for idx in (jidx, tidx):
        idx.add_batch(range(180, 240), more)
    _assert_same_search(jidx, tidx, queries)
    assert tidx._tail_nnz > 0 and tidx._builds == 1

    dead = rng.choice(240, 12, replace=False)
    for idx in (jidx, tidx):
        idx.delete_docs(dead)
    _assert_same_search(jidx, tidx, queries, k=10)
    assert not np.isin(tidx.search(queries, 10)[1], dead).any()
    np.testing.assert_allclose(tidx.query_idf_mass(queries),
                               jidx.query_idf_mass(queries), rtol=1e-6)

    for idx in (jidx, tidx):
        idx.compact()
    _assert_same_search(jidx, tidx, queries)
    assert len(tidx) == len(jidx) == 228


def test_inverted_rank_compat_matches_jax():
    rng = np.random.default_rng(5)
    jidx, tidx = _pair(rank_compat_scores=True)
    texts = _texts(rng, 90)
    for idx in (jidx, tidx):
        idx.add_batch(range(90), texts)
    _assert_same_search(jidx, tidx, _queries(rng, 20))


def test_rows_past_merge_limit_take_segsum_path():
    """A 9-term query over terms of df > 1024 runs at t=16 x p=2048, past
    the fused merge's 16384 lanes: both packages take the sort path."""
    rng = np.random.default_rng(2)
    n = 1100
    common = [f"c{j}" for j in range(9)]
    texts = [" ".join(common[:1 + i % 9] + [f"u{i}"] * (1 + i % 5)
                      + ["pad"] * i) for i in range(n)]  # distinct lengths
    jidx, tidx = _pair()
    for idx in (jidx, tidx):
        idx.add_batch(range(n), texts)
    before = launch_counts["merge_segsum_topk"]
    wv, wi = jidx.search([" ".join(common)], 8)
    gv, gi = tidx.search([" ".join(common)], 8)
    np.testing.assert_allclose(gv, wv, rtol=1e-4)
    np.testing.assert_array_equal(gi, wi)
    assert launch_counts["merge_segsum_topk"] == before


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_inverted_save_load_across_packages(tmp_path, direction):
    rng = np.random.default_rng(9)
    jidx, tidx = _pair()
    texts = _texts(rng, 120)
    for idx in (jidx, tidx):
        idx.add_batch(range(120), texts)
        idx.delete_docs([3, 50])
    if direction == "jax_to_torch":
        jidx.save(tmp_path / "inv")
        loaded = InvertedIndex.load(tmp_path / "inv",
                                    BM25Config(packed_merge=False),
                                    device="cpu")
        pair = (jidx, loaded)
    else:
        tidx.save(tmp_path / "inv")
        loaded = JaxInvertedIndex.load(tmp_path / "inv",
                                       JaxBM25Config(packed_merge=False))
        pair = (loaded, tidx)
    # Term ids may differ (the JAX package's native batch tokenizer
    # numbers terms in its own order); terms, lengths and deletes may not.
    assert set(loaded.vocab) == set(tidx.vocab)
    assert loaded.doc_len == tidx.doc_len and loaded._dead == {3, 50}
    _assert_same_search(*pair, _queries(rng, 25))


def test_packed_merge_large_cbits_keeps_doc_bits():
    """Past cbits = 24 the row max must not round up into the doc bits
    (the JAX package's float clamp lets it: ROADMAP.md Queue 3)."""
    doc = torch.full((1, 128), 2**30, dtype=torch.int32)
    con = torch.zeros((1, 128))
    doc[0, 0], con[0, 0] = 0, 0.7
    doc[0, 127], con[0, 127] = 0, 0.6  # the flipped second slot's last lane
    for cbits in (20, 25, 29):
        v, i = merge_segsum_topk_ref(doc, con, 2, 64, 2, cbits)
        assert i.tolist() == [[0, -1]]
        assert abs(v[0, 0].item() - 1.3) < 1e-6


def test_packed_default_scores_close_to_exact():
    rng = np.random.default_rng(4)
    texts = _texts(rng, 200)
    exact = InvertedIndex(BM25Config(packed_merge=False), device="cpu")
    packed = InvertedIndex(BM25Config(), device="cpu")
    for idx in (exact, packed):
        idx.add_batch(range(200), texts)
    queries = _queries(rng, 30)
    ev, ei = exact.search(queries, 5)
    pv, pi = packed.search(queries, 5)
    assert packed_cbits(200) == 23
    np.testing.assert_allclose(pv, ev, rtol=1e-4)


def test_wide_kernel_wrappers_reject_unsupported_device():
    """The wide-term path's kernel wrappers raise on a device they have
    no kernel for, rather than giving way to their plain versions."""
    from tpurag_torch.kernels.bm25_join import combine_topk
    from tpurag_torch.kernels.bm25_merge import merge_segsum_full

    rows = torch.zeros((1, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        combine_topk(rows, rows.int(), rows, rows.int(), k=4)
    with pytest.raises(ValueError, match="unsupported device"):
        merge_segsum_full(rows.int(), rows, p=4, t=2)


def test_wide_term_query_matches_unsplit():
    """Wide-term queries answer as the index with the split turned off
    does."""
    texts = [f"common t{i % 7}" + " pad" * i for i in range(100)]
    tidx = InvertedIndex(BM25Config(wide_term_width=64), device="cpu")
    whole = InvertedIndex(BM25Config(wide_term_width=1 << 20), device="cpu")
    for idx in (tidx, whole):
        idx.add_batch(range(100), texts)
    assert tidx.search(["t3"], 4)[1][0, 0] >= 0  # narrow terms still work
    (gv, gi), (wv, wi) = (x.search(["common t3", "common"], 4)
                          for x in (tidx, whole))
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gv, wv, rtol=1e-5)
    assert (gi >= 0).all()
