"""tpurag_torch's wide-term BM25 path against the JAX package.

The same texts go into both packages' InvertedIndex with
wide_term_width=8 (tests/test_bm25_wide.py's corpus, each document padded
to its own length so that no two tie on a score), so the corpus's common
terms split off into wide classes on the CPU; packed_merge=False keeps
both packages exact. Ids must match exactly and scores within 1e-4
relative: JAX on the CPU scores simple queries through its prefix-sum
sort path, whose rounding grows with the row's total (see
tests/test_torch_bm25.py).

The plain versions of the two wide-path kernels are held to the JAX
functions they port: merge_segsum_full_ref (K3's plain version) to the
Pallas kernel in interpret mode and to the XLA merge tree, and
combine_narrow_wide (K4's plain version) to JAX's merge form, its
binary-search form and its tiled Pallas form in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tests.test_bm25_wide import wide_corpus
from tpurag.core.config import BM25Config as JaxBM25Config
from tpurag.index.inverted import InvertedIndex as JaxInvertedIndex
from tpurag.kernels import bm25_join as jax_join
from tpurag.kernels import sortmerge as jax_sortmerge
from tpurag.kernels.bm25_pallas import (merge_segsum_full as jax_full,
                                        merge_segsum_full_xla, wide_merge_ok)
from tpurag_torch.core.config import BM25Config
from tpurag_torch.index.inverted import InvertedIndex, full_cbits
from tpurag_torch.kernels import bm25_join, bm25_merge
from tpurag_torch.kernels.bm25_merge import merge_segsum_full_ref
from tpurag_torch.kernels.runtime import NEG_INF, launch_counts
from tpurag_torch.kernels.sortmerge import merge_sorted_lists

_BIG = 2**30


def _corpus():
    """tests/test_bm25_wide.py's corpus with a filler run of 13 * i tokens
    in doc i: its own texts differ in length by at most 12 tokens, so
    every doc now has a length of its own and no two tie."""
    return [d + " zz" * (13 * i) for i, d in enumerate(wide_corpus())]


def _pair(docs, **cfg):
    cfg.setdefault("wide_term_width", 8)
    jidx = JaxInvertedIndex(JaxBM25Config(packed_merge=False, **cfg))
    tidx = InvertedIndex(BM25Config(packed_merge=False, **cfg), device="cpu")
    for i, d in enumerate(docs):
        jidx.add(i, d)
        tidx.add(i, d)
    return jidx, tidx


def _assert_same_search(jidx, tidx, queries, k=10):
    wv, wi = jidx.search(queries, k)
    gv, gi = tidx.search(queries, k)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gv, wv, rtol=1e-4)
    assert (gi[:, 0] >= 0).all()
    return gv, gi


@pytest.mark.parametrize("queries", [
    ["common rare", "half unique", "common half rare unique"],   # mixed
    ["common", "common half", "half alt"],                        # wide only
    ["rare", "common rare", "unique", "half", "filler1 filler2",
     "common alt rare"],                                          # mixed batch
], ids=["mixed", "wide_only", "batch"])
def test_wide_queries_match_jax(queries):
    jidx, tidx = _pair(_corpus())
    before = (launch_counts["merge_segsum_full"],
              launch_counts["combine_topk"])
    _assert_same_search(jidx, tidx, queries)
    # The CPU path runs the plain versions: no kernel launch is counted.
    assert (launch_counts["merge_segsum_full"],
            launch_counts["combine_topk"]) == before


def test_delete_then_wide_search_matches_jax():
    jidx, tidx = _pair(_corpus())
    for idx in (jidx, tidx):
        idx.delete_doc(0)
        idx.delete_doc(17)
    _, ids = _assert_same_search(jidx, tidx, ["common unique", "common rare",
                                              "half alt"])
    assert not np.isin(ids, [0, 17]).any()


def test_wide_split_on_matches_off():
    """wide_term_width above every bucket turns the split off; both
    packages agree with each other either way, and the port's split and
    unsplit answers agree."""
    docs = _corpus()
    queries = ["common rare", "half alt", "common half rare"]
    s_on, i_on = _assert_same_search(*_pair(docs), queries, k=8)
    s_off, i_off = _assert_same_search(
        *_pair(docs, wide_term_width=1 << 20), queries, k=8)
    np.testing.assert_allclose(s_on, s_off, rtol=1e-5)
    np.testing.assert_array_equal(i_on, i_off)


def test_tail_segment_wide_search_matches_jax():
    docs = _corpus()
    jidx, tidx = _pair(docs[:40])
    queries = ["common rare", "half", "common unique"]
    _assert_same_search(jidx, tidx, queries)
    for i, d in enumerate(docs[40:], start=40):  # lands in the tail
        jidx.add(i, d)
        tidx.add(i, d)
    assert tidx._tail_nnz > 0
    _assert_same_search(jidx, tidx, queries)


def _unflipped_rows(seed, b, t, p, n_docs=400):
    return chip_smoke.merge_rows(np.random.default_rng(seed), b, t, p,
                                 n_docs, flip=False)


@pytest.mark.parametrize("cbits", [0, 12])
@pytest.mark.parametrize("t,p", [(1, 64), (2, 16), (4, 32), (8, 32),
                                 (16, 16)])
def test_full_ref_matches_pallas_interpret(t, p, cbits):
    doc, con = _unflipped_rows(t * p + cbits, 5, t, p)
    ws, wd = jax_full(jnp.asarray(doc), jnp.asarray(con), p=p, t=t,
                      cbits=cbits, interpret=True)
    gs, gd = merge_segsum_full_ref(torch.from_numpy(doc),
                                   torch.from_numpy(con), p, t, cbits)
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-6)
    assert (gs.numpy() > 0).sum() > 20


@pytest.mark.parametrize("t,p", [(1, 64), (2, 64), (4, 32), (8, 16),
                                 (8, 32)])
def test_full_ref_matches_xla_merge_tree(t, p):
    """The XLA merge tree is another network, so a doc's lanes may add in
    another order: docs exact, sums within float rounding."""
    doc, con = _unflipped_rows(t + p, 6, t, p)
    ws, wd = merge_segsum_full_xla(jnp.asarray(doc), jnp.asarray(con), p=p,
                                   t=t)
    gs, gd = merge_segsum_full_ref(torch.from_numpy(doc),
                                   torch.from_numpy(con), p, t)
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-6)


def test_full_wrapper_cpu_and_t1():
    doc, con = _unflipped_rows(0, 3, 4, 16)
    got = bm25_merge.merge_segsum_full(torch.from_numpy(doc),
                                       torch.from_numpy(con), 16, 4)
    want = merge_segsum_full_ref(torch.from_numpy(doc),
                                 torch.from_numpy(con), 16, 4)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    seg, d = bm25_merge.merge_segsum_full(torch.from_numpy(doc[:, :16]),
                                          torch.from_numpy(con[:, :16]), 16, 1)
    assert torch.equal(d, torch.from_numpy(doc[:, :16]))
    assert torch.equal(seg <= NEG_INF / 2, d >= _BIG)
    with pytest.raises(ValueError, match="unsupported device"):
        bm25_merge.merge_segsum_full(torch.from_numpy(doc).to("meta"),
                                     torch.from_numpy(con).to("meta"), 16, 4)


@pytest.mark.parametrize("cbits", [0, 11, 14])
def test_full_cbits_follows_jax_routing(cbits):
    for w in (64, 2048, 16384, 32768, 65536, 131072):
        for t in (1, 2, 4, 8):
            want = cbits if wide_merge_ok(w, cbits, t) else 0
            assert full_cbits(w, t, cbits) == want, (w, t)


def _full_row_fixture(seed, g=6, wn=64, ww=128):
    """Doc-ascending rows with duplicate zero-value lanes (only the last
    lane of a doc-run holds its sum) and parked tails, as
    merge_segsum_full leaves them (tests/test_bm25_wide.py)."""
    rng = np.random.default_rng(seed)
    rows = []
    for w, n in ((wn, 20), (ww, 60)):
        doc = np.full((g, w), _BIG, np.int32)
        val = np.full((g, w), NEG_INF, np.float32)
        for gi in range(g):
            docs = np.sort(rng.choice(500, size=n, replace=False))
            lanes = np.sort(np.repeat(docs, rng.integers(1, 4, n))[:w])
            doc[gi, :len(lanes)] = lanes
            ends = np.r_[lanes[:-1] != lanes[1:], True]
            val[gi, :len(lanes)][ends] = (
                rng.random(int(ends.sum())).astype(np.float32) + 0.1)
        rows += [val, doc]
    return rows  # n_val, n_doc, w_seg, w_doc


@pytest.mark.parametrize("k", [5, 12])
@pytest.mark.parametrize("seed", [11, 12])
def test_combine_matches_jax_forms(seed, k):
    rows = _full_row_fixture(seed)
    jargs = [jnp.asarray(x) for x in rows]
    targs = [torch.from_numpy(x) for x in rows]
    gv, gi = bm25_join.combine_narrow_wide(*targs, k=k, window=6)
    wv, wi = jax_join.combine_narrow_wide(*jargs, k=k, window=6)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    # The wrapper's CPU path is the plain version itself.
    kv, ki = bm25_join.combine_topk(*targs, k=k, window=6)
    assert torch.equal(kv, gv) and torch.equal(ki, gi)
    # The random fixture has no tied totals, so every exact form agrees
    # on ids; sums add in other orders.
    for v, i in (jax_join.combine_narrow_wide_bsearch(*jargs, k=k),
                 bm25_join.combine_narrow_wide_bsearch(*targs, k=k),
                 jax_join.combine_narrow_wide_tiled(*jargs, k=k,
                                                    interpret=True, tile=16)):
        np.testing.assert_array_equal(np.asarray(i), gi.numpy())
        np.testing.assert_allclose(np.asarray(v), gv.numpy(), rtol=1e-6)


def test_combine_brute_force_exact():
    """Exactness against a dictionary sum, with a wide-only row and a
    k past the number of docs."""
    rows = _full_row_fixture(3, g=4, wn=32, ww=64)
    rows[0][1] = NEG_INF
    rows[1][1] = _BIG
    v, i = bm25_join.combine_narrow_wide(*map(torch.from_numpy, rows), k=80,
                                         window=6)
    n_val, n_doc, w_seg, w_doc = rows
    for g in range(4):
        acc = {}
        for val, doc in ((n_val[g], n_doc[g]), (w_seg[g], w_doc[g])):
            for x, d in zip(val, doc):
                if x > NEG_INF / 2:
                    acc[int(d)] = acc.get(int(d), 0.0) + float(x)
        truth = sorted(acc.items(), key=lambda kv: (-kv[1], kv[0]))
        got = [(int(d), float(x)) for d, x in zip(i[g], v[g]) if d >= 0]
        assert [d for d, _ in got] == [d for d, _ in truth]
        np.testing.assert_allclose([x for _, x in got],
                                   [x for _, x in truth], rtol=1e-6)
        assert (v[g, len(got):] == NEG_INF).all()


def test_join_helpers_match_jax():
    rng = np.random.default_rng(7)
    sorted_doc = np.sort(rng.integers(0, 50, (3, 40)), axis=1).astype(np.int32)
    sorted_doc[:, -5:] = _BIG
    q = rng.integers(0, 60, (3, 25)).astype(np.int32)
    q[:, 0] = _BIG
    for got, want in zip(
            bm25_join.bsearch_last(torch.from_numpy(sorted_doc),
                                   torch.from_numpy(q)),
            jax_join.bsearch_last(jnp.asarray(sorted_doc), jnp.asarray(q))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    vals = rng.random((4, 30)).astype(np.float32)
    vals[:, ::7] = NEG_INF
    ids = rng.integers(-1, 12, (4, 30)).astype(np.int32)
    for k in (3, 40):
        gv, gi = bm25_join.dedup_topk(torch.from_numpy(vals),
                                      torch.from_numpy(ids), k)
        wv, wi = jax_join.dedup_topk(jnp.asarray(vals), jnp.asarray(ids), k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    doc = np.sort(rng.integers(0, 300, (2, 128)), axis=1).astype(np.int32)
    con = rng.random((2, 128)).astype(np.float32)
    gs, ge = bm25_join.window_segsum(torch.from_numpy(doc),
                                     torch.from_numpy(con), 5)
    ws, we = jax_join.window_segsum(jnp.asarray(doc), jnp.asarray(con), 5)
    np.testing.assert_array_equal(ge.numpy(), np.asarray(we))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    seg = np.where(ge.numpy(), gs.numpy(), NEG_INF).astype(np.float32)
    seg = np.tile(seg, (1, 64))  # 8192 lanes: the two-stage form
    dd = np.tile(doc, (1, 64))
    gv, gi = bm25_join.tiled_topk(torch.from_numpy(seg),
                                  torch.from_numpy(dd), 6, tile=1024)
    wv, wi = jax_join.tiled_topk(jnp.asarray(seg), jnp.asarray(dd), 6,
                                 tile=1024)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def test_merge_sorted_lists_matches_jax():
    rng = np.random.default_rng(2)
    keys = np.sort(rng.integers(0, 1000, (3, 8, 16)), axis=2).astype(np.int32)
    vals = rng.random((3, 8, 16)).astype(np.float32)
    gk, gv = merge_sorted_lists(torch.from_numpy(keys), torch.from_numpy(vals))
    wk, wv = jax_sortmerge.merge_sorted_lists(jnp.asarray(keys),
                                              jnp.asarray(vals))
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    with pytest.raises(ValueError):
        merge_sorted_lists(torch.zeros((1, 3, 4)), torch.zeros((1, 3, 4)))


def _head_texts(rng, n=120):
    """Every doc holds 'common' (df=n) with varying term frequency, and
    a filler run of 21 * i tokens gives doc i a length of its own, so no
    two docs tie."""
    return [" ".join(["common"] * (1 + i % 9)
                     + [f"t{j}" for j in rng.choice(40, 5)]
                     + ["pad"] * (i % 13) + ["zz"] * (21 * i))
            for i in range(n)]


@pytest.mark.parametrize("exact", [False, True])
def test_head_m_layout_matches_jax(exact):
    rng = np.random.default_rng(8)
    jidx, tidx = _pair(_head_texts(rng), wide_term_width=2048, head_m=32,
                       exact_scoring=exact)
    for idx in (jidx, tidx):
        idx.compact()
    jl, tl = jidx._main, tidx._main
    assert jl.widths == tl.widths
    assert (tl.widths[-1] == 32) != exact
    jmats = dict(zip(jl.widths, jl.mats))
    tmats = dict(zip(tl.widths, tl.mats))
    for term, tid in tidx.vocab.items():
        jt = jidx.vocab[term]
        w = int(tl.term_bucket[tid])
        assert w == int(jl.term_bucket[jt])
        for jm, tm in zip(jmats[w], tmats[w]):
            np.testing.assert_array_equal(
                tm[tl.term_row[tid] + 1].numpy(),
                np.asarray(jm[jl.term_row[jt] + 1]))
    _assert_same_search(jidx, tidx, ["common t3", "t5 t7 common", "pad t1"])


def test_round1_json_postings_load_matches_jax(tmp_path):
    """The round-1 .npz (postings as one JSON object of per-term doc / tf
    lists, no offsets, no tombstones) loads in both packages, and the
    loaded indexes answer narrow and wide-term queries alike."""
    import json

    jidx, _ = _pair(_corpus())
    path = tmp_path / "round1.npz"
    np.savez(path, vocab=json.dumps(jidx.vocab),
             doc_len=np.asarray(jidx.doc_len, np.int32),
             n_docs=jidx.n_docs,
             postings=json.dumps({"doc": jidx._postings_doc,
                                  "tf": jidx._postings_tf}))
    cfg = dict(packed_merge=False, wide_term_width=8)
    jl = JaxInvertedIndex.load(path, JaxBM25Config(**cfg))
    tl = InvertedIndex.load(path, BM25Config(**cfg), device="cpu")
    assert tl._total_tokens == sum(jidx.doc_len) == jl._total_tokens
    assert tl.n_docs == jl.n_docs and not tl._dead
    # "common" is wide at width 8; "rare" and "unique" are narrow.
    _assert_same_search(jl, tl, ["common rare", "half unique", "rare",
                                 "common half rare unique"])


@pytest.mark.parametrize("name", list(chip_smoke.K4_CASES))
def test_combine_classes_plain_matches_per_class_and_jax(name):
    """combine_topk_classes on CPU tensors (its plain version) against
    combine_narrow_wide per class, in the port and in JAX, at K4's edge
    cases: several classes of different Ww, permuted rows, own narrow
    widths below wn_max, a one-member class, a row with no valid narrow
    lane, an all-invalid wide row."""
    n_val, n_doc, classes, window = chip_smoke.k4_case(name, device="cpu")
    k = 12
    before = launch_counts["combine_topk"]
    v, i = bm25_join.combine_topk_classes(n_val, n_doc, classes, k, window)
    assert launch_counts["combine_topk"] == before
    assert v.shape == (n_val.shape[0], k) and i.dtype == torch.int32
    rows = np.concatenate([sel for *_, sel, _ in classes])
    assert sorted(rows.tolist()) == list(range(n_val.shape[0]))
    for w_seg, w_doc, sel, _ in classes:
        sel_t = torch.as_tensor(sel)
        args = (n_val[sel_t], n_doc[sel_t], w_seg, w_doc)
        tv, ti = bm25_join.combine_narrow_wide(*args, k, window)
        jv, ji = jax_join.combine_narrow_wide(
            *(jnp.asarray(x.numpy()) for x in args), k=k, window=window)
        assert torch.equal(i[sel_t], ti) and torch.equal(v[sel_t], tv)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert (i[:, 0] >= 0).any()


def test_wide_flow_matches_jax_score_on_hard_queries():
    """The port's _score (wide_flow: one combine_topk_classes call over
    every wide class) against JAX's on hard queries only: mixed narrow +
    wide terms, wide terms alone (a row with no narrow lane), classes of
    several wide widths."""
    jidx, tidx = _pair(_corpus())
    for idx in (jidx, tidx):
        idx.compact()
    queries = ["common rare", "half unique", "common half rare unique",
               "common", "common half", "half alt", "common alt rare"]
    wide = []
    for idx in (jidx, tidx):
        rows = [[idx.vocab[w] for w in q.split()] for q in queries]
        tb = idx._main.term_bucket
        assert all(any(tb[t] > 8 for t in r) for r in rows)  # all hard
        wide.append(sorted({int(tb[t]) for r in rows for t in r
                            if tb[t] > 8}))
        s, i = idx._score(rows, 10, idx._main)
        wide.append((np.asarray(s), np.asarray(i)))
    (jw, (js, ji)), (tw, (ts, ti)) = wide[:2], wide[2:]
    assert jw == tw and len(tw) >= 2  # several wide widths
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, rtol=1e-4)
    assert (ti[:, 0] >= 0).all()


@pytest.mark.parametrize("probe", ["full", "no_join", "no_item_topk",
                                   "no_row_merge", "chunk2048", "chunk8192",
                                   "ntile1024", "ntile4096", "threads128",
                                   "threads128_ntile1024"])
def test_k4_anatomy_patches_apply(probe):
    """tools/k4_anatomy.py cuts parts out of K4 by textual patches; each
    anchor must be in the kernel's source exactly once."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "tools/k4_anatomy.py"
    spec = importlib.util.spec_from_file_location("k4_anatomy", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    src = tool.patched(tool.PROBES[probe])
    assert "combine_items_kernel" in src
    assert (src == tool.patched([])) == (probe == "full")
    assert tool.FIRST_SOURCE.exists()


@pytest.mark.parametrize("cbits", [0, 14])
@pytest.mark.parametrize("t,p", [(2, 256), (4, 64), (8, 64), (16, 32)])
def test_full_ref_stable_merge_matches_pallas_interpret(t, p, cbits):
    """K3's plain version (a stable merge by (doc, slot)) against the
    Pallas kernel in interpret mode at more shapes: docs exact, sums within
    the rounding of another order."""
    doc, con = _unflipped_rows(t * p + cbits + 1, 4, t, p, n_docs=300)
    ws, wd = jax_full(jnp.asarray(doc), jnp.asarray(con), p=p, t=t,
                      cbits=cbits, interpret=True)
    gs, gd = merge_segsum_full_ref(torch.from_numpy(doc),
                                   torch.from_numpy(con), p, t, cbits)
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-6)
    assert (gs.numpy() > 0).sum() > 20


@pytest.mark.parametrize("t,p", [(2, 256), (16, 16), (16, 64)])
def test_full_ref_stable_merge_matches_xla_merge_tree(t, p):
    doc, con = _unflipped_rows(t * p + 3, 5, t, p, n_docs=300)
    ws, wd = merge_segsum_full_xla(jnp.asarray(doc), jnp.asarray(con), p=p,
                                   t=t)
    gs, gd = merge_segsum_full_ref(torch.from_numpy(doc),
                                   torch.from_numpy(con), p, t)
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-6)


@pytest.mark.parametrize("cbits", [0, 12])
def test_full_ref_order_is_doc_then_slot(cbits):
    """The order K3 and its plain version share, spelled out: live lanes
    by (doc, slot), parked lanes after them, and each doc's sum at its last
    lane, adding its contributions from the highest slot down in float32."""
    t, p = 8, 32
    doc, con = _unflipped_rows(9, 3, t, p, n_docs=120)
    gs, gd = merge_segsum_full_ref(torch.from_numpy(doc),
                                   torch.from_numpy(con), p, t, cbits)
    for r in range(doc.shape[0]):
        c = con[r].astype(np.float32)
        if cbits:
            qmax = (1 << cbits) - 1
            safe = np.float32(max(c.max(), np.float32(1e-30)))
            q = np.clip(np.rint(c / safe * np.float32(qmax)), 0, qmax)
            c = q.astype(np.float32) * (safe / np.float32(qmax))
        lanes = sorted((int(d), s) for s in range(t)
                       for d in doc[r, s * p:(s + 1) * p] if d < _BIG)
        assert gd[r, :len(lanes)].tolist() == [d for d, _ in lanes]
        assert (gd[r, len(lanes):] == _BIG).all()
        assert (gs[r, len(lanes):] == NEG_INF).all()
        lane_of = {(int(d), s): s * p + i for s in range(t)
                   for i, d in enumerate(doc[r, s * p:(s + 1) * p])}
        for i, (d, s) in enumerate(lanes):
            if i + 1 < len(lanes) and lanes[i + 1][0] == d:
                assert gs[r, i] == NEG_INF
                continue
            slots = [x for dd, x in lanes if dd == d]
            total = np.float32(c[lane_of[(d, slots[-1])]])
            for x in slots[-2::-1]:
                total = np.float32(total + c[lane_of[(d, x)]])
            assert gs[r, i].item() == total, (r, i)


@pytest.mark.parametrize("name", list(chip_smoke.K3_CASES))
def test_full_classes_plain_matches_assemble(name):
    """K3's descriptor form (on CPU tensors its plain version, which reads
    each slot's live lanes as the kernel does) against the flow it
    replaces: the JAX package's index/inverted._assemble gather of whole
    bucket rows and merge_segsum_full_ref per class, narrow rows scattered
    at sel. The cases hold empty slots, a slot wider than p_max, t = 1, w <
    p_max, an all-parked row, W = 131072 and cbits 12 and 14."""
    from tpurag.index.inverted import _assemble

    widths, mats, narrow, wide, h, wn_max = chip_smoke.k3_case(name,
                                                              device="cpu")
    before = launch_counts["merge_segsum_full"]
    n_val, n_doc, wides = bm25_merge.merge_segsum_full_classes(
        widths, mats, narrow, wide, h, wn_max)
    assert launch_counts["merge_segsum_full"] == before
    want_v = torch.full((h, wn_max), NEG_INF)
    want_d = torch.full((h, wn_max), _BIG, dtype=torch.int32)
    jmats = [(jnp.asarray(d.numpy()), jnp.asarray(i.numpy()))
             for d, i in mats]
    for i, (p_max, t, cbits, sel, bucketw, rowid, _, idf) in enumerate(
            [*narrow, *wide]):
        doc, con = (torch.from_numpy(np.array(x)) for x in _assemble(
            jnp.asarray(bucketw), jnp.asarray(rowid), jnp.asarray(idf), jmats,
            p_max, t, list(widths)))
        g = doc.shape[0]
        seg, doc_s = merge_segsum_full_ref(doc.reshape(g, -1),
                                           con.reshape(g, -1), p_max, t,
                                           cbits)
        if i < len(narrow):
            want_v[torch.as_tensor(sel), :t * p_max] = seg
            want_d[torch.as_tensor(sel), :t * p_max] = doc_s
        else:
            got = wides[i - len(narrow)]
            assert torch.equal(got[0], seg) and torch.equal(got[1], doc_s)
    assert torch.equal(n_val, want_v) and torch.equal(n_doc, want_d)
    assert any((x > 0).any() for x in [n_val, *[w for w, _ in wides]])


def _decode_k3_table(prep):
    """(mats, rows, slots, items) of a prepared K3 table."""
    tab = prep["table"].numpy()
    n_m, n_r, n_s = prep["n_mats"], prep["n_rows"], prep["n_slots"]
    mats = tab[:4 * n_m].reshape(n_m, 4)
    rows = tab[4 * n_m:4 * n_m + 8 * n_r].reshape(n_r, 8)
    at = 4 * n_m + 8 * n_r
    slots = tab[at:at + 2 * n_s].view(np.int32).reshape(n_s, 4)
    items = tab[at + 2 * n_s:]
    assert len(items) == prep["n_items"]
    return mats, rows, slots, items


def test_k3_table_items_cover_every_lane():
    """The work table: ceil(lanes written / chunk) items a row, each (row,
    chunk) once and in order; slots decode to (matrix, row, live lanes,
    idf), empty ones zeroed; the straddling doc (lanes 4094..4097) has its
    end lane in its row's second item, its other lanes in the first (the
    look-back the kernel reads); a narrow row's items past its live lanes
    are in the table (they write the parked tail)."""
    C = bm25_merge._K3_CHUNK
    args = chip_smoke.k3_case("straddle", device="cpu")
    prep = bm25_merge._k3_prepare(*args)
    mats, rows, slots, items = _decode_k3_table(prep)
    widths, dev_mats, _, wide, _, _ = args
    assert [tuple(m[:3]) for m in mats] == [
        (d.data_ptr(), i.data_ptr(), w) for w, (d, i) in zip(widths, dev_mats)]
    w_out = rows[:, 3]
    np.testing.assert_array_equal(
        items, np.concatenate([(r << 32) | np.arange(-(-w // C))
                               for r, w in enumerate(w_out)]))
    _, t, _, _, bucketw, rowid, live, idf = wide[0]
    np.testing.assert_array_equal(rows[:, 4], t)
    np.testing.assert_array_equal(rows[:, 6], np.arange(len(rows)) * t)
    np.testing.assert_array_equal(slots[:, 1].reshape(-1, t), rowid)
    np.testing.assert_array_equal(slots[:, 2].reshape(-1, t), live)
    np.testing.assert_array_equal(slots[:, 3].view(np.float32).reshape(-1, t),
                                  idf)
    seg, doc_s = bm25_merge.merge_segsum_full_classes_ref(*args)[2][0]
    d = int(doc_s[0, 4094])
    assert (doc_s[0, 4094:4098] == d).all() and doc_s[0, 4098] != d
    assert (seg[0, 4094:4097] == NEG_INF).all() and seg[0, 4097] > 0
    assert (4097 // C, 4094 // C) == (1, 0) and ((0 << 32) | 1) in items

    args = chip_smoke.k3_case("parked", device="cpu")
    _, _, slots, _ = _decode_k3_table(bm25_merge._k3_prepare(*args))
    empty = slots[:, 2] == 0
    assert empty.any() and (slots[empty][:, :2] == 0).all()

    args = chip_smoke.k3_case("mix", device="cpu")
    prep = bm25_merge._k3_prepare(*args)
    _, rows, _, items = _decode_k3_table(prep)
    _, _, narrow, _, h, wn_max = args
    assert (rows[:h, 3] == wn_max).all()
    for r in range(h):  # every narrow row has wn_max / C items
        assert all(((r << 32) | j) in items for j in range(wn_max // C))
    n_val, n_doc, _ = bm25_merge.merge_segsum_full_classes_ref(*args)
    live = (n_doc < _BIG).sum(1)
    past = live <= C  # rows whose items 1.. lie past their live lanes
    assert past.sum() >= 3 and (n_doc[past, C:] == _BIG).all()
    assert (n_val[past, C:] == NEG_INF).all()


def test_wide_flow_makes_one_k3_call_and_matches_jax(monkeypatch):
    """A batch of hard queries (narrow and several wide classes) makes one
    merge_segsum_full_classes call per segment scored, and answers as the
    JAX package does."""
    from tpurag_torch.index import inverted

    calls = []
    real = inverted.merge_segsum_full_classes

    def rec(*args):
        calls.append(args)
        return real(*args)

    monkeypatch.setattr(inverted, "merge_segsum_full_classes", rec)
    jidx, tidx = _pair(_corpus())
    queries = ["common rare", "half unique", "common half rare unique",
               "common", "common half", "half alt", "common alt rare"]
    _assert_same_search(jidx, tidx, queries)
    assert len(calls) == 1
    _, _, narrow, wide, h, _ = calls[0]
    assert h == len(queries) and narrow and len(wide) >= 2


@pytest.mark.parametrize("probe", ["full", "search_only", "no_merge",
                                   "no_sums", "chunk2048", "chunk8192"])
def test_k3_anatomy_patches_apply(probe):
    """tools/k3_anatomy.py cuts parts out of K3 by textual patches; each
    anchor must be in the kernel's source exactly once."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "tools/k3_anatomy.py"
    spec = importlib.util.spec_from_file_location("k3_anatomy", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    src = tool.patched(tool.PROBES[probe])
    assert "full_rows_kernel" in src
    assert (src == tool.patched([])) == (probe == "full")
    assert tool.FIRST_SOURCE.exists()
