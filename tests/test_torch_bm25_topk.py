"""tpurag_torch's K2 in its slot-table form against the JAX package.

merge_segsum_topk_classes (on CPU tensors its plain version) reads each
query's term slots, the live lanes of bucket-matrix rows, merges them by
(doc, slot) and sums each doc's lanes from its last slot down. The JAX
package gathers the same rows (index/inverted._assemble), flips the odd
slots and runs its Pallas kernel's bitonic network (here in interpret
mode), which adds the same lanes in its own order: ids must match
exactly, scores within 1e-5 unpacked and 1e-6 relative packed, as in
tests/test_torch_bm25.py. Against K3's plain full rows of the same slots
(the order both kernels share) the top-k is bit for bit.
"""

import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tpurag.core.config import BM25Config as JaxBM25Config
from tpurag.index.inverted import InvertedIndex as JaxInvertedIndex
from tpurag.index.inverted import _assemble as jax_assemble
from tpurag.kernels.bm25_pallas import merge_segsum_topk as jax_merge
from tpurag_torch.core.config import BM25Config
from tpurag_torch.index.inverted import InvertedIndex
from tpurag_torch.kernels import bm25_merge
from tpurag_torch.kernels.bm25_merge import (block_classes, flip_odd_blocks,
                                             merge_segsum_full_classes_ref,
                                             merge_segsum_topk_classes,
                                             merge_segsum_topk_classes_ref,
                                             merge_segsum_topk_ref)
from tpurag_torch.kernels.runtime import NEG_INF, launch_counts
from tpurag_torch.kernels.topk import select_topk


def _classed(name):
    widths, mats, classes, h, k = chip_smoke.k2_case(name, device="cpu")
    return (widths, mats, classes,
            merge_segsum_topk_classes_ref(widths, mats, classes,
                                          *chip_smoke.k2_out(h, k, "cpu")))


@pytest.mark.parametrize("name", ["empty", "narrow", "t1", "sparse", "ties",
                                  "mix"])
def test_topk_classes_plain_matches_pallas_interpret(name):
    widths, mats, classes, (got_v, got_i) = _classed(name)
    k = got_v.shape[1]
    jmats = [(jnp.asarray(d.numpy()), jnp.asarray(i.numpy()))
             for d, i in mats]
    for p_max, t, cbits, sel, bucketw, rowid, _, idf in classes:
        doc, con = jax_assemble(jnp.asarray(bucketw), jnp.asarray(rowid),
                                jnp.asarray(idf), jmats, p_max, t,
                                list(widths))
        g = doc.shape[0]
        if t > 1:  # the JAX index's odd-slot flip
            doc, con = (jnp.concatenate([x[:, 0::2, None], x[:, 1::2, None,
                                                              ::-1]], axis=2)
                        .reshape(g, t * p_max) for x in (doc, con))
        else:
            doc, con = doc.reshape(g, p_max), con.reshape(g, p_max)
        k_eff = min(k, t * p_max)  # as the index caps it
        wv, wi = jax_merge(doc, con, k=k_eff, p=p_max, t=t, cbits=cbits,
                           interpret=True)
        gv, gi = got_v[sel].numpy(), got_i[sel].numpy()
        np.testing.assert_array_equal(gi[:, :k_eff], np.asarray(wi))
        if cbits:
            np.testing.assert_allclose(gv[:, :k_eff], np.asarray(wv),
                                       rtol=1e-6)
        else:
            np.testing.assert_allclose(gv[:, :k_eff], np.asarray(wv),
                                       atol=1e-5)
        assert (gi[:, k_eff:] == -1).all() and (gv[:, k_eff:] == NEG_INF).all()
    assert (got_i[:, 0] >= 0).any()


@pytest.mark.parametrize("name", list(chip_smoke.K2_CASES))
def test_topk_classes_plain_is_topk_of_k3_full_rows(name):
    """The classed plain path is select_topk (scores <= 0 empty) over K3's
    plain full rows of the same slots, bit for bit (K3 packs no t = 1 row,
    so packed single-slot classes are left out)."""
    widths, mats, classes, (got_v, got_i) = _classed(name)
    k = got_v.shape[1]
    compared = 0
    for cls in classes:
        if cls[1] == 1 and cls[2]:
            continue
        _, _, [(seg, doc_s)] = merge_segsum_full_classes_ref(
            widths, mats, [], [cls], 0, 0)
        vals, ids = select_topk(seg, doc_s, k)
        empty = vals <= 0.0
        sel = torch.as_tensor(cls[3])
        assert torch.equal(got_v[sel], torch.where(empty, NEG_INF, vals))
        assert torch.equal(got_i[sel], torch.where(empty, -1, ids))
        compared += 1
    assert compared


def test_topk_classes_leave_rows_of_no_class():
    widths, mats, classes, (got_v, got_i) = _classed("mix")
    rows = np.concatenate([c[3] for c in classes])
    rest = np.setdiff1d(np.arange(got_v.shape[0]), rows)
    assert len(rest) == 1
    assert (got_v[rest] == NEG_INF).all() and (got_i[rest] == -1).all()


def test_sparse_case_passes_the_live_lanes():
    """k above the live lanes: the slots past the docs are (NEG_INF, -1)."""
    _, _, classes, (got_v, got_i) = _classed("sparse")
    assert (got_i[:, -1] == -1).all() and (got_i[:, 0] >= 0).all()
    assert (got_v[:, -1] == NEG_INF).all()


@pytest.mark.parametrize("cbits", [0, 14])
@pytest.mark.parametrize("t", [1, 2, 8])
def test_flipped_rows_form_is_the_one_class_table(t, cbits):
    """merge_segsum_topk's plain version on flipped rows equals the classed
    plain path on a one-class table of the rows turned back, which is what
    its CUDA path launches."""
    p = 64
    doc, con = (torch.from_numpy(x) for x in chip_smoke.merge_rows(
        np.random.default_rng(t + cbits), 5, t, p, 3000))
    pp = p if t > 1 else t * p
    want = merge_segsum_topk_ref(doc, con, 8, pp, t, cbits)
    if t > 1:
        doc, con = flip_odd_blocks(doc, pp, t), flip_odd_blocks(con, pp, t)
    widths, mats, spec = block_classes(doc, con, pp, t, cbits)
    got = merge_segsum_topk_classes_ref(widths, mats, [spec],
                                        *chip_smoke.k2_out(5, 8, "cpu"))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (want[1][:, 0] >= 0).any()


def test_topk_classes_wrapper_cpu_path_and_launch_count():
    widths, mats, classes, h, k = chip_smoke.k2_case("mix", device="cpu")
    before = launch_counts["merge_segsum_topk"]
    got = merge_segsum_topk_classes(widths, mats, classes,
                                    *chip_smoke.k2_out(h, k, "cpu"))
    want = merge_segsum_topk_classes_ref(widths, mats, classes,
                                         *chip_smoke.k2_out(h, k, "cpu"))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert launch_counts["merge_segsum_topk"] == before  # no kernel on CPU


def test_topk_wrappers_reject_unsupported_device():
    """K2's wrappers raise on a device they have no kernel for, rather than
    giving way to their plain versions."""
    rows = torch.zeros((1, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        bm25_merge.merge_segsum_topk(rows.int(), rows, k=4, p=4, t=2)
    mats = ((torch.zeros((2, 16), dtype=torch.int32, device="meta"),
             torch.zeros((2, 16), device="meta")),)
    with pytest.raises(ValueError, match="unsupported device"):
        merge_segsum_topk_classes((16,), mats, [], rows, rows.int())


def test_k2_table_layout():
    """The table: Mats, then one Row per query row (its result row, W, t,
    cbits, first slot) with the most given lanes first, then one Slot per
    (row, slot); the sizes bound every row's block."""
    widths, mats, classes, h, k = chip_smoke.k2_case("mix", device="cpu")
    out_v, out_i = chip_smoke.k2_out(h, k, "cpu")
    prep = bm25_merge._k2_prepare(widths, mats, classes, out_v, out_i)
    tab = prep["table"].numpy()
    n_m, n_r = prep["n_mats"], prep["n_rows"]
    rows = tab[4 * n_m:4 * n_m + 8 * n_r].reshape(n_r, 8)
    slots = tab[4 * n_m + 8 * n_r:].view(np.int32).reshape(-1, 4)
    assert len(slots) == prep["n_slots"] == sum(c[4].size for c in classes)
    assert n_r == sum(len(c[3]) for c in classes)
    given = np.array([slots[f:f + t, 2].sum() for t, f in rows[:, [3, 5]]])
    assert (np.diff(given) <= 0).all() and given[0] == prep["lane_cap"]
    sel = (rows[:, 0] - out_v.data_ptr()) // (4 * k)
    assert sorted(sel.tolist()) == sorted(
        np.concatenate([c[3] for c in classes]).tolist())
    assert ((rows[:, 1] - out_i.data_ptr()) // (4 * k) == sel).all()
    by_row = {int(r): c for c in classes for r in c[3]}
    for row, s in zip(rows, sel):
        p_max, t, cbits = by_row[int(s)][:3]
        assert tuple(row[2:5]) == (t * p_max, t, cbits)
    assert prep["threads"] * 16 >= prep["lane_cap"]
    assert prep["stage_cap"] % 4 == 0 and prep["stage_cap"] >= given.max()


def _pair():
    return (JaxInvertedIndex(JaxBM25Config(packed_merge=False)),
            InvertedIndex(BM25Config(packed_merge=False), device="cpu"))


def test_index_scores_each_segment_in_one_k2_call(monkeypatch):
    """Queries of several narrow classes make one merge_segsum_topk_classes
    call per segment scored (main, then the tail), and answer as the JAX
    package does."""
    from tpurag_torch.index import inverted

    calls = []
    real = inverted.merge_segsum_topk_classes

    def rec(*args):
        calls.append(args)
        return real(*args)

    monkeypatch.setattr(inverted, "merge_segsum_topk_classes", rec)
    rng = np.random.default_rng(3)
    vocab = [f"t{j}" for j in range(150)]
    w = 1.0 / np.arange(1, 151)
    texts = [" ".join(rng.choice(vocab, 8 + i, p=w / w.sum()))
             for i in range(160)]  # distinct lengths: no tied scores
    jidx, tidx = _pair()
    for idx in (jidx, tidx):
        idx.add_batch(range(160), texts)
    queries = ["t0", "t1 t140", "t2 t3 t99 t120", "t5 t6 t7 t8 t9",
               "t149", "nothing here", "t0 t1 t2 t3 t4 t5 t6 t7 t8"]
    wv, wi = jidx.search(queries, 8)
    gv, gi = tidx.search(queries, 8)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gv, wv, rtol=1e-4)
    assert (gi[:, 0] >= 0).sum() == len(queries) - 1
    assert len(calls) == 1
    classes = calls[0][2]
    assert len(classes) >= 3 and {c[1] for c in classes} >= {1, 4, 8}
    for idx in (jidx, tidx):
        idx.add_batch(range(160, 170), texts[:10])  # a tail segment
    calls.clear()
    wv, wi = jidx.search(queries, 8)
    gv, gi = tidx.search(queries, 8)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gv, wv, rtol=1e-4)
    assert len(calls) == 2


@pytest.mark.parametrize("probe", ["full", "stage_only", "no_merge",
                                   "one_pick"])
def test_k2_anatomy_patches_apply(probe):
    """tools/k2_anatomy.py cuts parts out of K2 by textual patches; each
    anchor must be in the kernel's source exactly once."""
    path = pathlib.Path(__file__).resolve().parents[1] / "tools/k2_anatomy.py"
    spec = importlib.util.spec_from_file_location("k2_anatomy", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    src = tool.patched(tool.PROBES[probe])
    assert "topk_rows_kernel" in src
    assert (src == tool.patched([])) == (probe == "full")
    assert tool.FIRST_SOURCE.exists()
    assert "tr_merge_segsum_topk" in tool.FIRST_SOURCE.read_text()


def test_k2_host_draws_match_chip_smoke():
    """tools/k2_host.py times the keyword leg on chip_smoke.py's requests
    without their texts or embeddings: at a small size its postings index
    equals the one add_batch builds from zipf_corpus's texts (vocabulary,
    postings, lengths, results), and its request is the phase's first
    timed one."""
    path = pathlib.Path(__file__).resolve().parents[1] / "tools/k2_host.py"
    spec = importlib.util.spec_from_file_location("k2_host", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    n, vocab, df_max, b = 3000, 800, 200, 16
    cell = tool.draw_cell(chip_smoke, 5, n, vocab, df_max, b)
    rng = np.random.default_rng(5)
    texts, _ = chip_smoke.zipf_corpus(rng, n, vocab, df_max)
    emb = chip_smoke.unit_rows(rng, n, chip_smoke.DIM)
    requests = []
    for _ in range(2):
        chip_smoke.query_vectors(rng, emb, b)
        requests.append(chip_smoke.zipf_queries(rng, b, vocab))
    assert list(cell["queries"]) == requests[1]
    want = InvertedIndex(device="cpu")
    want.add_batch(range(n), texts)
    got = tool.build(cell, "cpu")
    assert got.vocab == want.vocab and got.doc_len == want.doc_len
    assert got._postings_doc == want._postings_doc
    assert got._postings_tf == want._postings_tf
    assert (got.n_docs, got._total_tokens) == (want.n_docs,
                                               want._total_tokens)
    gv, gi = got.search(requests[1], 8)
    wv, wi = want.search(requests[1], 8)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gv, wv)
    assert (gi >= 0).sum() > b
