"""tpurag_torch's int8 path (kernels/quant.py, DenseIndex(quant=True))
against the JAX package.

Inputs are made from numpy seeds and handed to both packages. The plain
versions of K5 (dense_scan_q8_ref) and K8 (gather_scores_ref) are held to
JAX's Pallas kernels in interpret mode and to their XLA forms: K5's exact
int arithmetic makes values and ids bit-identical; K8's fp32 dots agree
within 1e-6 (another summation order). DenseIndex parity uses
integer-valued vectors, whose norms are exact in any summation order, so
both packages store the same normalized rows and the int8 sidecars must
be equal bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurag.index.dense import DenseIndex as JaxDenseIndex
from tpurag.kernels import quant as jq
from tpurag_torch.index.dense import DenseIndex
from tpurag_torch.kernels.dense import (H100_SMS, MAX_MERGE_CANDIDATES,
                                        sm90_splits)
from tpurag_torch.kernels.quant import (Q8_RESIDENT_MAX_D, dense_scan_q8,
                                        dense_scan_q8_ref, dense_topk_q8,
                                        gather_scores, gather_scores_ref,
                                        q8_sm90_route, q8_sm90_tile,
                                        quantize_rows, rescore_topk,
                                        rescore_topk_ref)
from tpurag_torch.kernels.runtime import cdiv

torch.set_float32_matmul_precision("highest")


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("form", ["fp32", "bf16_rounded", "zero_rows"])
def test_quantize_rows_bit_identical_to_jax(form):
    rng = np.random.default_rng(0)
    x = _unit(rng, 2000, 96) * rng.uniform(0.1, 3.0, (2000, 1)).astype(
        np.float32)
    if form == "bf16_rounded":
        x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    if form == "zero_rows":
        x[::7] = 0.0
    want8, want_s = (np.asarray(a) for a in jq.quantize_rows(jnp.asarray(x)))
    got8, got_s = quantize_rows(_t(x))
    np.testing.assert_array_equal(got8.numpy(), want8)
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    if form == "zero_rows":
        assert (got_s.numpy()[::7] == 0).all() and (got8.numpy()[::7] == 0).all()


def _codes(rng, n, d, b):
    e8, es = jq.quantize_rows(jnp.asarray(_unit(rng, n, d)))
    q8, qs = jq.quantize_rows(jnp.asarray(_unit(rng, b, d)))
    return q8, qs, e8, es


@pytest.mark.parametrize("n,d,b,k,n_valid", [
    (700, 48, 3, 8, 700),
    (900, 128, 9, 16, 900),
    (333, 40, 2, 5, 300),     # n_valid < n
    (256, 32, 4, 12, 5),      # k > n_valid: ids -1
    (700, 64, 33, 31, 650),   # the largest k whose lists stay in shared
    (700, 64, 33, 40, 650),   # memory at K5's 128-query tile, and past it
])
def test_scan_q8_plain_bit_identical_to_jax(n, d, b, k, n_valid):
    rng = np.random.default_rng(n + k)
    q8, qs, e8, es = _codes(rng, n, d, b)
    pv, pi = jq.dense_topk_pallas_q8(q8, qs, e8, es, jnp.int32(n_valid), k,
                                     tile_b=8, tile_n=128, interpret=True)
    xv, xi = jq.dense_topk_xla_q8(q8, qs, e8, es, jnp.int32(n_valid), k)
    args = tuple(_t(a) for a in (q8, qs, e8, es)) + (n_valid, k)
    gv, gi = dense_scan_q8_ref(*args)
    for wv, wi in ((pv, pi), (xv, xi)):
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    if k > n_valid:
        assert (gi.numpy()[:, n_valid:] == -1).all()
    # On CPU tensors the K5 wrapper is the plain version.
    wv, wi = dense_scan_q8(*args)
    assert torch.equal(wv, gv) and torch.equal(wi, gi)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_scores_plain_matches_jax(dtype):
    rng = np.random.default_rng(1)
    n, d, b, m = 256, 128, 5, 6
    emb, q = _unit(rng, n, d), _unit(rng, b, d)
    ids = rng.integers(0, n, (b, m)).astype(np.int32)
    emb_j = jnp.asarray(emb, dtype)
    want = np.asarray(jq.gather_scores_pallas(jnp.asarray(q), emb_j,
                                              jnp.asarray(ids), tile_b=4,
                                              interpret=True))
    emb_t = _t(np.asarray(emb_j.astype(jnp.float32))).to(getattr(torch, dtype))
    got = gather_scores_ref(_t(q), emb_t, _t(ids))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    assert torch.equal(gather_scores(_t(q), emb_t, _t(ids)), got)


def test_rescore_topk_matches_jax_with_duplicates_and_empties():
    rng = np.random.default_rng(2)
    q, emb = _unit(rng, 4, 32), _unit(rng, 200, 32)
    top12 = np.argsort(-(q @ emb.T), axis=1)[:, :12]
    cand = np.concatenate([top12[:, ::-1], np.full((4, 1), -1),
                           top12[:, :3], np.full((4, 2), -1)],
                          axis=1).astype(np.int32)
    for k in (5, 16):  # 16 > the 12 distinct candidates: empties
        wv, wi = jq.rescore_topk(jnp.asarray(q), jnp.asarray(emb),
                                 jnp.asarray(cand), k)
        gv, gi = rescore_topk(_t(q), _t(emb), _t(cand), k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=1e-6)
        assert len(set(gi.numpy()[0][gi.numpy()[0] >= 0])) == min(k, 12)


def _rescore_case(name: str):
    """(queries, corpus, candidate ids, k) of a rescore edge case."""
    rng = np.random.default_rng(len(name))
    q, emb = _unit(rng, 5, 32), _unit(rng, 300, 32)
    top = np.argsort(-(q @ emb.T), axis=1)
    k = 6
    if name == "duplicates":  # ids repeated, the first lane not the best
        cand = np.concatenate([top[:, 4:0:-1], top[:, :6], top[:, 2:3]], 1)
    elif name == "empties":  # -1 ids anywhere, an all -1 row
        cand = top[:, :10].copy()
        cand[:, ::3] = -1
        cand[2] = -1
    elif name == "m_below_k":  # M = 4 < k
        cand, k = top[:, [3, 0, 2, 1]], 9
    else:  # "ties": rows 10..14 copy row 0, so their dots tie with it
        emb[10:15] = emb[0]
        cand = np.concatenate([np.full((5, 1), 12), top[:, :4],
                               np.full((5, 1), 0), np.full((5, 1), 14)], 1)
        q[0] = emb[0]  # row 0 and its copies are query 0's best
    return q, emb, cand.astype(np.int32), k


def _rescore_model(q, emb, cand, k):
    """numpy model of csrc/gather_scores.cu's rescore: a lane keeps its id
    unless it is < 0 or repeats an earlier lane's; each kept candidate's
    slot is the count of kept ones sorting before it (score desc, id
    asc)."""
    b, m = cand.shape
    out_v = np.full((b, k), np.float32(-3.0e38), np.float32)
    out_i = np.full((b, k), -1, np.int32)
    for r in range(b):
        kept = [(np.float32(q[r] @ emb[i]), int(i))
                for j, i in enumerate(cand[r])
                if i >= 0 and i not in cand[r, :j]]
        for s, i in kept:
            rank = sum(s2 > s or (s2 == s and i2 < i) for s2, i2 in kept)
            if rank < k:
                out_v[r, rank], out_i[r, rank] = s, i
    return out_v, out_i


@pytest.mark.parametrize("case", ["duplicates", "empties", "m_below_k",
                                  "ties"])
def test_rescore_topk_ref_matches_jax(case):
    """rescore_topk_ref (the plain version the CPU takes) against JAX's
    rescore_topk, and the fused kernel's keep-and-rank rule (a numpy model)
    against both."""
    q, emb, cand, k = _rescore_case(case)
    # JAX's top_k needs k <= M: it gets the candidates padded with -1 (no
    # candidate) to k, which the port's plain version does itself.
    pad = np.full((len(cand), max(k - cand.shape[1], 0)), -1, np.int32)
    wv, wi = jq.rescore_topk(jnp.asarray(q), jnp.asarray(emb),
                             jnp.asarray(np.concatenate([cand, pad], 1)), k)
    gv, gi = rescore_topk_ref(_t(q), _t(emb), _t(cand), k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=1e-6)
    mv, mi = _rescore_model(q, emb, cand, k)
    np.testing.assert_array_equal(mi, gi.numpy())
    np.testing.assert_allclose(mv, gv.numpy(), atol=1e-6)
    cv, ci = rescore_topk(_t(q), _t(emb), _t(cand), k)  # CPU: the same
    assert torch.equal(cv, gv) and torch.equal(ci, gi)
    if case == "ties":
        assert gi[0, :3].tolist() == [0, 12, 14]
    if case == "m_below_k":
        assert (gi[:, 4:] == -1).all()
    if case == "empties":
        assert (gi[2] == -1).all()


def test_rescore_wrapper_rejects_unsupported_device():
    x = torch.zeros((2, 8), device="meta")
    ids = torch.zeros((2, 3), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        rescore_topk(x, x, ids, 2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_topk_q8_with_rescore_matches_jax(dtype):
    rng = np.random.default_rng(3)
    n, d, b, k = 600, 64, 6, 10
    q, emb = _unit(rng, b, d), _unit(rng, n, d)
    emb_j = jnp.asarray(emb, dtype)
    e8, es = jq.quantize_rows(emb_j)
    wv, wi = jq.dense_topk_q8(jnp.asarray(q), e8, es, n, k,
                              rescore_emb=emb_j, interpret=True)
    emb_t = _t(np.asarray(emb_j.astype(jnp.float32))).to(getattr(torch, dtype))
    gv, gi = dense_topk_q8(_t(q), _t(e8), _t(es), n, k, rescore_emb=emb_t)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=1e-6)


def test_rescore_never_resurrects_padding_rows():
    # m > n_valid: the scan's padding columns are empties (-1), so zero
    # rows never rescore as 0.0 hits above live rows of negative cosine.
    rng = np.random.default_rng(4)
    d, n_valid, k = 32, 5, 6
    emb = np.zeros((128, d), np.float32)
    q = np.ones((1, d), np.float32) / np.sqrt(d)
    emb[:n_valid] = -q + 0.01 * rng.standard_normal((n_valid, d))
    emb[:n_valid] /= np.linalg.norm(emb[:n_valid], axis=1, keepdims=True)
    e8, es = quantize_rows(_t(emb))
    gv, gi = dense_topk_q8(_t(q), e8, es, n_valid, k, rescore_emb=_t(emb))
    wv, wi = jq.dense_topk_q8(jnp.asarray(q), *jq.quantize_rows(
        jnp.asarray(emb)), n_valid, k, rescore_emb=jnp.asarray(emb),
        interpret=True)
    ids = gi.numpy()[0]
    assert (ids[ids >= 0] < n_valid).all() and (gv.numpy()[0][ids >= 0] < 0).all()
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


def _int_vectors(rng, m, d):
    """Integer-valued rows: their squared norms are exact in any order."""
    return rng.integers(-8, 9, (m, d)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_index_add_delete_search_matches_jax(dtype):
    rng = np.random.default_rng(5)
    d = 48
    jidx = JaxDenseIndex(d, dtype=dtype, capacity=128, quant=True)
    tidx = DenseIndex(d, dtype=dtype, capacity=128, device="cpu", quant=True)
    for m in (100, 90, 70):  # grows past the initial capacity
        vecs = _int_vectors(rng, m, d)
        np.testing.assert_array_equal(jidx.add(vecs), tidx.add(vecs))
    dead = rng.choice(260, 25, replace=False)
    jidx.delete(dead)
    tidx.delete(dead)
    assert tidx.capacity == jidx.capacity and len(tidx) == len(jidx) == 235
    np.testing.assert_array_equal(tidx._q8.numpy(), np.asarray(jidx._q8))
    np.testing.assert_array_equal(tidx._qscale.numpy(),
                                  np.asarray(jidx._qscale))
    assert (tidx._qscale.numpy()[dead] == 0).all()
    np.testing.assert_array_equal(tidx.get_vectors([0, 5, 259]),
                                  jidx.get_vectors([0, 5, 259]))
    np.testing.assert_array_equal(tidx.get_rows(3, 9).float().numpy(),
                                  np.asarray(jidx.get_rows(3, 9), np.float32))
    q = rng.standard_normal((7, d)).astype(np.float32)
    for k in (1, 8, 30):
        wv, wi = jidx.search(q, k)
        gv, gi = tidx.search(q, k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=1e-6)
        assert not np.isin(gi.numpy(), dead).any()


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_quant_index_save_load_across_packages(tmp_path, direction):
    rng = np.random.default_rng(6)
    d = 40
    vecs = rng.standard_normal((150, d)).astype(np.float32)
    q = rng.standard_normal((6, d)).astype(np.float32)
    src = (JaxDenseIndex(d, quant=True) if direction == "jax_to_torch"
           else DenseIndex(d, device="cpu", quant=True))
    src.add(vecs)
    src.delete([4, 77])
    src.save(tmp_path / "dense")
    if direction == "jax_to_torch":
        dst = DenseIndex.load(tmp_path / "dense", device="cpu", quant=True)
        np.testing.assert_array_equal(dst._q8.numpy()[:150],
                                      np.asarray(src._q8)[:150])
    else:
        dst = JaxDenseIndex.load(tmp_path / "dense", quant=True)
        np.testing.assert_array_equal(np.asarray(dst._q8)[:150],
                                      src._q8.numpy()[:150])
    assert dst.quant and len(dst) == 148
    sv, si = src.search(q, 8)
    dv, di = dst.search(q, 8)
    np.testing.assert_array_equal(np.asarray(di), np.asarray(si))
    np.testing.assert_allclose(np.asarray(dv), np.asarray(sv), atol=1e-6)


def test_quant_wrappers_reject_unsupported_device():
    """K5's and K8's wrappers raise on a device they have no kernel for,
    rather than giving way to their plain versions."""
    x8 = torch.zeros((2, 8), dtype=torch.int8, device="meta")
    s = torch.zeros((2,), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        dense_scan_q8(x8, s, x8, s, 2, 1)
    with pytest.raises(ValueError, match="unsupported device"):
        gather_scores(torch.zeros((2, 8), device="meta"),
                      torch.zeros((4, 8), device="meta"),
                      torch.zeros((2, 3), dtype=torch.int32, device="meta"))


@pytest.mark.parametrize("d,ptrs,want", [
    (1024, (0, 4096), True),
    (64, (16, 32), True),
    (48, (0, 0), True),        # rows of 48 bytes: TMA zero-fills the box
    (40, (0, 0), False),       # rows of 40 bytes: the first body
    (1024, (8, 0), False),     # unaligned query codes
    (1024, (0, 4100), False),  # unaligned corpus codes
])
def test_q8_sm90_route(d, ptrs, want):
    """K5's wgmma body takes what a TMA tensor map can address."""
    assert q8_sm90_route(d, *ptrs) is want


@pytest.mark.parametrize("b,d,tile", [
    (1, 1024, 32), (32, 1024, 32), (33, 1024, 128), (512, 1024, 128),
    (32, Q8_RESIDENT_MAX_D, 32),
    (8, Q8_RESIDENT_MAX_D + 16, 128),  # the queries no longer fit
])
def test_q8_sm90_tile(b, d, tile):
    assert q8_sm90_tile(b, d) == tile


@pytest.mark.parametrize("b,n_valid,k", [
    (32, 1_000_000, 20), (512, 1_000_000, 8), (1, 1000, 1),
    (32, 1_000_000, 600), (33, 2900, 32)])
def test_q8_splits_fill_one_wave(b, n_valid, k):
    """K5's wgmma body takes K1's splits: its 32-query tile serves B <= 32,
    one query tile as at K1's 128, so (query tiles x splits) blocks fill
    132 SMs in one wave at 32 x 1M and 512 x 1M, every split holds a
    corpus tile, and the merge's S * k candidates stay in bounds."""
    s = sm90_splits(b, n_valid, k)
    q_tiles = cdiv(b, q8_sm90_tile(b, 1024))
    n_tiles = cdiv(n_valid, 128)
    assert s >= 1 and q_tiles * s <= H100_SMS
    assert s * k <= MAX_MERGE_CANDIDATES
    assert (s - 1) * cdiv(n_tiles, s) < n_tiles  # every split holds a tile
    if n_valid == 1_000_000 and k < 600:
        assert q_tiles * s in (131, 132)  # 7813 tiles: 131 x 60 or 33 x 4
    if k == 600:
        assert s == MAX_MERGE_CANDIDATES // k


@pytest.mark.parametrize("probe", ["full", "stages6", "stages8", "stages10",
                                   "no_mma", "no_fold", "stream", "stream8",
                                   "stream10"])
def test_k5_anatomy_patches_apply(probe):
    """tools/k5_anatomy.py times K5's wgmma body with textual patches of
    its source; each anchor must be in the source exactly once."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "tools/k5_anatomy.py"
    spec = importlib.util.spec_from_file_location("k5_anatomy", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    src = tool.patched(tool.PROBES[probe])
    assert "dense_scan_q8_sm90_kernel" in src
    assert (src == tool.patched([])) == (probe == "full")
