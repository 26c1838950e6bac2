"""tpurag_torch dense top-k and DenseIndex against the JAX package.

dense_topk_ref (the plain version of the CUDA kernel, and the CPU path of
dense_topk) is held against JAX's dense_topk_xla and its Pallas kernel in
interpret mode on the same numpy inputs. Ids must match exactly; scores
within 1e-5 for fp32 corpora and 2e-3 for bf16 ones (both sides cast the
queries to bf16 and sum exact bf16 products in fp32: the tolerance covers
the summation order only).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurag.index.dense import DenseIndex as JaxDenseIndex
from tpurag.kernels.dense import dense_topk_pallas, dense_topk_xla
from tpurag.kernels.runtime import NEG_INF
from tpurag_torch.index.dense import DenseIndex
from tpurag_torch.kernels.dense import dense_topk, dense_topk_ref

torch.set_float32_matmul_precision("highest")

TOL = {"float32": 1e-5, "bfloat16": 2e-3}
T_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,n,n_valid,d,k", [
    (5, 300, 300, 64, 8),
    (9, 260, 200, 48, 40),
    (4, 128, 20, 32, 30),   # k > n_valid: empty slots
])
def test_dense_ref_matches_jax(dtype, b, n, n_valid, d, k):
    rng = np.random.default_rng(n + k)
    emb, q = _unit(rng, n, d), _unit(rng, b, d)
    emb_j = jnp.asarray(emb, dtype)
    want_v, want_i = dense_topk_xla(jnp.asarray(q), emb_j, jnp.int32(n_valid), k)
    pal_v, pal_i = dense_topk_pallas(jnp.asarray(q), emb_j, jnp.int32(n_valid),
                                     k, interpret=True)
    emb_t = torch.from_numpy(emb).to(T_DTYPE[dtype])
    got_v, got_i = dense_topk_ref(torch.from_numpy(q), emb_t, n_valid, k)
    # The CPU path of the dispatching wrapper is the plain version.
    via_v, via_i = dense_topk(torch.from_numpy(q), emb_t, n_valid, k)
    assert torch.equal(via_v, got_v) and torch.equal(via_i, got_i)
    got_v, got_i = got_v.numpy(), got_i.numpy()

    np.testing.assert_array_equal(got_i, np.asarray(pal_i))
    np.testing.assert_allclose(got_v, np.asarray(pal_v), atol=TOL[dtype])
    live = np.asarray(want_v) > NEG_INF / 2  # xla keeps column ids there
    np.testing.assert_array_equal(got_i[live], np.asarray(want_i)[live])
    np.testing.assert_array_equal(got_i[~live], -1)
    np.testing.assert_allclose(got_v, np.asarray(want_v), atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_index_add_delete_search_matches_jax(dtype):
    rng = np.random.default_rng(7)
    d = 48
    jidx = JaxDenseIndex(d, dtype=dtype, capacity=128)
    tidx = DenseIndex(d, dtype=dtype, capacity=128, device="cpu")
    for m in (100, 90, 70):  # grows past the initial capacity
        vecs = rng.standard_normal((m, d)).astype(np.float32)
        np.testing.assert_array_equal(jidx.add(vecs), tidx.add(vecs))
    dead = rng.choice(260, 25, replace=False)
    jidx.delete(dead)
    tidx.delete(dead)
    assert len(jidx) == len(tidx) == 235
    assert tidx.capacity == jidx.capacity
    q = rng.standard_normal((7, d)).astype(np.float32)
    for k in (1, 8, 30):
        wv, wi = jidx.search(q, k)
        gv, gi = tidx.search(q, k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=TOL[dtype])
        assert not np.isin(gi.numpy(), dead).any()


def test_dense_index_empty_and_tiny():
    tidx = DenseIndex(16, device="cpu")
    s, i = tidx.search(np.ones((2, 16), np.float32), 4)
    assert (i.numpy() == -1).all() and (s.numpy() <= NEG_INF / 2).all()
    jidx = JaxDenseIndex(16)
    rows = np.random.default_rng(1).standard_normal((3, 16)).astype(np.float32)
    tidx.add(rows)
    jidx.add(rows)
    gv, gi = tidx.search(rows[:1], 8)
    wv, wi = jidx.search(rows[:1], 8)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))  # (1, 3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_dense_index_save_load_across_packages(tmp_path, dtype, direction):
    rng = np.random.default_rng(3)
    d = 40
    vecs = rng.standard_normal((150, d)).astype(np.float32)
    q = rng.standard_normal((6, d)).astype(np.float32)
    src = (JaxDenseIndex(d, dtype=dtype) if direction == "jax_to_torch"
           else DenseIndex(d, dtype=dtype, device="cpu"))
    src.add(vecs)
    src.delete([4, 77])
    src.save(tmp_path / "dense")
    if direction == "jax_to_torch":
        dst = DenseIndex.load(tmp_path / "dense", device="cpu")
        assert dst.dtype == T_DTYPE[dtype]
        assert torch.equal(dst.embeddings[:150].float(),
                           torch.from_numpy(np.array(
                               src.embeddings[:150], np.float32)))
    else:
        dst = JaxDenseIndex.load(tmp_path / "dense")
        assert dst.dtype == jnp.dtype(dtype)
        np.testing.assert_array_equal(
            np.asarray(dst.embeddings[:150], np.float32),
            src.embeddings[:150].float().numpy())
    assert len(dst) == 148 and dst.n_active == 150
    sv, si = src.search(q, 8)
    dv, di = dst.search(q, 8)
    np.testing.assert_array_equal(np.asarray(di), np.asarray(si))
    np.testing.assert_allclose(np.asarray(dv), np.asarray(sv), atol=TOL[dtype])


def test_dense_index_options_not_ported_raise():
    for kw in ({"store": "host"}, {"mesh": object()}):
        with pytest.raises(NotImplementedError):
            DenseIndex(16, device="cpu", **kw)
    assert DenseIndex(16, device="cpu", quant=True).quant  # ported


@pytest.mark.parametrize("b,n_valid,k", [
    (1024, 100_000, 8), (512, 1_000_000, 8), (256, 1_000_000, 16),
    (8, 2_100_000, 40), (1, 1000, 600), (130, 2900, 8), (512, 20_000, 600),
    (5, 0, 8), (20_000, 1_000_000, 8), (3, 300, 9000)])
def test_sm90_splits_fill_one_wave(b, n_valid, k):
    from tpurag_torch.kernels.dense import (H100_SMS, MAX_MERGE_CANDIDATES,
                                            SM90_TILE, sm90_splits)
    from tpurag_torch.kernels.runtime import cdiv

    s = sm90_splits(b, n_valid, k)
    q_tiles = cdiv(b, SM90_TILE)
    n_tiles = max(cdiv(n_valid, SM90_TILE), 1)
    assert s >= 1
    assert q_tiles * s <= max(H100_SMS, q_tiles)  # one wave at one per SM
    assert s * k <= max(MAX_MERGE_CANDIDATES, k)
    per = cdiv(n_tiles, s)  # the kernel's tiles per split
    assert (s - 1) * per < n_tiles  # every split holds a tile
    # 1024 x 100k: 8 query tiles x 16 splits, not 17 (136 blocks > 132).
    if (b, n_valid) == (1024, 100_000):
        assert s == 16
    if (b, n_valid, k) == (512, 1_000_000, 8):
        assert q_tiles * s == 132


def test_sm90_route():
    from tpurag_torch.kernels.dense import sm90_route

    assert sm90_route(torch.bfloat16, 1024, 0, 4096)
    assert sm90_route(torch.bfloat16, 72, 16, 32)
    assert not sm90_route(torch.bfloat16, 36, 0, 0)     # rows of 72 bytes
    assert not sm90_route(torch.bfloat16, 1024, 8, 0)   # unaligned pointer
    assert not sm90_route(torch.float32, 1024, 0, 0)
    assert not sm90_route(torch.int8, 1024, 0, 0)


@pytest.mark.parametrize("probe", ["full", "no_mma", "no_tma", "no_fold",
                                   "mma_only"])
def test_k1_anatomy_patches_apply(probe):
    """tools/k1_anatomy.py cuts parts out of K1's wgmma body by textual
    patches; each anchor must be in the kernel's source exactly once."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "tools/k1_anatomy.py"
    spec = importlib.util.spec_from_file_location("k1_anatomy", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    src = tool.patched(tool.PROBES[probe])
    assert "dense_scan_sm90_kernel" in src
    assert (src == tool.patched([])) == (probe == "full")
