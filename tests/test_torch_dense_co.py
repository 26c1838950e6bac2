"""tpurag_torch's corpus-outer dense top-k (K7) against the JAX package.

dense_topk_co computes dense_topk's function; on the CPU it is the
plain version, dense_topk_ref. It is held to JAX's dense_topk_pallas_co
in interpret mode at tests/test_dense.py's corpus-outer shapes: ids
exactly, scores within 1e-5 for fp32 corpora and 2e-3 for bf16 ones (the
summation order only, as in test_torch_dense.py). The JAX wrapper caps
the padded batch at 4096 (a VMEM limit); the port has no cap.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurag.kernels.dense import dense_topk_pallas_co, dense_topk_xla
from tpurag.kernels.runtime import NEG_INF
from tpurag_torch.kernels import dense as dense_mod
from tpurag_torch.kernels.dense import dense_topk_co, dense_topk_ref
from tpurag_torch.kernels.runtime import launch_counts

torch.set_float32_matmul_precision("highest")

TOL = {"float32": 1e-5, "bfloat16": 2e-3}
T_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,n,d,k,nv", [
    (7, 300, 64, 8, 300),     # b below one tile_b, odd shapes
    (16, 5000, 128, 8, 4777),  # n_valid mid-tile masking
    (130, 2500, 96, 5, 2500),  # multi query-tile, k not pow2
    (3, 10, 32, 8, 4),         # k > n_valid: empty slots
    (9, 257, 130, 3, 200),     # d not lane-aligned, n not tile-aligned
])
def test_dense_co_matches_jax(dtype, b, n, d, k, nv):
    rng = np.random.default_rng(b * n + d)
    emb, q = _unit(rng, n, d), _unit(rng, b, d)
    pv, pi = dense_topk_pallas_co(jnp.asarray(q), jnp.asarray(emb, dtype),
                                  jnp.int32(nv), k, tile_b=8, tile_n=256,
                                  interpret=True)
    before = launch_counts["dense_topk_co"]
    gv, gi = dense_topk_co(torch.from_numpy(q),
                           torch.from_numpy(emb).to(T_DTYPE[dtype]), nv, k)
    assert launch_counts["dense_topk_co"] == before  # no kernel on the CPU
    np.testing.assert_array_equal(gi.numpy(), np.asarray(pi))
    np.testing.assert_allclose(gv.numpy(), np.asarray(pv), atol=TOL[dtype])
    if k > nv:
        assert (gi.numpy()[:, nv:] == -1).all()
        assert (gv.numpy()[:, nv:] <= NEG_INF / 2).all()


def test_dense_co_answers_past_the_jax_batch_cap():
    """b = 4100 pads past the JAX wrapper's 4096 cap (it raises there); the
    port answers, equal to JAX's XLA oracle."""
    rng = np.random.default_rng(3)
    b, n, d, k = 4100, 96, 16, 4
    emb, q = _unit(rng, n, d), _unit(rng, b, d)
    with pytest.raises(ValueError, match="4096"):
        dense_topk_pallas_co(jnp.asarray(q), jnp.asarray(emb), jnp.int32(n),
                             k, tile_b=8, tile_n=128, interpret=True)
    wv, wi = dense_topk_xla(jnp.asarray(q), jnp.asarray(emb), jnp.int32(n), k)
    gv, gi = dense_topk_co(torch.from_numpy(q), torch.from_numpy(emb), n, k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=1e-5)


def test_dense_co_cpu_path_is_the_plain_version():
    rng = np.random.default_rng(4)
    emb = torch.from_numpy(_unit(rng, 200, 24))
    q = torch.from_numpy(_unit(rng, 5, 24))
    got = dense_topk_co(q, emb, 150, 7)
    want = dense_topk_ref(q, emb, 150, 7)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_dense_co_rejects_unsupported_device():
    """K7's wrapper raises on a device it has no kernel for, rather than
    giving way to its plain version or to K1."""
    x = torch.zeros((2, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        dense_mod.dense_topk_co(x, x, 2, 1)


@pytest.mark.parametrize("dtype,d,tn", [
    (torch.bfloat16, 1024, 64),  # the eval suite's width: 64 rows fit
    (torch.float32, 1024, 32),
    (torch.bfloat16, 6784, 16),  # the widest 16-row tile
    (torch.bfloat16, 6785, 0),
    (torch.float32, 3264, 16),
    (torch.float32, 3265, 0),
])
def test_dense_co_tile_rows(dtype, d, tn):
    """K7's corpus tile: the largest of 64, 32, 16 rows whose tile, query
    slice and score tile fit one block's 227 KB of shared memory."""
    assert dense_mod.co_tile_rows(dtype, d) == tn


def test_dense_co_splits():
    """One block per split: at least one corpus tile each, the card filled,
    and the merge's candidate cap kept."""
    assert dense_mod.dense_co_splits(0, 8) == 1
    assert dense_mod.dense_co_splits(10, 8) == 10
    assert dense_mod.dense_co_splits(15_625, 8) == dense_mod.TARGET_BLOCKS
    assert dense_mod.dense_co_splits(15_625, 200) == (
        dense_mod.MAX_MERGE_CANDIDATES // 200)
