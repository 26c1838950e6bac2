"""tpurag_torch top-k and RRF fusion against the JAX package's functions.

Inputs are made with numpy from a seed and handed to both packages.
select_topk / merge_topk: values and ids must be identical, ties included
(value descending, ties to the smaller id, the same exhausted-row output).
rrf_fuse: ids and source bits identical, scores within 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurag.kernels import fusion as jfusion
from tpurag.kernels import topk as jtopk
from tpurag_torch.kernels import fusion, topk


def _tied_scores(rng, b, n):
    """Few distinct values, so most rows carry ties."""
    scores = rng.integers(0, 4, (b, n)).astype(np.float32) * 0.25
    ids = np.stack([rng.permutation(3 * n)[:n] for _ in range(b)]).astype(
        np.int32)
    return scores, ids


@pytest.mark.parametrize("b,n,k", [(4, 16, 1), (6, 33, 8), (3, 40, 40),
                                   (5, 8, 12)])
def test_select_topk_matches_jax_with_ties(b, n, k):
    scores, ids = _tied_scores(np.random.default_rng(n), b, n)
    want_v, want_i = jtopk.select_topk(jnp.asarray(scores), jnp.asarray(ids), k)
    got_v, got_i = topk.select_topk(torch.from_numpy(scores),
                                    torch.from_numpy(ids), k)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


@pytest.mark.parametrize("ka,kb,k", [(8, 8, 8), (5, 12, 10)])
def test_merge_topk_matches_jax_with_ties(ka, kb, k):
    rng = np.random.default_rng(ka * kb)
    va, ia = _tied_scores(rng, 4, ka)
    vb, ib = _tied_scores(rng, 4, kb)
    ib = ib + 1000  # two disjoint candidate sets, as main/tail segments are
    va[:, -2:] = -3.0e38  # empty slots
    ia[:, -2:] = -1
    want = jtopk.merge_topk(*(jnp.asarray(x) for x in (va, ia, vb, ib)), k)
    got = topk.merge_topk(*(torch.from_numpy(x) for x in (va, ia, vb, ib)), k)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _id_lists(rng, b, ks, n_ids):
    """Rank-ordered id lists with -1 holes and ids shared across lists."""
    out = []
    for k in ks:
        ids = np.stack([rng.permutation(n_ids)[:k] for _ in range(b)])
        ids[rng.random((b, k)) < 0.25] = -1
        out.append(ids.astype(np.int32))
    return out


@pytest.mark.parametrize("preset", ["document", "code"])
@pytest.mark.parametrize("seed", [0, 1])
def test_rrf_fuse_matches_jax(preset, seed):
    from tpurag.core.config import PRESETS

    p = PRESETS[preset]
    lists = _id_lists(np.random.default_rng(seed), 16,
                      (p.vector_top_k, p.keyword_top_k), n_ids=20)
    kw = dict(weights=(p.vector_weight, p.keyword_weight),
              final_k=p.final_top_k, rrf_k=p.rrf_k, both_bonus=p.both_bonus)
    w_s, w_i, w_b = jfusion.rrf_fuse(tuple(jnp.asarray(x) for x in lists), **kw)
    g_s, g_i, g_b = fusion.rrf_fuse([torch.from_numpy(x) for x in lists], **kw)
    np.testing.assert_array_equal(g_i.numpy(), np.asarray(w_i))
    np.testing.assert_array_equal(g_b.numpy(), np.asarray(w_b))
    np.testing.assert_allclose(g_s.numpy(), np.asarray(w_s), rtol=0, atol=1e-6)


def test_rrf_fuse_all_empty_and_duplicates():
    lists = [np.full((2, 4), -1, np.int32),
             np.asarray([[3, 3, -1, 7], [-1, -1, -1, -1]], np.int32)]
    kw = dict(weights=(1.0, 1.0), final_k=4)
    w = jfusion.rrf_fuse(tuple(jnp.asarray(x) for x in lists), **kw)
    g = fusion.rrf_fuse([torch.from_numpy(x) for x in lists], **kw)
    for gx, wx in zip(g, w):
        np.testing.assert_array_equal(gx.numpy(), np.asarray(wx))
