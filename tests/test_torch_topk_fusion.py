"""tpurag_torch top-k and RRF fusion against the JAX package's functions.

Inputs are made with numpy from a seed and handed to both packages.
select_topk / merge_topk: values and ids must be identical, ties included
(value descending, ties to the smaller id, the same exhausted-row output).
rrf_fuse: ids and source bits identical, scores within 1e-6.
fuse_legs (hybrid_search's floor, gate and RRF): on the CPU its plain
version, bit for bit the composition it replaced and the JAX package's
hybrid_search on the same legs (tests/fuse_cases.py).
"""

from types import SimpleNamespace

import fuse_cases
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurag.kernels import fusion as jfusion
from tpurag.kernels import topk as jtopk
from tpurag_torch.kernels import fusion, topk
from tpurag_torch.utils import tracing


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


class _Leg:
    """Stands in for an index in hybrid_search: fixed hits, the gate's
    idf masses and a BM25 mode."""

    def __init__(self, scores, ids, wrap, mass=None, compat=False):
        self.hits = wrap(scores), wrap(ids)
        self.mass = mass
        self.config = SimpleNamespace(rank_compat_scores=compat)

    def __len__(self):
        return 1

    def search(self, queries, k, as_device=False):
        assert k == self.hits[1].shape[1]
        return self.hits

    def query_idf_mass(self, queries):
        return self.mass


def _fusion_before_fuse_legs(v_s, v_i, k_s, k_i, mass, p):
    """hybrid_search's fusion as it stood before fuse_legs: the floor,
    the gate, rrf_fuse, in plain torch."""
    keep = v_s >= p.min_vector_score
    v_i = torch.where(keep, v_i, -1)
    if k_i is None:
        k_i = torch.full((v_i.shape[0], p.keyword_top_k), -1,
                         dtype=torch.int32)
    elif mass is not None:
        mass = torch.as_tensor(mass)
        best = k_s.amax(dim=1, keepdim=True)
        k_i = torch.where(best >= p.min_keyword_coverage * mass[:, None],
                          k_i, -1)
    return fusion.rrf_fuse((v_i, k_i), weights=(p.vector_weight,
                                                p.keyword_weight),
                           final_k=p.final_top_k, rrf_k=p.rrf_k,
                           both_bonus=p.both_bonus)


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("final", ["below", "equal", "above"])
@pytest.mark.parametrize("gate", fuse_cases.GATES + ("no keyword",))
@pytest.mark.parametrize("preset", ["document", "code"])
def test_fuse_legs_plain_matches_todays_fusion_and_jax(preset, gate, final):
    """hybrid_search's fusion (fuse_legs, the plain version on the CPU)
    against the composition it replaced, bit for bit, and against the JAX
    package's hybrid_search on the same legs."""
    from tpurag.core.config import PRESETS as JAX_PRESETS
    from tpurag.engine import hybrid as jhybrid
    from tpurag_torch.core.config import PRESETS
    from tpurag_torch.engine import hybrid

    kv, kk = PRESETS[preset].vector_top_k, PRESETS[preset].keyword_top_k
    fk = {"below": kv + kk - 3, "equal": kv + kk, "above": kv + kk + 5}[final]
    p = fuse_cases.preset_for(PRESETS[preset], gate, fk)
    jp = fuse_cases.preset_for(JAX_PRESETS[preset], gate, fk)
    b = 16
    v_s, v_i, k_s, k_i, mass = fuse_cases.legs(
        len(preset) + fk, b, kv, kk, p.min_vector_score,
        p.min_keyword_coverage)
    keyword = gate != "no keyword"
    compat = gate == "compat"
    texts = ["q"] * b

    def run(pkg, wrap, preset_):
        inverted = (_Leg(k_s, k_i, wrap, mass, compat) if keyword else None)
        return pkg.hybrid_search(_Leg(v_s, v_i, wrap), inverted, None,
                                 texts, preset_)

    before = dict(tracing.counters)
    got = run(hybrid, torch.from_numpy, p)
    assert tracing.counters["fuse_plain"] == before.get("fuse_plain", 0) + 1
    gated = keyword and gate == "on"
    want = _fusion_before_fuse_legs(
        *map(torch.from_numpy, (v_s, v_i)),
        *((torch.from_numpy(k_s), torch.from_numpy(k_i)) if keyword
          else (None, None)), mass if gated else None, p)
    jax_want = run(jhybrid, jnp.asarray, jp)
    assert got[0].shape == (b, fk)
    np.testing.assert_array_equal(_bits(got[0]), _bits(want[0]))
    for g, w, j in zip(got[1:], want[1:], jax_want[1:]):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))
    # JAX divides w / t where torch multiplies by 1 / t: an ulp apart.
    np.testing.assert_allclose(got[0].numpy(), np.asarray(jax_want[0]),
                               rtol=0, atol=1e-6)
    # The edges of tests/fuse_cases.py: row 0 at the floor and the gate
    # (kept), row 1 a float below both (dropped), row 2 a tie, row 3 empty.
    ids = got[1].numpy()
    whole = final != "below"  # every kept candidate fits in the output
    assert (ids[3] == -1).all()
    assert v_i[0, 0] in ids[0] or not whole
    assert v_i[1, 0] not in ids[1] or v_i[1, 0] in k_i[1]
    if gate == "on":
        assert 11 in ids[0] or not whole
        assert 11 not in ids[1]
    if keyword and p.vector_weight == p.keyword_weight:
        assert list(ids[2, :2]) == [5, 9]
        assert got[0][2, 0] == got[0][2, 1]


@pytest.mark.parametrize("keyword", [True, False])
def test_fuse_legs_on_cpu_never_reaches_the_kernels(keyword, monkeypatch):
    from tpurag_torch.core.config import PRESETS

    def refused(*a, **kw):
        raise AssertionError("the kernel library was loaded")

    monkeypatch.setattr(fusion, "load_kernels", refused)
    p = PRESETS["document"]
    v_s, v_i, k_s, k_i, mass = (
        torch.from_numpy(x) if x.ndim == 2 else x
        for x in fuse_cases.legs(7, 8, 8, 8, p.min_vector_score,
                                 p.min_keyword_coverage))
    if not keyword:
        k_s = k_i = mass = None
    tracing.clear()
    got = fusion.fuse_legs(v_s, v_i, k_s, k_i, mass, p)
    want = fusion.fuse_legs_ref(v_s, v_i, k_s, k_i, mass, p)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    assert dict(tracing.counters) == {"fuse_plain": 1}
