"""tpurag_torch's IVF path (kernels/ivf_scan.py, index/ivf.py, the KB's
ivf / hybrid_ivf modes) against the JAX package.

The reference's state carries across: partitions that JAX builds and saves
load in the port (IVFIndex.load), and the port's plain version of K6
(ivf_probe_topk_ref) and its ivf_scan are held on those very layouts to
JAX's Pallas probe kernel and ivf_scan_pallas in interpret mode. int8
scans are exact integer arithmetic, so scores and ids are bit-identical;
bf16 / fp32 scans agree within 1e-5 (another summation order). Builds
compare field by field: the layout and int8 codes are the same numpy
arithmetic in both packages, and k-means (on clustered data, where no row
sits on a boundary) lands on the same assignment with centroids within
1e-5.

On the CPU the JAX package scores an IVF through its XLA fallback: fp32
queries against the bf16 (or dequantized) rows. The port's CPU path is
its kernels' plain versions (int8 x int8 with an exact rescore; queries
rounded to bf16 for a bf16 layout), so KB-level ivf scores of a bf16
layout agree within 8e-3, rescored ones within 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpurag
import tpurag_torch
from tpurag.core.config import BM25Config as JaxBM25Config
from tpurag.core.config import EngineConfig as JaxEngineConfig
from tpurag.core.config import IVFConfig as JaxIVFConfig
from tpurag.core.types import Chunk as JaxChunk
from tpurag.index import ivf as jivf
from tpurag.kernels.ivf_scan import ivf_probe_topk_pallas, ivf_scan_pallas
from tpurag.kernels.quant import quantize_rows as jax_quantize_rows
from tpurag.kernels.runtime import round_up
from tpurag_torch.core.config import BM25Config, EngineConfig, IVFConfig
from tpurag_torch.core.types import Chunk
from tpurag_torch.index import ivf as tivf
from tpurag_torch.index.ivf import IVFIndex
from tpurag_torch.kernels.ivf_scan import (ivf_chunk_rows, ivf_probe_topk,
                                           ivf_probe_topk_ref, ivf_row_split,
                                           ivf_scan, probe_clusters)
from tpurag_torch.kernels.runtime import NEG_INF

torch.set_float32_matmul_precision("highest")
_BIG = 2**30
_DTYPES = {"fp32": (jnp.float32, torch.float32),
           "bf16": (jnp.bfloat16, torch.bfloat16)}


def _blobs(seed, n_blobs=32, per=128, d=48, spread=3.0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_blobs, d)).astype(np.float32) * spread
    data = np.concatenate([c + rng.standard_normal((per, d)).astype(
        np.float32) for c in centers])
    rng.shuffle(data)
    return data


def _unit(x):
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32)
                      if jnp.asarray(x).dtype == jnp.bfloat16 else x)


# name -> (corpus, IVFConfig kwargs, build kwargs)
_LAYOUTS = {
    "fp32": (0, dict(n_lists=64, n_probe=8, kmeans_iters=5), "fp32", False),
    "bf16": (0, dict(n_lists=64, n_probe=8, kmeans_iters=5), "bf16", False),
    "q8": (0, dict(n_lists=64, n_probe=8, kmeans_iters=5), "fp32", True),
    # 40 rows in 5 lists: small clusters (and an exhaustive probe).
    "small": (1, dict(n_lists=16, n_probe=16, kmeans_iters=3), "fp32", True),
}


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    """JAX-built partitions, saved, and the port's IVFIndex.load of each."""
    tmp = tmp_path_factory.mktemp("ivf")
    out = {}
    for name, (seed, cfg, dt, quant) in _LAYOUTS.items():
        data = (_blobs(seed) if seed == 0 else np.random.default_rng(5)
                .standard_normal((40, 32)).astype(np.float32))
        jax_ivf = jivf.IVFIndex(JaxIVFConfig(**cfg)).build(
            data, dtype=_DTYPES[dt][0], quant=quant)
        jax_ivf.save(tmp / name)
        port = IVFIndex.load(tmp / name, config=IVFConfig(**cfg),
                             dtype=_DTYPES[dt][1], device="cpu")
        out[name] = (data, jax_ivf, port)
    return out


@pytest.mark.parametrize("name", sorted(_LAYOUTS))
def test_load_carries_the_jax_layout(layouts, name):
    _, j, t = layouts[name]
    assert (t.n, t.n_lists, t.c_max, t.align, t.nprobe_scale) == (
        j.n, j.n_lists, j.c_max, j.align, j.nprobe_scale)
    for attr in ("centroids", "emb_ivf", "row_ids", "cluster_starts",
                 "cluster_counts", "emb_ivf_q8", "cluster_scales"):
        a, b = getattr(j, attr), getattr(t, attr)
        assert (a is None) == (b is None), attr
        if a is not None:
            np.testing.assert_array_equal(_np(b), _np(a), err_msg=attr)
    np.testing.assert_array_equal(t.row_table, np.asarray(j.row_table))


def _probe_tables(j, q, nprobe):
    _, probe = jax.lax.top_k(jnp.asarray(q) @ j.centroids.T, nprobe)
    tables = [j.cluster_starts[probe].astype(jnp.int32),
              j.cluster_counts[probe].astype(jnp.int32)]
    if j.cluster_scales is not None:
        tables.append(j.cluster_scales[probe])
    return tables


def _map_empty(ids):
    ids = np.asarray(ids)
    return np.where(ids >= _BIG, -1, ids)


def _probe_against_pallas(layouts, name, nprobe, k, b=4, mask=None):
    """The plain version of K6 (and the wrapper, on CPU tensors) against
    JAX's Pallas probe kernel in interpret mode on b queries' probe
    tables; mask: (b, nprobe) probes given count 0 in both."""
    _, j, t = layouts[name]
    rng = np.random.default_rng(nprobe + k + b)
    q = _unit(rng.standard_normal((b, t.centroids.shape[1])).astype(
        np.float32))
    nprobe = min(nprobe, j.n_lists)
    tables = _probe_tables(j, q, nprobe)
    if mask is not None:
        tables[1] = jnp.where(jnp.asarray(mask), 0, tables[1])
    quant = len(tables) == 3
    if quant:
        qj = jax_quantize_rows(jnp.asarray(q))[0]
        emb_j, emb_t = j.emb_ivf_q8, t.emb_ivf_q8
    else:
        qj, emb_j, emb_t = jnp.asarray(q), j.emb_ivf, t.emb_ivf
    wv, wi = ivf_probe_topk_pallas(
        qj, emb_j, tables[0], tables[1], k=k, n_probe=nprobe,
        c_pad=int(round_up(j.c_max, 8)),
        scales_sel=tables[2] if quant else None, interpret=True)
    tt = [torch.from_numpy(np.array(x)) for x in tables]
    args = (torch.from_numpy(np.array(qj)), emb_t, tt[0], tt[1], k)
    kw = {"scales_sel": tt[2]} if quant else {}
    gv, gi = ivf_probe_topk_ref(*args, **kw)
    np.testing.assert_array_equal(_map_empty(gi), _map_empty(wi))
    assert (gi.numpy()[gv.numpy() <= NEG_INF / 2] >= _BIG).all()
    if quant:
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    else:
        np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=1e-5)
    # On CPU tensors the K6 wrapper is the plain version.
    vv, vi = ivf_probe_topk(*args, **kw)
    assert torch.equal(vv, gv) and torch.equal(vi, gi)
    return gv, gi


@pytest.mark.parametrize("name,nprobe,k", [
    ("fp32", 8, 10), ("bf16", 8, 10), ("q8", 8, 16), ("q8", 64, 10),
    ("small", 5, 20),  # every cluster, k past the 40 rows: empties
])
def test_probe_plain_matches_pallas(layouts, name, nprobe, k):
    _probe_against_pallas(layouts, name, nprobe, k)


@pytest.mark.parametrize("case", ["masked", "one_query"])
def test_probe_plain_matches_pallas_edges(layouts, case):
    """Probes of count 0 inside the table (ivf_scan's nprobe_dyn mask),
    one query's every probe among them; and a batch of one query."""
    if case == "masked":
        mask = np.zeros((4, 8), dtype=bool)
        mask[:, 5:] = True
        mask[1, 2] = True
        mask[2] = True  # no rows at all: every slot empty
        gv, gi = _probe_against_pallas(layouts, "q8", 8, 16, mask=mask)
        assert (gi[2] == _BIG).all() and (gv[2] <= NEG_INF / 2).all()
    else:
        _probe_against_pallas(layouts, "q8", 8, 16, b=1)


@pytest.mark.parametrize("name,rescore", [("q8", True), ("q8", False),
                                          ("bf16", False), ("small", True)])
def test_ivf_scan_matches_pallas(layouts, name, rescore):
    _, j, t = layouts[name]
    rng = np.random.default_rng(3)
    q = _unit(rng.standard_normal((4, t.centroids.shape[1])).astype(
        np.float32))
    nprobe = min(8, j.n_lists)
    quant = j.emb_ivf_q8 is not None
    common = dict(k=10, nprobe=nprobe)
    wv, wi = ivf_scan_pallas(
        jnp.asarray(q), j.centroids, j.emb_ivf_q8 if quant else j.emb_ivf,
        j.cluster_starts, j.cluster_counts, j.row_ids,
        c_pad=int(round_up(j.c_max, 8)),
        cluster_scales=j.cluster_scales if quant else None,
        rescore_emb=j.emb_ivf if rescore else None, interpret=True, **common)
    gv, gi = ivf_scan(torch.from_numpy(q), t.centroids,
                      t.emb_ivf_q8 if quant else t.emb_ivf, t.cluster_starts,
                      t.cluster_counts, t.row_ids,
                      cluster_scales=t.cluster_scales if quant else None,
                      rescore_emb=t.emb_ivf if rescore else None, **common)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=1e-5)


def test_nprobe_dyn_mask_matches_static(layouts):
    data, j, t = layouts["q8"]
    rng = np.random.default_rng(41)
    q = torch.from_numpy(_unit(rng.standard_normal((4, 48)).astype(
        np.float32)))
    args = (q, t.centroids, t.emb_ivf_q8, t.cluster_starts, t.cluster_counts,
            t.row_ids)
    kw = dict(k=10, cluster_scales=t.cluster_scales, rescore_emb=t.emb_ivf)
    for small in (1, 2, 4):
        sv, si = ivf_scan(*args, nprobe=small, **kw)
        dv, di = ivf_scan(*args, nprobe=t.n_lists, nprobe_dyn=small, **kw)
        assert torch.equal(di, si) and torch.equal(dv, sv)


def _split_rows(counts, chunk_rows, split):
    """Each block's (query, probe, row) triples, walking its chunks from
    its start as the kernel's producer does."""
    n = np.where(counts > 0, -(-counts // chunk_rows), 0)
    n[:, 0] = np.maximum(n[:, 0], 1)
    flat = n.ravel()
    p = counts.shape[1]
    out = []
    for c0, c1, b, pr, row in split:
        e, j, rows = b * p + pr, row // chunk_rows, []
        assert row % chunk_rows == 0 and j < flat[e]
        for _ in range(c1 - c0):
            while j >= flat[e]:
                e, j = e + 1, 0
            lo = j * chunk_rows
            hi = min(lo + chunk_rows, max(int(counts.flat[e]), 0))
            rows.append([(e // p, e % p, r) for r in range(lo, hi)])
            j += 1
        out.append(rows)
    return out


@pytest.mark.parametrize("case", ["random", "one_query", "empty_probes",
                                  "no_rows"])
def test_row_split_covers_every_row(case):
    """ivf_row_split, the row-split body's split: every probed row falls in
    exactly one block's share, no chunk crosses a cluster, and the shares
    differ by at most one chunk; every query has a chunk, so a query with
    no rows still reaches a block."""
    rng = np.random.default_rng(7)
    counts = {"random": lambda: rng.integers(0, 300, (32, 65)),
              "one_query": lambda: np.array([[20_480]]),
              "empty_probes": lambda: np.where(rng.random((8, 6)) < 0.5, 0,
                                               rng.integers(1, 90, (8, 6))),
              "no_rows": lambda: np.zeros((5, 3), dtype=np.int64)}[case]()
    chunk_rows = ivf_chunk_rows(1024)  # int8 at D = 1024: 32 rows
    for grid in (1, 7, 264):
        split = ivf_row_split(counts, chunk_rows, grid)
        total = sum(c1 - c0 for c0, c1, *_ in split)
        assert len(split) == min(grid, total)
        assert [c0 for c0, *_ in split[1:]] == [c1 for _, c1, *_ in split[:-1]]
        shares = [c1 - c0 for c0, c1, *_ in split]
        assert max(shares) - min(shares) <= 1
        blocks = _split_rows(counts, chunk_rows, split)
        seen = [t for rows in blocks for chunk in rows for t in chunk]
        want = [(b, p, r) for b in range(counts.shape[0])
                for p in range(counts.shape[1]) for r in range(counts[b, p])]
        assert seen == want  # each row once, query-major then probe
        for rows in blocks:
            for chunk in rows:
                assert len(chunk) <= chunk_rows
                assert len({(b, p) for b, p, _ in chunk}) <= 1
        queries = {b for c0, c1, b, *_ in split}
        assert queries <= set(range(counts.shape[0]))
    assert ivf_row_split(np.zeros((0, 4)), chunk_rows, 8) == []


def test_probe_clusters_tie_order():
    cents = torch.tensor([[1.0, 0.0], [0.0, 1.0], [1.0, 0.0], [0.5, 0.5]])
    q = torch.tensor([[1.0, 0.0]])
    assert probe_clusters(q, cents, 3).tolist() == [[0, 2, 3]]


def test_kmeans_matches_jax():
    data = _unit(_blobs(2, n_blobs=8, per=64))
    init = data[np.random.default_rng(0).choice(len(data), 8, replace=False)]
    want = np.asarray(jivf._kmeans(jnp.asarray(data), jnp.asarray(init), 6))
    got = tivf._kmeans(torch.from_numpy(data), torch.from_numpy(init), 6)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_split_oversized_matches_jax():
    rng = np.random.default_rng(23)
    data = _unit(rng.standard_normal((600, 16)).astype(np.float32))
    assign = np.where(rng.random(600) < 0.6, 0,
                      rng.integers(1, 8, 600)).astype(np.int32)
    cents = rng.standard_normal((8, 16)).astype(np.float32)
    for align in (8, 128):
        want = jivf.split_oversized(cents, assign, data, 2.0, align=align)
        got = tivf.split_oversized(cents, assign, data, 2.0, align=align)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert len(got[2]) > 8  # the fat cluster was split


_BUILD_FIELDS = ("cluster_starts", "cluster_counts", "row_ids", "emb_ivf",
                 "emb_ivf_q8", "cluster_scales")


@pytest.mark.parametrize("streaming", [False, True])
@pytest.mark.parametrize("quant", [False, True])
def test_build_matches_jax(streaming, quant):
    # Twelve tight blobs in four lists: every k-means boundary runs between
    # blobs, far from any row, so both packages assign alike (two lists
    # seeded in one blob would cut it). One blob holds 2/3 of the rows, so
    # split_oversized acts too.
    rng = np.random.default_rng(23)
    sizes = np.concatenate([[2400], rng.integers(40, 200, 11)])
    data = np.repeat(rng.standard_normal((12, 48)).astype(np.float32),
                     sizes, axis=0)
    data += 0.05 * rng.standard_normal(data.shape).astype(np.float32)
    rng.shuffle(data)
    cfg = dict(n_lists=4, n_probe=2, kmeans_iters=5, max_cluster_factor=2.0)
    j = jivf.IVFIndex(JaxIVFConfig(**cfg))
    t = IVFIndex(IVFConfig(**cfg), device="cpu")
    if streaming:
        j.build_streaming(lambda lo, hi: data[lo:hi], len(data),
                          dtype=jnp.bfloat16, quant=quant, block=512)
        t.build_streaming(lambda lo, hi: data[lo:hi], len(data),
                          dtype=torch.bfloat16, quant=quant, block=512)
    else:
        j.build(data, dtype=jnp.bfloat16, quant=quant)
        t.build(data, dtype=torch.bfloat16, quant=quant)
    assert (t.n_lists, t.c_max, t.align, t.nprobe_scale) == (
        j.n_lists, j.c_max, j.align, j.nprobe_scale)
    assert t.n_lists > 4  # the fat blob was split
    for attr in _BUILD_FIELDS:
        a, b = getattr(j, attr), getattr(t, attr)
        assert (a is None) == (b is None), attr
        if a is not None:
            np.testing.assert_array_equal(_np(b), _np(a), err_msg=attr)
    np.testing.assert_allclose(t.centroids.numpy(), np.asarray(j.centroids),
                               atol=1e-5)
    np.testing.assert_array_equal(t.row_table, np.asarray(j.row_table))


@pytest.mark.parametrize("target", [0.8, 0.95])
def test_tune_nprobe_matches_jax(layouts, target):
    data, j, t = layouts["fp32"]
    rng = np.random.default_rng(43)
    q = _unit(data[rng.choice(len(data), 16, replace=False)]
              + 0.5 * rng.standard_normal((16, 48)).astype(np.float32))
    emb = _unit(data)
    exact = np.argsort(-(q @ emb.T), axis=1, kind="stable")[:, :10]
    want = j.tune_nprobe(jnp.asarray(q), exact, k=10, target_recall=target,
                         shared_shape=False)
    got = t.tune_nprobe(q, exact, k=10, target_recall=target)
    assert got == want and 1 <= got <= t.n_lists


def test_port_saved_ivf_loads_in_jax(tmp_path):
    data = _blobs(4, n_blobs=16, per=64, d=32)
    t = IVFIndex(IVFConfig(n_lists=16, n_probe=4, kmeans_iters=4),
                 device="cpu").build(data, dtype=torch.bfloat16, quant=True)
    t.save(tmp_path / "ivf")
    j = jivf.IVFIndex.load(tmp_path / "ivf", dtype=jnp.bfloat16)
    assert z_dtype(tmp_path / "ivf.npz") == np.uint16
    for attr in _BUILD_FIELDS:
        np.testing.assert_array_equal(_np(getattr(t, attr)),
                                      _np(getattr(j, attr)), err_msg=attr)
    q = _unit(data[:5] + 0.1)
    args = (j.centroids, j.emb_ivf_q8, j.cluster_starts, j.cluster_counts,
            j.row_ids)
    wv, wi = ivf_scan_pallas(jnp.asarray(q), *args, k=5, nprobe=4,
                             c_pad=int(round_up(j.c_max, 8)),
                             cluster_scales=j.cluster_scales,
                             rescore_emb=j.emb_ivf, interpret=True)
    gv, gi = t.search(q, 5, nprobe=4)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=1e-5)


def z_dtype(path):
    return np.load(path)["emb"].dtype


# -- the whole slice: KnowledgeBase ------------------------------------------

_N = 1500


def _kb_corpus():
    """Tie-free: every text has its own length, every row its own
    integer-valued vector (exact norms in both packages), in 12 blobs.
    Each query is +-1 on the 16 largest coordinates of a corpus row and 0
    elsewhere: normalized, it is +-1/4, exact in bf16, so both packages
    score the same query whether or not they round it to bf16."""
    rng = np.random.default_rng(11)
    centers = rng.integers(-6, 7, (12, 40))
    vecs = (centers[rng.integers(0, 12, _N)]
            + rng.integers(-2, 3, (_N, 40))).astype(np.float32)
    texts = [f"c{i} t{i % 97} z{i % 13} " + "pad " * (i % 211) + "w " * (
        i // 211) for i in range(_N)]
    tail = (centers[rng.integers(0, 12, 12)] + rng.integers(
        -2, 3, (12, 40))).astype(np.float32)
    src = vecs[rng.choice(_N, 16, replace=False)]
    top = np.argsort(-np.abs(src), axis=1, kind="stable")[:, :16]
    qv = np.zeros_like(src)
    np.put_along_axis(qv, top, np.sign(np.take_along_axis(src, top, 1)), 1)
    tail[3] = qv[0]  # a tail row must come back through the tail scan
    return vecs, texts, tail, qv, [f"t{i} z{i % 13}" for i in range(16)]


def _kbs(quant):
    vecs, texts, tail, _, _ = _kb_corpus()
    ivf = dict(n_lists=12, n_probe=4, kmeans_iters=5)
    jkb = tpurag.KnowledgeBase("kb", dim=40, quant=quant, config=(
        dataclasses.replace(JaxEngineConfig(), ivf=JaxIVFConfig(**ivf),
                            bm25=JaxBM25Config(packed_merge=False))))
    tkb = tpurag_torch.KnowledgeBase("kb", dim=40, quant=quant, config=(
        dataclasses.replace(EngineConfig(), ivf=IVFConfig(**ivf),
                            bm25=BM25Config(packed_merge=False))),
        device="cpu")
    for kb, chunk in ((jkb, JaxChunk), (tkb, Chunk)):
        kb.add_chunks([chunk(text=t, doc_id=f"d{i}") for i, t in
                       enumerate(texts)], vectors=vecs)
        kb.build_ivf()
        kb.add_chunks([chunk(text=f"fresh{i}", doc_id="fresh")
                       for i in range(len(tail))], vectors=tail)
    return jkb, tkb


_KB_CACHE = {}


@pytest.fixture
def kbs(request):
    if request.param not in _KB_CACHE:
        _KB_CACHE[request.param] = _kbs(request.param)
    return _KB_CACHE[request.param]


def _same(got, want, atol):
    hits = 0
    for g, w in zip(got, want):
        assert [r.chunk_id for r in g.results] == [r.chunk_id for r in w.results]
        assert [r.found_in for r in g.results] == [r.found_in for r in w.results]
        np.testing.assert_allclose([r.score for r in g.results],
                                   [r.score for r in w.results], atol=atol)
        hits += len(g.results)
    assert hits > 0


@pytest.mark.parametrize("kbs,mode,atol", [
    (True, "vector", 1e-5), (True, "ivf", 1e-5), (True, "hybrid", 1e-6),
    (True, "hybrid_ivf", 1e-6), (False, "ivf", 8e-3),
    (False, "hybrid_ivf", 1e-6),
], indirect=["kbs"])
def test_kb_slice_matches_jax(kbs, mode, atol):
    jkb, tkb = kbs
    _, _, tail, qv, texts = _kb_corpus()
    got = tkb.search_batch(texts, top_k=6, mode=mode, vectors=qv)
    want = jkb.search_batch(texts, top_k=6, mode=mode, vectors=qv)
    _same(got, want, atol)
    if mode in ("ivf", "hybrid_ivf"):  # the tail row, found through K1's scan
        assert _N + 3 in [r.chunk_id for r in got[0].results]


def test_jax_saved_quant_kb_with_ivf_loads_in_port(tmp_path):
    jkb, _ = _kbs(True)
    jkb.save(tmp_path / "kb")
    tkb = tpurag_torch.KnowledgeBase.load(tmp_path / "kb", device="cpu")
    assert tkb.quant and tkb.dense.quant and tkb._ivf is not None
    assert tkb._ivf_built_at == jkb._ivf_built_at == _N
    np.testing.assert_array_equal(tkb._ivf.emb_ivf_q8.numpy(),
                                  np.asarray(jkb._ivf.emb_ivf_q8))
    _, _, _, qv, texts = _kb_corpus()
    for mode in ("ivf", "hybrid_ivf", "vector"):
        got = tkb.search_batch(texts, top_k=6, mode=mode, vectors=qv)
        want = jkb.search_batch(texts, top_k=6, mode=mode, vectors=qv)
        for g, w in zip(got, want):
            assert [r.chunk_id for r in g.results] == [r.chunk_id for r in w.results]


def test_port_saved_quant_kb_with_ivf_loads_in_jax(tmp_path):
    _, tkb = _kbs(True)
    tkb.save(tmp_path / "kb")
    jkb = tpurag.KnowledgeBase.load(tmp_path / "kb")
    assert jkb.quant and jkb._ivf is not None and jkb._ivf_built_at == _N
    _, _, _, qv, texts = _kb_corpus()
    got = jkb.search_batch(texts, top_k=6, mode="hybrid_ivf", vectors=qv)
    want = tkb.search_batch(texts, top_k=6, mode="hybrid_ivf", vectors=qv)
    for g, w in zip(got, want):
        assert [r.chunk_id for r in g.results] == [r.chunk_id for r in w.results]


def test_kb_ivf_auto_refresh_on_sustained_ingest():
    cfg = EngineConfig(ivf=IVFConfig(n_lists=8, n_probe=8, kmeans_iters=2,
                                     auto_refresh_ratio=0.25,
                                     auto_refresh_min_rows=8))
    kb = tpurag_torch.KnowledgeBase("r", config=cfg, device="cpu")
    for i in range(40):
        kb.add_document(f"doc{i}", f"document number {i} about topic "
                        f"{['ships', 'birds', 'rocks'][i % 3]} " * 4)
    kb.build_ivf()
    built0 = kb._ivf_built_at
    for i in range(40, 80):
        kb.add_document(f"doc{i}", f"later document {i} about "
                        f"{['gears', 'levers'][i % 2]} " * 4)
    kb.wait_ivf_refresh(timeout=None)
    assert not kb._ivf_refresh_thread.is_alive()
    assert kb._ivf_built_at > built0, "background rebuild never swapped in"
    assert kb.dense.n_active - kb._ivf_built_at \
        < max(8, 0.25 * kb._ivf_built_at) + 40  # tail bounded again
    r = kb.search("later document about gears", mode="ivf", top_k=3)
    assert r.results and any("gears" in x.text for x in r.results)


_K6_PROBES = ["full", "no_fold", "stream", "no_merge", "mem_lists",
              "stages2", "stages4", "stages6", "stage16k", "stage64k",
              "blocks2"]


@pytest.mark.parametrize("probe", _K6_PROBES)
def test_k6_anatomy_patches_apply(probe):
    """tools/k6_anatomy.py times K6's row-split body with textual patches
    of its source; each anchor must be in the source exactly once."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "tools/k6_anatomy.py"
    spec = importlib.util.spec_from_file_location("k6_anatomy", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    assert sorted(tool.PROBES) == sorted(_K6_PROBES)
    src = tool.patched(tool.PROBES[probe])
    assert "ivf_rows_kernel" in src
    assert (src == tool.patched([])) == (probe == "full")
