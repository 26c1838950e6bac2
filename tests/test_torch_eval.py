"""tpurag_torch's eval-suite path against the JAX package.

The graph gathers must match exactly, the freshness math within 1e-6.
hybrid_step (dense top-k + fused BM25 top-k + RRF) is held to the JAX
package's composition of the same functions on the same arrays (config
2's CPU inputs, and the driver's example step ``__graft_entry__.
_hybrid_forward``): fused ids exactly, fused scores within 1e-6 relative
(RRF scores are sums of w / (60 + rank + 1) terms, so equal ranks give
equal scores up to the order of two additions). run_all on the CPU
returns the JAX package's keys for every runnable config.
"""

import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from tpurag.index.inverted import packed_cbits as jax_packed_cbits
from tpurag.kernels.bm25_pallas import bm25_topk_fused as jax_fused
from tpurag.kernels.dense import dense_topk_xla
from tpurag.kernels.fusion import rrf_fuse as jax_rrf
from tpurag.kernels.graphops import expand_neighbors as jax_expand
from tpurag.kernels.graphops import gather_chunks as jax_gather
from tpurag.memory.freshness import combined_memory_scores as jax_combined
from tpurag.memory.freshness import freshness_scores as jax_fresh
from tpurag_torch.eval import bench
from tpurag_torch.kernels.graphops import expand_neighbors, gather_chunks
from tpurag_torch.memory.freshness import (combined_memory_scores,
                                           freshness_scores)

JAX_BENCH = (pathlib.Path(__file__).resolve().parent.parent / "tpurag"
             / "eval" / "bench.py")
RUNNABLE = ["exact_dense", "hybrid", "memory_fusion", "graph", "ivf_latency"]


def _csr_graph(rng, n_ent, max_deg):
    deg = rng.integers(0, max_deg, n_ent)
    off = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    flat = rng.integers(0, n_ent, int(off[-1])).astype(np.int32)
    seeds = rng.integers(-1, n_ent, (5, 7)).astype(np.int32)
    seeds[0, 0] = -1
    seeds[1, 0] = n_ent + 3   # past the offsets: clipped like JAX
    return seeds, off, flat


@pytest.mark.parametrize("fn,jfn", [(expand_neighbors, jax_expand),
                                    (gather_chunks, jax_gather)])
@pytest.mark.parametrize("width", [1, 6, 32])
def test_graph_gathers_match_jax(fn, jfn, width):
    seeds, off, flat = _csr_graph(np.random.default_rng(width), 50, 12)
    want = np.asarray(jfn(jnp.asarray(seeds), jnp.asarray(off),
                          jnp.asarray(flat), width))
    got = fn(*(torch.from_numpy(x) for x in (seeds, off, flat)), width)
    assert got.dtype == torch.int32 and got.shape == (5, 7, width)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy() >= 0).any() and (got.numpy() == -1).any()


def test_freshness_matches_jax():
    rng = np.random.default_rng(0)
    now = 1.7e9
    conf = rng.uniform(0.0, 1.0, 200).astype(np.float32)
    last = now - rng.uniform(-5, 400, 200) * 3600   # a few in the future
    cnt = rng.integers(0, 50, 200)
    want = np.asarray(jax_fresh(conf, last, cnt, now))
    got = freshness_scores(conf, last, cnt, now, device="cpu")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    rel = rng.uniform(0, 1, 200).astype(np.float32)
    np.testing.assert_allclose(
        combined_memory_scores(rel, got, device="cpu").numpy(),
        np.asarray(jax_combined(rel, want)), rtol=1e-6, atol=1e-7)


def _assert_same_fused(got, want):
    (gs, gi), (ws, wi) = got, want
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-6)
    assert (gi.numpy()[:, 0] >= 0).all()


def test_hybrid_step_matches_jax_composition():
    x = bench.hybrid_inputs(device="cpu")
    assert x["cbits"] == jax_packed_cbits(x["n_valid"]) > 0
    j = {name: jnp.asarray(x[name].numpy()) for name in
         ("q", "emb", "starts", "lens", "idf", "post_doc", "post_impact")}
    nv, k = x["n_valid"], x["k"]
    _, v_i = dense_topk_xla(j["q"], j["emb"], jnp.int32(nv), k)
    _, k_i = jax_fused(j["starts"], j["lens"], j["idf"], j["post_doc"],
                       j["post_impact"], jnp.int32(nv), k=k,
                       p_max=x["p_max"], cbits=x["cbits"])
    ws, wi, _ = jax_rrf((v_i, k_i), weights=(1.0, 1.0), final_k=k)
    _assert_same_fused(bench.hybrid_step(**x), (ws, wi))


def test_hybrid_step_matches_graft_forward():
    args = graft._example_args()
    x = bench.example_inputs(device="cpu")
    names = ("q", "emb", "n_valid", "starts", "lens", "idf", "post_doc",
             "post_impact")
    for name, a in zip(names, args):
        got = torch.as_tensor(x[name]).float().numpy()
        np.testing.assert_array_equal(got, np.asarray(a, np.float32))
    _assert_same_fused(bench.hybrid_step(**x), graft._hybrid_forward()(*args))


def _jax_result_keys() -> dict:
    """Each config's returned keys, read off tpurag/eval/bench.py's return
    dict literals (running the JAX suite would take minutes)."""
    tree = ast.parse(JAX_BENCH.read_text())
    keys = {}
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name.startswith(
                "config"):
            ret = [n for n in ast.walk(node) if isinstance(n, ast.Return)
                   and isinstance(n.value, ast.Dict)]
            keys[node.name] = {k.value for k in ret[-1].value.keys}
    return keys


def test_run_all_on_cpu_returns_the_jax_keys():
    want = _jax_result_keys()
    out = bench.run_all(RUNNABLE, device="cpu")
    assert [r["config"] for r in out] == RUNNABLE
    for r in out:
        fn = bench.CONFIGS[r["config"]].__name__
        assert set(r) - {"config"} == want[fn], fn
        assert all(np.isfinite(v) for v in r.values()
                   if isinstance(v, float)), r
    by_name = {r["config"]: r for r in out}
    assert by_name["exact_dense"]["value"] == 1.0
    assert by_name["ivf_latency"]["recall_at_10"] >= 0.95
    assert set(bench.CONFIGS) == {"exact_dense", "hybrid", "memory_fusion",
                                  "graph", "sharded", "ingest", "ingest_base",
                                  "ivf_latency", "chat"}


@pytest.mark.parametrize("name,item", [("sharded", "item 8"),
                                       ("ingest", "item 7"),
                                       ("ingest_base", "item 7"),
                                       ("chat", "item 4")])
def test_configs_not_ported_raise(name, item):
    with pytest.raises(NotImplementedError, match=item):
        bench.run_all([name], device="cpu")
