"""tpurag_torch's corpus-outer dense top-k (K7) against the JAX package.

dense_topk_co computes dense_topk's function; on the CPU it is the
plain version, dense_topk_ref. It is held to JAX's dense_topk_pallas_co
in interpret mode at tests/test_dense.py's corpus-outer shapes: ids
exactly, scores within 1e-5 for fp32 corpora and 2e-3 for bf16 ones (the
summation order only, as in test_torch_dense.py). The JAX wrapper caps
the padded batch at 4096 (a VMEM limit); the port has no cap.
"""

import pathlib
import re

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


# -- K7's Hopper body: route, form, budget, splits (CPU; the kernel itself
# is held to the plain version on the card, tests/test_torch_cuda.py) ------

CO_SRC = (pathlib.Path(__file__).resolve().parents[1]
          / "tpurag_torch/csrc/dense_topk_co_sm90.cu")


def _cu_constants(struct: str) -> dict:
    """The `static constexpr int` constants of a struct in K7's Hopper
    source, evaluated in order (TD and WARPS from the file's top)."""
    src = CO_SRC.read_text()
    env = {}
    for name in ("TD", "THREADS", "WARPS"):
        expr = re.search(rf"constexpr int {name} = ([^;]+);", src).group(1)
        env[name] = eval(expr, {}, env)
    body = re.search(rf"struct {struct} {{(.*?)\n}};", src, re.S).group(1)
    for name, expr in re.findall(r"static constexpr int (\w+) = ([^;]+);",
                                 body):
        env[name] = eval(expr, {}, env)
    return env


def _cu_bytes(form: int, d: int) -> int:
    """ResQ::bytes / ResC::bytes (at the ring's least depth) of the .cu
    file at width d."""
    ks_n = dense_mod.cdiv(d, 64)
    if form == 1:  # barriers: full and empty per stage, the query boxes'
        c = _cu_constants("ResQ")
        ring, res, bars = c["BOX"], c["QBOX"], 2 * c["STAGES"] + 1
    else:  # full and empty per stage, one per corpus box
        c = _cu_constants("ResC")
        ring, res, bars = c["QBOX"], c["CBOX"], 2 * c["STAGES"] + ks_n
    return 1024 + c["STAGES"] * ring + ks_n * res + c["SCORE"] + bars * 8


@pytest.mark.parametrize("form,d,fits", [
    (2, 1024, True), (2, 1344, True), (2, 1352, False),
    (1, 1024, True), (1, 2304, True), (1, 2312, False),
])
def test_dense_co_sm90_budget_matches_the_kernel(form, d, fits):
    """kernels/dense.co_sm90_bytes mirrors the .cu file's budget: form
    (ii) holds D up to 1344 (21 corpus boxes beside a 3-stage ring), form
    (i) up to 2304 (36 query boxes), in 227 KB beside 1 KB of realignment
    room."""
    assert dense_mod.co_sm90_bytes(form, d) == _cu_bytes(form, d)
    assert (dense_mod.co_sm90_bytes(form, d) <= dense_mod.MAX_SMEM) == fits
    b = 32 if form == 1 else 33
    assert dense_mod.co_sm90_form(b, d) == (form if fits else 0)


@pytest.mark.parametrize("b,form", [(1, 1), (32, 1), (33, 2), (512, 2)])
def test_dense_co_sm90_form_by_batch(b, form):
    """Up to 32 queries stay resident (form (i)); from 33 on the corpus
    tile does (form (ii))."""
    assert dense_mod.co_sm90_form(b, 1024) == form


@pytest.mark.parametrize("dtype,d,offset,form", [
    (torch.bfloat16, 1024, 0, 2),
    (torch.float32, 1024, 0, 0),     # fp32: the first body
    (torch.bfloat16, 1024, 2, 0),    # one element past 16-byte alignment
    (torch.bfloat16, 1028, 0, 0),    # D % 8 != 0: no TMA rows
    (torch.bfloat16, 1344, 0, 2),    # form (ii)'s widest tile
    (torch.bfloat16, 1352, 0, 0),
])
def test_dense_co_sm90_route(dtype, d, offset, form):
    """The Hopper body takes bf16 rows that TMA can address and whose form
    fits; everything else takes K7's first body."""
    assert dense_mod.co_sm90_route(dtype, 130, d, 4096, 4096 + offset) == form


@pytest.mark.parametrize("slots", [dense_mod.H100_SMS, 33])
def test_dense_co_sm90_splits(slots):
    """One block per split, within the blocks resident at once (all SMs,
    or their share per query group), at least one tile in each split
    where the tiles allow (the kernel's split_start gives floor or ceil
    shares), and the merge's candidate cap kept."""
    for n_tiles in list(range(0, 300)) + [15_625, 31_250]:
        for k in (1, 8, 40, 200, 600):
            s = dense_mod.co_sm90_splits(n_tiles, k, slots)
            assert 1 <= s <= slots
            assert s * k <= max(dense_mod.MAX_MERGE_CANDIDATES, k)
            starts = [x * n_tiles // s for x in range(s + 1)]
            empty = sum(b == a for a, b in zip(starts, starts[1:]))
            assert empty == (1 if n_tiles == 0 else 0)
    assert dense_mod.co_sm90_splits(15_625, 200, slots) == min(slots, 40)
    assert dense_mod.co_sm90_splits(15_625, 8, slots) == slots
    assert dense_mod.co_sm90_splits(3, 8, slots) == 3


@pytest.mark.parametrize("b,form,groups", [
    (512, 2, 4), (256, 2, 2), (130, 2, 2), (33, 2, 1), (8, 1, 1)])
def test_dense_co_sm90_groups(b, form, groups):
    """Form (ii) deals its 128-query tiles to up to CO_GROUPS blocks per
    split; form (i) has one group."""
    assert dense_mod.CO_GROUPS == 4
    assert dense_mod.co_sm90_groups(b, form) == groups


@pytest.mark.parametrize("probe", ["full", "no_mma", "no_fold", "no_tma",
                                   "mma_only", "ring_3"])
def test_k7_anatomy_patches_apply(probe):
    """tools/k7_anatomy.py times K7's Hopper body with textual patches of
    its source; each anchor must be in the source exactly once."""
    import importlib.util

    path = pathlib.Path(__file__).resolve().parents[1] / "tools/k7_anatomy.py"
    spec = importlib.util.spec_from_file_location("k7_anatomy", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    src = tool.patched(tool.PROBES[probe])
    assert "dense_co_resident_c_kernel" in src
    assert (src == tool.patched([])) == (probe == "full")
