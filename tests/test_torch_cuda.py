"""The port's CUDA kernels against their plain PyTorch versions, on a card.

CUDA kernels have no CPU mode: without a GPU every test here skips. On a
machine with one (no jax needed there):

    python -m pytest --noconftest tests/test_torch_cuda.py -q

The checks are chip_smoke.py's, at smaller shapes.
"""

import pathlib

import numpy as np
import pytest
import torch

import chip_smoke
from tpurag_torch.kernels.runtime import NEG_INF, launch_counts


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return torch.device("cuda")


@pytest.mark.parametrize("b,n_rows,n_valid,d,k,dtype", [
    (1024, 8192, 8000, 1024, 8, torch.bfloat16),
    (256, 20480, 20000, 1024, 200, torch.bfloat16),
    (70, 700, 650, 96, 8, torch.float32),
    (5, 300, 20, 37, 40, torch.float32),      # k > n_valid, unaligned D
    (3, 1000, 1000, 64, 600, torch.bfloat16),  # lists in device memory
])
def test_dense_kernel_matches_plain(cuda, b, n_rows, n_valid, d, k, dtype):
    before = launch_counts["dense_topk"]
    err, _ = chip_smoke.check_dense(b, n_rows, n_valid, d, k, dtype)
    assert err <= chip_smoke.TOL
    assert launch_counts["dense_topk"] == before + 1


@pytest.mark.parametrize("b,n_rows,n_valid,d,k", chip_smoke.SM90_SHAPES)
def test_dense_sm90_body_matches_plain(cuda, b, n_rows, n_valid, d, k):
    """K1's TMA + wgmma body at its edge shapes."""
    before = launch_counts["dense_topk_sm90"]
    err, _ = chip_smoke.check_dense(b, n_rows, n_valid, d, k, seed=b + k)
    assert err <= chip_smoke.TOL
    assert launch_counts["dense_topk_sm90"] == before + 1


@pytest.mark.parametrize("b,n_rows,n_valid,d,k", [
    (1024, 8192, 8000, 1024, 8), (130, 2500, 2397, 72, 200)])
def test_dense_first_body_matches_plain_on_bf16(cuda, b, n_rows, n_valid, d,
                                                k):
    err, _ = chip_smoke.check_dense(b, n_rows, n_valid, d, k, seed=b,
                                    first_body=True)
    assert err <= chip_smoke.TOL


def test_dense_unaligned_bf16_takes_first_body(cuda):
    before = launch_counts["dense_topk"], launch_counts["dense_topk_sm90"]
    err, _ = chip_smoke.check_dense(5, 300, 250, 36, 8, seed=3)
    assert err <= chip_smoke.TOL
    assert (launch_counts["dense_topk"],
            launch_counts["dense_topk_sm90"]) == (before[0] + 1, before[1])


@pytest.mark.parametrize("t", [1, 2, 8])
@pytest.mark.parametrize("p", [16, 64, 2048])
@pytest.mark.parametrize("cbits", [0, 14])
def test_merge_kernel_matches_plain(cuda, t, p, cbits):
    before = launch_counts["merge_segsum_topk"]
    chip_smoke.check_merge(64, t, p, cbits, k=8, n_docs=5000, seed=t * p,
                           runs=2)
    assert launch_counts["merge_segsum_topk"] == before + 2


@pytest.mark.parametrize("name", list(chip_smoke.K2_CASES))
def test_topk_classes_kernel_matches_plain(cuda, name):
    """K2's slot-table form at its edges (chip_smoke.K2_CASES: empty slots,
    live lanes below the bucket width, slots narrower than p_max, t = 1, k
    above the live lanes, ties, parked docs, a 16384-lane row, 256 slots, a
    class mix in one launch), bit for bit, run twice."""
    before = launch_counts["merge_segsum_topk"]
    chip_smoke.check_topk_classes(name, runs=2)
    assert launch_counts["merge_segsum_topk"] == before + 2


def test_kb_on_card_matches_cpu(cuda):
    from tpurag_torch import KnowledgeBase

    rng = np.random.default_rng(0)
    words = [f"w{i}" for i in range(300)]
    docs = {f"doc{j}": ". ".join(" ".join(rng.choice(words, 12))
                                 for _ in range(6)) for j in range(40)}
    kbs = [KnowledgeBase("t", dim=64, device=dev) for dev in ("cuda", "cpu")]
    for kb in kbs:
        for name, text in docs.items():
            kb.add_document(name, text)
        kb.delete_document("doc3")
    queries = [" ".join(rng.choice(words, 4)) for _ in range(32)]
    for mode in ("hybrid", "vector", "keyword"):
        got, want = (kb.search_batch(queries, mode=mode) for kb in kbs)
        for g, w in zip(got, want):
            assert [r.chunk_id for r in g.results] == [r.chunk_id for r in w.results]
            np.testing.assert_allclose([r.score for r in g.results],
                                       [r.score for r in w.results],
                                       rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("t,p,cbits", [
    (2, 16, 0), (8, 64, 14), (8, 2048, 0), (2, 8192, 14),
    (4, 16384, 0),    # W = 65536: past one block's shared memory
    (2, 32768, 12),   # W = 65536 packed
])
def test_full_merge_kernel_matches_plain(cuda, t, p, cbits):
    before = launch_counts["merge_segsum_full"]
    chip_smoke.check_full(8, t, p, cbits, n_docs=200_000, seed=t * p)
    assert launch_counts["merge_segsum_full"] == before + 1


@pytest.mark.parametrize("name", list(chip_smoke.K3_CASES))
def test_full_classes_kernel_matches_plain(cuda, name):
    """The batched K3 at its edges (chip_smoke.K3_CASES: a doc whose t
    lanes straddle an item boundary at t = 4 and 16, docs in every slot,
    an all-parked row, empty slots, a slot wider than p_max, t = 1, W =
    131072 at t = 4 and 8, cbits 12 and 14, a class mix in one launch), bit
    for bit, run twice."""
    before = launch_counts["merge_segsum_full"]
    chip_smoke.check_full_classes(name, runs=2)
    assert launch_counts["merge_segsum_full"] == before + 2


def test_full_classes_kernel_refuses_too_many_slots(cuda):
    from tpurag_torch.kernels.bm25_merge import (K3_MAX_T,
                                                 merge_segsum_full_classes)

    widths, mats, _, wide, _, _ = chip_smoke.k3_case("every16")
    t = 2 * K3_MAX_T
    cls = (64, t, 0, None, np.zeros((1, t), np.int32),
           np.zeros((1, t), np.int32), np.zeros((1, t), np.int32),
           np.ones((1, t), np.float32))
    with pytest.raises(ValueError, match="t <= 512"):
        merge_segsum_full_classes(widths, mats, [], [cls], 0, 0)


@pytest.mark.parametrize("wn,ww,k", [
    (64, 128, 8), (2048, 4096, 40), (16384, 65536, 8), (65536, 32768, 8),
])
def test_combine_kernel_matches_plain(cuda, wn, ww, k):
    before = launch_counts["combine_topk"]
    chip_smoke.check_combine(16, wn, ww, k, n_docs=200_000, seed=wn + ww)
    assert launch_counts["combine_topk"] == before + 1


@pytest.mark.parametrize("k", [1, 8, 40, 200])
@pytest.mark.parametrize("name", list(chip_smoke.K4_CASES))
def test_combine_classes_kernel_matches_plain(cuda, name, k):
    """The batched K4 at its edges (chip_smoke.K4_CASES: a doc straddling
    a chunk boundary, a narrow lane on an item's first doc, Ww below,
    equal to and not a multiple of the chunk, k past the candidates, ties
    across items, an all-invalid wide row), bit for bit, run twice."""
    before = launch_counts["combine_topk"]
    chip_smoke.check_combine_classes(name, k, runs=2)
    assert launch_counts["combine_topk"] == before + 2


def test_combine_classes_kernel_lists_in_device_memory(cuda):
    """k = 1100: the warp lists (8 x k keys) pass 64 KB and live in a
    device-memory scratch."""
    chip_smoke.check_combine_classes("mixed", 1100, runs=2)


def test_wide_term_index_on_card_matches_cpu(cuda):
    from tpurag_torch.core.config import BM25Config
    from tpurag_torch.index.inverted import InvertedIndex

    rng = np.random.default_rng(3)
    texts = [" ".join(["common"] * (1 + i % 3) + [f"t{j}" for j in
                      rng.choice(2000, 6)] + ["pad"] * (i % 50))
             for i in range(3000)]
    idx = [InvertedIndex(BM25Config(wide_term_width=64, packed_merge=False),
                         device=dev) for dev in ("cuda", "cpu")]
    for x in idx:
        x.add_batch(range(3000), texts)
        x.delete_docs([5, 77])
    # 'common' and 'pad' are wide (df > 64), the t-terms narrow.
    queries = [f"common t{i} t{i + 1}" for i in range(40)] + ["t3 t4",
                                                               "pad common"]
    (gv, gi), (cv, ci) = (x.search(queries, 10) for x in idx)
    np.testing.assert_array_equal(gi, ci)
    np.testing.assert_allclose(gv, cv, rtol=1e-6)


@pytest.mark.parametrize("b,n_rows,n_valid,d,k", chip_smoke.Q8_SHAPES)
def test_int8_scan_kernel_matches_plain(cuda, b, n_rows, n_valid, d, k):
    """K5 as routed, bit-identical: D % 16 == 0 takes the TMA + int8 wgmma
    body, D = 40 the first body."""
    before = (launch_counts["dense_scan_q8"],
              launch_counts["dense_scan_q8_sm90"])
    chip_smoke.check_q8(b, n_rows, n_valid, d, k, seed=b + k)
    sm90 = 1 if d % 16 == 0 else 0
    assert (launch_counts["dense_scan_q8"],
            launch_counts["dense_scan_q8_sm90"]) == (before[0] + 1,
                                                     before[1] + sm90)


@pytest.mark.parametrize("b,n_rows,n_valid,d,k", [
    (32, 20480, 20000, 1024, 20), (512, 8192, 8000, 1024, 8),
    (3, 1000, 1000, 64, 600)])
def test_int8_first_body_matches_plain_on_aligned_rows(cuda, b, n_rows,
                                                       n_valid, d, k):
    before = launch_counts["dense_scan_q8_sm90"]
    chip_smoke.check_q8(b, n_rows, n_valid, d, k, seed=b, first_body=True)
    assert launch_counts["dense_scan_q8_sm90"] == before


@pytest.mark.parametrize("b,m,n,d,dtype", [
    (32, 20, 5000, 1024, torch.bfloat16),
    (7, 16, 300, 1024, torch.float32),
    (3, 5, 100, 37, torch.bfloat16),   # unaligned D
])
def test_gather_scores_kernel_matches_plain(cuda, b, m, n, d, dtype):
    before = launch_counts["gather_scores"]
    chip_smoke.check_gather(b, m, n, d, dtype, seed=b)
    assert launch_counts["gather_scores"] == before + 1


@pytest.mark.parametrize("b,n_lists,n_probe,d,k,dtype,kw", [
    (32, 256, 64, 1024, 20, torch.int8, {}),
    (8, 64, 64, 256, 10, torch.int8, {}),      # every cluster probed
    (5, 40, 3, 40, 50, torch.int8, {}),        # unaligned D, k > rows
    (32, 256, 64, 1024, 10, torch.bfloat16, {}),
    (4, 30, 6, 36, 8, torch.bfloat16, {}),     # unaligned D
    (6, 50, 10, 64, 12, torch.float32, {}),
    *chip_smoke.IVF_CASES.values(),
])
def test_ivf_probe_kernel_matches_plain(cuda, b, n_lists, n_probe, d, k,
                                        dtype, kw):
    """K6 as routed (check_ivf asserts the route: rows of a multiple of 16
    bytes take the row-split body, D = 40 int8 and D = 36 bf16 the first
    body), at random probes of small clusters and chip_smoke.IVF_CASES."""
    before = launch_counts["ivf_probe_topk"]
    err = chip_smoke.check_ivf(b, n_lists, n_probe, d, k, dtype, seed=k,
                               **kw)
    assert err <= chip_smoke.TOL
    assert launch_counts["ivf_probe_topk"] == before + 1


@pytest.mark.parametrize("quant", [False, True])
def test_ivf_kb_on_card_matches_cpu(cuda, quant, tmp_path):
    from tpurag_torch import KnowledgeBase
    from tpurag_torch.core.config import EngineConfig, IVFConfig

    rng = np.random.default_rng(5)
    centers = rng.standard_normal((16, 64)).astype(np.float32) * 3
    vecs = (centers[rng.integers(0, 16, 3000)]
            + rng.standard_normal((3000, 64)).astype(np.float32))
    cfg = EngineConfig(ivf=IVFConfig(n_lists=16, n_probe=4, kmeans_iters=4))
    kbs = [KnowledgeBase("t", dim=64, config=cfg, quant=quant, device=dev)
           for dev in ("cuda", "cpu")]
    from tpurag_torch.core.types import Chunk

    for kb in kbs:
        kb.add_chunks([Chunk(text=f"c{i} t{i % 97}" + " pad" * (i % 61),
                             doc_id=f"d{i}") for i in range(3000)],
                      vectors=vecs)
        kb.build_ivf()
        kb.add_chunks([Chunk(text=f"tail{i}", doc_id="tail")
                       for i in range(10)], vectors=vecs[:10] + 0.5)
    q = vecs[rng.integers(0, 3000, 24)] + rng.standard_normal(
        (24, 64)).astype(np.float32)
    kbs[0].save(tmp_path / "kb")  # quant and the IVF survive a reload
    kbs.append(KnowledgeBase.load(tmp_path / "kb", device="cuda"))
    assert kbs[2].quant == quant and kbs[2]._ivf is not None
    for mode in ("vector", "hybrid", "ivf", "hybrid_ivf"):
        got, want, back = (kb.search_batch([f"t{i}" for i in range(24)],
                                           mode=mode, vectors=q, top_k=5)
                           for kb in kbs)
        for g, w, r in zip(got, want, back):
            assert [x.chunk_id for x in g.results] == [x.chunk_id for x in w.results]
            assert [x.chunk_id for x in r.results] == [x.chunk_id for x in g.results]


@pytest.mark.parametrize("t,p_max,cbits", [(8, 2048, 14), (2, 64, 0),
                                           (2, 16, 14)])
def test_fused_bm25_kernel_matches_plain(cuda, t, p_max, cbits):
    before = launch_counts["bm25_topk_fused"]
    chip_smoke.check_fused(32, t, p_max, cbits, k=8, n_docs=100_000,
                           seed=t + p_max)
    assert launch_counts["bm25_topk_fused"] == before + 1


@pytest.mark.parametrize("cbits", [14, 0])
@pytest.mark.parametrize("name", list(chip_smoke.FUSED_CASES))
def test_fused_bm25_kernel_edge_cases(cuda, name, cbits):
    """K2' at every lane live (the full network), rows on both sides of
    the W/2 route in one launch, one live lane and none: bit-identical,
    one launch."""
    before = launch_counts["bm25_topk_fused"]
    chip_smoke.check_fused_case(name, cbits)
    assert launch_counts["bm25_topk_fused"] == before + 1


@pytest.mark.parametrize("name", list(chip_smoke.RESCORE_CASES))
def test_rescore_kernel_matches_plain(cuda, name):
    """K8's rescore in one launch against rescore_topk_ref."""
    before = launch_counts["rescore_topk"]
    assert chip_smoke.check_rescore(name) <= 1e-5
    assert launch_counts["rescore_topk"] == before + 1


@pytest.mark.parametrize("b,n_rows,n_valid,d,k,dtype", [
    (130, 2500, 2500, 96, 5, torch.bfloat16),   # multi query-tile
    (9, 257, 200, 130, 3, torch.float32),       # unaligned D, n_valid < N
])
def test_dense_co_kernel_matches_plain(cuda, b, n_rows, n_valid, d, k,
                                       dtype):
    before = launch_counts["dense_topk_co"]
    err = chip_smoke.check_dense_co(b, n_rows, n_valid, d, k, dtype,
                                    seed=b + k)
    assert err <= chip_smoke.TOL
    assert launch_counts["dense_topk_co"] == before + 1


@pytest.mark.parametrize("b,n_rows,n_valid,d,k", chip_smoke.K7_SHAPES)
def test_dense_co_sm90_body_matches_plain(cuda, b, n_rows, n_valid, d, k):
    """K7's TMA + wgmma body (chip_smoke.K7_SHAPES) as routed."""
    before = launch_counts["dense_topk_co_sm90"]
    err = chip_smoke.check_dense_co(b, n_rows, n_valid, d, k, seed=b + k)
    assert err <= chip_smoke.TOL
    assert launch_counts["dense_topk_co_sm90"] == before + 1


@pytest.mark.parametrize("case", ["d1352", "fp32", "misaligned", "named"])
def test_dense_co_first_body_takes_the_rest(cuda, case):
    """D = 1352 (past form (ii)'s tile), fp32 and a corpus one element past
    a 16-byte boundary take K7's first body, as does a call by name."""
    args = {"d1352": ((130, 3000, 2900, 1352, 8), {}),
            "fp32": ((130, 3000, 2900, 256, 8, torch.float32), {}),
            "misaligned": ((130, 3000, 2900, 1024, 8), {"misalign": True}),
            "named": ((130, 3000, 2900, 1024, 8), {"first_body": True})}
    pos, kw = args[case]
    before = (launch_counts["dense_topk_co"],
              launch_counts["dense_topk_co_sm90"])
    err = chip_smoke.check_dense_co(*pos, seed=7, **kw)
    assert err <= chip_smoke.TOL
    assert (launch_counts["dense_topk_co"],
            launch_counts["dense_topk_co_sm90"]) == (before[0] + 1,
                                                     before[1])


def test_fused_bm25_kernel_takes_each_doc_once(cuda):
    """A clamped window that spans two terms is not sorted, so doc 5 ends
    two segments; like select_topk, K2' takes it once."""
    from tpurag_torch.kernels.bm25_merge import (bm25_topk_fused,
                                                 bm25_topk_fused_ref)

    args = [torch.tensor(x, dtype=dt, device="cuda") for x, dt in (
        ([[3]], torch.int32), ([[4]], torch.int32), ([[1.0]], torch.float32),
        ([5, 9, 2, 5], torch.int32), ([1.0, 2.0, 3.0, 4.0], torch.float32))]
    got = bm25_topk_fused(*args, 10, k=4, p_max=4)
    want = bm25_topk_fused_ref(*args, 10, k=4, p_max=4)
    assert got[1].tolist() == want[1].tolist() == [[5, 2, 9, -1]]
    assert torch.equal(got[0], want[0])


def _fuse_inputs(preset, gate, final_k, b, seed, kv=None, kk=None):
    """tests/fuse_cases.py's legs on the card, max(b, 4) rows (its edge
    rows need four; callers cut them): (legs, masses or None, preset)."""
    import fuse_cases
    from tpurag_torch.core.config import PRESETS

    base = PRESETS[preset]
    kv = base.vector_top_k if kv is None else kv
    kk = base.keyword_top_k if kk is None else kk
    final_k = {"below": kv + kk - 3, "equal": kv + kk,
               "above": kv + kk + 5}.get(final_k, final_k)
    p = fuse_cases.preset_for(base, "off" if gate == "off" else "on",
                              final_k)
    v_s, v_i, k_s, k_i, mass = fuse_cases.legs(
        seed, max(b, 4), kv, kk, p.min_vector_score, p.min_keyword_coverage)
    legs = [torch.from_numpy(x).cuda() for x in (v_s, v_i, k_s, k_i)]
    if gate == "no keyword":
        legs[2:] = None, None
    return legs, (mass if gate == "on" else None), p


def _same_triples(got, want):
    assert got[0].shape == want[0].shape
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])


def _fuse_both(legs, mass, p):
    """fuse_legs (one kernel launch) and fuse_legs_ref on the same CUDA
    legs."""
    from tpurag_torch.kernels.fusion import fuse_legs, fuse_legs_ref

    before = launch_counts["fuse_legs"]
    got = fuse_legs(*legs, mass, p)
    want = fuse_legs_ref(*legs, mass, p)
    torch.cuda.synchronize()
    assert launch_counts["fuse_legs"] == before + 1
    return got, want


@pytest.mark.parametrize("b", [1, 512])
@pytest.mark.parametrize("final", ["below", "equal", "above"])
@pytest.mark.parametrize("gate", ["on", "off", "compat", "no keyword"])
@pytest.mark.parametrize("preset", ["document", "code"])
def test_fuse_kernel_matches_plain(cuda, preset, gate, final, b):
    """The fusion kernel's triples (scores as bit patterns) against its
    plain version: gate on, off (coverage 0), off by rank-compat scores
    (no masses), no keyword leg; final_k below, at and above k_v + k_k;
    the floor and gate edges, swapped-rank ties and empty rows of
    tests/fuse_cases.py; B = 1 runs each edge row alone."""
    legs, mass, p = _fuse_inputs(preset, gate, final, b, seed=b + len(gate))
    if b > 1:
        _same_triples(*_fuse_both(legs, mass, p))
        return
    for r in range(4):
        one = [None if x is None else x[r:r + 1].contiguous() for x in legs]
        _same_triples(*_fuse_both(one, None if mass is None
                                  else mass[r:r + 1], p))


def test_fuse_kernel_orders_equal_scores_by_id(cuda):
    """Ids at swapped ranks reach equal fused scores (equal weights):
    the smaller id first, as select_topk orders them."""
    legs, mass, p = _fuse_inputs("document", "on", "equal", 64, seed=3)
    v_i, k_i = legs[1].clone(), legs[3].clone()
    for r in range(4, 64):  # ids 1000 + r and 2000 + r at ranks (1, 4), (4, 1)
        v_i[r, 1], v_i[r, 4] = 2000 + r, 1000 + r
        k_i[r, 4], k_i[r, 1] = 2000 + r, 1000 + r
    legs[0][4:, :5] = 0.95
    legs[2][4:, :5] = 1e6
    legs[1], legs[3] = v_i, k_i
    got, want = _fuse_both(legs, mass, p)
    _same_triples(got, want)
    ids = got[1].cpu().numpy()
    for r in range(4, 64):
        at = list(ids[r]).index(1000 + r)
        assert ids[r, at + 1] == 2000 + r
        assert got[0][r, at] == got[0][r, at + 1]


@pytest.mark.parametrize("kv,kk,b", [(256, 256, 24), (257, 8, 24),
                                     (8, 257, 24), (200, 3, 24),
                                     (1000, 1500, 8), (2000, 1200, 4)])
def test_fuse_kernel_takes_wide_legs(cuda, kv, kk, b):
    """Legs past a warp take a block a row, each thread striding over
    several lanes; past 3072 lanes the row's shared memory is over the
    default 48 KiB and the launch opts in to more. Every width is one
    launch, bit-identical to the plain version, and no plain call."""
    from tpurag_torch.utils import tracing

    legs, mass, p = _fuse_inputs("document", "on", 40, b, seed=kv + kk,
                                 kv=kv, kk=kk)
    tracing.clear()
    _same_triples(*_fuse_both(legs, mass, p))
    assert dict(tracing.counters) == {}


def test_fuse_kernel_refuses_a_row_past_shared_memory(cuda):
    """A row whose lanes do not fit one block's shared memory (16 bytes a
    lane) raises ValueError, with nothing launched."""
    import dataclasses

    from tpurag_torch.core.config import PRESETS
    from tpurag_torch.kernels.fusion import fuse_legs

    kv = 20000
    p = dataclasses.replace(PRESETS["document"], final_top_k=8)
    v_s = torch.rand((1, kv), device="cuda")
    v_i = torch.arange(kv, dtype=torch.int32, device="cuda")[None]
    before = launch_counts["fuse_legs"]
    with pytest.raises(ValueError, match="shared memory"):
        fuse_legs(v_s, v_i, v_s, v_i, None, p)
    assert launch_counts["fuse_legs"] == before


@pytest.mark.parametrize("final_k", [0, 8])
def test_fuse_kernel_on_rows_without_lanes_or_slots(cuda, final_k):
    """No lanes at all (an empty dense leg, no keyword leg): all-empty
    rows from one launch; final_k = 0: (B, 0) results and no launch."""
    import dataclasses

    from tpurag_torch.core.config import PRESETS
    from tpurag_torch.kernels.fusion import fuse_legs, fuse_legs_ref

    p = dataclasses.replace(PRESETS["document"], final_top_k=final_k)
    for kv in (0, 8):
        v_s = torch.rand((5, kv), device="cuda")
        v_i = torch.arange(5 * kv, dtype=torch.int32,
                           device="cuda").reshape(5, kv)
        before = launch_counts["fuse_legs"]
        got = fuse_legs(v_s, v_i, None, None, None, p)
        torch.cuda.synchronize()
        assert [x.shape for x in got] == [(5, final_k)] * 3
        if final_k == 0:
            assert launch_counts["fuse_legs"] == before
            continue
        assert launch_counts["fuse_legs"] == before + 1
        if kv:
            _same_triples(got, fuse_legs_ref(v_s, v_i, None, None, None, p))
        else:
            assert (got[0] == NEG_INF).all() and (got[1] == -1).all()
            assert (got[2] == 0).all()


def test_fuse_is_one_launch_and_at_most_one_copy(cuda):
    """Under torch.profiler one fuse_legs call runs one device kernel (the
    fusion kernel) and at most one host-to-device copy (the masses). The
    profile runs in its own process (tools/fuse_anatomy.py --ops), which
    ends without the teardown where CUPTI may hang after a session."""
    import json
    import subprocess
    import sys

    done = subprocess.run([sys.executable, "tools/fuse_anatomy.py", "--ops"],
                          capture_output=True, text=True, timeout=300,
                          cwd=pathlib.Path(__file__).resolve().parents[1])
    assert done.returncode == 0, done.stderr[-2000:]
    ops = json.loads(done.stdout.strip().splitlines()[-1])["ops"]
    copies = [n for n in ops if "Memcpy" in n or "Memset" in n]
    kernels = [n for n in ops if n not in copies]
    assert len(kernels) == 1 and "fuse_rrf_kernel" in kernels[0], ops
    assert len(copies) <= 1 and all("HtoD" in n for n in copies), ops
