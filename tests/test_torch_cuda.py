"""The port's CUDA kernels against their plain PyTorch versions, on a card.

CUDA kernels have no CPU mode: without a GPU every test here skips. On a
machine with one (no jax needed there):

    python -m pytest --noconftest tests/test_torch_cuda.py -q

The checks are chip_smoke.py's, at smaller shapes.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from tpurag_torch.kernels.runtime import launch_counts


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
