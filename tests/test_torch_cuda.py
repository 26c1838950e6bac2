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
    from tpurag_torch.kernels.dense import dense_topk

    before = dense_topk.launches
    err, _, _ = chip_smoke.check_dense(b, n_rows, n_valid, d, k, dtype)
    assert err <= chip_smoke.TOL
    assert dense_topk.launches == before + 1


@pytest.mark.parametrize("t", [1, 2, 8])
@pytest.mark.parametrize("p", [16, 64, 2048])
@pytest.mark.parametrize("cbits", [0, 14])
def test_merge_kernel_matches_plain(cuda, t, p, cbits):
    from tpurag_torch.kernels.bm25_merge import merge_segsum_topk

    before = merge_segsum_topk.launches
    chip_smoke.check_merge(64, t, p, cbits, k=8, n_docs=5000, seed=t * p)
    assert merge_segsum_topk.launches == before + 1


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
    from tpurag_torch.kernels.bm25_merge import merge_segsum_full

    before = merge_segsum_full.launches
    chip_smoke.check_full(8, t, p, cbits, n_docs=200_000, seed=t * p)
    assert merge_segsum_full.launches == before + 1


@pytest.mark.parametrize("wn,ww,k", [
    (64, 128, 8), (2048, 4096, 40), (16384, 65536, 8), (65536, 32768, 8),
])
def test_combine_kernel_matches_plain(cuda, wn, ww, k):
    from tpurag_torch.kernels.bm25_join import combine_topk

    before = combine_topk.launches
    chip_smoke.check_combine(16, wn, ww, k, n_docs=200_000, seed=wn + ww)
    assert combine_topk.launches == before + 1


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
