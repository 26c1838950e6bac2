"""Legacy save formats the JAX package still reads, read by tpurag_torch.

A dense index saved as one round-1 ``.npz`` (fp32 rows, a JSON ``meta``
entry, no ``.meta.json``) and a knowledge base whose ``kb.json`` holds its
chunks inline (no ``chunks_file``) load in both packages to the same rows
and the same answers.
"""

import json

import numpy as np
import pytest
import torch

import tpurag
import tpurag_torch
from tpurag.index.dense import DenseIndex as JaxDenseIndex
from tpurag_torch.index.dense import DenseIndex


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_round1_npz_loads_in_both(tmp_path, dtype):
    rng = np.random.default_rng(0)
    vecs = rng.standard_normal((20, 16)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    np.savez(tmp_path / "old", emb=vecs,
             meta=json.dumps({"dim": 16, "dtype": dtype, "n_active": 20,
                              "deleted": [1]}))
    j = JaxDenseIndex.load(tmp_path / "old")
    t = DenseIndex.load(tmp_path / "old", device="cpu")
    assert t.n_active == j.n_active == 20 and t._deleted == j._deleted == {1}
    assert str(t.dtype).endswith(dtype)
    np.testing.assert_array_equal(t.get_vectors(range(20)),
                                  j.get_vectors(range(20)))
    q = rng.standard_normal((4, 16)).astype(np.float32)
    jv, ji = (np.asarray(x) for x in j.search(q, 5))
    tv, ti = (x.numpy() for x in t.search(torch.from_numpy(q), 5))
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-6)
    assert not (ti == 1).any() and (ti >= 0).all()


def test_kb_inline_chunk_list_loads_in_both(tmp_path):
    """A JAX-saved KB whose kb.json was rewritten to the inline chunk list
    (the legacy layout) loads in the port and answers as JAX does."""
    kb = tpurag.KnowledgeBase("p", dim=32)
    kb.add_document("a", "alpha beta gamma content")
    kb.add_document("b", "delta epsilon zeta content")
    kb.save(tmp_path / "kb")
    meta_file = tmp_path / "kb" / "kb.json"
    meta = json.loads(meta_file.read_text())
    chunks_file = tmp_path / "kb" / meta.pop("chunks_file")
    meta["chunks"] = [json.loads(line) for line in
                      chunks_file.read_text(encoding="utf-8").splitlines()]
    chunks_file.unlink()
    meta_file.write_text(json.dumps(meta))
    jkb = tpurag.KnowledgeBase.load(tmp_path / "kb")
    tkb = tpurag_torch.KnowledgeBase.load(tmp_path / "kb", device="cpu")
    assert len(tkb.chunks) == len(jkb.chunks) == 2
    for mode in ("hybrid", "keyword", "vector"):
        got = tkb.search("alpha beta", top_k=2, mode=mode)
        want = jkb.search("alpha beta", top_k=2, mode=mode)
        assert got.results[0].doc_name == want.results[0].doc_name == "a"
        assert ([r.chunk_id for r in got.results]
                == [r.chunk_id for r in want.results])
