"""The keyword-confidence gate (HybridPreset.min_keyword_coverage) in
tpurag_torch against the JAX package, on tests/test_keyword_gate.py's
fixture: a semantic corpus whose keyword evidence is function words only,
and one rare-term document.

Both packages: vector and gated hybrid recall@8 of 1.0, the ungated
preset's recall below it (keyword noise evicts the vector leg's rank-5
truths; the port's 1/6, JAX's 0 on the CPU, from the same keyword scores
tied in another order), and the rare-term document found by hybrid
search. The query holding the
rare term also matches 30 decoys on equal BM25 scores; JAX on the CPU
breaks that tie by last-bit noise, the port by doc id (ROADMAP "Known
differences"), so its keyword results are compared as sets of scores.
"""

import dataclasses

import numpy as np
import pytest

import tpurag
import tpurag_torch
from test_keyword_gate import N_DECOYS, N_TOPICS, PAD, QPAD, OracleEmbedder
from tpurag.core.config import PRESETS as JAX_PRESETS
from tpurag_torch.core.config import PRESETS

RARE_QUERY = f"{QPAD} zyqwization casualmark0"


def _build(pkg, **kw):
    kb = pkg.KnowledgeBase("gate-sem", embedder=OracleEmbedder(), **kw)
    for i in range(N_TOPICS):
        for d in range(N_DECOYS):
            kb.add_document(f"decoy{i}_{d}", f"{PAD} formalmark{i}")
        kb.add_document(f"truth{i}", f"{PAD} formalmark{i} truthdoc")
    kb.add_document("lexdoc", f"{PAD} zyqwization protocol")
    return kb


@pytest.fixture(scope="module")
def kbs():
    return ((_build(tpurag), JAX_PRESETS),
            (_build(tpurag_torch, device="cpu"), PRESETS))


def _recall_at_8(kb, mode: str, preset=None) -> float:
    hits = 0
    for i in range(N_TOPICS):
        r = kb.search(f"{QPAD} stuff casualmark{i}", top_k=8, mode=mode,
                      preset=preset)
        hits += f"truth{i}" in [x.doc_name for x in r.results]
    return hits / N_TOPICS


@pytest.mark.parametrize("mode", ["vector", "hybrid"])
def test_gate_recall_matches_jax(kbs, mode):
    for kb, _ in kbs:
        assert _recall_at_8(kb, mode) == 1.0


def test_gate_disabled_reproduces_noise_failure_in_both(kbs):
    """Without the gate the function-word noise evicts vector truths from
    the fused top-8 in both packages (tests/test_keyword_gate.py pins < 1.0
    for JAX). The two keyword legs hold the same scores on those queries;
    they differ only in which of the tied docs they return (the port takes
    the smaller ids, JAX on the CPU its last-bit noise), and with that in
    which truths survive the fusion: the port keeps one of six, JAX none
    (ROADMAP "Known differences")."""
    (jkb, jp), (tkb, tp) = kbs
    ungated = [dataclasses.replace(p["document"], min_keyword_coverage=0.0)
               for p in (jp, tp)]
    for i in range(N_TOPICS):
        q = f"{QPAD} stuff casualmark{i}"
        want = jkb.search(q, top_k=8, mode="keyword").results
        got = tkb.search(q, top_k=8, mode="keyword").results
        assert len(got) == len(want) == 8
        np.testing.assert_allclose(sorted(x.score for x in got),
                                   sorted(x.score for x in want), rtol=1e-5)
    assert _recall_at_8(jkb, "hybrid", ungated[0]) < 1.0
    assert _recall_at_8(tkb, "hybrid", ungated[1]) == pytest.approx(
        1 / N_TOPICS)


def test_rare_term_survives_gate_in_both(kbs):
    for kb, _ in kbs:
        r = kb.search(RARE_QUERY, top_k=8, mode="hybrid")
        assert "lexdoc" in [x.doc_name for x in r.results]


def test_tied_decoy_query_keyword_scores_match_as_sets(kbs):
    (jkb, _), (tkb, _) = kbs
    want = jkb.search(RARE_QUERY, top_k=8, mode="keyword").results
    got = tkb.search(RARE_QUERY, top_k=8, mode="keyword").results
    assert got[0].doc_name == want[0].doc_name == "lexdoc"
    np.testing.assert_allclose(sorted(x.score for x in got),
                               sorted(x.score for x in want), rtol=1e-5)
    np.testing.assert_allclose(
        tkb.inverted.query_idf_mass([RARE_QUERY, "the", "zyqwization"]),
        jkb.inverted.query_idf_mass([RARE_QUERY, "the", "zyqwization"]),
        rtol=1e-6)
