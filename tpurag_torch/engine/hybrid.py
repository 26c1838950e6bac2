# Ported from tpurag/engine/hybrid.py.
"""Hybrid (dense + keyword) retrieval with RRF fusion.

Mirrors hybridSearch (src/lib/hybrid-search.ts:275-362):
  1. dense cosine top-k, then drop hits below the preset's min vector score;
  2. BM25 keyword top-k, gated off per query when even its best hit
     covers under min_keyword_coverage of the query's idf mass;
  3. reciprocal-rank fusion with preset weights / rrf_k / both-bonus;
  4. cut to final_top_k.

Both legs and the fusion stay on the indexes' device; the host sends
only the gate's idf masses, and takes back the final (scores, ids, bits)
triple. Steps 1-4 past the legs are ``kernels.fusion.fuse_legs``: on the
card one kernel launch.

Source bit layout in the returned mask: bit 0 = vector, bit 1 = keyword.
"""

from __future__ import annotations

from tpurag_torch.core.config import HybridPreset
from tpurag_torch.index.dense import DenseIndex
from tpurag_torch.index.inverted import InvertedIndex
from tpurag_torch.kernels.fusion import fuse_legs
from tpurag_torch.utils import tracing

SOURCE_BITS = ("vector", "keyword")


def hybrid_search(
    dense: DenseIndex,
    inverted: InvertedIndex | None,
    query_vecs,
    query_texts: list[str],
    preset: HybridPreset,
    dense_search=None,
):
    """Batch hybrid search.

    dense_search: optional (query_vecs, k) -> (scores, ids) dense-leg
    override, e.g. the KB's IVF + tail leg (mode='hybrid_ivf'), whose
    probe-scan cost scales with the probed clusters instead of the corpus.

    Returns (scores, ids, src_bits), (B, final_top_k) tensors on the
    indexes' device, queued but not waited for; empty slots are
    (NEG_INF, -1, 0)."""
    v_scores, v_ids = (dense_search or dense.search)(query_vecs,
                                                     preset.vector_top_k)
    keyword = inverted is not None and len(inverted) > 0
    # Keyword index unavailable -> vector-only degradation (reference:
    # hybrid-search.ts:322-330): fuse_legs takes no keyword leg.
    k_scores = k_ids = None
    if keyword:
        k_scores, k_ids = inverted.search(query_texts, preset.keyword_top_k,
                                          as_device=True)

    # Everything past the two legs is one span: the floor, the gate, RRF.
    with tracing.span("fuse"):
        mass = None
        if (keyword and preset.min_keyword_coverage > 0.0
                and not inverted.config.rank_compat_scores):
            # Keyword-leg confidence gate (see HybridPreset); rank-compat
            # pseudo-scores carry no match mass, so it gates true BM25 only.
            mass = inverted.query_idf_mass(query_texts)
        return fuse_legs(v_scores, v_ids, k_scores, k_ids, mass, preset)


def decode_bits(bits: int, names: tuple[str, ...] = SOURCE_BITS) -> tuple[str, ...]:
    return tuple(n for i, n in enumerate(names) if bits & (1 << i))
