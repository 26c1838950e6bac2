# Copied from tpurag/core/config.py (the JAX package's copy is the reference).
"""Centralized typed configuration.

The reference scatters behavioral constants across ~10 TS config objects
(SURVEY.md §5.6). Here they are centralized as frozen dataclasses with
identical defaults, cited to the reference file:line they mirror.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ChunkingConfig:
    """Reference: src/lib/llm/config.ts:32-33,70-74 (SentenceSplitter 512/50)."""

    chunk_size: int = 512      # tokens per chunk
    chunk_overlap: int = 50    # token overlap between consecutive chunks


@dataclasses.dataclass(frozen=True)
class HybridPreset:
    """RRF hybrid-search preset.

    Reference: PRESET_CONFIGS, src/lib/hybrid-search.ts:77-105.
    ``document``: k=60, topK 8/8, minScore 0.3, bothBonus 0.1.
    ``code``: k=40, keyword weight 1.3, topK 6/5, minScore 0.25, bothBonus 0.15.
    """

    name: str = "document"
    rrf_k: int = 60
    vector_weight: float = 1.0
    keyword_weight: float = 1.0
    vector_top_k: int = 8
    keyword_top_k: int = 8
    min_vector_score: float = 0.3
    both_bonus: float = 0.1
    # Keyword-leg confidence gate: drop a query's BM25 candidates when
    # best_bm25 < min_keyword_coverage * query_idf_mass — i.e. when even
    # the best hit matches under this idf-weighted fraction of the query
    # (InvertedIndex.query_idf_mass). Protects semantic corpora where
    # lexical evidence is pure noise (register-shift queries halved
    # hybrid recall@10 0.594→0.281 before gating, results_semantic_
    # scale.json) while leaving real lexical matches — whose top hits
    # cover most of the query's idf mass — untouched. The reference's
    # analogues are its min-score filters and the keyword-coverage
    # rerank term (hybrid-search.ts:77-105, dedup-filter.ts:132-155).
    min_keyword_coverage: float = 0.1

    @property
    def rrf_max(self) -> float:
        """Theoretical maximum fused score under this preset: rank 0 in
        every source (w/(rrf_k+1) each) plus the both-sources bonus.
        The exact normalizer for mapping RRF scores onto [0, 1]."""
        return ((self.vector_weight + self.keyword_weight)
                / (self.rrf_k + 1) + self.both_bonus)
    final_top_k: int = 8


PRESETS: dict[str, HybridPreset] = {
    "document": HybridPreset(),
    "code": HybridPreset(
        name="code",
        rrf_k=40,
        keyword_weight=1.3,
        vector_top_k=6,
        keyword_top_k=5,
        min_vector_score=0.25,
        both_bonus=0.15,
        final_top_k=8,
    ),
    # Unified memory+documents retrieval raises the vector floor to 0.4
    # (reference: src/lib/context/engine.ts:242-246).
    "unified": HybridPreset(name="unified", min_vector_score=0.4),
}


@dataclasses.dataclass(frozen=True)
class BM25Config:
    """BM25 scoring parameters (Okapi). The reference outsources keyword
    search to Meilisearch and converts ranks to scores as 1/(rank+1)
    (src/lib/meilisearch.ts:235); we score true BM25 on-device and keep a
    rank-compat mode for strict parity."""

    k1: float = 1.2
    b: float = 0.75
    rank_compat_scores: bool = False  # emit 1/(rank+1) instead of BM25 score
    max_df_ratio: float = 1.0  # skip query terms matching more than this
                               # fraction of docs (stopword elision; 1.0 = off)
    head_m: int = 0     # impact-ordered head size: terms with df > head_m
                        # score only their top-head_m-impact postings
                        # (WAND-style pruning; bounds candidate width at
                        # T*head_m lanes but is APPROXIMATE — fails on
                        # flat-impact corpora). 0 (default) = exact.
    exact_scoring: bool = False  # force full postings even if head_m set
    width_ladder: tuple = (64, 256, 1024, 2048)
    # Query width classes round UP to this ladder (exact — storage buckets
    # keep their natural pow2 width; only the kernel's scan width pads).
    # Bounds the number of compiled Pallas variants on a long-lived server
    # to len(ladder) per (k, t) instead of one per pow2 width; the padding
    # cost is < 2x lanes in the worst case while compile count drops ~2x.
    wide_term_width: int = 2048
    # Terms with postings-bucket width ABOVE this score in per-width
    # WIDE classes (kernels/bm25_pallas.merge_segsum_full) instead of
    # forcing the whole query's class up to their width; the exact
    # narrow+wide combine is kernels/bm25_join.py. 2048 matches the
    # width_ladder top, so narrow classes stay on the round-1 fused
    # kernel unchanged. Raise only if profiling shows wide classes
    # dominated by few-lane terms; must be a ladder rung or above.
    packed_merge: bool = True
    # Pack (doc id, quantized contribution) into one int32 key so the
    # fused merge network moves half the data (kernels/bm25_pallas.py).
    # Contribution precision adapts to corpus size (31 - doc-id bits;
    # >= 12 bits, else the kernel falls back to the two-array form).
    # Exactness: contributions quantize at <= max_row/2^12 ~ 0.02%; set
    # False for bit-exact BM25 scores.


@dataclasses.dataclass(frozen=True)
class FreshnessConfig:
    """Memory freshness decay.

    score = confidence * exp(-decay_rate*hours_since_access)
                       * (1 + freq_bonus*ln(access_count+1)), clamped to [0,1].
    Reference: src/lib/memory/freshness.ts:20-23,37-56.
    """

    decay_rate_per_hour: float = 0.05
    freq_bonus: float = 0.1


@dataclasses.dataclass(frozen=True)
class MemoryConfig:
    """Reference: src/lib/memory/{store,service,budget}.ts."""

    relevance_threshold: float = 0.5   # service.ts:60, store.ts:105
    relevance_weight: float = 0.7      # store.ts:160
    freshness_weight: float = 0.3      # store.ts:160
    dedup_similarity: float = 0.9      # store.ts:274
    token_budget: int = 2000           # budget.ts:18
    budget_reserve_ratio: float = 0.1  # budget.ts:52
    min_truncate_tokens: int = 50      # budget.ts:61-93
    overfetch_factor: int = 2          # store.ts: vector search x2 over-fetch
    freshness: FreshnessConfig = dataclasses.field(default_factory=FreshnessConfig)


@dataclasses.dataclass(frozen=True)
class SourceWeights:
    """Multi-source merge weights.

    Reference: src/lib/context/optimizer/multi-source-merger.ts:18-23.
    """

    memory: float = 1.2
    rag: float = 1.0
    tool: float = 0.8
    history: float = 0.6


@dataclasses.dataclass(frozen=True)
class ContextConfig:
    """Reference: src/lib/context/engine.ts:40-64 + agent.ts:266,220."""

    agent_token_budget: int = 3000
    greeting_token_budget: int = 1500
    compression_trigger: float = 0.85   # engine.ts:62, compress past 85% usage
    compression_target: float = 0.50    # engine.ts:63,187
    dedup_jaccard: float = 0.85         # dedup-filter.ts:18
    dedup_prefix_chars: int = 200       # dedup-filter.ts:60-65
    rerank_fusion_weight: float = 0.7   # dedup-filter.ts:145
    rerank_keyword_weight: float = 0.3
    history_summary_after: int = 10     # history-summary.ts: summarize past 10 msgs
    history_keep_rounds: int = 3
    weights: SourceWeights = dataclasses.field(default_factory=SourceWeights)


@dataclasses.dataclass(frozen=True)
class IVFConfig:
    """IVF partitioning for large corpora (no reference equivalent — the
    reference is exact-only; targets from BASELINE.json: recall@10 >= 0.95)."""

    n_lists: int = 1024
    n_probe: int = 64
    kmeans_iters: int = 10
    sample_size: int = 262_144  # training sample cap for k-means
    # Split clusters above factor x mean size into extra lists at build
    # time: the probe kernel's grid is sized by the LARGEST cluster, so
    # k-means skew (5.6x at 10M) multiplies every probe's cost
    # (index/ivf.py:split_oversized). None disables.
    max_cluster_factor: Optional[float] = 2.0
    # Auto-refresh policy (round-4 verdict item 5): after build_ivf(),
    # new rows accumulate in an exact-scanned tail whose cost grows
    # linearly — without a rebuild, sustained ingest degrades
    # mode='ivf' toward exact-scan latency. When the tail exceeds
    # auto_refresh_ratio x partition size (and auto_refresh_min_rows,
    # the churn floor), a background single-flight rebuild snapshots
    # the corpus and swaps in under the write lock. Mirrors the
    # inverted index's 25% tail-compaction bound
    # (index/inverted.py TAIL_COMPACT_RATIO). None disables.
    auto_refresh_ratio: Optional[float] = 0.25
    auto_refresh_min_rows: int = 4096


@dataclasses.dataclass(frozen=True)
class DeviceConfig:
    """Dense engine device-side layout."""

    dtype: str = "bfloat16"       # embedding storage dtype in HBM
    dim: int = 1024               # lightrag-service/main.py:188 (dim=1024)
    min_capacity: int = 4096      # initial corpus capacity (grows by doubling)


@dataclasses.dataclass(frozen=True)
class GraphConfig:
    """Entity/relation graph search (replaces LightRAG sidecar,
    lightrag-service/main.py:375-419). Modes: local / global / hybrid / naive."""

    entity_top_k: int = 16
    relation_top_k: int = 16
    expand_hops: int = 1
    max_neighbors: int = 64


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Top-level engine configuration."""

    chunking: ChunkingConfig = dataclasses.field(default_factory=ChunkingConfig)
    bm25: BM25Config = dataclasses.field(default_factory=BM25Config)
    memory: MemoryConfig = dataclasses.field(default_factory=MemoryConfig)
    context: ContextConfig = dataclasses.field(default_factory=ContextConfig)
    ivf: IVFConfig = dataclasses.field(default_factory=IVFConfig)
    device: DeviceConfig = dataclasses.field(default_factory=DeviceConfig)
    graph: GraphConfig = dataclasses.field(default_factory=GraphConfig)
    preset: str = "document"

    def hybrid_preset(self) -> HybridPreset:
        return PRESETS[self.preset]

    def replace(self, **kw) -> "EngineConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = EngineConfig()


def get_config(overrides: Optional[dict] = None) -> EngineConfig:
    if not overrides:
        return DEFAULT_CONFIG
    return dataclasses.replace(DEFAULT_CONFIG, **overrides)


def config_from_env(base: Optional[EngineConfig] = None) -> EngineConfig:
    """Environment-variable overrides (the reference reads env at call
    time, SURVEY.md §5.6: CHUNK_SIZE, CHUNK_OVERLAP etc.). Supported:
    TPURAG_CHUNK_SIZE, TPURAG_CHUNK_OVERLAP, TPURAG_PRESET,
    TPURAG_EMBED_DIM, TPURAG_BM25_K1, TPURAG_BM25_B, TPURAG_IVF_NPROBE."""
    import os

    cfg = base or EngineConfig()
    env = os.environ

    def _i(name, default):
        return int(env.get(name, default))

    def _f(name, default):
        return float(env.get(name, default))

    chunking = dataclasses.replace(
        cfg.chunking,
        chunk_size=_i("TPURAG_CHUNK_SIZE", cfg.chunking.chunk_size),
        chunk_overlap=_i("TPURAG_CHUNK_OVERLAP", cfg.chunking.chunk_overlap))
    bm25 = dataclasses.replace(
        cfg.bm25,
        k1=_f("TPURAG_BM25_K1", cfg.bm25.k1),
        b=_f("TPURAG_BM25_B", cfg.bm25.b))
    device = dataclasses.replace(
        cfg.device, dim=_i("TPURAG_EMBED_DIM", cfg.device.dim))
    ivf = dataclasses.replace(
        cfg.ivf, n_probe=_i("TPURAG_IVF_NPROBE", cfg.ivf.n_probe))
    preset = env.get("TPURAG_PRESET", cfg.preset)
    if preset not in PRESETS:
        preset = cfg.preset
    return dataclasses.replace(cfg, chunking=chunking, bm25=bm25,
                               device=device, ivf=ivf, preset=preset)
