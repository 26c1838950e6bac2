# Copied from tpurag/ingest/chunker.py (the JAX package's copy is the reference).
"""Text chunking.

Reference: SentenceSplitter(chunkSize=512, chunkOverlap=50) in token units
(src/lib/llm/config.ts:70-74). Same semantics: split to sentences, pack
sentences greedily up to chunk_size tokens, carry chunk_overlap tokens of
tail context into the next chunk. Token counting is the CJK-aware estimate
the reference uses everywhere (chinese_chars/1.5 + other_chars/4,
src/lib/context/optimizer/multi-source-merger.ts:95-99).
"""

from __future__ import annotations

import re

from tpurag_torch.core.config import ChunkingConfig

_SENT_SPLIT = re.compile(r"(?<=[.!?。！？;；\n])\s*")
_CJK_CHAR = re.compile(r"[㐀-䶿一-鿿぀-ヿ가-힯]")


def estimate_tokens(text: str) -> int:
    """CJK-aware token estimate (multi-source-merger.ts:95-99)."""
    cjk = len(_CJK_CHAR.findall(text))
    other = len(text) - cjk
    return int(cjk / 1.5 + other / 4) + 1


def split_sentences(text: str) -> list[str]:
    parts = [p for p in _SENT_SPLIT.split(text) if p.strip()]
    return parts or ([text] if text.strip() else [])


def chunk_text(text: str, config: ChunkingConfig | None = None) -> list[str]:
    """Greedy sentence-packing chunker, 512-token chunks / 50-token overlap."""
    cfg = config or ChunkingConfig()
    sents = split_sentences(text)
    if not sents:
        return []
    chunks: list[str] = []
    cur: list[str] = []
    cur_tok = 0
    for s in sents:
        t = estimate_tokens(s)
        if cur and cur_tok + t > cfg.chunk_size:
            chunks.append(" ".join(cur).strip())
            # Overlap: carry trailing sentences worth ~chunk_overlap tokens.
            keep: list[str] = []
            kept = 0
            for prev in reversed(cur):
                pt = estimate_tokens(prev)
                if kept + pt > cfg.chunk_overlap:
                    break
                keep.insert(0, prev)
                kept += pt
            cur = keep
            cur_tok = kept
        # A single sentence longer than chunk_size gets hard-split.
        while t > cfg.chunk_size:
            approx_chars = cfg.chunk_size * 4
            head, s = s[:approx_chars], s[approx_chars:]
            chunks.append((" ".join(cur) + " " + head).strip())
            cur, cur_tok = [], 0
            t = estimate_tokens(s)
        if s.strip():
            cur.append(s)
            cur_tok += t
    if cur:
        chunks.append(" ".join(cur).strip())
    return [c for c in chunks if c]
