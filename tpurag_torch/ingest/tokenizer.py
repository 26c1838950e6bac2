# Copied from tpurag/ingest/tokenizer.py (the JAX package's copy is the reference).
"""Lexical tokenizer for the BM25 inverted index.

The reference delegates keyword tokenization to Meilisearch's built-in
(Rust) tokenizer, which handles CJK. Equivalent here: lowercase latin
words + numbers, and CJK handled as character bigrams (the standard
BM25-over-Chinese recipe, matching Meilisearch's Jieba-less fallback
behavior closely enough for rank parity on mixed corpora).

This pure-Python version is the behavioral spec. InvertedIndex.add_batch
tokenizes batches with the native copy of the JAX package's C++
tokenizer (index/postings.py, csrc/host/tokenizer.cc), held to this one
by tests.
"""

from __future__ import annotations

import re

_WORD = re.compile(r"[a-z0-9_]+")
# CJK unified ideographs + extension A, Hiragana, Katakana, Hangul.
_CJK = re.compile(r"[぀-ヿ㐀-䶿一-鿿가-힯]+")

_TOKEN_SPLIT = re.compile(
    r"([぀-ヿ㐀-䶿一-鿿가-힯]+)|([a-z0-9_]+)"
)


def tokenize(text: str) -> list[str]:
    """Text -> BM25 terms (latin words lowercased; CJK runs -> bigrams)."""
    out: list[str] = []
    for cjk, word in _TOKEN_SPLIT.findall(text.lower()):
        if word:
            out.append(word)
        elif cjk:
            if len(cjk) == 1:
                out.append(cjk)
            else:
                out.extend(cjk[i : i + 2] for i in range(len(cjk) - 1))
    return out


def tokenize_query(text: str) -> list[str]:
    """Query-side tokenization (same pipeline, deduplicated, order-kept)."""
    seen: set[str] = set()
    out: list[str] = []
    for t in tokenize(text):
        if t not in seen:
            seen.add(t)
            out.append(t)
    return out
