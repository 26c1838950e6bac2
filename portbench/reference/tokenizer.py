"""A frozen copy of the lexical tokenizer the configurations index with
(tpurag_torch/ingest/tokenizer.py, itself the JAX package's): lowercase
latin words and numbers, CJK runs as character bigrams."""

from __future__ import annotations

import re

_TOKEN_SPLIT = re.compile(
    r"([぀-ヿ㐀-䶿一-鿿가-힯]+)|([a-z0-9_]+)"
)


def tokenize(text: str) -> list[str]:
    out: list[str] = []
    for cjk, word in _TOKEN_SPLIT.findall(text.lower()):
        if word:
            out.append(word)
        elif cjk:
            if len(cjk) == 1:
                out.append(cjk)
            else:
                out.extend(cjk[i:i + 2] for i in range(len(cjk) - 1))
    return out


def tokenize_query(text: str) -> list[str]:
    """Query tokens, each once, in order."""
    return list(dict.fromkeys(tokenize(text)))
