# Copied from tpurag/ingest/embedder.py (HashEmbedder only).
"""Embedding providers.

:class:`HashEmbedder` is a deterministic, dependency-free feature hashing
of BM25 tokens into a dense space (numpy, no network), identical to the
JAX package's. Any callable `texts -> (B, D) array` works where an
Embedder is expected. The on-chip transformer encoder is not ported yet.
"""

from __future__ import annotations

import hashlib

import numpy as np

from tpurag_torch.ingest.tokenizer import tokenize


class HashEmbedder:
    """Feature-hash bag-of-tokens embedder (deterministic, no network)."""

    def __init__(self, dim: int = 256, seed: int = 0):
        self.dim = dim
        self.seed = seed
        self._cache: dict[str, np.ndarray] = {}

    def _token_vec(self, tok: str) -> np.ndarray:
        v = self._cache.get(tok)
        if v is None:
            h = hashlib.blake2b(
                tok.encode("utf-8"), digest_size=8, person=b"tpuragHE",
                salt=self.seed.to_bytes(8, "little"),
            ).digest()
            rng = np.random.default_rng(int.from_bytes(h, "little"))
            v = rng.standard_normal(self.dim).astype(np.float32)
            v /= np.linalg.norm(v) + 1e-30
            if len(self._cache) < 200_000:
                self._cache[tok] = v
        return v

    def __call__(self, texts: list[str]) -> np.ndarray:
        out = np.zeros((len(texts), self.dim), np.float32)
        for i, t in enumerate(texts):
            toks = tokenize(t)
            if not toks:
                out[i, 0] = 1.0
                continue
            for tok in toks:
                out[i] += self._token_vec(tok)
            out[i] /= np.linalg.norm(out[i]) + 1e-30
        return out


class EncoderEmbedder:
    """The JAX package's on-chip transformer encoder (tpurag.models)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "EncoderEmbedder is not ported yet (ROADMAP.md Queue 1, "
            "'Encoder'); use HashEmbedder or pass vectors")
