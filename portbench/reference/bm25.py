"""Okapi BM25 over the generated chunk texts, in float64.

score(d) = sum over the query's distinct tokens t of
idf(t) * tf (k1 + 1) / (tf + k1 (1 - b + b dl / avgdl)),
idf(t) = ln(1 + (N - df + 0.5) / (df + 0.5)), with tf the token's count in
d's indexed text, dl its token count and avgdl the mean over the corpus
(at least 1). Tokens absent from the corpus add nothing to a score and
the Okapi maximum (df = 0) to the query's idf mass, the mass the
configuration's keyword gate holds the best score against.
"""

from __future__ import annotations

import math
from collections import Counter

import numpy as np
import torch

from portbench.reference.tokenizer import tokenize, tokenize_query


class BM25:
    """The statistics of every chunk, and the postings of the tokens in
    `queries` (the only ones a score reads), from the chunks' indexed
    texts."""

    def __init__(self, texts, k1: float, b: float, queries):
        wanted = {t for q in queries for t in tokenize_query(q)}
        docs: dict[str, list] = {t: [] for t in wanted}
        tfs: dict[str, list] = {t: [] for t in wanted}
        dl = np.zeros(len(texts), np.float64)
        for d, text in enumerate(texts):
            toks = tokenize(text)
            dl[d] = len(toks)
            counts = Counter(toks)
            for tok in wanted.intersection(counts):
                docs[tok].append(d)
                tfs[tok].append(counts[tok])
        self._set({t: (np.asarray(docs[t], np.int64),
                       np.asarray(tfs[t], np.float64))
                   for t in wanted if docs[t]}, dl, k1, b)

    @classmethod
    def from_words(cls, word_ids, offsets, words, headers, k1: float,
                   b: float, queries) -> "BM25":
        """The same statistics from the words each chunk was drawn from,
        where a chunk's indexed text is its header (tokenized here) and
        text whose tokens are exactly words[word_ids[offsets[c]:
        offsets[c + 1]]]: counted in bulk, without tokenizing the texts."""
        self = cls.__new__(cls)
        wanted = {t for q in queries for t in tokenize_query(q)}
        n, v = len(offsets) - 1, len(words)
        index = {w: i for i, w in enumerate(words)}
        hit = np.zeros(v, bool)
        hit[[index[t] for t in wanted if t in index]] = True
        sizes = np.diff(offsets)
        chunk = np.repeat(np.arange(n, dtype=np.int64), sizes)
        keep = hit[word_ids]
        keys, tf = np.unique(chunk[keep] * v + word_ids[keep],
                             return_counts=True)
        order = np.argsort(keys % v, kind="stable")
        keys, tf = keys[order], tf[order]
        w = keys % v
        cut = np.flatnonzero(np.diff(w)) + 1
        pairs: dict[str, list] = {}
        for lo, hi in zip(np.concatenate([[0], cut]),
                          np.concatenate([cut, [len(w)]])):
            if hi > lo:
                pairs.setdefault(words[w[lo]], []).append(
                    (keys[lo:hi] // v, tf[lo:hi]))
        dl = sizes.astype(np.float64)
        head_toks: dict[str, list] = {}
        for d, h in enumerate(headers):
            toks = head_toks.get(h)
            if toks is None:
                toks = head_toks[h] = tokenize(h)
            dl[d] += len(toks)
            for tok, c in Counter(toks).items():
                if tok in wanted:
                    pairs.setdefault(tok, []).append(
                        (np.array([d]), np.array([c])))
        post = {}
        for tok, parts in pairs.items():
            d = np.concatenate([p[0] for p in parts]).astype(np.int64)
            t = np.concatenate([p[1] for p in parts]).astype(np.float64)
            d, at = np.unique(d, return_inverse=True)
            post[tok] = (d, np.bincount(at, weights=t))
        self._set(post, dl, k1, b)
        return self

    def _set(self, post: dict, dl: np.ndarray, k1: float, b: float) -> None:
        self.k1, self.b = float(k1), float(b)
        self._post = post
        self.n = len(dl)
        self.avgdl = max(dl.sum() / max(self.n, 1), 1.0)
        self.dnorm = self.k1 * (1.0 - self.b + self.b * dl / self.avgdl)
        self.dl = dl

    def postings(self, tok: str):
        """(docs int64, tf float64) of a token, doc-ascending."""
        return self._post.get(tok, (np.zeros(0, np.int64),
                                    np.zeros(0, np.float64)))

    def idf(self, df: int) -> float:
        n = max(self.n, 1)
        df = min(df, n)
        return math.log(1.0 + (n - df + 0.5) / (df + 0.5))

    def idf_mass(self, query: str) -> float:
        return sum(self.idf(len(self.postings(t)[0]))
                   for t in tokenize_query(query))

    def scores(self, query: str, contribution_dtype=None):
        """(docs, scores): every chunk holding a query token, ascending,
        with its score. contribution_dtype (a torch dtype) rounds each
        term's contribution and the sum to it: the control's lower
        precision."""
        docs, cons = [], []
        for t in tokenize_query(query):
            d, tf = self.postings(t)
            if not len(d):
                continue
            docs.append(d)
            cons.append(self.idf(len(d)) * tf * (self.k1 + 1.0)
                        / (tf + self.dnorm[d]))
        if not docs:
            return np.zeros(0, np.int64), np.zeros(0, np.float64)
        d = np.concatenate(docs)
        c = np.concatenate(cons)
        if contribution_dtype is not None:
            c = _round(c, contribution_dtype)
        order = np.argsort(d, kind="stable")
        d, c = d[order], c[order]
        uniq, start = np.unique(d, return_index=True)
        s = np.add.reduceat(c, start)
        if contribution_dtype is not None:
            s = _round(s.astype(np.float32), contribution_dtype)
        return uniq, s


def _round(x: np.ndarray, dtype) -> np.ndarray:
    return torch.from_numpy(np.asarray(x)).to(dtype).double().numpy()


def top(docs: np.ndarray, scores: np.ndarray, k: int):
    """The k best (scores, docs), scores descending, ties to the smaller
    doc."""
    order = np.lexsort((docs, -scores))[:k]
    return scores[order], docs[order]
