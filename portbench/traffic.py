"""The seeded inputs of a cell: a configuration's corpus and a traffic
mix's query batches.

A corpus is chunk texts and chunk vectors, each made by a generator the
configuration names (``corpus.texts.kind``, ``corpus.vectors.kind``); a
query is a text and a vector, made as the traffic file's ``queries``
says. The vector generators and the query plan are copies of
chip_smoke.py's ``query_vectors``, ``zipf_queries``, ``ivf_corpus`` and
``ivf_queries`` (themselves bench.py's and benchmarks/kb_10m.py's plans),
changed in three ways: their sizes come from the configuration and
traffic files, every draw comes from the run's ``--seed``, and vectors
are made on the device with a ``torch.Generator`` in a few large calls.
The chunk texts are new: documents of Zipf-drawn words, cut as the
source's chunker cuts them (``chunk_texts``). The program receives only
what these make; nothing here imports it.

Every stream is keyed by (seed, stream id, chunk), so the same seed gives
the same corpus and the same sequence of batches however many batches a
run ends up drawing.
"""

from __future__ import annotations

import numpy as np
import torch

# Stream ids of the seed's sub-streams.
CORPUS, VECTORS, QUERY_TERMS, QUERY_VECTORS, SAMPLE = range(5)
# Queries drawn per seeded chunk of the query stream.
CHUNK_QUERIES = 4096


def seed_seq(seed: int, *key: int) -> np.random.SeedSequence:
    return np.random.SeedSequence(int(seed) % (1 << 128), spawn_key=key)


def np_rng(seed: int, *key: int) -> np.random.Generator:
    return np.random.default_rng(seed_seq(seed, *key))


def torch_gen(seed: int, *key: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    state = seed_seq(seed, *key).generate_state(1, np.uint64)[0]
    g.manual_seed(int(state) & ((1 << 63) - 1))
    return g


def indexed_text(text: str, doc_name: str) -> str:
    """The text a chunk is indexed under: the program prepends a
    '【文档: name】' header to a named document chunk (rag-era's
    src/lib/llm/index-manager.ts:75-97)."""
    return f"【文档: {doc_name}】\n{text}" if doc_name else text


def zipf_cdf(vocab: int, exponent: float) -> np.ndarray:
    """Cumulative P(r) ~ (1 + r)^-exponent over ranks 0..vocab-1."""
    w = (1.0 + np.arange(vocab)) ** -float(exponent)
    c = np.cumsum(w)
    return c / c[-1]


class Ranks:
    """Draws of ranks by a cumulative distribution: the first r with
    cdf[r] >= u, found from a guide table of 2^20 cells (the same ranks
    a binary search gives, in a few passes)."""

    CELLS = 1 << 20

    def __init__(self, cdf: np.ndarray):
        self.cdf = cdf
        self.guide = np.searchsorted(
            cdf, np.arange(self.CELLS) / self.CELLS).astype(np.int64)

    def __call__(self, u: np.ndarray) -> np.ndarray:
        r = self.guide[(u * self.CELLS).astype(np.int64)]
        last = len(self.cdf) - 1
        while True:
            low = (self.cdf[r] < u) & (r < last)
            if not low.any():
                return r
            r[low] += 1


def word(r: int) -> str:
    return f"w{r}"


# -- chunk texts ------------------------------------------------------------


def chunk_texts(sent_tokens, chunk_tokens: int, overlap_tokens: int):
    """The sentence ranges [start, end) of each chunk that rag-era's
    SentenceSplitter(chunkSize, chunkOverlap) cuts a document of
    sentences into (src/lib/llm/config.ts:70-74), given each sentence's
    token estimate: sentences packed greedily while the chunk holds at
    most chunk_tokens, the next chunk opening with the trailing sentences
    of at most overlap_tokens. No sentence here outgrows a chunk."""
    out = []
    start, cur = 0, 0
    for j, t in enumerate(sent_tokens):
        if j > start and cur + t > chunk_tokens:
            out.append((start, j))
            s, kept = j, 0
            while s > start and kept + sent_tokens[s - 1] <= overlap_tokens:
                s -= 1
                kept += sent_tokens[s]
            start, cur = s, kept
        cur += t
    if len(sent_tokens) > start:
        out.append((start, len(sent_tokens)))
    return out


def estimate_tokens(n_chars: np.ndarray) -> np.ndarray:
    """rag-era's token estimate of latin text, characters / 4 + 1
    (src/lib/context/optimizer/multi-source-merger.ts:95-99)."""
    return n_chars // 4 + 1


class ZipfChunks:
    """Documents of sentences of Zipf-drawn words (word r, 'w<r>', drawn
    with P ~ (1 + r)^-exponent; a sentence of sentence_words[0] to [1]
    words, its last carrying the full stop), each cut into doc_chunks
    chunks of at most chunk_tokens with overlap_tokens carried over, as
    the source's chunker cuts them. Document d is 'doc<d>'."""

    def __init__(self, spec: dict, n: int, seed: int,
                 keep_documents: bool = False):
        self.chunk_tokens = spec["chunk_tokens"]
        self.overlap_tokens = spec["overlap_tokens"]
        self.vocab = vocab = spec["vocab"]
        lo, hi = spec["sentence_words"]
        per_doc = spec["doc_chunks"]
        cdf = zipf_cdf(vocab, spec["exponent"])
        draw = Ranks(cdf)
        table = [word(r) for r in range(vocab)]
        table = np.array(table + [w + "." for w in table], dtype=object)
        wlen = np.array([len(w) for w in table[:vocab]], np.int64)
        # Sentences a document draws at first: its chunks at the mean
        # sentence's token estimate, with room; twice as many on a retry.
        p = np.diff(np.concatenate([[0.0], cdf]))
        per_sent = (lo + hi) / 2 * (float(p @ wlen) + 1) / 4
        first = int(per_doc * (self.chunk_tokens / per_sent + 2) * 1.25)
        rng = np_rng(seed, CORPUS)
        self.texts, self.doc_ids, self.doc_names = [], [], []
        self.documents = [] if keep_documents else None
        self.words = list(table[:vocab])
        flat, sizes = [], []
        d = 0
        while len(self.texts) < n:
            want = min(per_doc, n - len(self.texts))
            n_sent = first
            while True:
                sl = rng.integers(lo, hi + 1, n_sent)
                ends = np.cumsum(sl)
                ids = draw(rng.random(int(ends[-1])))
                starts = ends - sl
                # A sentence's characters: its words, the spaces between
                # them and the full stop.
                cum = np.concatenate([[0], np.cumsum(wlen[ids] + 1)])
                chars = cum[ends] - cum[starts]
                ranges = chunk_texts(estimate_tokens(chars).tolist(),
                                     self.chunk_tokens, self.overlap_tokens)
                if len(ranges) > want:
                    break
                n_sent *= 2
            ranges = ranges[:want]
            ids[ends - 1] += vocab  # each sentence's last word, with '.'
            # A chunk is a run of the document's sentences: a slice of its
            # text, from its first word to its last full stop.
            cum[1:] += np.cumsum(ids >= vocab)
            doc = " ".join(table[ids[:ends[ranges[-1][1] - 1]]])
            for s, e in ranges:
                self.texts.append(doc[cum[starts[s]]:cum[ends[e - 1]] - 1])
                self.doc_ids.append(f"d{d}")
                self.doc_names.append(f"doc{d}")
                flat.append(ids[starts[s]:ends[e - 1]] % vocab)
                sizes.append(ends[e - 1] - starts[s])
            if keep_documents:
                self.documents.append(doc)
            d += 1
        # Each chunk's words as drawn: word ids flat, chunk c's at
        # word_ids[offsets[c]:offsets[c + 1]]. Its text tokenizes to
        # exactly these words (the full stop is no token).
        self.word_ids = np.concatenate(flat).astype(np.int32)
        self.offsets = np.concatenate([[0], np.cumsum(sizes)])

    def queries(self, q: dict, chunk: int, n: int, seed: int):
        """n query texts: bench.py's plan, q['terms'] words each, word r
        drawn with P ~ (1 + r)^-q['exponent']."""
        rng = np_rng(seed, QUERY_TERMS, chunk)
        cdf = zipf_cdf(self.vocab, q["exponent"])
        tid = np.minimum(np.searchsorted(cdf, rng.random((n, q["terms"]))),
                         self.vocab - 1)
        return [" ".join(word(t) for t in row) for row in tid.tolist()]


TEXTS = {"zipf_chunks": ZipfChunks}


# -- vectors ----------------------------------------------------------------


class UnitRows:
    """Random unit rows (chip_smoke.py's bench.py plan); a query is the
    sum of q['sources'] seeded corpus rows plus q['noise'] Gaussian noise,
    so those rows are its nearest neighbours."""

    def __init__(self, spec: dict, n: int, dim: int, seed: int, device):
        self.n, self.dim, self.seed = n, dim, seed
        self.device = torch.device(device)
        self._rows = None

    def blocks(self):
        yield 0, self.n, self.rows()

    def rows(self) -> torch.Tensor:
        if self._rows is None:
            g = torch_gen(self.seed, VECTORS, device=self.device)
            x = torch.randn((self.n, self.dim), generator=g,
                            device=self.device)
            self._rows = x / torch.linalg.vector_norm(x, dim=1, keepdim=True)
        return self._rows

    def release(self) -> None:
        self._rows = None

    def queries(self, q: dict, chunk: int, n: int) -> np.ndarray:
        rng = np_rng(self.seed, QUERY_VECTORS, chunk)
        src = torch.as_tensor(rng.integers(0, self.n, (n, q["sources"])),
                              device=self.device)
        g = torch_gen(self.seed, QUERY_VECTORS, chunk, device=self.device)
        qv = self.rows()[src].sum(dim=1)
        qv += q["noise"] * torch.randn(qv.shape, generator=g,
                                       device=self.device)
        return qv.cpu().numpy()


class Mixture:
    """benchmarks/kb_10m.py's mixture: unit centers, each row a center
    plus Gaussian noise of norm ~noise; a query a fresh draw from the
    mixture, normalized."""

    def __init__(self, spec: dict, n: int, dim: int, seed: int, device):
        self.n, self.dim, self.seed = n, dim, seed
        self.n_centers, self.noise = spec["n_centers"], spec["noise"]
        self.block = spec["block_rows"]
        self.device = torch.device(device)
        g = torch_gen(seed, VECTORS, device=self.device)
        c = torch.randn((self.n_centers, dim), generator=g,
                        device=self.device)
        self.centers = c / torch.linalg.vector_norm(c, dim=1, keepdim=True)

    def blocks(self):
        """block_rows at a time; the same seed gives the same blocks on
        every pass."""
        g = torch_gen(self.seed, VECTORS, 1, device=self.device)
        which = torch.randint(0, self.n_centers, (self.n,), generator=g,
                              device=self.device)
        scale = self.noise / float(np.sqrt(self.dim))
        for s in range(0, self.n, self.block):
            e = min(s + self.block, self.n)
            blk = torch.randn((e - s, self.dim), generator=g,
                              device=self.device)
            blk *= scale
            blk += self.centers[which[s:e]]
            yield s, e, blk

    def release(self) -> None:
        pass

    def queries(self, q: dict, chunk: int, n: int) -> np.ndarray:
        g = torch_gen(self.seed, QUERY_VECTORS, chunk, device=self.device)
        qc = torch.randint(0, self.n_centers, (n,), generator=g,
                           device=self.device)
        qv = torch.randn((n, self.dim), generator=g, device=self.device)
        qv *= self.noise / float(np.sqrt(self.dim))
        qv += self.centers[qc]
        qv /= torch.linalg.vector_norm(qv, dim=1, keepdim=True)
        return qv.cpu().numpy()


VECTOR_KINDS = {"unit": UnitRows, "mixture": Mixture}


class Corpus:
    """A configuration's chunks: texts, document ids and names, and the
    vectors, on the device."""

    def __init__(self, spec: dict, dim: int, seed: int, device):
        self.n, self.dim, self.seed = spec["n_chunks"], dim, seed
        t, v = spec["texts"], spec["vectors"]
        self.text_gen = TEXTS[t["kind"]](t, self.n, seed)
        self.vectors = VECTOR_KINDS[v["kind"]](v, self.n, dim, seed, device)
        self.kind = (t["kind"], v["kind"])
        self.texts = self.text_gen.texts
        self.doc_ids = self.text_gen.doc_ids
        self.doc_names = self.text_gen.doc_names

    def bm25(self, k1: float, b: float, queries):
        """The reference's BM25 over the chunks as indexed (the document
        header and the chunk's words), for `queries`."""
        from portbench.reference.bm25 import BM25

        g = self.text_gen
        return BM25.from_words(g.word_ids, g.offsets, g.words,
                               [indexed_text("", n) for n in self.doc_names],
                               k1, b, queries)

    def vector_blocks(self):
        """(lo, hi, fp32 rows) on the device."""
        return self.vectors.blocks()

    def release(self) -> None:
        self.vectors.release()

    def queries(self, q: dict, chunk: int, n: int):
        texts = self.text_gen.queries(q, chunk, n, self.seed)
        return texts, self.vectors.queries(q["vectors"], chunk, n)


def make_corpus(config: dict, seed: int, device) -> Corpus:
    return Corpus(config["corpus"], config["dim"], seed, device)


class QueryStream:
    """The traffic's batches in order, drawn chunk by chunk. Each batch
    is (texts, host fp32 vectors, u), u the batch's uniform draws that
    pick the rows kept for the correctness sample."""

    def __init__(self, corpus, traffic: dict, seed: int):
        want = traffic["queries"]["vectors"]["kind"]
        if want != corpus.kind[1]:
            raise ValueError(f"traffic query vectors {want!r} need a "
                             f"{want!r} corpus, not {corpus.kind[1]!r}")
        self.corpus, self.spec = corpus, traffic["queries"]
        self.batch, self.seed = traffic["batch"], seed
        self.per_chunk = max(1, CHUNK_QUERIES // self.batch)
        self.batches: list = []
        self._chunk = 0

    def draw(self, n_batches: int) -> None:
        """Extend the stream to at least n_batches batches."""
        while len(self.batches) < n_batches:
            n = self.per_chunk * self.batch
            texts, qv = self.corpus.queries(self.spec, self._chunk, n)
            u = np_rng(self.seed, SAMPLE, self._chunk).random(n)
            for j in range(self.per_chunk):
                lo, hi = j * self.batch, (j + 1) * self.batch
                self.batches.append((texts[lo:hi], qv[lo:hi], u[lo:hi]))
            self._chunk += 1
