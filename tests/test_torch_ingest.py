"""tpurag_torch keyword ingest: InvertedIndex.add_batch's native path
(index/postings.py, csrc/host/tokenizer.cc) against add(), its plain
path, one document at a time.

Both must leave the same index: vocabulary in the same order, every
term's doc ids and term frequencies in the same order, doc_len, n_docs,
the token total and the segment bookkeeping; after compaction the same
device layout, array for array. The postings live in int32 bytearrays
that the cyclic collector does not track, and they keep the JAX
package's save format.
"""

import gc
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

from tpurag.core.config import BM25Config as JaxBM25Config
from tpurag.index.inverted import InvertedIndex as JaxInvertedIndex
from tpurag_torch.core.config import BM25Config
from tpurag_torch.index import inverted, postings
from tpurag_torch.index.inverted import InvertedIndex
from tpurag_torch.ingest.tokenizer import tokenize
from tpurag_torch.utils import tracing

ROOT = pathlib.Path(__file__).resolve().parent.parent
SEED = 2**31 + 17


def _is_cjk(cp: int) -> bool:
    return (0x3040 <= cp <= 0x30FF or 0x3400 <= cp <= 0x4DBF
            or 0x4E00 <= cp <= 0x9FFF or 0xAC00 <= cp <= 0xD7AF)


def _index(config=None) -> InvertedIndex:
    return InvertedIndex(config or BM25Config(packed_merge=False),
                         device="cpu")


def _plain(ids, texts, into=None) -> InvertedIndex:
    idx = into if into is not None else _index()
    for i, t in zip(ids, texts):
        idx.add(int(i), t)
    return idx


def _assert_same(got: InvertedIndex, want: InvertedIndex) -> None:
    assert list(got.vocab.items()) == list(want.vocab.items())
    assert got._postings_doc == want._postings_doc
    assert got._postings_tf == want._postings_tf
    assert got.doc_len == want.doc_len
    assert (got.n_docs, got._total_tokens) == (want.n_docs,
                                               want._total_tokens)
    assert got._main_count == want._main_count
    assert (got._tail_nnz, got._dead) == (want._tail_nnz, want._dead)


def _assert_same_layout(got, want) -> None:
    assert got.widths == want.widths and got.nnz == want.nnz
    for name in ("term_bucket", "term_row", "term_len"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name))
    for (gd, gi), (wd, wi) in zip(got.mats, want.mats, strict=True):
        assert torch.equal(gd, wd) and torch.equal(gi, wi)


def _bench_texts(n: int) -> list[str]:
    """n of the benchmark's chunks as KnowledgeBase.add_chunks indexes
    them, under their '【文档: doc<d>】' header."""
    sys.path.insert(0, str(ROOT))
    from portbench.traffic import ZipfChunks, indexed_text

    cfg = json.loads((ROOT / "portbench/configs/kb100k-bf16.json")
                     .read_text())
    corpus = ZipfChunks(cfg["corpus"]["texts"], n, seed=SEED)
    return [indexed_text(t, name)
            for t, name in zip(corpus.texts, corpus.doc_names)]


def test_tokenizer_library_builds_and_binds():
    lib = postings.library()
    assert lib is not None
    assert postings.library() is lib
    part, = postings.batch_postings(lib, ["Hello hello 世界!", "", "x"])
    assert (part.lo, part.hi) == (0, 3)
    assert part.terms == ["hello", "世界", "x"]
    assert part.doc_total.tolist() == [3, 0, 1]
    assert part.term_docs.tolist() == [1, 1, 1]
    assert part.doc.tolist() == [0, 0, 2] and part.tf.tolist() == [2, 1, 1]


def test_add_batch_matches_add_on_benchmark_chunks():
    texts = _bench_texts(600)
    assert all(t.startswith("【文档: doc") for t in texts)
    got = _index()
    got.add_batch(range(len(texts)), texts)
    want = _plain(range(len(texts)), texts)
    _assert_same(got, want)
    assert "文档" in got.vocab and got.doc_len[0] > 200
    got.compact()
    want.compact()
    _assert_same_layout(got._main, want._main)


CASES = {
    "mixed": [
        "Hello World 你好世界 hello", "日本語のテキスト and ENGLISH_words 42",
        "한국어 텍스트 mixed 中文", "emoji 🙂 between w1 and w2 🙃",
        "ＦＵＬＬＷＩＤＴＨ ｆｕｌｌ and café naïve", "a", "",
        "snake_case CamelCase x86_64 3.14159", "中", "— – … «quotes» ‘x’",
        "tab\tnew\nline\r\nend", "Ελληνικά Кириллица עברית العربية",
        "重复 重复 重复 repeat REPEAT Repeat",
    ],
    "empty_docs": ["", "word", "", "", "other word", "", "", "", "w"],
    "zero_terms": ["", "!!!", "   ", "🙂🙃", "— …", "\n\t", "ÀÉ", "«»",
                   "ß ü"],
    "folds": ["\u0130stanbul \u0130S \u0131I",
              "\u212aELVIN 5\u212a \u212aelvin", "AB\u0130 x", "\u0130",
              "\u212a", "\u4e2d\u0130\u6587\u212a\u4e2d",
              "\u017f long s", "plain K", "\u01c5ungla \u01f2"],
    "surrogates": ["a\ud800b", "\udfff中\ud83d文", "x\udc00", "w1 w2",
                   "\ud800", "ok", "中\udc80", "end", "more words"],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_add_batch_matches_add(case):
    texts = CASES[case]
    ids = list(range(3, 3 + 2 * len(texts), 2))[::-1]  # sparse, descending
    got = _index()
    got.add_batch(ids, texts)
    _assert_same(got, _plain(ids, texts))
    if case == "zero_terms":
        assert not got.vocab and got._total_tokens == 0
        assert got.n_docs == len(texts)


def test_every_code_point_tokenizes_as_add():
    """Every code point, surrogates included, inside a word that names it
    (upper-case letters on either side) and after a CJK character."""
    texts = [" ".join(f"X{cp:x}{chr(cp)}Y \u4e2d{chr(cp)}"
                      for cp in range(lo, lo + 4096))
             for lo in range(0, 0x110000, 4096)]
    got = _index()
    got.add_batch(range(len(texts)), texts)
    _assert_same(got, _plain(range(len(texts)), texts))


def test_fold_set_is_what_lower_changes():
    """The non-ASCII characters that the spec (which tokenizes
    str.lower()) makes more than a CJK unigram or a separator of are the
    two csrc/host/tokenizer.cc folds: U+0130 and U+212A."""
    changed = {chr(cp) for cp in range(0x80, 0x110000)
               if tokenize(chr(cp)) != ([chr(cp)] if _is_cjk(cp) else [])}
    assert changed == {"\u0130", "\u212a"}


def test_add_batch_sequence_matches_add():
    """add, small and large add_batch calls, deletes, compactions and
    searches in one order, against the same order done by add alone."""
    texts = _bench_texts(300) + CASES["mixed"]
    got, want = _index(), _index()
    steps = [("batch", 0, 120), ("search",), ("add", 120, 123),
             ("batch", 123, 128), ("delete", [5, 77, 121]),
             ("batch", 128, 250), ("search",), ("compact",),
             ("delete", [0, 130, 249]), ("batch", 250, len(texts)),
             ("search",), ("compact",)]
    queries = ["w1 w2 w30", "文档 doc3", "hello 你好", "w0"]
    for step in steps:
        if step[0] in ("batch", "add"):
            ids = list(range(step[1], step[2]))
            if step[0] == "batch":
                got.add_batch(ids, texts[step[1]:step[2]])
            else:
                _plain(ids, texts[step[1]:step[2]], into=got)
            _plain(ids, texts[step[1]:step[2]], into=want)
        elif step[0] == "delete":
            got.delete_docs(step[1])
            want.delete_docs(step[1])
        elif step[0] == "compact":
            got.compact()
            want.compact()
            _assert_same_layout(got._main, want._main)
        else:
            gs, gi = got.search(queries, 8)
            ws, wi = want.search(queries, 8)
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gs, ws)
            if got._tail_nnz:
                _assert_same_layout(got._tail_layout(), want._tail_layout())
        _assert_same(got, want)


def test_add_batch_splits_native_calls(monkeypatch):
    texts = _bench_texts(40)
    calls = []
    real = postings._call

    def counted(lib, blobs, lo, hi):
        calls.append((lo, hi))
        return real(lib, blobs, lo, hi)

    monkeypatch.setattr(postings, "_call", counted)
    monkeypatch.setattr(postings, "MAX_CALL_BYTES", 4 * max(map(len, texts)))
    got = _index()
    got.add_batch(range(40), texts)
    _assert_same(got, _plain(range(40), texts))
    assert len(calls) > 4 and calls[0][0] == 0 and calls[-1][1] == 40
    assert all(a[1] == b[0] for a, b in zip(calls, calls[1:]))
    with pytest.raises(ValueError):
        list(postings.batch_postings(postings.library(),
                                     ["x" * (postings.MAX_CALL_BYTES + 1)]))


@pytest.mark.parametrize("case", ["bench", "empty_docs", "zero_terms"])
def test_native_output_does_not_depend_on_threads(monkeypatch, case):
    """Each thread count, up to more threads than documents, gives the
    one-thread call's postings, array for array."""
    texts = _bench_texts(64) if case == "bench" else CASES[case]
    lib = postings.library()
    monkeypatch.setattr(postings, "MIN_THREAD_BYTES", 1)
    outs = []
    for threads in (1, 2, 3, 8, 64):
        monkeypatch.setattr(postings, "_cpus", lambda n=threads: n)
        part, = postings.batch_postings(lib, texts)
        outs.append(part)
    for part in outs[1:]:
        assert part.terms == outs[0].terms
        for name in ("doc_total", "term_docs", "doc", "tf"):
            np.testing.assert_array_equal(getattr(part, name),
                                          getattr(outs[0], name))
    got = _index()
    got.add_batch(range(len(texts)), texts)  # 64 threads at most
    _assert_same(got, _plain(range(len(texts)), texts))


def test_add_batch_paths_and_counters(monkeypatch):
    texts = _bench_texts(20)
    tracing.clear()
    _index().add_batch(range(20), texts)
    assert tracing.counters["ingest_native_docs"] == 20
    assert "ingest_python_docs" not in tracing.counters
    _index().add_batch(range(7), texts[:7])  # under NATIVE_MIN_DOCS
    assert tracing.counters["ingest_python_docs"] == 7
    # A text too long for one native call takes add().
    monkeypatch.setattr(postings, "MAX_CALL_BYTES", 4 * len(texts[0]) - 1)
    want = _plain(range(20), texts)
    got = _index()
    got.add_batch(range(20), texts)
    _assert_same(got, want)
    assert tracing.counters["ingest_python_docs"] == 27
    # No library: every document takes add().
    monkeypatch.setattr(postings, "library", lambda: None)
    got = _index()
    got.add_batch(range(20), texts)
    _assert_same(got, want)
    assert tracing.counters["ingest_python_docs"] == 47
    assert tracing.counters["ingest_native_docs"] == 20


def test_postings_are_untracked_by_the_collector(tmp_path):
    texts = _bench_texts(60) + CASES["mixed"]
    idx = _index()
    idx.add_batch(range(len(texts)), texts)
    idx.add(len(texts), "one more document 文档")
    idx.delete_docs([1, 2])
    idx.compact()
    idx.save(tmp_path / "inv")
    loaded = InvertedIndex.load(tmp_path / "inv", device="cpu")
    for each in (idx, loaded):
        bufs = each._postings_doc + each._postings_tf
        assert bufs and all(type(b) is bytearray for b in bufs)
        assert not any(gc.is_tracked(b) for b in bufs)
    assert loaded._postings_doc == idx._postings_doc
    assert loaded._postings_tf == idx._postings_tf


def _npz(path) -> dict:
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def test_jax_saved_index_loads_into_the_port_and_back(tmp_path):
    texts = _bench_texts(80) + CASES["mixed"]
    jidx = JaxInvertedIndex(JaxBM25Config(packed_merge=False))
    jidx.add_batch(range(len(texts)), texts)
    jidx.delete_docs([4, 9])
    jidx.save(tmp_path / "jax")
    port = InvertedIndex.load(tmp_path / "jax", device="cpu")
    port.save(tmp_path / "port")
    want, got = _npz(tmp_path / "jax.npz"), _npz(tmp_path / "port.npz")
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    back = JaxInvertedIndex.load(tmp_path / "port")
    assert back.vocab == jidx.vocab and back.doc_len == jidx.doc_len
    assert back._postings_doc == jidx._postings_doc
    assert back._postings_tf == jidx._postings_tf
    assert back._dead == jidx._dead


def test_save_writes_the_flat_format(tmp_path):
    idx = _index()
    texts = ["b a b", "c", "a a d"] * 4
    idx.add_batch(range(12), texts)
    idx.save(tmp_path / "inv")
    data = _npz(tmp_path / "inv.npz")
    offs = data["post_offsets"]
    assert offs.dtype == np.int64 and offs[-1] == len(data["post_doc"])
    assert data["post_doc"].dtype == np.int32
    tid = idx.vocab["a"]
    assert data["post_doc"][offs[tid]:offs[tid + 1]].tolist() == [
        0, 2, 3, 5, 6, 8, 9, 11]
    assert data["post_tf"][offs[tid]:offs[tid + 1]].tolist() == [1, 2] * 4
    assert inverted._ints(idx._postings_tf[tid]).tolist() == [1, 2] * 4
