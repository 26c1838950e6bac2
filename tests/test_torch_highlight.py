"""tpurag_torch.index.highlighter: the batched native highlighter against
index.inverted.highlight, its spec, string for string.

The native path (csrc/host/highlight.cc, built by the host's C++
compiler) must equal the Python function on the benchmark's own corpus
and on adversarial input, route what it cannot match byte for byte to
the Python function, and give the same output from concurrent callers.
"""

import json
import pathlib
import re
import sys
import threading

import _sre
import numpy as np
import pytest

from tpurag_torch.index import highlighter
from tpurag_torch.index.highlighter import highlight_batch, native_tokens
from tpurag_torch.index.inverted import highlight
from tpurag_torch.ingest.tokenizer import tokenize_query
from tpurag_torch.kernels import runtime

ROOT = pathlib.Path(__file__).resolve().parent.parent
# The non-ASCII characters Python 3.12's re.IGNORECASE matches to ASCII.
FOLDS = {"\u0130", "\u0131", "\u017f", "\u212a"}  # İ, ı, ſ, Kelvin sign


def _spec(texts, tokens, which, mark="**"):
    return [highlight(t, tokens[q], mark) for t, q in zip(texts, which)]


def test_host_library_builds_and_loads():
    lib = runtime.load_host_library()
    assert lib is not None, runtime.host_build_info
    path = pathlib.Path(runtime.host_build_info["path"])
    assert path.parent == runtime.BUILD_DIR and path.exists()
    assert runtime.load_host_library() is lib


@pytest.fixture(scope="module")
def bench_pairs():
    """2,048 (chunk, query) pairs from the benchmark's own generator and
    query plan: 256 queries, 8 chunks each, half of them chunks holding
    one of the query's words as a substring."""
    sys.path.insert(0, str(ROOT))
    from portbench.traffic import ZipfChunks

    cfg = json.loads((ROOT / "portbench/configs/kb100k-bf16.json")
                     .read_text())
    plan = json.loads((ROOT / "portbench/workloads/zipf8-hybrid-b512.json")
                      .read_text())["queries"]
    corpus = ZipfChunks(cfg["corpus"]["texts"], 400, seed=2**31 + 16)
    queries = corpus.queries(plan, 0, 256, seed=2**31 + 16)
    rng = np.random.default_rng(16)
    texts, which = [], []
    for b, q in enumerate(queries):
        words = q.split()
        holding = [i for i, t in enumerate(corpus.texts)
                   if any(w in t for w in words)]
        for j in range(8):
            pool = holding if holding and j % 2 == 0 else corpus.texts
            i = rng.integers(0, len(pool))
            texts.append(corpus.texts[pool[i]] if pool is holding
                         else corpus.texts[i])
            which.append(b)
    return texts, [tokenize_query(q) for q in queries], which


def test_benchmark_corpus_equals_python(bench_pairs):
    texts, tokens, which = bench_pairs
    assert len(texts) >= 2000
    got, fallbacks = highlight_batch(texts, tokens, which)
    assert fallbacks == 0
    want = _spec(texts, tokens, which)
    assert sum(g != t for g, t in zip(got, texts)) > len(texts) // 2
    assert got == want


def test_shuffled_query_order_equals_python(bench_pairs):
    texts, tokens, which = bench_pairs
    order = np.random.default_rng(3).permutation(len(texts))
    texts = [texts[i] for i in order]
    which = [which[i] for i in order]
    got, fallbacks = highlight_batch(texts, tokens, which, mark="<em>")
    assert fallbacks == 0
    assert got == _spec(texts, tokens, which, "<em>")


LONG = "x" * 65
MANY = [f"t{i}" for i in range(40)]  # more than one 64-bit word of tokens

# (id, text, tokens, mark, fallbacks)
CASES = [
    ("prefixes", "w1 w15 w152 w1520 xw15 w1w15w152", ["w1", "w15", "w152"],
     "**", 0),
    ("overlap", "abcabcab aaaaa bcab", ["abc", "bca", "cab", "aa", "aaa"],
     "**", 0),
    ("upper_text", "The QUICK Brown fOx, THE end", ["quick", "fox", "the"],
     "**", 0),
    ("upper_tokens", "quick Quick QUICK", ["QUICK", "Qu"], "**", 0),
    ("cjk_header", "【文档: doc1】\n检索增强生成 检索 DOC1 doc12",
     tokenize_query("检索增强 doc1 文档"), "**", 0),
    ("kana_hangul", "ひらがな カタカナ 한국어 한국", tokenize_query("ひらがな 한국어"),
     "**", 0),
    ("emoji", "😀w1😀 w1😀 😀😀", ["w1", "😀", "😀😀"], "**", 0),
    ("dotted_I", "\u0130stanbul is big", ["is"], "**", 1),
    ("dotless_i", "\u0131s is", ["is"], "**", 1),
    ("long_s", "\u017ftar star", ["star"], "**", 1),
    ("kelvin", "\u212aelvin kelvin", ["kelvin"], "**", 1),
    ("fold_char_no_token", "\u0130 only", ["zz"], "**", 1),
    ("metachars", r"a.b a|b (x) [y] * \ $^ a+b", ["a.b", "(x)", "[y]", "*",
                                                 "\\", "$^", "a|b", "+"],
     "**", 0),
    ("no_tokens", "some text", [], "**", 0),
    ("empty_token", "some text", ["", "text"], "**", 0),
    ("only_empty_token", "some text", [""], "**", 0),
    ("duplicates", "dup dup DUP", ["dup", "dup", "DUP", "du"], "**", 0),
    ("empty_text", "", ["a", "b"], "**", 0),
    ("token_longer_than_text", "ab", ["abc", "abcdef"], "**", 0),
    ("other_mark", "mark the words", ["mark", "words"], "<em>", 0),
    ("non_ascii_mark", "mark the words", ["mark", "words"], "⟦", 0),
    ("non_ascii_text", "café CAFÉ cafe naïve", ["caf", "na"], "**", 0),
    ("cased_non_ascii_token", "café CAFÉ", ["é"], "**", 1),
    ("token_over_64_bytes", LONG + " " + LONG.upper(), [LONG], "**", 1),
    ("many_tokens", " ".join(MANY + ["T39x", "t1t2"]), MANY, "**", 0),
    ("surrogates", "😀 x\ud800y x", ["x", "\ud800"], "**", 0),
    ("underscore_digits", "a_1 A_1 _1_", ["a_1", "_1"], "**", 0),
]


@pytest.mark.parametrize("text,tokens,mark,fallbacks",
                         [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_adversarial_equals_python(text, tokens, mark, fallbacks):
    got, fb = highlight_batch([text], [tokens], [0], mark)
    assert got == [highlight(text, tokens, mark)]
    assert fb == fallbacks


def test_adversarial_in_one_batch():
    """Every case in one call, twice over, interleaved with ASCII texts:
    the code-point walk over mixed texts and per-text fallbacks."""
    texts, tokens, which = [], [], []
    for k, (_, text, toks, _, _) in enumerate(CASES):
        tokens.append(toks)
        texts += [text, "w1 W15 plain " + text[:3], text]
        which += [k, k, k]
    got, fb = highlight_batch(texts, tokens, which)
    assert got == _spec(texts, tokens, which)
    assert fb == sum(highlight_batch([t], [tokens[q]], [0])[1]
                     for t, q in zip(texts, which))


def test_without_the_library_every_text_takes_python(monkeypatch,
                                                     bench_pairs):
    texts, tokens, which = bench_pairs
    monkeypatch.setattr(highlighter, "load_host_library", lambda: None)
    got, fallbacks = highlight_batch(texts[:50], tokens, which[:50])
    assert fallbacks == 50
    assert got == _spec(texts[:50], tokens, which[:50])


def test_fold_set_is_the_four():
    """Brute force over every non-ASCII code point: the characters that
    re.IGNORECASE matches to an ASCII literal are exactly FOLDS."""
    rest = "".join(chr(c) for c in range(0x80, sys.maxunicode + 1))
    found = set()
    for a in range(0x80):
        found.update(re.compile(re.escape(chr(a)), re.IGNORECASE)
                     .findall(rest))
    assert found == FOLDS


def test_native_token_characters_match_only_themselves():
    """Every non-ASCII character the gate lets through is one re
    compiles to a plain literal under IGNORECASE (not cased), and every
    character tokenize_query can emit besides ASCII is let through."""
    let_through = [c for c in map(chr, range(0x80, sys.maxunicode + 1))
                   if native_tokens([c])]
    assert not [c for c in let_through if _sre.unicode_iscased(ord(c))]
    cjk = re.compile(r"[぀-ヿ㐀-䶿一-鿿가-힯]")
    emitted = [chr(c) for c in range(0x80, 0x10000) if cjk.match(chr(c))]
    assert native_tokens(emitted)
    assert not native_tokens(["é"]) and not native_tokens(sorted(FOLDS)[:1])


def test_concurrent_callers_get_the_one_thread_output(bench_pairs):
    texts, tokens, which = bench_pairs
    want = highlight_batch(texts, tokens, which)
    barrier = threading.Barrier(2)
    outs = [None, None]

    def run(k):
        barrier.wait()
        outs[k] = [highlight_batch(texts, tokens, which) for _ in range(3)]

    threads = [threading.Thread(target=run, args=(k,)) for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert all(o == want for out in outs for o in out)


def test_query_index_out_of_range_raises():
    with pytest.raises(IndexError):
        highlight_batch(["text"], [["t"]], [1])
