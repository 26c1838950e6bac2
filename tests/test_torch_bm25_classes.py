"""The keyword leg's query classing, held to its rules in plain Python.

``InvertedIndex`` resolves each query's terms against a segment layout
and splits the batch into classes: queries without wide terms take K2's
classed path (``merge_segsum_topk_classes``, or ``segsum_topk_candidates``
on ``slot_rows`` past K2's lanes), queries holding a wide term split into
a narrow and a wide side for K3 (``merge_segsum_full_classes``) and K4
(``combine_topk_classes``). The oracle below restates the class-key rules
one query and one term at a time:

- classed path: p_max is the largest bucket width of the query's terms in
  the layout (16 when it has none), rounded up ``width_ladder``; t_max is
  the next power of two of its term count, terms absent from the layout
  included, each term in its slot in query order;
- narrow side of a wide query: the same rule over its narrow in-layout
  terms only, moved to the front in order;
- wide side: the largest wide bucket width, not rounded, and the next
  power of two of the wide term count.

Classes come in the order their first member appears, members in batch
order. The recorders check every class key, member list and slot array
each kernel wrapper receives, on the main segment and on a tail.
"""

import math

import numpy as np
import pytest
import torch

from tpurag_torch.core.config import BM25Config
from tpurag_torch.index import inverted
from tpurag_torch.index.inverted import InvertedIndex, full_cbits, packed_cbits
from tpurag_torch.ingest.tokenizer import tokenize_query
from tpurag_torch.kernels.bm25_merge import merge_ok

N_DOCS = 600
# Terms of a known document frequency: buckets 16, 16, 32, 64, 128, 128,
# 256, 512 and 1024 wide.
DFS = {"d3": 3, "d10": 10, "d20": 20, "d40": 40, "d70": 70, "d100": 100,
       "d200": 200, "d300": 300, "d550": 550}
QUERIES = [
    "d3 d10",                       # narrow only
    "d20 d200 d3",                  # narrow and wide
    "d300",                         # wide only
    "zzz qqq",                      # out of vocabulary only
    "tailonly d10",                 # a term only the tail holds
    "d550 d3 d40",                  # d550 is past max_df_ratio 0.9
    "d70 zzz d100 d20",             # OOV between in-layout terms
    "d300 d200 d3 d10 d20",         # several wide widths
    " ".join(["d300"] + [f"n{j}" for j in range(16)]),  # past K2's lanes
]
CONFIGS = {
    "default": dict(),
    "wide64": dict(wide_term_width=64, width_ladder=(32, 64),
                   max_df_ratio=0.9),
    "no_ladder": dict(wide_term_width=128, width_ladder=()),
}


def _index(**cfg):
    idx = InvertedIndex(BM25Config(packed_merge=False, **cfg), device="cpu")
    texts = []
    for i in range(N_DOCS):
        words = [t for t, df in DFS.items() if (i * 7919) % N_DOCS < df]
        words += [f"n{j}" for j in range(40) if (i + j) % 37 == 0]
        texts.append(" ".join(words + ["pad"] * (i % 13)))
    idx.add_batch(range(N_DOCS), texts)
    return idx


def _add_tail(idx):
    idx.add_batch(range(N_DOCS, N_DOCS + 10),
                  [f"tailonly d3 d70 n{i} d300" for i in range(10)])


def _rows(idx, queries):
    """Each query's term ids as the index scores them: in vocabulary and
    within max_df_ratio."""
    cap = int(idx.config.max_df_ratio * max(idx.n_docs, 1))
    return [[idx.vocab[t] for t in tokenize_query(q) if t in idx.vocab
             and (idx.config.max_df_ratio >= 1.0 or idx._df(idx.vocab[t])
                  <= cap)] for q in queries]


def _pow2(n):
    p = 1
    while p < n:
        p *= 2
    return p


def _oracle(idx, rows, layout, k):
    """The calls one segment's scoring makes, as the class-key rules
    give them: ("topk", classes), ("slot_rows", class) for each class past
    K2's lanes, then ("full", narrow, wide, h, wn_max) and ("combine",
    [(sel, narrow widths)], window)."""
    cfg = idx.config
    tb, tr, tl = layout.term_bucket, layout.term_row, layout.term_len
    n_live = max(idx.n_docs, 1)
    cbits = packed_cbits(len(idx.doc_len), cfg.packed_merge)

    def in_layout(t):
        return t < len(tb) and tb[t] > 0

    def slot(t):
        if not in_layout(t):
            return 0, 0, 0, 0.0
        df = min(idx._df(t), n_live)
        return (int(tb[t]), int(tr[t]) + 1, int(tl[t]),
                math.log(1.0 + (n_live - df + 0.5) / (df + 0.5)))

    def ladder(p):
        for w in sorted(cfg.width_ladder):
            if w >= p:
                return w
        return p

    def classes(members):
        """members: (output row, key, terms in slot order)."""
        groups = {}
        for out, key, terms in members:
            groups.setdefault(key, []).append((out, terms))
        out = []
        for (p, t), mem in groups.items():
            arr = np.zeros((4, len(mem), t))
            for g, (_, terms) in enumerate(mem):
                for j, term in enumerate(terms):
                    arr[:, g, j] = slot(term)
            out.append((p, t, np.array([o for o, _ in mem], np.int64),
                        *arr[:3].astype(np.int32), arr[3].astype(np.float32)))
        return out

    wide_w = cfg.wide_term_width

    def is_wide(t):
        return in_layout(t) and tb[t] > wide_w

    simple = [(bi, (ladder(max((int(tb[t]) for t in r if in_layout(t)),
                               default=16)), _pow2(len(r))), r)
              for bi, r in enumerate(rows) if not any(map(is_wide, r))]
    hard = [r for r in rows if any(map(is_wide, r))]
    calls = []
    if simple:
        cls = classes(simple)
        calls.append(("topk", [(p, t, cbits, *rest) for p, t, *rest in cls
                               if merge_ok(p * t)]))
        calls += [("slot_rows", c) for c in cls if not merge_ok(c[0] * c[1])]
    if hard:
        narrow = [[t for t in r if in_layout(t) and not is_wide(t)]
                  for r in hard]
        wide = [[t for t in r if is_wide(t)] for r in hard]
        n_cls = classes([(hi, (ladder(max((int(tb[t]) for t in r),
                                          default=16)), _pow2(len(r))), r)
                         for hi, r in enumerate(narrow)])
        w_cls = classes([(hi, (max(int(tb[t]) for t in r), _pow2(len(r))),
                          r) for hi, r in enumerate(wide)])

        def spec(c):
            return (c[0], c[1], full_cbits(c[0] * c[1], c[1], cbits), *c[2:])

        calls.append(("full", [spec(c) for c in n_cls],
                      [spec(c) for c in w_cls], len(hard),
                      max(p * t for p, t, *_ in n_cls)))
        n_width = np.zeros(len(hard), np.int64)
        for p, t, sel, *_ in n_cls:
            n_width[sel] = p * t
        calls.append(("combine", [(c[2], n_width[c[2]]) for c in w_cls],
                      max(2, max(c[1] for c in n_cls)
                          + max(c[1] for c in w_cls))))
    return calls


def _recorders(monkeypatch):
    calls = []

    def wrap(name, record):
        real = getattr(inverted, name)

        def rec(*args, **kw):
            calls.append(record(*args, **kw))
            return real(*args, **kw)

        monkeypatch.setattr(inverted, name, rec)

    def copy(cls):
        return tuple(np.array(x) if isinstance(x, np.ndarray) else x
                     for x in cls)

    wrap("merge_segsum_topk_classes",
         lambda widths, mats, classes, *_: ("topk",
                                            [copy(c) for c in classes]))
    wrap("slot_rows", lambda widths, mats, bw, rowid, live, idf, p, t: (
        "slot_rows", copy((p, t, None, bw, rowid, live, idf))))
    wrap("merge_segsum_full_classes",
         lambda widths, mats, narrow, wide, h, wn_max: (
             "full", [copy(c) for c in narrow], [copy(c) for c in wide], h,
             wn_max))
    wrap("combine_topk_classes",
         lambda n_val, n_doc, classes, k, window: (
             "combine", [(np.array(c[2]), np.array(c[3])) for c in classes],
             window))
    return calls


def _same_class(got, want, with_sel=True):
    assert got[:2] == want[:2]
    for g, w in zip(got[2:], want[2:]):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype, (g.dtype, w.dtype)
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w


def _same_calls(got, want):
    # A class with no member launches nothing: an empty batch may pass one.
    def members(calls):
        out = []
        for c in calls:
            if c[0] == "topk":
                c = ("topk", [x for x in c[1] if len(x[3])])
                if not c[1]:
                    continue
            out.append(c)
        return out

    got, want = members(got), members(want)
    assert [c[0] for c in got] == [c[0] for c in want]
    for g, w in zip(got, want):
        if g[0] == "topk":
            assert len(g[1]) == len(w[1])
            for gc, wc in zip(g[1], w[1]):
                _same_class(gc, wc)
        elif g[0] == "slot_rows":
            _same_class(g[1][:2] + g[1][3:], w[1][:2] + w[1][3:])
        elif g[0] == "full":
            for gs, ws in ((g[1], w[1]), (g[2], w[2])):
                assert len(gs) == len(ws)
                for gc, wc in zip(gs, ws):
                    _same_class(gc, wc)
            assert g[3:] == w[3:]
        else:
            assert len(g[1]) == len(w[1]) and g[2] == w[2]
            for (gs, gw), (ws, ww) in zip(g[1], w[1]):
                np.testing.assert_array_equal(gs, ws)
                np.testing.assert_array_equal(gw, ww)


@pytest.mark.parametrize("batch", ["empty", "single", "mixed"])
@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_classes_follow_the_key_rules(monkeypatch, cfg, batch):
    idx = _index(**CONFIGS[cfg])
    batches = {"empty": [[]], "single": [[q] for q in QUERIES],
               "mixed": [QUERIES, QUERIES[::-1]]}[batch]
    calls = _recorders(monkeypatch)
    seen = set()
    for tail in (False, True):
        if tail:
            _add_tail(idx)
        for queries in batches:
            calls.clear()
            s, i = idx.search(queries, 8)
            assert s.shape == i.shape == (len(queries), 8)
            rows = _rows(idx, queries)
            want = _oracle(idx, rows, idx._main, 8)
            if tail:
                assert idx._tail_nnz and idx._tail is not None
                want += _oracle(idx, rows, idx._tail, 8)
            _same_calls(calls, want)
            seen.update(c[0] for c in want)
    if batch == "mixed":
        # The default config has no wide term at this corpus size, and its
        # 17-term query is past K2's lanes; the others send it to K3.
        assert seen == ({"topk", "slot_rows"} if cfg == "default"
                        else {"topk", "full", "combine"})


def test_search_of_no_query_is_empty():
    idx = _index()
    for as_device in (False, True):
        s, i = idx.search([], 5, as_device=as_device)
        assert tuple(s.shape) == tuple(i.shape) == (0, 5)
        assert isinstance(s, torch.Tensor) == as_device
