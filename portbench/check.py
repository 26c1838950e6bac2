"""The comparison that decides `correct`, and the recall reference.

The program's answer to a query is a fused list of (chunk id, fused
score, found_in). Each fused score is a sum of reciprocal ranks, so it
names the rank the id held in each leg: the check decodes those claims
and holds each one to the plain reference (portbench/reference), which
rebuilds both legs from the generated inputs. Three numbers come out of
a sample of the window's answers:

- ``dense_gap`` (cosine): for each id the answer places at vector rank
  r, how far its exact score lies from the reference's r-th best, in a
  cell whose dense leg is exact (K1); in a cell whose dense leg is
  approximate by design (IVF probes, int8 candidates) how far it lies
  above the reference's r-th best, or above an id the answer ranks
  before it. Either way, how far below the preset's score floor.
- ``keyword_gap`` (share of the query's best BM25 score): for each id at
  keyword rank r, how far its exact BM25 score lies from the reference's
  r-th best.
- ``bad_answers`` (queries): answers that break a rule no rounding can
  explain: ids repeated or outside the corpus, text or document name not
  the chunk's, scores out of order, a fused score that no pair of ranks
  gives, two ids at one rank, a keyword hit past a gate the reference
  shuts by a margin, or a leg's rank missing that the fusion must have
  kept (that the reference's leg holds by a margin).

In a mode that runs one leg alone (``vector``, ``ivf``, ``keyword``) the
answer's scores are that leg's own: each id at rank r is held to the
reference's r-th best as above, its reported score to the reference's
score of it, and the answer to as many ids as the reference's leg holds.

Ties and near-ties cost nothing: every gap compares the reference's
scores, never the ids it would have picked.
"""

from __future__ import annotations

import itertools

import numpy as np

from portbench.reference import bm25 as bm25_ref
from portbench.reference import fusion

TOL_FUSED = 1e-6    # a fused score's float32 rounding, decoded
TOL_FLOOR = 1e-4    # dense scores this near the floor may fall either side
TOL_GATE = 1e-3     # keyword gates this near their threshold may go either way
MAX_ASSIGNMENTS = 4096


# The legs each search mode runs: two fused by reciprocal rank, or one
# whose own scores are the answer.
LEGS = {"hybrid": ("vector", "keyword"), "hybrid_ivf": ("vector", "keyword"),
        "vector": ("vector",), "ivf": ("vector",), "keyword": ("keyword",)}


class Cell:
    """What the comparison reads of a cell."""

    def __init__(self, config: dict, traffic: dict):
        self.preset = config["preset"]
        self.final_k = traffic["top_k"]
        self.mode = traffic["mode"]
        self.legs = LEGS[self.mode]
        self.fused = len(self.legs) == 2
        # A leg alone answers final_k of its own.
        self.vtop = self.preset["vector_top_k"] if self.fused else self.final_k
        self.ktop = self.preset["keyword_top_k"] if self.fused else self.final_k
        # The dense scores' precision: an int8 KB rescores its candidates
        # exactly with fp32 queries (K8); otherwise queries meet the rows
        # in the stored type. A traffic file may state it.
        self.precision = traffic.get("query_precision") or (
            "float32" if config["quant"] else config["dtype"])
        # The dense leg is exact only where K1 scans every row.
        self.exact_dense = (not config["quant"]
                            and self.mode in ("hybrid", "vector"))
        self.rv = fusion.rank_scores(self.preset["vector_weight"],
                                     self.preset["rrf_k"], self.vtop)
        self.rk = fusion.rank_scores(self.preset["keyword_weight"],
                                     self.preset["rrf_k"], self.ktop)
        self.both = fusion.both_score(self.rv, self.rk,
                                      self.preset["both_bonus"])


def keyword_facts(bm: bm25_ref.BM25, text: str, ktop: int, dtype=None):
    """(docs, scores, the ktop best scores, the ktop best docs, idf mass)
    of one query."""
    docs, scores = bm.scores(text, dtype)
    best_s, best_d = bm25_ref.top(docs, scores, ktop)
    return docs, scores, best_s, best_d, bm.idf_mass(text)


def compare(cell: Cell, answers, qv, texts, dense, bm, n_chunks: int):
    """answers: per query, a list of (id, fused score, found_in bits,
    text ok). Returns {"dense_gap", "keyword_gap", "bad_answers"}."""
    q = len(answers)
    if q == 0:
        return {"dense_gap": 0.0, "keyword_gap": 0.0, "bad_answers": 0}
    width = max(1, max(len(a) for a in answers))
    ids = np.full((q, width), -1, np.int64)
    for i, a in enumerate(answers):
        for j, (cid, *_rest) in enumerate(a):
            ids[i, j] = cid if 0 <= cid < n_chunks else -1
    if "vector" in cell.legs:
        dv_s, _ = dense.top(qv, cell.vtop, cell.precision)
        dscore = dense.scores_of(qv, ids, cell.precision)
    else:
        dv_s = dscore = np.zeros((q, 0))
    judge = _judge if cell.fused else _judge_leg
    d_gap = k_gap = 0.0
    bad = 0
    for i, a in enumerate(answers):
        facts = (keyword_facts(bm, texts[i], cell.ktop)
                 if "keyword" in cell.legs else None)
        ok, dg, kg = judge(cell, a, dv_s[i], dscore[i], facts, n_chunks)
        bad += not ok
        d_gap, k_gap = max(d_gap, dg), max(k_gap, kg)
    return {"dense_gap": float(d_gap), "keyword_gap": float(k_gap),
            "bad_answers": int(bad)}


def _well_formed(cell: Cell, answer, n_chunks: int) -> bool:
    """At most final_k ids, each once, each in the corpus, each with its
    chunk's text and document name."""
    cids = [r[0] for r in answer]
    return (len(answer) <= cell.final_k and len(set(cids)) == len(cids)
            and all(0 <= c < n_chunks for c in cids)
            and all(r[3] for r in answer))


def _keyword_at(docs, scores, cids) -> np.ndarray:
    """The reference's BM25 score of each id (0 where it holds no query
    token)."""
    if not len(docs):
        return np.zeros(len(cids))
    pos = np.clip(np.searchsorted(docs, cids), 0, len(docs) - 1)
    return np.where(docs[pos] == np.asarray(cids), scores[pos], 0.0)


def _judge_leg(cell: Cell, answer, dv_s, dscore, facts, n_chunks: int):
    """(sound, dense gap, keyword gap) of one answer of a single-leg
    mode: the leg's own ids and scores, best first."""
    sound = _well_formed(cell, answer, n_chunks)
    bit = fusion.VECTOR if cell.legs == ("vector",) else fusion.KEYWORD
    for (_, s0, *_), (_, s1, *_) in zip(answer, answer[1:]):
        sound &= s0 >= s1
    sound &= all(r[2] == bit for r in answer)
    claimed = np.array([r[1] for r in answer], np.float64)
    dg = kg = 0.0
    if bit == fusion.VECTOR:
        floor = cell.preset["min_vector_score"]
        mine = np.asarray(dscore[:len(answer)], np.float64)
        if len(answer):
            dg = max(float(np.max(np.abs(claimed - mine))),
                     float(np.max(floor - mine)))
            if cell.exact_dense:
                dg = max(dg, float(np.max(np.abs(dv_s[:len(answer)] - mine))))
            else:
                dg = max(dg, float(np.max(mine - dv_s[:len(answer)])),
                         float(np.max(np.diff(mine), initial=0.0)))
        if cell.exact_dense:  # every row above the floor by a margin
            sound &= len(answer) >= int(np.sum(dv_s >= floor + TOL_FLOOR))
        return sound, max(dg, 0.0), kg
    docs, scores, ks, _, _ = facts
    mine = _keyword_at(docs, scores, [r[0] for r in answer])
    for r in range(len(answer)):
        if r >= len(ks) or ks[0] <= 0:
            kg = 1.0
            continue
        kg = max(kg, abs(ks[r] - mine[r]) / ks[0],
                 abs(claimed[r] - mine[r]) / ks[0])
    sound &= len(answer) >= min(cell.final_k, len(docs))
    return sound, 0.0, kg


def _judge(cell: Cell, answer, dv_s, dscore, facts, n_chunks: int):
    """(sound, dense gap, keyword gap) of one fused answer."""
    docs, scores, ks, _, mass = facts
    best = ks[0] if len(ks) else -np.inf
    thr = cell.preset["min_keyword_coverage"] * mass
    gate_shut = best < thr * (1 - TOL_GATE)
    gate_open = best >= thr * (1 + TOL_GATE)
    sound = _well_formed(cell, answer, n_chunks)
    cids = [r[0] for r in answer]
    for (c0, s0, *_), (c1, s1, *_) in zip(answer, answer[1:]):
        if not (s0 > s1 or (s0 == s1 and c0 < c1)):
            sound = False
    options = []
    for _, s, bits, _ in answer:
        opts = []
        if bits == fusion.VECTOR:
            opts = [(r, None) for r in np.flatnonzero(
                np.abs(cell.rv - s) <= TOL_FUSED)]
        elif bits == fusion.KEYWORD:
            opts = [(None, r) for r in np.flatnonzero(
                np.abs(cell.rk - s) <= TOL_FUSED)]
        elif bits == fusion.VECTOR | fusion.KEYWORD:
            opts = [tuple(x) for x in np.argwhere(
                np.abs(cell.both - s) <= TOL_FUSED)]
        if not opts:
            sound = False
            opts = [(None, None)]
        options.append(opts)
    kscore = _keyword_at(docs, scores, cids)
    n_v = (int(np.sum(dv_s >= cell.preset["min_vector_score"] + TOL_FLOOR))
           if cell.exact_dense else 0)
    n_k = min(cell.ktop, len(docs)) if gate_open else 0
    # A full answer may have cut a leg's entry no better than its last;
    # a shorter one has cut nothing.
    floor_fused = (min(r[1] for r in answer)
                   if len(answer) == cell.final_k else -np.inf)
    best_pick = None
    for pick in itertools.islice(itertools.product(*options),
                                 MAX_ASSIGNMENTS):
        vr = [p[0] for p in pick if p[0] is not None]
        kr = [p[1] for p in pick if p[1] is not None]
        if len(set(vr)) != len(vr) or len(set(kr)) != len(kr):
            continue
        broken = False
        dg = kg = 0.0
        claims = sorted((p[0], dscore[j]) for j, p in enumerate(pick)
                        if p[0] is not None)
        for r, s in claims:
            dg = max(dg, cell.preset["min_vector_score"] - s)
            if cell.exact_dense:
                dg = max(dg, abs(dv_s[r] - s))
            else:
                dg = max(dg, s - dv_s[r])
        if not cell.exact_dense:
            for (_, s0), (_, s1) in zip(claims, claims[1:]):
                dg = max(dg, s1 - s0)
        for j, p in enumerate(pick):
            if p[1] is None:
                continue
            if gate_shut:
                broken = True
            kg = max(kg, 1.0 if p[1] >= len(ks)
                     else abs(ks[p[1]] - kscore[j]) / ks[0])
        for have, n, table in ((set(vr), n_v, cell.rv),
                               (set(kr), n_k, cell.rk)):
            for r in range(n):
                if r not in have and table[r] > floor_fused + TOL_FUSED:
                    broken = True
        key = (broken, max(dg, kg))
        if best_pick is None or key < best_pick[0]:
            best_pick = (key, dg, kg)
    if best_pick is None:
        return False, 0.0, 0.0
    (broken, _), dg, kg = best_pick
    return sound and not broken, max(dg, 0.0), kg


def reference_answers(cell: Cell, qv, texts, dense, bm, dense_precision,
                      keyword_dtype=None):
    """The reference put in the program's place: each query's fused
    (ids, scores, bits), its dense leg at `dense_precision` and its
    keyword contributions rounded to `keyword_dtype` (None: float64).
    The control calls it at the precisions below the configuration's."""
    b = len(texts)
    v_ids = np.full((b, cell.vtop), -1, np.int64)
    v_s = np.full((b, cell.vtop), -np.inf)
    if "vector" in cell.legs:
        v_s, dv_i = dense.top(qv, cell.vtop, dense_precision)
        v_ids = fusion.dense_leg(v_s, dv_i, cell.preset)
    k_ids = np.full((b, cell.ktop), -1, np.int64)
    k_s = np.full((b, cell.ktop), -np.inf)
    cache: dict = {}
    for i, t in enumerate(texts) if "keyword" in cell.legs else ():
        if t not in cache:
            _, _, ks, kd, mass = keyword_facts(bm, t, cell.ktop,
                                               keyword_dtype)
            row = np.full(cell.ktop, -1, np.int64)
            if len(ks) and (not cell.fused
                            or fusion.gate_open(ks[0], mass, cell.preset)):
                row[:len(kd)] = kd
            cache[t] = (row, ks)
        k_ids[i] = cache[t][0]
        k_s[i, :len(cache[t][1])] = cache[t][1]
    if cell.fused:
        return fusion.rrf(v_ids, k_ids, cell.preset, cell.final_k)
    ids, s = (v_ids, v_s) if cell.legs == ("vector",) else (k_ids, k_s)
    bit = fusion.VECTOR if cell.legs == ("vector",) else fusion.KEYWORD
    s = np.where(ids >= 0, s, -np.inf)
    return ids, s, np.where(ids >= 0, bit, 0)


def as_answers(ids, fused, bits):
    """reference_answers' arrays as compare()'s answer lists."""
    return [[(int(c), float(s), int(b), True)
             for c, s, b in zip(ri, rs, rb) if c >= 0]
            for ri, rs, rb in zip(ids, fused, bits)]


def recall(cell: Cell, port_ids, qv, texts, dense, bm) -> float:
    """Share of the reference's exact hybrid top-k ids (fp32 cosine over
    the generated vectors, float64 BM25, the same fusion) that the
    program's top-k holds, over every query it answered."""
    ref_ids, _, _ = reference_answers(cell, qv, texts, dense, bm,
                                      "float32_exact")
    found = total = 0
    for got, want in zip(port_ids, ref_ids):
        want = set(int(x) for x in want if x >= 0)
        found += len(want.intersection(got))
        total += len(want)
    return found / max(total, 1)
