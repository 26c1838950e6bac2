"""Seeded inputs for the hybrid fusion step (``kernels.fusion.fuse_legs``),
shared by its CPU tests and its card tests (no JAX here).

Each case is a batch of the two legs' hits as numpy arrays: rank-ordered
dense hits (fp32 scores, int32 ids, -1 empty) and keyword hits, ids drawn
from a small pool so that the legs share some, plus the keyword gate's
idf masses. Rows 0-3 hold the edges:

- row 0: the best keyword score exactly fp32(cov) * mass (the gate keeps
  it), and a dense score exactly fp32(min_vector_score) (the floor keeps
  it);
- row 1: both one float below those (both dropped);
- row 2: ids X < Y at swapped ranks in the two legs (dense Y, X; keyword
  X, Y): with equal weights their fused scores are equal, and X goes
  first;
- row 3: every slot empty.
"""

import dataclasses

import numpy as np

GATES = ("on", "off", "compat")
NEG_INF = np.float32(-3.0e38)


def preset_for(preset, gate: str, final_k: int):
    """The preset with its final_k, and the gate switched off for "off"
    (min_keyword_coverage 0). "compat" leaves the preset as it is: the
    caller switches the gate off by the index's rank-compat scores."""
    kw = {"final_top_k": final_k}
    if gate == "off":
        kw["min_keyword_coverage"] = 0.0
    return dataclasses.replace(preset, **kw)


def legs(seed: int, b: int, kv: int, kk: int, min_score: float, cov: float):
    """(v_scores, v_ids, k_scores, k_ids, mass) for b >= 4 rows."""
    rng = np.random.default_rng(seed)
    pool = max(kv, kk) + 4
    v_i = np.stack([rng.permutation(pool)[:kv] for _ in range(b)])
    k_i = np.stack([rng.permutation(pool)[:kk] for _ in range(b)])
    v_i = (v_i * 7 + 3).astype(np.int32)
    k_i = (k_i * 7 + 3).astype(np.int32)
    v_i[rng.random((b, kv)) < 0.15] = -1
    k_i[rng.random((b, kk)) < 0.15] = -1
    v_s = rng.uniform(0.1, 0.9, (b, kv)).astype(np.float32)
    k_s = rng.uniform(0.0, 10.0, (b, kk)).astype(np.float32)
    mass = rng.uniform(5.0, 40.0, b).astype(np.float32)

    floor = np.float32(min_score)
    thr = np.float32(np.float32(cov) * mass[:2])
    v_s[0, 0], v_s[1, 0] = floor, np.nextafter(floor, NEG_INF)
    v_i[:2, 0] = np.abs(v_i[:2, 0])
    for r in (0, 1):
        top = thr[r] if r == 0 else np.nextafter(thr[r], NEG_INF)
        k_s[r] = np.minimum(k_s[r], top)
        k_s[r, kk // 2] = top
        k_i[r, kk // 2] = 11
    x, y = 5, 9  # not on the pool's grid of 7n + 3
    v_i[2, :2], k_i[2, :2] = (y, x), (x, y)
    v_s[2, :2], k_s[2, :2] = 0.9, 1e6
    v_i[3], k_i[3] = -1, -1
    v_s[3], k_s[3] = NEG_INF, NEG_INF
    k_s[k_i < 0] = NEG_INF
    return v_s, v_i, k_s, k_i, mass
