"""tpurag_torch's CSR BM25 top-k against the JAX package.

bm25_topk_fused (K2''s wrapper; on the CPU its plain version: the CSR
gather, odd terms flipped, the Pallas kernel's bitonic network and
window sums) is held to JAX's
bm25_topk_fused, whose Pallas kernel runs in interpret mode here: ids
exactly, scores within 1e-5 unpacked and 1e-6 relative packed, as in
test_torch_bm25.py. The windows include clamped starts, zero lengths,
docs past n_valid and k above the candidate count.

The kernel runs the network on a row's live lanes only (pads hold the
row's largest value, so a pad never moves and a live lane facing one
goes to the comparator's min side). ``live_lane_rows`` below is a numpy
model of that executor, the kernel's load included (window lengths, the
packed row max over every lane with invalid lanes as 0), held bit for
bit to the plain version's full network and window sums.

bm25_topk_segsum and bm25_topk (the scatter-add cross-check) are plain
torch in both packages' sense (XLA code in JAX): held to JAX's on the
cases of tests/test_bm25_segsum.py. Their scores are differences of
running prefix sums, which both packages add in their own order: within
1e-4 (that file's tolerance between its own two paths).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from test_bm25_segsum import make_args
from tpurag_torch.eval.bench import hybrid_inputs
from tpurag.kernels.bm25 import bm25_topk as jax_bm25_topk
from tpurag.kernels.bm25 import bm25_topk_segsum as jax_segsum
from tpurag.kernels.bm25_pallas import bm25_topk_fused as jax_fused
from tpurag_torch.index.inverted import packed_cbits
from tpurag_torch.kernels import bm25_merge
from tpurag_torch.kernels.bm25 import bm25_topk, bm25_topk_segsum
from tpurag_torch.kernels.bm25_merge import (_bitonic_rows, bm25_topk_fused,
                                             bm25_topk_fused_ref,
                                             flip_odd_blocks)
from tpurag_torch.kernels.bm25 import gather_candidates
from tpurag_torch.kernels.runtime import NEG_INF, launch_counts

N_DOCS = 3000


def _both(arrays):
    """numpy CSR arrays -> (JAX arrays, torch tensors)."""
    return ([jnp.asarray(x) for x in arrays],
            [torch.from_numpy(np.ascontiguousarray(x)) for x in arrays])


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("p_max", [16, 64])
@pytest.mark.parametrize("t", [1, 2, 4, 8])
def test_fused_matches_jax(t, p_max, packed):
    rng = np.random.default_rng(t * 100 + p_max + packed)
    *arrays, n_valid = chip_smoke.csr_windows(rng, 6, t, p_max, N_DOCS)
    cbits = packed_cbits(N_DOCS) if packed else 0
    k = 24 if t * p_max <= 16 else 8  # t=1, p_max=16: k past the 16 lanes
    j, tt = _both(arrays)
    wv, wi = jax_fused(*j, jnp.int32(n_valid), k=k, p_max=p_max, cbits=cbits)
    gv, gi = bm25_topk_fused(*tt, n_valid, k=k, p_max=p_max, cbits=cbits)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    if cbits:
        np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=1e-6)
    else:
        np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=1e-5)
    assert (gi.numpy()[:, 0] >= 0).any()
    if k > t * p_max:
        assert (gi.numpy()[:, t * p_max:] == -1).all()


def test_fused_edge_cases_are_exercised():
    """The fixture's windows do hit the edge cases they are meant to."""
    starts, lens, idf, post_doc, post_impact, n_valid = chip_smoke.csr_windows(
        np.random.default_rng(1), 6, 4, 64, N_DOCS)
    assert starts.max() > len(post_doc) - 64        # a clamped start
    assert (lens == 0).any() and (lens > 0).any()
    assert (post_doc >= n_valid).any() and (post_doc < n_valid).any()


def test_fused_wrapper_cpu_path_and_launch_count():
    *arrays, n_valid = chip_smoke.csr_windows(np.random.default_rng(2), 4, 4,
                                              16, 500)
    tt = [torch.from_numpy(x) for x in arrays]
    before = launch_counts["bm25_topk_fused"]
    got = bm25_merge.bm25_topk_fused(*tt, n_valid, k=8, p_max=16, cbits=20)
    want = bm25_topk_fused_ref(*tt, n_valid, k=8, p_max=16, cbits=20)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert launch_counts["bm25_topk_fused"] == before  # no kernel on CPU


def test_fused_wrapper_rejects_unsupported_device():
    """K2''s wrapper raises on a device it has no kernel for, rather
    than giving way to its plain version."""
    x = torch.zeros((2, 4), dtype=torch.int32, device="meta")
    post = torch.zeros((64,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        bm25_topk_fused(x, x, x.float(), post, post.float(), 10, k=4,
                        p_max=16)


def test_fused_wide_rows_route_to_segsum():
    """T * p_max past 16384 lanes takes bm25_topk_segsum in both
    packages (bm25_pallas.py:409-413)."""
    t, p_max = 8, 4096
    rng = np.random.default_rng(5)
    *arrays, n_valid = chip_smoke.csr_windows(rng, 2, t, p_max, 50_000)
    arrays[1] = np.minimum(arrays[1], 96)  # short windows: small row sums
    j, tt = _both(arrays)
    wv, wi = jax_fused(*j, jnp.int32(n_valid), k=10, p_max=p_max)
    gv, gi = bm25_topk_fused(*tt, n_valid, k=10, p_max=p_max)
    sv, si = bm25_topk_segsum(*tt, n_valid, k=10, p_max=p_max)
    assert torch.equal(gv, sv) and torch.equal(gi, si)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=1e-4)
    assert (gi.numpy()[:, 0] >= 0).all()


def test_fused_keeps_the_t_window_quirk():
    """A doc repeated more than T times in one term's window (the eval
    suite's postings: sorted random doc ids) sums only T of its lanes in
    the fused merge, while the segsum path sums them all. The port keeps
    the fused function's answer."""
    t, p_max = 2, 16
    post_doc = np.array([3] * 5 + [7, 9] + [11] * 9 + [2**30] * 16, np.int32)
    post_impact = np.ones(len(post_doc), np.float32)
    starts = np.array([[0, 16]], np.int32)
    lens = np.array([[16, 0]], np.int32)
    idf = np.array([[1.0, 1.0]], np.float32)
    arrays = [starts, lens, idf, post_doc, post_impact]
    j, tt = _both(arrays)
    wv, wi = jax_fused(*j, jnp.int32(100), k=4, p_max=p_max)
    gv, gi = bm25_topk_fused(*tt, 100, k=4, p_max=p_max)
    sv, si = bm25_topk_segsum(*tt, 100, k=4, p_max=p_max)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=1e-6)
    fused = dict(zip(gi[0].tolist(), gv[0].tolist()))
    full = dict(zip(si[0].tolist(), sv[0].tolist()))
    assert fused[11] == pytest.approx(2.0) and full[11] == pytest.approx(9.0)
    assert fused[3] == pytest.approx(2.0) and full[3] == pytest.approx(5.0)


def test_fused_takes_each_doc_once():
    """A clamped window that spans two terms is not doc-sorted, so doc 5
    ends two segments; select_topk (JAX's and the plain version's) takes
    it once."""
    arrays = [np.array(x, dt) for x, dt in (
        ([[3]], np.int32), ([[4]], np.int32), ([[1.0]], np.float32),
        ([5, 9, 2, 5], np.int32), ([1.0, 2.0, 3.0, 4.0], np.float32))]
    j, tt = _both(arrays)
    wv, wi = jax_fused(*j, jnp.int32(10), k=4, p_max=4)
    gv, gi = bm25_topk_fused(*tt, 10, k=4, p_max=4)
    assert gi.tolist() == np.asarray(wi).tolist() == [[5, 2, 9, -1]]
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=1e-6)


def _segsum_pair(args, k, p_max):
    st, ln, idf, pd, pi, dn, nv = (np.asarray(a) for a in args)
    tt = [torch.from_numpy(np.array(x)) for x in (st, ln, idf, pd, pi)]
    wv, wi = jax_segsum(*args[:5], args[6], k=k, p_max=p_max)
    gv, gi = bm25_topk_segsum(*tt, int(nv), k=k, p_max=p_max)
    return (np.asarray(wv), np.asarray(wi)), (gv.numpy(), gi.numpy()), tt, dn


@pytest.mark.parametrize("t,p_max,k", [(4, 64, 10), (1, 32, 5), (5, 64, 10)])
def test_segsum_and_scatter_match_jax(t, p_max, k):
    """tests/test_bm25_segsum.py's make_args cases (t=5 is not a power of
    two: the stable-sort branch). make_args empties each query's last
    slot, so its single-term case has no hits, as in that file."""
    args = make_args(np.random.default_rng(t * 7 + p_max), t=t, p_max=p_max)
    (wv, wi), (gv, gi), tt, dn = _segsum_pair(args, k, p_max)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gv, wv, atol=1e-4)
    sv, si = jax_bm25_topk(*args, k=k, p_max=p_max)
    cv, ci = bm25_topk(*tt, torch.from_numpy(np.array(dn)), int(args[6]),
                       k=k, p_max=p_max)
    np.testing.assert_array_equal(ci.numpy(), np.asarray(si))
    np.testing.assert_allclose(cv.numpy(), np.asarray(sv), atol=1e-4)
    np.testing.assert_allclose(cv.numpy(), gv, atol=1e-4)
    assert (gi[:, 0] >= 0).all() == (t > 1)


def test_segsum_duplicate_doc_merge():
    starts = np.array([[0, 2]], np.int32)
    lens = np.array([[2, 2]], np.int32)
    idf = np.array([[1.0, 2.0]], np.float32)
    post_doc = np.array([3, 7, 3, 9, 2**30, 2**30], np.int32)
    post_impact = np.array([1.1, 1.1, 1.1, 1.1, 0.0, 0.0], np.float32)
    tt = [torch.from_numpy(x) for x in (starts, lens, idf, post_doc,
                                        post_impact)]
    v, i = bm25_topk_segsum(*tt, 16, k=3, p_max=2)
    wv, wi = jax_segsum(*(jnp.asarray(x) for x in (starts, lens, idf,
                                                   post_doc, post_impact)),
                        jnp.int32(16), k=3, p_max=2)
    np.testing.assert_array_equal(i.numpy(), np.asarray(wi))
    got = {int(d): float(s) for s, d in zip(v[0], i[0]) if d >= 0}
    assert got[3] == pytest.approx(3.0 * 1.1, abs=1e-5)
    assert got[7] == pytest.approx(1.1, abs=1e-5)
    assert got[9] == pytest.approx(2.2, abs=1e-5)


def test_segsum_and_fused_no_hits():
    starts = torch.zeros((2, 4), dtype=torch.int32)
    lens = torch.zeros((2, 4), dtype=torch.int32)
    idf = torch.ones((2, 4))
    post_doc = torch.full((8,), 2**30, dtype=torch.int32)
    post_impact = torch.zeros(8)
    args = (starts, lens, idf, post_doc, post_impact, 8)
    for fn in (bm25_topk_segsum, bm25_topk_fused):
        v, i = fn(*args, k=3, p_max=4)
        assert (i == -1).all() and (v <= NEG_INF / 2).all()


@pytest.mark.parametrize("name,kernel", [
    ("topk_rows_kernel", "K2"),
    ("merge_segsum_kernel<(bool)1>", "K2'"),
    ("full_rows_kernel", "K3"),
    ("merge_segsum_kernel<true>", "K2'"),
    ("dense_co_scan_kernel<__nv_bfloat16, 64>", "K7"),
    ("dense_co_resident_c_kernel", "K7"),
    ("dense_co_resident_q_kernel", "K7"),
    ("dense_scan_kernel<signed char>", "K5"),
    ("dense_scan_kernel<__nv_bfloat16>", "K1"),
    ("rescore_topk_kernel<__nv_bfloat16>", "K8"),
    ("fuse_rrf_kernel", "F"),
])
def test_profile_names_map_to_port_kernels(name, kernel):
    """chip_smoke's profile sums device time by port kernel: K2's body is
    topk_rows_kernel, K2''s the templated merge_segsum_kernel<PACKED>."""
    assert chip_smoke.port_kernel(name) == kernel


@pytest.mark.parametrize("raw,kernel", [
    ("(anonymous namespace)::fuse_rrf_kernel(float const*, int const*, int, "
     "float const*, int const*, int, float const*, float, float, float, "
     "float, float, float, int, int, int, float*, int*, int*)", "F"),
    ("void (anonymous namespace)::merge_segsum_kernel<true>(int const*)",
     "K2'"),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::FillFunctor<float>, std::array<char*, 1ul> >(int, "
     "at::native::FillFunctor<float>, std::array<char*, 1ul>)", None),
])
def test_profiled_device_functions_map_to_port_kernels(raw, kernel):
    """The profiler's full names (namespace, return type, parameters) reach
    the port kernel's entry; torch's glue maps to none."""
    assert chip_smoke.port_kernel(chip_smoke.device_fn(raw)) == kernel


BIG = 2**30
PAD_KEY = 2**31 - 1


def live_lane_rows(starts, lens, idf, post_doc, post_impact, n_valid, p,
                   cbits):
    """numpy model of csrc/bm25_merge.cu's live-lane network, row by row:
    the lanes of each window (odd windows flipped) are loaded, a lane is
    live if o < len, doc < n_valid and (packed) its key is no pad; the
    network's stages then run over the live lanes alone, each finding its
    partner at pos ^ s. Returns (seg, doc_s, live positions): the
    t-window sums at the live segment ends (NEG_INF elsewhere) and the
    merged doc row, as _bitonic_rows gives them."""
    b, t = starts.shape
    w = t * p
    lim = max(len(post_doc) - p, 0)
    lane = np.arange(w)
    src = np.where(lane & p, lane ^ (p - 1), lane)
    j, o = src // p, src % p
    segs, docs, where = [], [], []
    for row in range(b):
        at = np.clip(starts[row, j], 0, lim) + o
        inw = o < lens[row, j]
        at = np.where(inw, at, 0)  # a lane past its window reads nothing
        d = np.where(inw, post_doc[at], BIG)
        valid = inw & (d < n_valid)
        d = np.where(valid, d, BIG).astype(np.int64)
        c = np.where(valid, idf[row, j] * post_impact[at],
                     np.float32(0)).astype(np.float32)
        if cbits:
            qmax = (1 << cbits) - 1
            safe = np.maximum(c.max(), np.float32(1e-30))
            q = np.clip(np.rint((c / safe) * np.float32(qmax)).astype(
                np.int64), 0, qmax)
            key = np.where(d < (PAD_KEY >> cbits), (d << cbits) | q, PAD_KEY)
            pad = PAD_KEY
        else:
            key, pad = d.copy(), BIG
        cs = c.copy()
        pos = np.nonzero(key != pad)[0]
        kk = 2 * p
        while kk <= w:
            s = kk // 2
            while s >= 1:
                # Pairs are disjoint within a stage: one vector step.
                part, lo = pos ^ s, pos & ~s
                asc = (lo & kk) == 0
                empty = key[part] == pad
                to = np.where(asc, lo, lo | s)
                ex = ~empty & (pos == lo)
                a, bb = key[pos[ex]], key[part[ex]]
                swap = np.where(asc[ex], a > bb, a < bb)
                x, y = pos[ex][swap], part[ex][swap]
                key[x], key[y] = key[y].copy(), key[x].copy()
                cs[x], cs[y] = cs[y].copy(), cs[x].copy()
                mv = empty & (to != pos)
                f, g = pos[mv], to[mv]
                key[g], cs[g] = key[f], cs[f]
                key[f], cs[f] = pad, 0.0
                pos = np.where(mv, to, pos)
                s //= 2
            kk *= 2
        if cbits:
            doc_s = key >> cbits
            con = (key & qmax).astype(np.float32) * np.float32(
                safe / np.float32(qmax))
        else:
            doc_s, con = key, cs
        seg = np.full(w, np.float32(NEG_INF), np.float32)
        for i in pos:
            if i != w - 1 and doc_s[i + 1] == doc_s[i]:
                continue
            total = np.float32(con[i])
            for back in range(1, t):
                same = i >= back and doc_s[i - back] == doc_s[i]
                total = np.float32(total + (con[i - back] if same
                                            else np.float32(0)))
            seg[i] = total
        segs.append(seg)
        docs.append(doc_s.astype(np.int32))
        where.append(np.sort(pos))
    return np.stack(segs), np.stack(docs), where


def _windows_lead(starts, lens, post_doc, n_valid, p, cbits):
    """Per row: True if in every window the live lanes come first (the
    0-1 image of each block sorted), the case in which the network leaves
    the live lanes as the row's prefix."""
    lim = max(len(post_doc) - p, 0)
    out = []
    for row in range(starts.shape[0]):
        ok = True
        for jj in range(starts.shape[1]):
            n = int(np.clip(lens[row, jj], 0, p))
            d = post_doc[np.clip(starts[row, jj], 0, lim) + np.arange(n)]
            live = d < n_valid
            if cbits:
                live &= d < (PAD_KEY >> cbits)
            ok &= bool(np.all(live[:live.sum()]))
        out.append(ok)
    return out


def _special_windows(name: str):
    """The live-lane model's edge cases: (starts, lens, idf, post_doc,
    post_impact, n_valid, p)."""
    rng = np.random.default_rng(len(name))
    if name == "eval_draw":  # hybrid_inputs' CPU draw: docs repeat
        x = hybrid_inputs(device="cpu")
        return (*(x[n].numpy() for n in ("starts", "lens", "idf", "post_doc",
                                         "post_impact")), x["n_valid"],
                x["p_max"])
    t, p, n_docs = 8, 16, 500
    post_doc = np.sort(rng.integers(0, n_docs, 40 * p)).astype(np.int32)
    post_impact = rng.uniform(0.2, 2.0, len(post_doc)).astype(np.float32)
    idf = rng.uniform(0.5, 3.0, (4, t)).astype(np.float32)
    starts = rng.integers(0, len(post_doc) - p, (4, t)).astype(np.int32)
    lens = np.full((4, t), p, np.int32)
    n_valid = n_docs
    if name == "clamped":  # starts past nnz - p, and mid-list ones
        starts[:, ::2] = len(post_doc) - rng.integers(1, p, (4, t // 2))
        post_doc[-p:] = rng.integers(0, n_docs, p)  # unsorted tail
        lens[:, 1::2] = rng.integers(0, p + 1, (4, t // 2))
    elif name == "empty":  # an empty row, empty windows
        lens[0] = 0
        lens[1:, ::3] = 0
        n_valid = n_docs // 2
    elif name == "one_live":  # one live lane, in an odd (flipped) window
        lens[:] = 0
        lens[:, 3] = 1
        post_doc[starts[:, 3]] = np.arange(4)
    elif name == "full":  # every lane live
        pass
    return starts, lens, idf, post_doc, post_impact, n_valid, p


def _check_live_model(arrays, n_valid, p, cbits):
    starts = arrays[0]
    t = starts.shape[1]
    seg, doc_s, where = live_lane_rows(*arrays, n_valid, p, cbits)
    doc, con = gather_candidates(*(torch.from_numpy(x) for x in arrays),
                                 n_valid, p)
    if t > 1:
        doc, con = flip_odd_blocks(doc, p, t), flip_odd_blocks(con, p, t)
    want_seg, want_doc, _ = _bitonic_rows(doc, con, p, t, cbits)
    np.testing.assert_array_equal(doc_s, want_doc.numpy())
    np.testing.assert_array_equal(seg.view(np.int32),
                                  want_seg.numpy().view(np.int32))
    lead = _windows_lead(starts, arrays[1], arrays[3], n_valid, p, cbits)
    for ok, pos in zip(lead, where):
        if ok:  # the live lanes end as the row's prefix
            np.testing.assert_array_equal(pos, np.arange(len(pos)))
    return lead, where


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("p", [8, 16, 64])
@pytest.mark.parametrize("t", [1, 2, 4, 8])
def test_live_lane_network_matches_bitonic_rows(t, p, packed):
    """The live-lane executor gives _bitonic_rows' merged row and sums bit
    for bit on chip_smoke.csr_windows (clamped starts, empty windows,
    docs past n_valid); where each window's live lanes lead it, they end
    as the row's prefix."""
    rng = np.random.default_rng(t * 1000 + p + packed)
    *arrays, n_valid = chip_smoke.csr_windows(rng, 6, t, p, N_DOCS)
    cbits = packed_cbits(N_DOCS) if packed else 0
    lead, where = _check_live_model(arrays, n_valid, p, cbits)
    assert any(len(x) for x in where)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("case", ["eval_draw", "clamped", "empty",
                                  "one_live", "full"])
def test_live_lane_network_edge_cases(case, packed):
    *arrays, n_valid, p = _special_windows(case)
    cbits = packed_cbits(max(n_valid, 2)) if packed else 0
    lead, where = _check_live_model(arrays, n_valid, p, cbits)
    t = arrays[0].shape[1]
    n_live = [len(x) for x in where]
    if case == "eval_draw":
        assert all(lead) and max(n_live) > 0
    elif case == "empty":
        assert n_live[0] == 0 and max(n_live) > 0
    elif case == "one_live":
        assert n_live == [1] * len(n_live)
    elif case == "full":
        assert n_live == [t * p] * len(n_live)
    elif case == "clamped":
        assert (arrays[0] > len(arrays[3]) - p).any()


_K2F_PROBES = ["full", "one_block", "two_blocks", "topk_smem", "no_network",
               "no_topk", "load_only"]


@pytest.mark.parametrize("probe", _K2F_PROBES)
def test_k2f_anatomy_patches_apply(probe):
    """tools/k2f_anatomy.py times K2' with textual patches of its source;
    each anchor must be in the source exactly once."""
    tool = chip_smoke.load_tool("k2f_anatomy")
    assert sorted(tool.PROBES) == sorted(_K2F_PROBES)
    src = tool.patched(tool.PROBES[probe])
    assert "merge_segsum_kernel" in src
    assert (src == tool.patched([])) == (probe == "full")
