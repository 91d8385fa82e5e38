"""Matcher tests: numpy oracle replicating the reference loop exactly, plus
the match_points_test-style GT-precision sweep over the real dataset
(exec/match_points_test.cpp:29-38)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from jaxvo.ops.match import match_descriptors, match_stats


def reference_match(desc1, desc2, dist_thr=0.2, ratio_thr=0.8):
    """Literal port of the scan loop in my_utilities.h:80-115 (oracle only)."""
    out = []
    for i in range(len(desc1)):
        best, second, best_idx = np.inf, np.inf, -1
        for j in range(len(desc2)):
            d = float(np.sum((desc1[i] - desc2[j]) ** 2, dtype=np.float32))
            if d < best:
                second = best
                best = d
                best_idx = j
            elif d < second:
                second = d
        if best_idx != -1 and best < dist_thr and best / second < ratio_thr:
            out.append((i, best_idx))
    return out


def run_match(desc1, valid1, desc2, valid2, **kw):
    return match_descriptors(
        jnp.asarray(desc1), jnp.asarray(valid1), jnp.asarray(desc2), jnp.asarray(valid2), **kw
    )


def test_matches_numpy_oracle_random():
    rng = np.random.default_rng(0)
    d1 = rng.uniform(-1, 1, (40, 10)).astype(np.float32)
    d2 = rng.uniform(-1, 1, (60, 10)).astype(np.float32)
    # make some near-duplicates so accepts actually happen
    d2[5] = d1[3] + 0.01
    d2[17] = d1[20] + 0.02
    d2[33] = d1[8]
    ref = reference_match(d1, d2)
    res = run_match(d1, np.ones(40, bool), d2, np.ones(60, bool))
    got = [(i, int(res.idx[i])) for i in range(40) if bool(res.valid[i])]
    assert got == ref


def test_tie_breaking_first_index_wins():
    d1 = np.zeros((1, 10), np.float32)
    d2 = np.zeros((3, 10), np.float32)
    d2[0] += 0.05  # dist 0.025
    d2[1] += 0.01  # best
    d2[2] += 0.01  # duplicate of best at later index -> second
    res = run_match(d1, np.ones(1, bool), d2, np.ones(3, bool))
    # best == second -> ratio 1.0 >= 0.8 -> rejected (reference behavior)
    assert not bool(res.valid[0])
    assert int(res.idx[0]) == 1
    assert np.isclose(float(res.best[0]), float(res.second[0]))


def test_single_candidate_passes_ratio():
    # second = inf -> ratio 0 passes; accept iff best < 0.2
    d1 = np.zeros((1, 10), np.float32)
    d2 = np.full((1, 10), 0.1, np.float32)  # dist = 0.1 < 0.2
    res = run_match(d1, np.ones(1, bool), d2, np.ones(1, bool))
    assert bool(res.valid[0])
    far = np.full((1, 10), 0.2, np.float32)  # dist = 0.4 > 0.2
    res2 = run_match(d1, np.ones(1, bool), far, np.ones(1, bool))
    assert not bool(res2.valid[0])


def test_padding_masks():
    rng = np.random.default_rng(1)
    d1 = rng.uniform(-1, 1, (8, 10)).astype(np.float32)
    d2 = rng.uniform(-1, 1, (8, 10)).astype(np.float32)
    d2[6] = d1[2]  # would match
    valid2 = np.ones(8, bool)
    valid2[6] = False  # ... but it is padding
    res = run_match(d1, np.ones(8, bool), d2, valid2)
    assert not bool(res.valid[2]) or int(res.idx[2]) != 6
    # invalid rows never match
    valid1 = np.zeros(8, bool)
    res2 = run_match(d1, valid1, d2, np.ones(8, bool))
    assert not np.asarray(res2.valid).any()


def test_real_dataset_precision(sequence):
    """match_points_test analog: per consecutive pair, GT-correct matches must
    dominate (the reference prints 'out of N possible, found M, K correct';
    on this dataset the matcher is nearly perfect)."""
    s = sequence
    total_found = total_correct = 0
    match_j = jax.jit(
        lambda a, va, b, vb: match_descriptors(a, va, b, vb)
    )
    for i in range(0, 120, 10):  # sample pairs for test speed
        res = match_j(
            jnp.asarray(s.desc[i]), jnp.asarray(s.valid[i]),
            jnp.asarray(s.desc[i + 1]), jnp.asarray(s.valid[i + 1]),
        )
        stats = match_stats(
            res,
            jnp.asarray(s.id_real[i]), jnp.asarray(s.valid[i]),
            jnp.asarray(s.id_real[i + 1]), jnp.asarray(s.valid[i + 1]),
        )
        total_found += int(stats.found)
        total_correct += int(stats.correct)
    assert total_found > 300
    assert total_correct / total_found > 0.95


def test_mxu_method_agrees_on_real_data(sequence):
    s = sequence
    r1 = run_match(s.desc[0], s.valid[0], s.desc[1], s.valid[1], method="direct")
    r2 = run_match(s.desc[0], s.valid[0], s.desc[1], s.valid[1], method="mxu")
    assert np.array_equal(np.asarray(r1.valid), np.asarray(r2.valid))
    agree = np.asarray(r1.idx)[np.asarray(r1.valid)] == np.asarray(r2.idx)[np.asarray(r1.valid)]
    assert agree.all()


def test_vmap_over_frame_pairs(sequence):
    s = sequence
    batched = jax.vmap(lambda a, va, b, vb: match_descriptors(a, va, b, vb))
    res = batched(
        jnp.asarray(s.desc[:8]), jnp.asarray(s.valid[:8]),
        jnp.asarray(s.desc[1:9]), jnp.asarray(s.valid[1:9]),
    )
    assert res.idx.shape == (8, s.uv.shape[1])
    single = match_descriptors(
        jnp.asarray(s.desc[3]), jnp.asarray(s.valid[3]),
        jnp.asarray(s.desc[4]), jnp.asarray(s.valid[4]),
    )
    assert np.array_equal(np.asarray(res.valid[3]), np.asarray(single.valid))


def test_fused_pair_matcher_agrees(sequence):
    """match_descriptors_pair == two independent mxu-method matches."""
    from jaxvo.ops.match import match_descriptors_pair

    s = sequence
    # mimic the tracker's two calls on frames (1 -> map-like frame 5) and (0 -> 1)
    q1, vq1, t1, vt1 = s.desc[1], s.valid[1], s.desc[5], s.valid[5]
    q2, vq2, t2, vt2 = s.desc[0], s.valid[0], s.desc[1], s.valid[1]
    r1, r2 = jax.jit(match_descriptors_pair)(
        jnp.asarray(q1), jnp.asarray(vq1), jnp.asarray(t1), jnp.asarray(vt1),
        jnp.asarray(q2), jnp.asarray(vq2), jnp.asarray(t2), jnp.asarray(vt2),
    )
    e1 = run_match(q1, vq1, t1, vt1, method="mxu")
    e2 = run_match(q2, vq2, t2, vt2, method="mxu")
    for got, exp in ((r1, e1), (r2, e2)):
        assert np.array_equal(np.asarray(got.valid), np.asarray(exp.valid))
        sel = np.asarray(exp.valid)
        assert np.array_equal(np.asarray(got.idx)[sel], np.asarray(exp.idx)[sel])
        np.testing.assert_allclose(
            np.asarray(got.best)[sel], np.asarray(exp.best)[sel], atol=2e-6)


# ---------------------------------------------------------------------------
# every distance form against a NumPy brute-force top-2 (the cases the
# removed tiled kernel was tested on: random with planted matches, a
# best/second split across the map with an exact tie, sizes that align
# with nothing)
# ---------------------------------------------------------------------------
def numpy_top2(d1, v1, d2, v2, dist_thr=0.2, ratio_thr=0.8):
    d = ((d1[:, None, :].astype(np.float64) - d2[None].astype(np.float64)) ** 2).sum(-1)
    d = np.where(v2[None, :], d, np.inf)
    idx = np.argmin(d, axis=1)  # first index on ties, as the reference
    rows = np.arange(len(d1))
    best = d[rows, idx]
    d2nd = d.copy()
    d2nd[rows, idx] = np.inf
    second = d2nd.min(axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        ok = (best < dist_thr) & (best / second < ratio_thr) & v1
    return idx, ok, best, second


def _case_random():
    rng = np.random.default_rng(0)
    d1 = rng.uniform(-1, 1, (64, 10)).astype(np.float32)
    d2 = rng.uniform(-1, 1, (1024, 10)).astype(np.float32)
    d2[5] = d1[3] + 0.01
    d2[700] = d1[20] + 0.02
    v2 = np.ones(1024, bool)
    v2[100:130] = False
    return d1, np.ones(64, bool), d2, v2


def _case_split_and_tie():
    d1 = np.zeros((8, 10), np.float32)
    d1[1] = 0.5
    d2 = np.ones((1024, 10), np.float32)
    d2[3] = 0.05      # row 0: best early in the map ...
    d2[900] = 0.06    # ... second near its end
    d2[10] = 0.5      # row 1: an exact tie — first index wins, and the
    d2[800] = 0.5     # duplicate makes the ratio 1 (rejected)
    return d1, np.ones(8, bool), d2, np.ones(1024, bool)


def _case_unaligned():
    rng = np.random.default_rng(2)
    d1 = rng.uniform(-1, 1, (50, 10)).astype(np.float32)
    d2 = rng.uniform(-1, 1, (700, 10)).astype(np.float32)
    d2[650] = d1[10]
    return d1, np.ones(50, bool), d2, np.ones(700, bool)


# best-distance tolerance per form: the bf16 cross term rounds each
# descriptor entry to 8 mantissa bits (~4e-3 relative on O(1) values)
_BEST_ATOL = {"direct": 1e-5, "mxu": 1e-4, "mxu_bf16": 3e-2}


@pytest.mark.parametrize("case", [_case_random, _case_split_and_tie,
                                  _case_unaligned])
@pytest.mark.parametrize("method", ["direct", "mxu", "mxu_bf16"])
def test_methods_match_numpy_top2(method, case):
    d1, v1, d2, v2 = case()
    idx, ok, best, second = numpy_top2(d1, v1, d2, v2)
    got = match_descriptors(jnp.asarray(d1), jnp.asarray(v1),
                            jnp.asarray(d2), jnp.asarray(v2), method=method)
    np.testing.assert_array_equal(np.asarray(got.valid), ok)
    np.testing.assert_array_equal(np.asarray(got.idx)[ok], idx[ok])
    np.testing.assert_allclose(np.asarray(got.best)[ok], best[ok],
                               atol=_BEST_ATOL[method])
    if case is _case_split_and_tie:
        assert int(got.idx[0]) == 3 and int(got.idx[1]) == 10
        assert not bool(got.valid[1])
