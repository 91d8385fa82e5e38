"""Batched brute-force descriptor matching with Lowe's ratio test.

Replaces the O(N·M·D) scalar loop template ``match_points``
(src/my_utilities.h:70-120): for every descriptor in set1, find the best and
second-best squared-L2 distance over set2, accept iff
``best < distance_threshold`` and ``best/second < ratio_threshold``
(my_utilities.h:102-105, thresholds 0.2 / 0.8 from my_utilities.h:44-46).

Accelerator-first design: one (N, M) distance computation + a two-pass masked min
per row.  No dynamic output size — the result is a per-row index + validity
mask, which downstream consumers gather through.  ``vmap`` over a leading
axis batches frame pairs.

Tie semantics match the reference exactly: the *first* index attaining the
minimum wins (strict ``<`` update in the scan loop -> jnp.argmin's
first-occurrence rule), and a duplicate of the best value at a later index
becomes the second-best.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

INF = jnp.inf


class MatchResult(NamedTuple):
    """Per-row matching outcome.

    idx:    (N,) int32 — index into set2 of the best match (garbage when invalid)
    valid:  (N,) bool — passed both threshold and ratio tests
    best:   (N,) float32 — best squared-L2 distance
    second: (N,) float32 — second-best squared-L2 distance
    """

    idx: jnp.ndarray
    valid: jnp.ndarray
    best: jnp.ndarray
    second: jnp.ndarray


def descriptor_distances(desc1, desc2, method: str = "direct"):
    """(N, D) x (M, D) -> (N, M) squared-L2 distance matrix.

    ``direct`` expands the difference (bit-faithful to the reference's
    per-pair ``(p1 - p2).squaredNorm()``); ``mxu`` uses the
    |a|^2 + |b|^2 - 2ab expansion so the inner product is a matmul —
    preferable for large M but subject to cancellation near zero.
    """
    if method == "mxu":
        n1 = jnp.sum(desc1 * desc1, -1, keepdims=True)  # (N, 1)
        n2 = jnp.sum(desc2 * desc2, -1, keepdims=True).T  # (1, M)
        cross = jnp.dot(desc1, desc2.T, preferred_element_type=jnp.float32)
        return n1 + n2 - 2.0 * cross
    if method == "mxu_bf16":
        # bf16 inputs, f32 accumulation: the cross term runs in bf16.
        # Norms stay f32.  Decision-identical to "direct" on the bundled
        # data (0 accept/index flips over all 8,855 matches — descriptors
        # are O(1) and margins wide) and on the GPU, but
        # near-tie flips are possible in principle; parity mode keeps
        # "direct".
        n1 = jnp.sum(desc1 * desc1, -1, keepdims=True)
        n2 = jnp.sum(desc2 * desc2, -1, keepdims=True).T
        cross = jnp.dot(desc1.astype(jnp.bfloat16), desc2.astype(jnp.bfloat16).T,
                        preferred_element_type=jnp.float32)
        return n1 + n2 - 2.0 * cross
    diff = desc1[:, None, :] - desc2[None, :, :]
    return jnp.sum(diff * diff, -1)


def top2_min(dist, col_valid):
    """Per-row (best, best_idx, second) with invalid columns masked to +inf."""
    masked = jnp.where(col_valid[None, :], dist, INF)
    idx = jnp.argmin(masked, axis=1).astype(jnp.int32)
    best = jnp.take_along_axis(masked, idx[:, None], axis=1)[:, 0]
    n = masked.shape[1]
    col_ids = jnp.arange(n, dtype=jnp.int32)
    masked2 = jnp.where(col_ids[None, :] == idx[:, None], INF, masked)
    second = jnp.min(masked2, axis=1)
    return best, idx, second


@jax.named_scope("match")
def match_descriptors(
    desc1,
    valid1,
    desc2,
    valid2,
    distance_threshold: float = 0.2,
    ratio_threshold: float = 0.8,
    method: str = "direct",
) -> MatchResult:
    """Match set1 -> set2 under threshold + Lowe ratio acceptance.

    desc1: (N, D), valid1: (N,); desc2: (M, D), valid2: (M,).
    """
    dist = descriptor_distances(desc1, desc2, method)
    best, idx, second = top2_min(dist, valid2)
    # best/second: inf second -> ratio 0 (passes), mirroring FLT_MAX division
    ratio = best / second
    accept = (best < distance_threshold) & (ratio < ratio_threshold)
    accept = accept & valid1
    return MatchResult(idx=idx, valid=accept, best=best, second=second)


@jax.named_scope("match")
def match_descriptors_pair(
    q1, v_q1, t1, v_t1,
    q2, v_q2, t2, v_t2,
    distance_threshold: float = 0.2,
    ratio_threshold: float = 0.8,
) -> tuple:
    """Two independent matches fused into ONE distance matmul + top-2 chain.

    Matches (q1 -> t1) and (q2 -> t2) by stacking the queries to (N1+N2, D)
    and the targets to (T1+T2, D), with a block mask so each query half only
    sees its own target segment.  Latency-mode win: the tracker issues two
    matcher calls per frame (2D-3D against the map and 2D-2D against the
    next frame, icp_test.cpp:75,122) — fusing them halves the serial kernel
    chain.  Decision-identical to two ``match_descriptors(method="mxu")``
    calls (masked columns are +inf in both).
    """
    N1, T1 = q1.shape[0], t1.shape[0]
    q = jnp.concatenate([q1, q2], 0)          # (N1+N2, D)
    t = jnp.concatenate([t1, t2], 0)          # (T1+T2, D)
    tv = jnp.concatenate([v_t1, v_t2], 0)     # (T1+T2,)
    dist = descriptor_distances(q, t, "mxu")  # one matmul
    # block mask: rows [0, N1) see cols [0, T1); the rest see [T1, T1+T2)
    rows_first = jnp.arange(q.shape[0]) < N1
    cols_first = jnp.arange(t.shape[0]) < T1
    seg_ok = rows_first[:, None] == cols_first[None, :]
    masked_valid = seg_ok & tv[None, :]
    masked = jnp.where(masked_valid, dist, INF)
    idx = jnp.argmin(masked, axis=1).astype(jnp.int32)
    best = jnp.take_along_axis(masked, idx[:, None], axis=1)[:, 0]
    col_ids = jnp.arange(t.shape[0], dtype=jnp.int32)
    masked2 = jnp.where(col_ids[None, :] == idx[:, None], INF, masked)
    second = jnp.min(masked2, axis=1)
    accept = (best < distance_threshold) & (best / second < ratio_threshold)
    accept = accept & jnp.concatenate([v_q1, v_q2], 0)
    r1 = MatchResult(idx[:N1], accept[:N1], best[:N1], second[:N1])
    r2 = MatchResult(idx[N1:] - T1, accept[N1:], best[N1:], second[N1:])
    return r1, r2


class MatchStats(NamedTuple):
    possible: jnp.ndarray  # pairs with equal id_real (the GT oracle count)
    found: jnp.ndarray     # accepted matches
    correct: jnp.ndarray   # accepted matches whose id_real agree


def match_stats(
    result: MatchResult, id1, valid1, id2, valid2
) -> MatchStats:
    """GT-oracle statistics, as logged by the reference on every call
    (my_utilities.h:87-90, 111-113, 116-119)."""
    pair_same = (id1[:, None] == id2[None, :]) & valid1[:, None] & valid2[None, :]
    possible = jnp.sum(pair_same)
    found = jnp.sum(result.valid)
    matched_id2 = jnp.take(id2, result.idx)
    correct = jnp.sum(result.valid & (id1 == matched_id2))
    return MatchStats(possible, found, correct)
