"""Loop-closure detection + relocalization + pose-graph drift repair.

NEW layer with no reference counterpart (the reference tracks frame to
frame and never revisits poses — exec/icp_test.cpp:61-136).  Completes
BASELINE.json config 5 ("multi-host sharded pose-graph + Schur BA"): the
pose-graph solver lives in ba/posegraph.py; this module supplies the
loop-closure edges that make accumulated drift OBSERVABLE — on an open
trajectory the constraint graph is a chain and drift is gauge-like, so
neither windowed nor global BA can repair it (measured: 0-3% ATE change
at 28 m drift); with loop edges the same solvers recover the trajectory.

Pipeline (the ORB-SLAM-style hierarchy, all fixed-shape / one program):
  1. co-visibility: which frame pairs observe the same map landmarks —
     a one-hot (F, L) membership matrix and ONE matmul M·M^T
  2. loop candidates: top-K (i, j) pairs with |i-j| >= min_gap and
     >= min_shared co-observed landmarks
  3. relocalize the LATE frame of each pair against the map positions of
     the SHARED landmarks (triangulated at the early visit = pre-drift)
     with DLT PnP + PICP polish (ops/pnp.py — basin-free, the drifted
     estimate can be arbitrarily far off)
  4. loop edges Z_ij = T_i^-1 · T_j^pnp joined with odometry edges into
     ba/posegraph.pgo_solve — an L2 pass (drifted loop residuals are huge
     and a robust kernel would suppress exactly them), then a robust pass
     to reject any bad relocalizations.

All of steps 1-4 compile into one jit program; the edge axis is the
sharding axis (jaxvo/parallel/posegraph_sharded.py).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from jaxvo.ba.posegraph import PoseGraph, odometry_edges, pgo_solve
from jaxvo.ops import lie
from jaxvo.ops.pnp import pnp_ransac


def covisibility_counts(obs_lm, obs_valid, L: int, tile: int | None = None):
    """(F, F) matrix of co-observed-landmark counts.

    obs_lm: (F, N) int32 map ids; obs_valid: (F, N) bool.

    Dense path (small maps): one scatter into an (F, L) membership matrix
    and a single matmul M·M^T.  Tiled path (``tile`` set, or auto
    above 16k landmarks): C = Σ_t M_t·M_tᵀ over landmark-id blocks — each
    block's (F, tile) membership is built, multiplied, and discarded, so
    the full (F, L) matrix never materializes and loop closure survives
    the 100k-landmark config-5 scale (at F=500, L=100k the dense matrix
    is 200 MB; tiled peak is F·tile).  Exact: landmark blocks partition
    the id space, and co-visibility counts are a sum over landmarks.
    """
    F, N = obs_lm.shape
    if tile is None and L > 16384:
        tile = 8192
    if tile is None or tile >= L:
        M = jnp.zeros((F, L), jnp.float32)
        M = M.at[jnp.arange(F, dtype=jnp.int32)[:, None], obs_lm].max(
            obs_valid.astype(jnp.float32), mode="drop")
        return M @ M.T
    n_tiles = -(-L // tile)
    rows = jnp.arange(F, dtype=jnp.int32)[:, None]
    val = obs_valid.astype(jnp.float32)

    def body(acc, lo):
        # ids outside [lo, lo+tile) -> sentinel column `tile` (OOB, dropped)
        col = jnp.where(
            (obs_lm >= lo) & (obs_lm < lo + tile), obs_lm - lo, tile)
        Mt = jnp.zeros((F, tile), jnp.float32).at[rows, col].max(
            val, mode="drop")
        return acc + Mt @ Mt.T, None

    los = (jnp.arange(n_tiles, dtype=jnp.int32) * tile)
    C, _ = jax.lax.scan(body, jnp.zeros((F, F), jnp.float32), los)
    return C


def detect_loops(C, min_gap: int, min_shared: int, max_edges: int):
    """Top-``max_edges`` loop-candidate pairs from a co-visibility matrix.

    Returns (pairs (E, 2) int32 with i < j, shared (E,), valid (E,)).
    Invalid slots (fewer than max_edges qualifying pairs) have valid=False.
    """
    F = C.shape[0]
    ii = jnp.arange(F, dtype=jnp.int32)
    sep = ii[None, :] - ii[:, None]                    # j - i
    mask = (sep >= min_gap) & (C >= min_shared)
    score = jnp.where(mask, C, -1.0).reshape(-1)
    top, idx = jax.lax.top_k(score, max_edges)
    pairs = jnp.stack([idx // F, idx % F], -1).astype(jnp.int32)
    valid = top > 0
    return pairs, jnp.maximum(top, 0.0), valid


def _relocalize_pair(key, K, poses, map_xyz, map_valid, uv, obs_lm,
                     obs_valid, pair, pv, width, height, min_shared):
    """One loop edge: robust PnP of the late frame on the shared early
    landmarks.  RANSAC, not plain DLT — the map positions carry tracking
    noise including gross outliers (see ops/pnp.pnp_ransac); the edge is
    kept only when >= min_shared correspondences survive as inliers."""
    i, j = pair[0], pair[1]
    lm_i = jnp.where(obs_valid[i], obs_lm[i], -1)
    # map_valid gate: callers whose obs_valid comes straight from the
    # matcher are already gated, but raw matches would otherwise feed
    # garbage-position map slots into the RANSAC relocalization
    shared = obs_valid[j] & map_valid[obs_lm[j]] & jnp.any(
        obs_lm[j][:, None] == lm_i[None, :], axis=-1)
    X = map_xyz[obs_lm[j]]
    kp = jax.random.fold_in(key, i * poses.shape[0] + j)
    T_j_wic, ok, n_inl = pnp_ransac(kp, K, X, uv[j], shared, width, height)
    T_j = lie.inv_se3(T_j_wic)                         # camera-in-world
    Z = lie.inv_se3(poses[i]) @ T_j
    w = (pv & ok & (n_inl >= min_shared)).astype(jnp.float32)
    Z = jnp.where(w > 0, Z, jnp.eye(4, dtype=Z.dtype))
    return Z, w


@partial(jax.jit, static_argnames=(
    "width", "height", "min_gap", "min_shared", "max_edges",
    "pgo_iterations", "loop_weight", "odo_weight"))
def close_loops(K, poses, map_xyz, map_valid, uv, obs_lm, obs_valid,
                width: int, height: int,
                min_gap: int = 30, min_shared: int = 12,
                max_edges: int = 32, pgo_iterations: int = 60,
                loop_weight: float = 1.0, odo_weight: float = 25.0,
                key=None):
    """Detect loops, relocalize, and pose-graph-optimize — one program.

    poses: (F, 4, 4) camera-in-world tracked trajectory.
    obs_lm/obs_valid: per-frame matches against the FROZEN map (the same
    topology the global refiner uses).  Returns (poses_pgo, n_loop_edges,
    chi) — poses unchanged when no loop qualifies.
    """
    F = poses.shape[0]
    L = map_xyz.shape[0]
    C = covisibility_counts(obs_lm, obs_valid & map_valid[obs_lm], L)
    pairs, shared, pvalid = detect_loops(C, min_gap, min_shared, max_edges)

    if key is None:
        key = jax.random.PRNGKey(0)
    Z, w = jax.vmap(
        lambda p, v: _relocalize_pair(
            key, K, poses, map_xyz, map_valid, uv, obs_lm, obs_valid, p, v,
            width, height, min_shared)
    )(pairs, pvalid)

    # information weighting: consecutive-frame relative poses are locally
    # far more accurate (~mm, one PICP hand-off) than a PnP
    # relocalization over >= min_shared points (~dm) — without the ratio
    # the L2 pass bends an already-good trajectory toward noisy loop
    # edges (measured 2.4x ATE degradation on a drift-free sequence)
    e_ij, e_T, e_w = odometry_edges(poses, weight=odo_weight)
    edges_ij = jnp.concatenate([e_ij, pairs], 0)
    edges_T = jnp.concatenate([e_T, Z], 0)
    edges_w = jnp.concatenate([e_w, loop_weight * w], 0)

    fixed = jnp.arange(F) < 1
    graph = PoseGraph(poses=poses, edges_ij=edges_ij, edges_T=edges_T,
                      edges_w=edges_w, fixed=fixed)
    # L2 pass: drifted loop residuals are enormous — a robust kernel here
    # would suppress exactly the edges that carry the information
    graph, _ = pgo_solve(graph, iterations=pgo_iterations,
                         kernel_threshold=1.0e8)
    # robust pass: with the drift redistributed, surviving large residuals
    # are bad relocalizations — saturate them out
    graph, stats = pgo_solve(graph, iterations=max(pgo_iterations // 3, 10),
                             kernel_threshold=1.0)
    n_loops = jnp.sum(w > 0)
    ok = jnp.all(jnp.isfinite(graph.poses)) & (n_loops > 0)
    poses_out = jnp.where(ok, graph.poses, poses)
    return poses_out, n_loops, stats.chi
