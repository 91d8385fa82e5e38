"""Pose-graph optimization: synthetic repair tests + sharded parity.

The canonical PGO validation (the analog of g2o's sphere/manhattan
fixtures): a dead-reckoned chain accumulates odometry noise into large
absolute drift; adding a handful of loop-closure edges and solving the
graph must pull the trajectory back onto the ground truth — exactly the
repair that windowed BA, anchored to its drifted prefix, provably cannot
perform (see test_ba_refine).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from jaxvo.ba import posegraph as pg
from jaxvo.ops import lie


def _circle_gt(F=40, radius=5.0):
    """Ground-truth poses around a closed circle (returns (F, 4, 4))."""
    out = []
    for k in range(F):
        th = 2 * np.pi * k / F
        v = np.array(
            [radius * np.cos(th), radius * np.sin(th), 0.0, 0.0, 0.0, th + np.pi / 2],
            np.float32,
        )
        out.append(np.asarray(lie.se3_exp(jnp.asarray(v))))
    return np.stack(out)


def _noisy_chain(gt, sigma_t=0.03, sigma_r=0.01, seed=0):
    """Noisy odometry measurements + the dead-reckoned trajectory."""
    rng = np.random.default_rng(seed)
    F = gt.shape[0]
    rels, poses = [], [gt[0]]
    for i in range(F - 1):
        Z = np.asarray(lie.inv_se3(jnp.asarray(gt[i])) @ jnp.asarray(gt[i + 1]))
        noise = np.concatenate(
            [sigma_t * rng.standard_normal(3), sigma_r * rng.standard_normal(3)]
        ).astype(np.float32)
        Zn = np.asarray(lie.se3_exp(jnp.asarray(noise))) @ Z
        rels.append(Zn)
        poses.append(poses[-1] @ Zn)
    return np.stack(rels), np.stack(poses)


def _ate(poses, gt):
    return float(np.sqrt(np.mean(np.sum((poses[:, :3, 3] - gt[:, :3, 3]) ** 2, -1))))


def test_zero_residual_graph_is_fixed_point():
    gt = _circle_gt(20)
    eij, eT, ew = pg.odometry_edges(jnp.asarray(gt))
    graph = pg.PoseGraph(
        jnp.asarray(gt), eij, eT, ew,
        jnp.zeros(20, bool).at[0].set(True),
    )
    out, stats = pg.pgo_solve(graph, iterations=5)
    assert float(stats.chi) < 1e-6
    np.testing.assert_allclose(np.asarray(out.poses), gt, atol=1e-4)


def test_loop_closure_repairs_drift():
    gt = _circle_gt(40)
    rels, dead = _noisy_chain(gt, seed=3)
    ate0 = _ate(dead, gt)
    assert ate0 > 0.15  # the chain must actually have drifted

    # odometry edges from the noisy measurements
    F = 40
    ii = jnp.arange(F - 1, dtype=jnp.int32)
    odo = (jnp.stack([ii, ii + 1], -1), jnp.asarray(rels), jnp.ones(F - 1, jnp.float32))
    # 4 loop-closure edges with near-exact relative poses (re-observation)
    lc_pairs = [(0, 20), (5, 35), (10, 30), (0, 39)]
    lc_ij = jnp.asarray(lc_pairs, jnp.int32)
    lc_T = jnp.stack([
        lie.inv_se3(jnp.asarray(gt[i])) @ jnp.asarray(gt[j]) for i, j in lc_pairs
    ])
    lc = (lc_ij, lc_T, jnp.full(len(lc_pairs), 10.0, jnp.float32))

    graph = pg.PoseGraph(
        jnp.asarray(dead),
        jnp.concatenate([odo[0], lc[0]], 0),
        jnp.concatenate([odo[1], lc[1]], 0),
        jnp.concatenate([odo[2], lc[2]], 0),
        jnp.zeros(F, bool).at[0].set(True),
    )
    out, stats = pg.pgo_solve(graph, iterations=25)
    ate1 = _ate(np.asarray(out.poses), gt)
    assert np.isfinite(float(stats.chi))
    # the graph must repair most of the accumulated drift (measured 3x:
    # 0.337 -> 0.113; the remainder is the MAP-optimal interpolation of
    # the odometry noise between the 4 loop anchors, not solver slack —
    # more iterations / heavier loop weights do not move it)
    assert ate1 < 0.5 * ate0


@pytest.mark.slow
def test_sharded_matches_single_device():
    from jaxvo.parallel.mesh import local_mesh
    from jaxvo.parallel.posegraph_sharded import sharded_pgo_solve

    gt = _circle_gt(24)
    rels, dead = _noisy_chain(gt, seed=5)
    F = 24
    ii = jnp.arange(F - 1, dtype=jnp.int32)
    lc_pairs = [(0, 12), (3, 21)]
    lc_T = jnp.stack([
        lie.inv_se3(jnp.asarray(gt[i])) @ jnp.asarray(gt[j]) for i, j in lc_pairs
    ])
    graph = pg.PoseGraph(
        jnp.asarray(dead),
        jnp.concatenate([jnp.stack([ii, ii + 1], -1), jnp.asarray(lc_pairs, jnp.int32)], 0),
        jnp.concatenate([jnp.asarray(rels), lc_T], 0),
        jnp.concatenate([jnp.ones(F - 1, jnp.float32), jnp.full(2, 10.0, jnp.float32)], 0),
        jnp.zeros(F, bool).at[0].set(True),
    )
    out1, s1 = pg.pgo_solve(graph, iterations=15)

    mesh = local_mesh(axis="edge")
    out2, s2 = sharded_pgo_solve(mesh, graph, iterations=15, axis="edge")
    # same math, different reduction order: poses agree to fp tolerance
    np.testing.assert_allclose(
        np.asarray(out2.poses), np.asarray(out1.poses), atol=2e-3)
    assert np.isclose(float(s2.chi), float(s1.chi), rtol=1e-3, atol=1e-5)


def test_window_edges_and_build_graph_api():
    gt = _circle_gt(30)
    rels, dead = _noisy_chain(gt, seed=7)
    eij, eT, ew = pg.window_edges(jnp.asarray(dead), window=8, step=4, skip=2)
    assert eij.shape[0] == eT.shape[0] == ew.shape[0] > 0
    graph = pg.build_graph(dead, extra_edges=[(eij, eT, ew)])
    out, stats = pg.pgo_solve(graph, iterations=10)
    assert np.all(np.isfinite(np.asarray(out.poses)))
    # consistency: solving a graph built FROM the trajectory keeps it intact
    # (window edges are exact relative poses of the same trajectory)
    np.testing.assert_allclose(
        np.asarray(out.poses)[:, :3, 3], dead[:, :3, 3], atol=1e-2)
