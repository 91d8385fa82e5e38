"""Tests for the reference's four executables re-expressed as drivers."""

import numpy as np
import pytest

from jaxvo.config import EngineConfig
from jaxvo.engine.drivers import (
    duplicate_landmark_count,
    run_match_test,
    run_pose_recovery,
    run_triangulate_test,
    run_vo,
)


def test_run_vo_variant(sequence):
    """vo.cpp: kernel 1000 / fixed 5 rounds / path-length scale
    (exec/vo.cpp, cam.cpp:183, cam.cpp:214-216, vo.cpp:216-223)."""
    state, logs, poses, diag = run_vo(sequence)
    assert int(state.map_count) > 300
    # every frame runs exactly 5 GN rounds, no convergence check
    assert (np.asarray(logs.iterations) == 5).all()
    # with kernel 1000 + 5 fixed rounds the tracker drifts through the
    # sparse section (the same behavior the threshold sweep shows for 1000;
    # vo.cpp's own error reporting is commented out, vo.cpp:183-212) — the
    # path-ratio scale is finite but not the Umeyama-quality ~0.2
    assert np.isfinite(diag["scale_path_ratio"]) and diag["scale_path_ratio"] > 0
    assert diag["duplicates"] >= 0


def test_match_test_driver(sequence):
    rows = run_match_test(sequence)
    assert len(rows) == 120
    total_f = sum(r.found for r in rows)
    total_c = sum(r.correct for r in rows)
    assert total_f > 4000
    assert total_c / total_f > 0.95  # matcher precision on the GT oracle


def test_pose_recovery_driver(sequence):
    """Chained two-view odometry (exec/pose_recovery_test.cpp) on a subset:
    unit-norm translations so scale drifts, but headings should chain."""
    sub = type(sequence)(*[np.asarray(a)[:15] for a in sequence])
    poses_world, inliers = run_pose_recovery(sub)
    assert poses_world.shape == (15, 4, 4)
    assert np.mean(inliers) > 30
    # rotations stay orthonormal through the chain
    R = poses_world[-1][:3, :3]
    assert np.allclose(R @ R.T, np.eye(3), atol=1e-4)


def test_triangulate_test_driver(sequence, world):
    ids, pts, gt = run_triangulate_test(sequence, world)
    assert len(ids) > 100
    # after the (unit-scale) bootstrap, estimated points differ from GT by
    # roughly the inverse scene scale; directions should correlate strongly
    valid = np.isfinite(gt).all(1)
    scale = np.median(np.linalg.norm(gt[valid], axis=1) / np.maximum(np.linalg.norm(pts[valid], axis=1), 1e-9))
    err = np.linalg.norm(pts[valid] * scale - gt[valid], axis=1)
    assert np.median(err) < 0.5


def test_duplicate_count_on_real_run(sequence):
    from jaxvo.engine.drivers import run_icp

    state, *_ = run_icp(sequence)
    d = duplicate_landmark_count(state)
    assert 0 <= d < 100  # the reference reports duplicates too (vo.cpp:162)
