"""Golden-file regression vs the reference's shipped artifacts.

Row-wise tolerance diffs of parity-mode output against
``/root/reference/output/`` (written by exec/icp_test.cpp:147-210).  The
RANSAC draw differs from OpenCV's, so the tolerances are calibrated to the
measured CPU envelope (~2x headroom) — tight enough that drift like the
round-2 accelerator regression (trans_err_mean 0.44 vs the reference's 0.21, per-
frame deviations up to 1.66) fails every assertion here.
"""

import os

import numpy as np
import pytest

from jaxvo.config import EngineConfig
from jaxvo.engine.eval import evaluate, world_points_output
from jaxvo.engine.vo import run_sequence


@pytest.fixture(scope="module")
def parity_run(sequence):
    cfg = EngineConfig(mode="parity")
    state, logs, poses, diag = run_sequence(sequence, cfg)
    res = evaluate(poses, sequence.gt_pose, cfg)
    return cfg, state, res


def test_golden_scaled_trajectory(parity_run, output_dir):
    cfg, state, res = parity_run
    ref = np.loadtxt(os.path.join(output_dir, "estimated_trajectory_scaled.txt"))
    assert ref.shape[0] == res.poses_world.shape[0] == 121
    est_t = res.poses_world[:, :3, 3] * res.scale
    d = np.linalg.norm(est_t[:, :2] - ref[:, 1:3], axis=1)
    # measured CPU envelope: mean 0.056, max 0.333
    assert d.mean() < 0.10, f"trajectory diverged from golden: mean {d.mean():.3f}"
    assert d.max() < 0.45, f"trajectory diverged from golden: max {d.max():.3f}"


def test_golden_errors_file(parity_run, output_dir):
    cfg, state, res = parity_run
    ref = np.loadtxt(os.path.join(output_dir, "errors.txt"))
    d = np.abs(res.trans_err - ref[:, 1])
    # measured CPU envelope: mean 0.035, max 0.206
    assert d.mean() < 0.07, f"per-frame errors diverged: mean {d.mean():.3f}"
    # and our absolute error level must stay within the reference's bound
    assert res.trans_err.mean() < 0.30
    assert res.trans_err.max() < 0.60


def test_golden_world_points(parity_run, output_dir):
    cfg, state, res = parity_run
    ids, pts = world_points_output(state, cfg, res.scale)
    ref = np.loadtxt(os.path.join(output_dir, "estimated_world_points.txt"))
    # the reference reconstructs exactly 490 landmarks (README:7); parity
    # mode must reproduce the same landmark ID SET exactly
    assert len(ref) == 490
    np.testing.assert_array_equal(np.sort(ids), np.sort(ref[:, 0].astype(np.int32)))
    ref_map = {int(r[0]): r[1:4] for r in ref}
    d = np.array([np.linalg.norm(p - ref_map[int(i)]) for i, p in zip(ids, pts)])
    # measured: median 0.038, p90 1.02 (a few deep low-parallax points are
    # legitimately unstable under a different RANSAC draw — median/p90
    # bound the bulk without chasing them)
    assert np.median(d) < 0.10
    assert np.percentile(d, 90) < 2.0
