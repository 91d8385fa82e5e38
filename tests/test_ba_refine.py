"""BA refinement over tracked trajectories (full-BA configs).

Two refiners exist:
  * ``refine_trajectory_global`` — joint BA over all poses + landmarks,
    gauge anchored at poses 0/1 (start of trajectory, minimal drift).
    The accuracy refiner: must STRICTLY improve trajectories.
  * ``refine_trajectory`` — overlapping-window sweep (the sharded/scaling
    formulation).  Local smoothing only; held to a non-degradation bound.
"""

import numpy as np
import pytest

from jaxvo.config import BAConfig, EngineConfig
from jaxvo.data import synthetic
from jaxvo.engine.ba_refine import refine_trajectory, refine_trajectory_global
from jaxvo.engine.eval import evaluate, metrics_dict
from jaxvo.engine.vo import run_sequence


@pytest.mark.slow
def test_global_refine_improves_noisy_synthetic():
    cfg = EngineConfig(mode="fixed")
    world = synthetic.make_world(21, n_landmarks=900, xy_extent=9.0)
    gt = synthetic.make_planar_trajectory(30, step=0.25, turn=0.03, seed=21)
    seq = synthetic.render_sequence(world, gt, cfg, pixel_noise=0.4, seed=21)
    state, logs, poses, diag = run_sequence(seq, cfg)
    m0 = metrics_dict(evaluate(poses, gt, cfg))

    ba_cfg = BAConfig(window=30, iterations=12)
    poses2, points2, stats = refine_trajectory_global(
        state, seq, poses, cfg, ba_cfg, n_sweeps=2)
    m1 = metrics_dict(evaluate(poses2, gt, cfg))
    assert np.isfinite(m1["ate_rmse"])
    # strict improvement: global BA must cut ATE by well over the 10%
    # north-star bound (measured ~100x on this fixture)
    assert m1["ate_rmse"] < 0.5 * m0["ate_rmse"]
    assert m1["ate_robot"] < 0.5 * m0["ate_robot"]
    assert all(np.isfinite(s["chi"]) for s in stats)


@pytest.mark.slow
def test_global_refine_real_sequence(sequence):
    """Bundled 121-frame sequence: the tracked trajectory carries real
    drift in the robot-frame metric (~0.05); global BA recovers the
    generator trajectory to numerical precision (the data is noiseless —
    projecting world.dat through gt_pose·mount reproduces observations to
    ~0.002 px)."""
    cfg = EngineConfig(mode="fixed")
    state, logs, poses, diag = run_sequence(sequence, cfg)
    m0 = metrics_dict(evaluate(poses, sequence.gt_pose, cfg))

    poses2, points2, stats = refine_trajectory_global(
        state, sequence, poses, cfg,
        BAConfig(window=121, iterations=15), n_sweeps=2)
    m1 = metrics_dict(evaluate(poses2, sequence.gt_pose, cfg))
    assert np.isfinite(m1["ate_rmse"])
    # >= 10% improvement required by the north star; measured: to ~0.0000
    assert m1["ate_robot"] < 0.9 * m0["ate_robot"]
    assert m1["ate_robot"] < 0.01
    # the reference-comparable camera-vs-robot metric sits at its
    # theoretical artifact floor (~0.193 = perfect camera trajectory)
    assert m1["ate_rmse"] < 0.21


def test_windowed_refine_nondegrading_real_prefix(sequence):
    cfg = EngineConfig(mode="fixed")
    sub = type(sequence)(*[np.asarray(a)[:40] for a in sequence])
    state, logs, poses, diag = run_sequence(sub, cfg)
    m0 = metrics_dict(evaluate(poses, sub.gt_pose, cfg))
    poses2, points2, stats = refine_trajectory(
        state, sub, poses, cfg, BAConfig(window=10, iterations=6)
    )
    m1 = metrics_dict(evaluate(poses2, sub.gt_pose, cfg))
    assert np.isfinite(m1["ate_rmse"])
    assert m1["ate_rmse"] <= m0["ate_rmse"] * 1.2


@pytest.mark.slow
def test_kitti_like_long_sequence():
    """BASELINE config 4 stand-in: long forward-motion sequence, deeper
    scene, tracking + global BA.  Window BA cannot repair global monocular
    drift (it is anchored to the drifted prefix); the global refiner must."""
    cfg = EngineConfig(mode="fixed")
    rng_world = synthetic.make_world(
        31, n_landmarks=3000, xy_extent=120.0, z_range=(0.0, 8.0)
    )
    gt = synthetic.make_kitti_like_trajectory(60, step=1.0, seed=31)
    seq = synthetic.render_sequence(rng_world, gt, cfg, pixel_noise=0.3, seed=31)
    assert seq.n_obs.min() >= 8
    cfg = cfg.replace(map_capacity=2048)
    state, logs, poses, diag = run_sequence(seq, cfg)
    m = metrics_dict(evaluate(poses, gt, cfg))
    assert np.isfinite(m["ate_rmse"])
    assert m["ate_rmse"] < 12.0  # 60 m travel, monocular scale drift allowed

    poses2, points2, stats = refine_trajectory_global(
        state, seq, poses, cfg,
        BAConfig(window=60, iterations=15, huber_threshold=500.0), n_sweeps=2)
    m2 = metrics_dict(evaluate(poses2, gt, cfg))
    assert np.isfinite(m2["ate_rmse"])
    # strict improvement (measured: 4.6 -> 0.05)
    assert m2["ate_rmse"] < 0.5 * m["ate_rmse"]
    assert not any(s["skipped"] for s in stats)
