"""Fault-injection robustness tests: the engine degrades gracefully where
the reference would exit(EXIT_FAILURE) or silently derail."""

import numpy as np
import pytest

from jaxvo.config import EngineConfig, PICPConfig
from jaxvo.data import synthetic
from jaxvo.engine.eval import evaluate, metrics_dict
from jaxvo.engine.vo import run_sequence
from jaxvo.utils import faults
from jaxvo.utils.checks import validate_state


@pytest.fixture(scope="module")
def clean_seq():
    cfg = EngineConfig()
    world = synthetic.make_world(11, n_landmarks=800, xy_extent=8.0)
    gt = synthetic.make_planar_trajectory(30, seed=11)
    return synthetic.render_sequence(world, gt, cfg, pixel_noise=0.2, seed=11), gt


def run(seq, gt, **cfg_kw):
    cfg = EngineConfig(
        mode="fixed",
        picp=PICPConfig(min_matches_reuse_pose=10),
        **cfg_kw,
    )
    state, logs, poses, diag = run_sequence(seq, cfg)
    validate_state(state)
    return metrics_dict(evaluate(poses, gt, cfg)), state


@pytest.mark.slow
def test_outlier_pixels_tolerated(clean_seq):
    """10% of pixels kicked by up to 150 px: tracking must stay graceful
    (finite, bounded drift), and the robust global-BA pass with a tighter
    kernel must recover most of the damage (the corrupted observations
    saturate the robust weight and are excluded)."""
    from jaxvo.config import BAConfig
    from jaxvo.engine.ba_refine import refine_trajectory_global
    from jaxvo.engine.vo import run_sequence

    seq, gt = clean_seq
    bad = faults.corrupt_pixels(seq, fraction=0.1, magnitude=150.0, seed=1)
    cfg = EngineConfig(mode="fixed", picp=PICPConfig(min_matches_reuse_pose=10))
    state, logs, poses, diag = run_sequence(bad, cfg)
    m = metrics_dict(evaluate(poses, gt, cfg))
    assert np.isfinite(m["ate_rmse"])
    # graceful: corrupted input degrades but never derails the tracker
    assert m["ate_robot"] < 1.5
    poses2, _, _ = refine_trajectory_global(
        state, bad, poses, cfg,
        BAConfig(window=poses.shape[0], iterations=12, huber_threshold=100.0),
        n_sweeps=2,
    )
    m2 = metrics_dict(evaluate(poses2, gt, cfg))
    assert m2["ate_robot"] < 0.7 * m["ate_robot"]


def test_corrupted_descriptors_tolerated(clean_seq):
    seq, gt = clean_seq
    bad = faults.corrupt_descriptors(seq, fraction=0.2, sigma=2.0, seed=2)
    m, state = run(bad, gt)
    assert np.isfinite(m["ate_rmse"])
    assert m["ate_rmse"] < 0.5


def test_dropped_frame_does_not_crash(clean_seq):
    """A fully dropped frame yields zero matches; the engine keeps the last
    pose and keeps going (the reference would derail)."""
    seq, gt = clean_seq
    bad = faults.drop_frames(seq, [12], seed=3)
    m, state = run(bad, gt)
    assert np.isfinite(m["ate_rmse"])
    # trajectory after the gap recovers to something sane
    assert m["ate_rmse"] < 1.0


def test_online_vo_survives_corrupt_frames():
    """Serving robustness: an OnlineVO session fed empty and noise-bombed
    frames mid-stream must keep the last pose (graceful degradation,
    my_utilities.cpp:269-273 semantics) and recover on good frames."""
    import jax.numpy as jnp

    from jaxvo.config import EngineConfig, PICPConfig
    from jaxvo.data import synthetic
    from jaxvo.engine import vo

    cfg = EngineConfig(mode="fixed", map_capacity=256, max_obs=64,
                       picp=PICPConfig(min_matches_reuse_pose=8))
    world = synthetic.make_world(21, n_landmarks=400, xy_extent=8.0)
    gt = synthetic.make_planar_trajectory(14, seed=21)
    seq = synthetic.render_sequence(world, gt, cfg, seed=21)
    F = seq.uv.shape[0]

    sess = vo.OnlineVO(cfg, seed=42)
    sess.start(vo.frame_of(seq, 0), vo.frame_of(seq, 1))
    last = None
    for i in range(1, F):
        f = vo.frame_of(seq, i)
        if i == F // 2:  # drop every observation in this frame
            f = f._replace(valid=jnp.zeros_like(f.valid))
        p = np.asarray(sess.step(f))
        assert np.all(np.isfinite(p)), i
        if i == F // 2:
            # starvation -> previous pose reused
            np.testing.assert_allclose(p, last, atol=1e-6)
        last = p
    # the session tracked through: final pose moved past the glitch
    assert np.linalg.norm(last[:3, 3]) > 0.1
