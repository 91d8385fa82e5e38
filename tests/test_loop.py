"""Loop-closure pipeline (ba/loop.py): co-visibility detection, PnP
relocalization, pose-graph drift repair, and the full refine stack.

No reference counterpart (the reference never revisits poses,
exec/icp_test.cpp:61-136); completes BASELINE.json config 5.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

pytestmark = pytest.mark.slow  # module-scoped 120-frame SLAM fixture

from jaxvo.ba.loop import close_loops, covisibility_counts, detect_loops
from jaxvo.config import BAConfig, EngineConfig, PICPConfig
from jaxvo.data import synthetic
from jaxvo.engine.ba_refine import refine_trajectory_loop
from jaxvo.engine.eval import evaluate, metrics_dict
from jaxvo.engine.slam import run_sequence_slam
from jaxvo.ops.match import match_descriptors


def test_covisibility_counts_exact():
    # 3 frames, 4 landmarks: frame0 sees {0,1}, frame1 sees {1,2}, frame2 {0,1,3}
    obs_lm = jnp.asarray([[0, 1, 0], [1, 2, 1], [0, 1, 3]], jnp.int32)
    obs_valid = jnp.asarray([[True, True, False],
                             [True, True, False],
                             [True, True, True]])
    C = np.asarray(covisibility_counts(obs_lm, obs_valid, 8))
    expect = np.array([[2, 1, 2], [1, 2, 1], [2, 1, 3]], np.float32)
    np.testing.assert_allclose(C, expect)


def test_covisibility_tiled_parity():
    """Tiled (blocked-matmul) co-visibility == dense, including ids that
    straddle tile boundaries and invalid/duplicate observations."""
    rng = np.random.default_rng(0)
    F, N, L = 37, 24, 1000
    obs_lm = jnp.asarray(rng.integers(0, L, (F, N)).astype(np.int32))
    obs_valid = jnp.asarray(rng.random((F, N)) < 0.8)
    dense = np.asarray(covisibility_counts(obs_lm, obs_valid, L))
    for tile in (64, 128, 333):
        tiled = np.asarray(covisibility_counts(obs_lm, obs_valid, L, tile))
        np.testing.assert_allclose(tiled, dense, atol=1e-5, err_msg=str(tile))


def test_covisibility_auto_tiles_large_maps():
    """Above 16k landmarks the tiled path engages automatically (the
    dense (F, L) membership would be the first thing to OOM at the 100k
    config-5 scale) and still matches a hand-computed overlap."""
    L = 100_000
    obs_lm = jnp.asarray([[5, 99_000, 0], [99_000, 5, 1]], jnp.int32)
    obs_valid = jnp.ones((2, 3), bool)
    C = np.asarray(covisibility_counts(obs_lm, obs_valid, L))
    np.testing.assert_allclose(C, [[3, 2], [2, 3]])


def test_detect_loops_gap_and_threshold():
    F = 10
    C = np.zeros((F, F), np.float32)
    C[0, 9] = C[9, 0] = 20.0   # qualifying loop pair
    C[0, 2] = C[2, 0] = 50.0   # too close (gap)
    C[1, 8] = C[8, 1] = 3.0    # too few shared
    pairs, shared, valid = detect_loops(jnp.asarray(C), min_gap=5,
                                        min_shared=10, max_edges=4)
    pairs, valid = np.asarray(pairs), np.asarray(valid)
    assert valid.sum() == 1
    assert tuple(pairs[np.argmax(valid)]) == (0, 9)


@pytest.fixture(scope="module")
def loop_run():
    """SLAM-mode tracking over a 120-frame loop circuit (real drift)."""
    cfg = EngineConfig(mode="fixed", n_frames=120, map_capacity=8192,
                       fuse_frame_matchers=True,
                       picp=PICPConfig(convergence_threshold=1e-4),
                       ba=BAConfig(window=10, iterations=8,
                                   max_landmarks=8192))
    gt = synthetic.make_loop_trajectory(120, step=1.0, seed=13,
                                        turn_frames=10)
    extent = float(np.abs(gt[:, :2]).max()) + 15.0
    world = synthetic.make_world(13, n_landmarks=6000, xy_extent=extent,
                                 z_range=(0.0, 8.0))
    seq = synthetic.render_sequence(world, gt, cfg, pixel_noise=0.3, seed=13)
    state, logs, poses, diag = run_sequence_slam(seq, cfg)
    return cfg, gt, seq, state, np.asarray(poses)


def test_close_loops_repairs_drift(loop_run):
    cfg, gt, seq, state, poses = loop_run
    m0 = metrics_dict(evaluate(poses, gt, cfg))
    K = jnp.asarray(cfg.K())

    def mf(iv):
        r = match_descriptors(iv[0], iv[1], state.map_desc, state.map_valid,
                              cfg.matcher.distance_threshold,
                              cfg.matcher.ratio_threshold,
                              cfg.matcher.method)
        return r.idx, r.valid

    obs_lm, obs_valid = jax.lax.map(
        mf, (jnp.asarray(seq.desc), jnp.asarray(seq.valid)))
    poses_pgo, n_loops, chi = close_loops(
        K, jnp.asarray(poses), state.map_xyz, state.map_valid,
        jnp.asarray(seq.uv), obs_lm, obs_valid, cfg.width, cfg.height)
    assert int(n_loops) > 0
    m1 = metrics_dict(evaluate(np.asarray(poses_pgo), gt, cfg))
    assert np.isfinite(m1["ate_rmse"])
    # PGO must not degrade, and the final stack (next test) must repair
    assert m1["ate_rmse"] <= m0["ate_rmse"] * 1.05


def test_full_loop_refine_stack(loop_run):
    """SLAM tracking -> loop PGO -> graduated global BA: >= 10%% ATE cut
    (measured ~99%% on the 200-frame fixture; this is the hard gate)."""
    cfg, gt, seq, state, poses = loop_run
    m0 = metrics_dict(evaluate(poses, gt, cfg))
    poses2, points2, stats = refine_trajectory_loop(
        state, seq, poses, cfg,
        BAConfig(window=poses.shape[0], iterations=15,
                 huber_threshold=500.0, max_landmarks=8192))
    m1 = metrics_dict(evaluate(poses2, gt, cfg))
    assert np.isfinite(m1["ate_rmse"])
    assert stats[0]["stage"] == "pgo"
    assert m1["ate_rmse"] < 0.9 * m0["ate_rmse"]


def test_close_loops_nondegrading_without_drift():
    """Slow open path (no real drift): distant frames still co-observe
    landmarks (everything stays in view at 0.2 m/frame), so edges fire —
    but relocalization agrees with tracking and PGO must not degrade."""
    cfg = EngineConfig(mode="fixed", n_frames=40, map_capacity=4096,
                       ba=BAConfig(window=10, iterations=4,
                                   max_landmarks=4096))
    gt = synthetic.make_planar_trajectory(40, step=0.2, turn=0.0, seed=3)
    world = synthetic.make_world(3, n_landmarks=2000, xy_extent=12.0)
    seq = synthetic.render_sequence(world, gt, cfg, pixel_noise=0.2, seed=3)
    from jaxvo.engine.vo import run_sequence

    state, logs, poses, diag = run_sequence(seq, cfg)
    K = jnp.asarray(cfg.K())

    def mf(iv):
        r = match_descriptors(iv[0], iv[1], state.map_desc, state.map_valid,
                              cfg.matcher.distance_threshold,
                              cfg.matcher.ratio_threshold,
                              cfg.matcher.method)
        return r.idx, r.valid

    obs_lm, obs_valid = jax.lax.map(
        mf, (jnp.asarray(seq.desc), jnp.asarray(seq.valid)))
    poses_pgo, n_loops, chi = close_loops(
        K, jnp.asarray(poses, jnp.float32), state.map_xyz, state.map_valid,
        jnp.asarray(seq.uv), obs_lm, obs_valid, cfg.width, cfg.height)
    m0 = metrics_dict(evaluate(np.asarray(poses), gt, cfg))
    m1 = metrics_dict(evaluate(np.asarray(poses_pgo), gt, cfg))
    assert np.all(np.isfinite(np.asarray(poses_pgo)))
    assert m1["ate_rmse"] <= m0["ate_rmse"] * 1.1 + 1e-3
