"""Sliding-window BA tests on synthetic problems with known ground truth."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from jaxvo.ba.window import BAProblem, ba_solve, ba_step, linearize_ba
from jaxvo.config import BAConfig, EngineConfig
from jaxvo.data import synthetic

CFG = EngineConfig()
K = jnp.asarray(CFG.K())


def make_ba_problem(
    W=8, L=256, noise_px=0.0, pose_noise=0.0, point_noise=0.0, seed=0,
    fix_first_two=True,
):
    """Render a synthetic window and perturb the initial estimates."""
    rng = np.random.default_rng(seed)
    world = synthetic.make_world(seed, n_landmarks=L, xy_extent=6.0)
    gt = synthetic.make_planar_trajectory(W, step=0.25, turn=0.05, seed=seed)
    seq = synthetic.render_sequence(world, gt, CFG, pixel_noise=noise_px, seed=seed)

    poses_gt = np.stack(
        [np.linalg.inv(synthetic.camera_pose_from_gt(g, CFG)) for g in gt]
    ).astype(np.float32)  # world-in-camera

    N = seq.uv.shape[1]
    obs_lm = np.where(seq.valid, seq.id_real, 0).astype(np.int32)

    poses0 = poses_gt.copy()
    if pose_noise > 0:
        from jaxvo.ops import lie

        for i in range(2 if fix_first_two else 1, W):
            xi = pose_noise * rng.standard_normal(6).astype(np.float32)
            poses0[i] = np.asarray(lie.se3_exp(jnp.asarray(xi))) @ poses0[i]
    points0 = world.xyz.copy()
    if point_noise > 0:
        points0 = points0 + point_noise * rng.standard_normal(points0.shape).astype(np.float32)

    fixed = np.zeros(W, bool)
    fixed[0] = True
    if fix_first_two:
        fixed[1] = True

    prob = BAProblem(
        poses=jnp.asarray(poses0),
        points=jnp.asarray(points0.astype(np.float32)),
        obs_uv=jnp.asarray(seq.uv[:W]),
        obs_lm=jnp.asarray(obs_lm[:W]),
        obs_valid=jnp.asarray(seq.valid[:W]),
        point_valid=jnp.ones(L, bool),
        fixed=jnp.asarray(fixed),
    )
    return prob, poses_gt, world


def reproj_rms(prob):
    from jaxvo.ops.camera import project_points

    errs = []
    for f in range(prob.poses.shape[0]):
        X = prob.points[prob.obs_lm[f]]
        uv, ok = project_points(K, prob.poses[f], X, CFG.width, CFG.height)
        m = np.asarray(prob.obs_valid[f] & ok)
        e = np.linalg.norm(np.asarray(uv - prob.obs_uv[f]), axis=1)[m]
        errs.append(e)
    e = np.concatenate(errs)
    return float(np.sqrt((e**2).mean()))


def test_ba_zero_residual_at_gt():
    prob, poses_gt, world = make_ba_problem(noise_px=0.0)
    assert reproj_rms(prob) < 1e-3
    # one BA step must not break a perfect solution
    cfg = BAConfig(iterations=1)
    prob2, stats = ba_step(prob, K, CFG.width, CFG.height, cfg)
    assert reproj_rms(prob2) < 1e-2


def test_ba_recovers_perturbed_poses():
    prob, poses_gt, world = make_ba_problem(pose_noise=0.03, seed=1)
    assert reproj_rms(prob) > 1.0  # perturbation visible
    cfg = BAConfig(iterations=10, damping=1e-3)
    solve = jax.jit(lambda p: ba_solve(p, K, CFG.width, CFG.height, cfg))
    prob2, stats = solve(prob)
    assert reproj_rms(prob2) < 1e-2
    # poses back at GT
    err_t = np.linalg.norm(
        np.asarray(prob2.poses)[:, :3, 3] - poses_gt[:, :3, 3], axis=1
    )
    assert err_t.max() < 1e-2


def test_ba_recovers_perturbed_points():
    prob, poses_gt, world = make_ba_problem(point_noise=0.05, seed=2)
    # 15 iterations: the adaptive-LM lambda starts at 1.0 (scale-relative,
    # so no longer negligible) and halves per accepted step — the endgame
    # needs the extra rounds to reach the GN fixed point
    cfg = BAConfig(iterations=15)
    prob2, stats = ba_solve(prob, K, CFG.width, CFG.height, cfg)
    assert reproj_rms(prob2) < 1e-2
    # observed landmarks pulled back to GT
    seen = np.zeros(world.xyz.shape[0], bool)
    seen[np.unique(np.asarray(prob.obs_lm)[np.asarray(prob.obs_valid)])] = True
    err = np.linalg.norm(np.asarray(prob2.points) - world.xyz, axis=1)
    assert np.median(err[seen]) < 1e-2


def test_ba_joint_with_noise():
    prob, poses_gt, world = make_ba_problem(
        noise_px=0.3, pose_noise=0.02, point_noise=0.03, seed=3
    )
    cfg = BAConfig(iterations=15, damping=1e-3)
    prob2, stats = ba_solve(prob, K, CFG.width, CFG.height, cfg)
    # converges to the noise floor (~noise_px)
    assert reproj_rms(prob2) < 0.6
    err_t = np.linalg.norm(
        np.asarray(prob2.poses)[:, :3, 3] - poses_gt[:, :3, 3], axis=1
    )
    assert err_t.max() < 0.05


def test_ba_robust_kernel_rejects_outliers():
    prob, poses_gt, world = make_ba_problem(pose_noise=0.02, seed=4)
    # corrupt 10% of observations grossly
    rng = np.random.default_rng(4)
    uv = np.asarray(prob.obs_uv).copy()
    valid = np.asarray(prob.obs_valid)
    W, N = valid.shape
    for f in range(W):
        rows = np.nonzero(valid[f])[0]
        bad = rng.choice(rows, max(1, len(rows) // 10), replace=False)
        uv[f, bad] += rng.uniform(100, 300, (len(bad), 2))
    prob = prob._replace(obs_uv=jnp.asarray(uv))
    cfg = BAConfig(iterations=12, damping=1e-3, huber_threshold=1000.0)
    prob2, stats = ba_solve(prob, K, CFG.width, CFG.height, cfg)
    err_t = np.linalg.norm(
        np.asarray(prob2.poses)[:, :3, 3] - poses_gt[:, :3, 3], axis=1
    )
    assert err_t.max() < 0.05


def test_ba_fixed_poses_do_not_move():
    prob, poses_gt, world = make_ba_problem(pose_noise=0.03, point_noise=0.02, seed=5)
    cfg = BAConfig(iterations=8)
    prob2, stats = ba_solve(prob, K, CFG.width, CFG.height, cfg)
    np.testing.assert_array_equal(
        np.asarray(prob2.poses[:2]), np.asarray(prob.poses[:2])
    )


def test_linearize_shapes():
    prob, *_ = make_ba_problem(W=4, L=64)
    cfg = BAConfig()
    Hpp, bp, Hll, bl, Wfl, stats = linearize_ba(prob, K, CFG.width, CFG.height, cfg)
    assert Hpp.shape == (4, 6, 6) and bp.shape == (4, 6)
    assert Hll.shape == (64, 3, 3) and bl.shape == (64, 3)
    assert Wfl.shape == (64, 4, 6, 3)
    # Hpp symmetric PSD
    H = np.asarray(Hpp)
    assert np.allclose(H, np.swapaxes(H, 1, 2), atol=1e-3)


def test_ba_compact_matches_full():
    """Active-landmark compaction must match the uncompacted solve."""
    prob, poses_gt, world = make_ba_problem(
        W=8, L=1500, noise_px=0.3, pose_noise=0.02, point_noise=0.05, seed=5
    )
    cfg = BAConfig(window=8, iterations=6, max_landmarks=1500)
    full, s_full = ba_solve(prob, K, CFG.width, CFG.height, cfg, compact=False)
    comp, s_comp = ba_solve(prob, K, CFG.width, CFG.height, cfg, compact=True)
    np.testing.assert_allclose(
        np.asarray(comp.poses), np.asarray(full.poses), atol=1e-4)
    np.testing.assert_allclose(
        np.asarray(comp.points), np.asarray(full.points), atol=1e-3)
    assert int(s_comp.num_inliers) == int(s_full.num_inliers)
    # untouched landmarks stay bit-identical
    touched = np.zeros(1500, bool)
    touched[np.asarray(prob.obs_lm)[np.asarray(prob.obs_valid)]] = True
    assert np.array_equal(
        np.asarray(comp.points)[~touched], np.asarray(prob.points)[~touched])


def test_assembly_onehot_matches_segsum():
    """The SLAM-mode local BA hard-codes assembly='onehot' (one-hot
    matmuls instead of segment_sum scatters); the two
    assemblies must produce identical normal-equation blocks and solves.
    Fast non-slow coverage for the production default path."""
    import sys, os
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "benchmarks"))
    from ba_scaling import build_problem

    cfg, prob = build_problem(W=5, L=256, obs_per_frame=64, seed=11)
    K = jnp.asarray(cfg.K())
    a = BAConfig(iterations=4, assembly="segsum")
    b = BAConfig(iterations=4, assembly="onehot")
    from jaxvo.ba.window import linearize_ba

    la = linearize_ba(prob, K, cfg.width, cfg.height, a)
    lb = linearize_ba(prob, K, cfg.width, cfg.height, b)
    for i in range(5):  # Hpp, bp, Hll, bl, Wfl
        np.testing.assert_allclose(np.asarray(la[i]), np.asarray(lb[i]),
                                   rtol=1e-5, atol=1e-4)
    pa, _ = ba_solve(prob, K, cfg.width, cfg.height, a)
    pb, _ = ba_solve(prob, K, cfg.width, cfg.height, b)
    np.testing.assert_allclose(np.asarray(pa.poses), np.asarray(pb.poses),
                               atol=1e-5)


def test_compact_mask_matches_sort():
    """Sort-free 'mask' renumbering (the SLAM-mode default) is an exact
    twin of the argsort-based compaction, including the capped-overflow
    sentinel case."""
    from jaxvo.ba.window import _compact_active, _compact_active_mask

    rng = np.random.default_rng(5)
    for L, La, rows, cols in ((64, 33, 4, 12), (512, 65, 6, 50),
                              (100, 10, 4, 20)):
        lm = jnp.asarray(rng.integers(0, L, size=(rows, cols)).astype(np.int32))
        valid = jnp.asarray(rng.random((rows, cols)) > 0.3)
        a_lm, a_old = _compact_active(lm, valid, L, La)
        b_lm, b_old = _compact_active_mask(lm, valid, L, La)
        np.testing.assert_array_equal(np.asarray(a_lm), np.asarray(b_lm))
        np.testing.assert_array_equal(np.asarray(a_old), np.asarray(b_old))


def test_compact_cap_drops_not_corrupts():
    """With compact_cap below the unique-landmark count, overflow
    observations are DROPPED (visible in stats.num_obs) — never
    aggregated into a corrupted pseudo-landmark — and the solve stays
    finite."""
    import sys, os
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "benchmarks"))
    from ba_scaling import build_problem

    cfg, prob = build_problem(W=5, L=512, obs_per_frame=128, seed=13)
    K = jnp.asarray(cfg.K())
    exact = BAConfig(iterations=3)
    capped = BAConfig(iterations=3, compact_cap=64, compact_method="mask")
    pa, sa = ba_solve(prob, K, cfg.width, cfg.height, exact)
    pb, sb = ba_solve(prob, K, cfg.width, cfg.height, capped)
    assert int(sb.num_obs) < int(sa.num_obs)  # the cap is not silent
    assert np.isfinite(np.asarray(pb.poses)).all()
    assert np.isfinite(np.asarray(pb.points)).all()
