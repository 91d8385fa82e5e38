"""PICP solver tests: numpy oracle replicating the C++ solver loop
sequentially, plus synthetic convergence and robustness checks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from jaxvo.config import EngineConfig, PICPConfig
from jaxvo.data import synthetic
from jaxvo.ops import lie, picp

CFG = EngineConfig()
K = CFG.K()


# ---------------------------------------------------------------------------
# numpy oracle: a literal sequential port of picp_solver.cpp + the
# icp_test.cpp GN schedule (for testing only — the JAX path never loops).
# ---------------------------------------------------------------------------
def np_v2t_euler(v):
    def rx(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)

    def ry(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)

    def rz(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)

    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = rx(v[3]) @ ry(v[4]) @ rz(v[5])
    T[:3, 3] = v[:3]
    return T


def np_skew(v):
    return np.array(
        [[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]], np.float32
    )


def oracle_picp(T, world_pts, image_uv, corrs, cfg: PICPConfig, width, height):
    """corrs: list of (img_idx, world_idx). Returns (T, iters, inliers, chi)."""
    prev = np.float32(np.finfo(np.float32).max)
    n_inl, chi_in = 0, 0.0
    it = 0
    for j in range(cfg.max_iterations):
        H = np.zeros((6, 6), np.float32)
        b = np.zeros(6, np.float32)
        n_inl, chi_in = 0, np.float32(0)
        for (ri, ci) in corrs:
            X = world_pts[ci]
            z = image_uv[ri]
            p_cam = T[:3, :3] @ X + T[:3, 3]
            if p_cam[2] <= 0:
                continue
            phom = K @ p_cam
            uv = phom[:2] / phom[2]
            if not (0 <= uv[0] <= width - 1 and 0 <= uv[1] <= height - 1):
                continue
            e = (uv - z).astype(np.float32)
            Jr = np.zeros((3, 6), np.float32)
            Jr[:, :3] = np.eye(3)
            Jr[:, 3:] = np_skew(-p_cam)
            iz = 1.0 / phom[2]
            iz2 = iz * iz
            Jp = np.array(
                [[iz, 0, -phom[0] * iz2], [0, iz, -phom[1] * iz2]], np.float32
            )
            J = Jp @ K @ Jr
            chi = float(e @ e)
            lam = 1.0
            inlier = True
            if chi > cfg.kernel_threshold:
                lam = np.sqrt(cfg.kernel_threshold / chi)
                inlier = False
            else:
                chi_in += np.float32(chi)
                n_inl += 1
            if inlier or cfg.keep_outliers:
                H += J.T @ J * lam
                b += J.T @ e * lam
        H += np.eye(6, dtype=np.float32) * cfg.damping
        if n_inl < cfg.min_num_inliers:
            break
        dx = np.linalg.solve(H, -b)
        T = np_v2t_euler(dx) @ T
        it = j + 1
        curr = chi_in
        rel = abs(prev - curr) / prev if prev > 1e-10 else 0.0
        if rel < cfg.convergence_threshold:
            break
        prev = curr
    return T, it, n_inl, chi_in


def make_problem(n_pts=120, noise=0.5, pose_err=0.05, seed=0):
    """Synthetic PICP problem: world points, observed pixels from GT pose,
    an initial pose perturbed from GT."""
    world = synthetic.make_world(seed, n_landmarks=600, xy_extent=6.0)
    gt = np.array([0.4, 0.1, 0.1], np.float32)
    T_wc = synthetic.camera_pose_from_gt(gt, CFG)
    T_cw = np.linalg.inv(T_wc).astype(np.float32)
    p_cam = world.xyz @ T_cw[:3, :3].T + T_cw[:3, 3]
    phom = p_cam @ K.T
    with np.errstate(divide="ignore", invalid="ignore"):
        uv = phom[:, :2] / phom[:, 2:3]
    ok = (p_cam[:, 2] > 0.1) & (uv[:, 0] >= 0) & (uv[:, 0] <= 639) & (uv[:, 1] >= 0) & (uv[:, 1] <= 479)
    sel = np.nonzero(ok)[0][:n_pts]
    rng = np.random.default_rng(seed)
    obs = uv[sel] + noise * rng.standard_normal((len(sel), 2))
    # initial pose: perturbed world-in-camera
    dv = pose_err * rng.standard_normal(6).astype(np.float32)
    T0 = (np_v2t_euler(dv) @ T_cw).astype(np.float32)
    return world.xyz[sel].astype(np.float32), obs.astype(np.float32), T_cw, T0


def test_matches_numpy_oracle_fixed_rounds():
    """Exact per-round math parity: disable the convergence check (it is a
    razor-edge fp decision — see test below) and compare the state after a
    fixed number of GN rounds against the sequential numpy port."""
    pts, obs, T_gt, T0 = make_problem()
    cfg = PICPConfig(
        kernel_threshold=3000.0, max_iterations=6, convergence_threshold=-1.0
    )
    corrs = [(i, i) for i in range(len(pts))]
    T_ref, it_ref, ninl_ref, chi_ref = oracle_picp(
        T0.copy(), pts, obs, corrs, cfg, CFG.width, CFG.height
    )
    res = picp.solve(
        jnp.asarray(K), jnp.asarray(T0), jnp.asarray(pts), jnp.asarray(obs),
        jnp.arange(len(pts), dtype=jnp.int32), jnp.ones(len(pts), bool),
        CFG.width, CFG.height, cfg,
    )
    assert int(res.iterations) == it_ref == 6
    assert int(res.num_inliers) == ninl_ref
    np.testing.assert_allclose(np.asarray(res.T), T_ref, atol=5e-4)
    assert np.isclose(float(res.chi_inliers), chi_ref, rtol=1e-3)


def test_matches_numpy_oracle_stopping_rule():
    """With the rel-chi stopping rule active, the batched reduction and the
    sequential oracle may disagree by one round when the relative
    improvement lands exactly at the threshold (different fp summation
    order); the converged POSE must still agree."""
    pts, obs, T_gt, T0 = make_problem()
    cfg = PICPConfig(kernel_threshold=3000.0)
    corrs = [(i, i) for i in range(len(pts))]
    T_ref, it_ref, ninl_ref, chi_ref = oracle_picp(
        T0.copy(), pts, obs, corrs, cfg, CFG.width, CFG.height
    )
    res = picp.solve(
        jnp.asarray(K), jnp.asarray(T0), jnp.asarray(pts), jnp.asarray(obs),
        jnp.arange(len(pts), dtype=jnp.int32), jnp.ones(len(pts), bool),
        CFG.width, CFG.height, cfg,
    )
    assert abs(int(res.iterations) - it_ref) <= 1
    assert int(res.num_inliers) == ninl_ref
    np.testing.assert_allclose(np.asarray(res.T), T_ref, atol=5e-4)
    assert np.isclose(float(res.chi_inliers), chi_ref, rtol=1e-3)


def test_converges_to_gt_pose():
    pts, obs, T_gt, T0 = make_problem(noise=0.0, pose_err=0.08)
    cfg = PICPConfig()
    res = picp.solve(
        jnp.asarray(K), jnp.asarray(T0), jnp.asarray(pts), jnp.asarray(obs),
        jnp.arange(len(pts), dtype=jnp.int32), jnp.ones(len(pts), bool),
        CFG.width, CFG.height, cfg,
    )
    T = np.asarray(res.T)
    # noise-free chi keeps shrinking geometrically, so the relative-improvement
    # rule never fires (same as the reference's "Convergence not reached")
    assert np.linalg.norm(T[:3, 3] - T_gt[:3, 3]) < 1e-3
    dR = T[:3, :3].T @ T_gt[:3, : 3]
    assert np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)) < 1e-3
    # with pixel noise, chi plateaus and the stopping rule triggers early
    pts, obs, T_gt, T0 = make_problem(noise=0.3, pose_err=0.08)
    res2 = picp.solve(
        jnp.asarray(K), jnp.asarray(T0), jnp.asarray(pts), jnp.asarray(obs),
        jnp.arange(len(pts), dtype=jnp.int32), jnp.ones(len(pts), bool),
        CFG.width, CFG.height, cfg,
    )
    assert bool(res2.converged) and int(res2.iterations) < 15


def test_outliers_are_saturated():
    pts, obs, T_gt, T0 = make_problem(noise=0.0, pose_err=0.05)
    rng = np.random.default_rng(1)
    bad = rng.choice(len(pts), len(pts) // 4, replace=False)
    obs_c = obs.copy()
    obs_c[bad] += rng.uniform(100, 300, (len(bad), 2))  # gross outliers
    cfg = PICPConfig(kernel_threshold=1000.0)
    res = picp.solve(
        jnp.asarray(K), jnp.asarray(T0), jnp.asarray(pts), jnp.asarray(obs_c),
        jnp.arange(len(pts), dtype=jnp.int32), jnp.ones(len(pts), bool),
        CFG.width, CFG.height, cfg,
    )
    T = np.asarray(res.T)
    # outliers excluded (keep_outliers=False) -> pose still accurate
    assert np.linalg.norm(T[:3, 3] - T_gt[:3, 3]) < 5e-3
    assert int(res.num_inliers) <= len(pts) - len(bad) + 5


def test_masked_correspondences_ignored():
    pts, obs, T_gt, T0 = make_problem(noise=0.2)
    n = len(pts)
    # garbage in masked rows must not affect the solution
    pts2 = np.concatenate([pts, 1e6 * np.ones((16, 3), np.float32)])
    obs2 = np.concatenate([obs, np.zeros((16, 2), np.float32)])
    idx = np.concatenate([np.arange(n), np.arange(n, n + 16)]).astype(np.int32)
    mask = np.concatenate([np.ones(n, bool), np.zeros(16, bool)])
    cfg = PICPConfig()
    r1 = picp.solve(
        jnp.asarray(K), jnp.asarray(T0), jnp.asarray(pts), jnp.asarray(obs),
        jnp.arange(n, dtype=jnp.int32), jnp.ones(n, bool),
        CFG.width, CFG.height, cfg,
    )
    r2 = picp.solve(
        jnp.asarray(K), jnp.asarray(T0), jnp.asarray(pts2), jnp.asarray(obs2),
        jnp.asarray(idx), jnp.asarray(mask),
        CFG.width, CFG.height, cfg,
    )
    np.testing.assert_allclose(np.asarray(r1.T), np.asarray(r2.T), atol=1e-5)
    assert int(r1.num_inliers) == int(r2.num_inliers)


def test_fixed_rounds_variant():
    pts, obs, T_gt, T0 = make_problem(noise=0.0, pose_err=0.05)
    cfg = PICPConfig(kernel_threshold=1000.0)
    res = picp.solve_fixed_rounds(
        jnp.asarray(K), jnp.asarray(T0), jnp.asarray(pts), jnp.asarray(obs),
        jnp.arange(len(pts), dtype=jnp.int32), jnp.ones(len(pts), bool),
        CFG.width, CFG.height, cfg, rounds=5,
    )
    assert int(res.iterations) == 5
    T = np.asarray(res.T)
    assert np.linalg.norm(T[:3, 3] - T_gt[:3, 3]) < 1e-2


def test_jit_and_grad_safe():
    """The solver must be jittable (it is the inner loop of the scan) and
    produce finite results with zero valid correspondences."""
    pts = np.ones((8, 3), np.float32)
    obs = np.zeros((8, 2), np.float32)
    cfg = PICPConfig()
    f = jax.jit(
        lambda T: picp.solve(
            jnp.asarray(K), T, jnp.asarray(pts), jnp.asarray(obs),
            jnp.arange(8, dtype=jnp.int32), jnp.zeros(8, bool),
            CFG.width, CFG.height, cfg,
        )
    )
    res = f(jnp.eye(4))
    assert np.all(np.isfinite(np.asarray(res.T)))


def test_unrolled_matches_while_loop():
    """solve_unrolled (static round count, done-mask select) must agree with
    the lax.while_loop driver whenever the loop converges within the cap."""
    pts, obs, T_gt, T0 = make_problem(noise=0.3, pose_err=0.08)
    cfg = PICPConfig(convergence_threshold=1e-4)
    args = (
        jnp.asarray(K), jnp.asarray(T0), jnp.asarray(pts), jnp.asarray(obs),
        jnp.arange(len(pts), dtype=jnp.int32), jnp.ones(len(pts), bool),
        CFG.width, CFG.height, cfg,
    )
    ref = picp.solve(*args)
    assert bool(ref.converged) and int(ref.iterations) <= 12
    unr = picp.solve_unrolled(*args, rounds=12)
    np.testing.assert_allclose(np.asarray(unr.T), np.asarray(ref.T), atol=1e-6)
    assert int(unr.iterations) == int(ref.iterations)
    assert int(unr.num_inliers) == int(ref.num_inliers)
    assert bool(unr.converged)
    # different fusion ⇒ fp reassociation in the chi reduction: 1e-5-level
    np.testing.assert_allclose(
        float(unr.chi_inliers), float(ref.chi_inliers), rtol=1e-4
    )
    # cap smaller than convergence: pose keeps the last computed update and
    # the converged flag reports the truth
    short = picp.solve_unrolled(*args, rounds=2)
    assert int(short.iterations) == 2
    assert not bool(short.converged)


@pytest.mark.slow
def test_unrolled_through_track_step():
    """The engine branch (cfg.picp.unrolled_rounds > 0) produces the same
    trajectory as the while_loop path on a synthetic sequence."""
    from jaxvo.config import EngineConfig
    from jaxvo.data import synthetic
    from jaxvo.engine import vo

    ecfg = EngineConfig(mode="fixed")
    world = synthetic.make_world(3, n_landmarks=600, xy_extent=6.0)
    gt = synthetic.make_planar_trajectory(8, step=0.2, turn=0.04, seed=3)
    seq = synthetic.render_sequence(world, gt, ecfg, pixel_noise=0.1, seed=3)
    key = jax.random.PRNGKey(0)

    def run(cfg):
        f0, f1 = vo.frame_of(seq, 0), vo.frame_of(seq, 1)
        state, _ = jax.jit(lambda k, a, b: vo.bootstrap(k, a, b, cfg))(key, f0, f1)
        tracker = vo.make_tracker(cfg)
        _, logs = tracker(state, vo.frames_of(seq, 0, 7), vo.frames_of(seq, 1, 8))
        return np.asarray(logs.pose)

    import dataclasses

    base = run(ecfg)
    fast = run(
        dataclasses.replace(
            ecfg,
            picp=dataclasses.replace(ecfg.picp, unrolled_rounds=50),
            scan_unroll=2,
        )
    )
    np.testing.assert_allclose(fast, base, atol=1e-5)
