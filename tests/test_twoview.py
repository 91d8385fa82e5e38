"""Two-view initializer + triangulation tests: synthetic closed-loop
(near-zero error) and the real frames 0-1 bootstrap vs world.dat."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from jaxvo.config import EngineConfig, RansacConfig
from jaxvo.data import synthetic
from jaxvo.ops import lie, triangulate, twoview
from jaxvo.ops.match import match_descriptors

CFG = EngineConfig()
K = jnp.asarray(CFG.K())


def make_two_frames(pixel_noise=0.0, seed=0):
    world = synthetic.make_world(seed, n_landmarks=400, xy_extent=6.0)
    gt = np.array([[0, 0, 0], [0.2, 0.05, 0.05]], np.float32)
    seq = synthetic.render_sequence(world, gt, CFG, pixel_noise=pixel_noise, seed=seed)
    return world, gt, seq


def correspondences_by_id(seq):
    """Perfect correspondences via the id_real oracle."""
    ids0 = seq.id_real[0][seq.valid[0]]
    ids1 = seq.id_real[1][seq.valid[1]]
    common, i0, i1 = np.intersect1d(ids0, ids1, return_indices=True)
    return seq.uv[0][seq.valid[0]][i0], seq.uv[1][seq.valid[1]][i1], common


def pad(a, n, dim=2):
    out = np.zeros((n, dim), np.float32)
    out[: len(a)] = a
    m = np.zeros(n, bool)
    m[: len(a)] = True
    return out, m


def test_essential_8pt_exact():
    world, gt, seq = make_two_frames()
    uv1, uv2, _ = correspondences_by_id(seq)
    x1 = twoview.normalize_points(jnp.asarray(uv1), K)
    x2 = twoview.normalize_points(jnp.asarray(uv2), K)
    E = twoview.essential_8pt(x1, x2)
    err = np.asarray(twoview.sampson_error(E, x1, x2))
    assert np.median(err) < 1e-8  # noise-free -> essentially exact


def test_bootstrap_recovers_relative_pose():
    world, gt, seq = make_two_frames()
    uv1, uv2, _ = correspondences_by_id(seq)
    N = 256
    uv1p, m = pad(uv1, N)
    uv2p, _ = pad(uv2, N)
    key = jax.random.PRNGKey(42)
    T21, rres, pres = twoview.bootstrap_pose(
        key, K, jnp.asarray(uv1p), jnp.asarray(uv2p), jnp.asarray(m), CFG.ransac
    )
    assert int(rres.num_inliers) > 0.9 * m.sum()
    # ground-truth relative camera pose (camera-2 in camera-1 frame)
    T_wc1 = synthetic.camera_pose_from_gt(gt[0], CFG)
    T_wc2 = synthetic.camera_pose_from_gt(gt[1], CFG)
    T12_gt = np.linalg.inv(T_wc1) @ T_wc2
    T21_np = np.asarray(T21)
    # rotation must match tightly
    dR = T21_np[:3, :3].T @ T12_gt[:3, :3]
    ang = np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))
    assert ang < 1e-3
    # translation direction matches up to the (unit) scale
    t_est = T21_np[:3, 3] / np.linalg.norm(T21_np[:3, 3])
    t_gt = T12_gt[:3, 3] / np.linalg.norm(T12_gt[:3, 3])
    assert np.dot(t_est, t_gt) > 0.999


def test_triangulation_synthetic_exact():
    world, gt, seq = make_two_frames()
    uv1, uv2, ids = correspondences_by_id(seq)
    T_wc1 = synthetic.camera_pose_from_gt(gt[0], CFG)
    T_wc2 = synthetic.camera_pose_from_gt(gt[1], CFG)
    pts, finite = triangulate.triangulate_two_view(
        K, jnp.asarray(T_wc1), jnp.asarray(T_wc2), jnp.asarray(uv1), jnp.asarray(uv2)
    )
    gt_pts = world.xyz[np.searchsorted(world.ids, ids)]
    err = np.linalg.norm(np.asarray(pts) - gt_pts, axis=1)
    assert np.asarray(finite).all()
    assert np.median(err) < 1e-2
    assert np.mean(err < 0.1) > 0.95


def test_triangulation_matches_projection_roundtrip():
    """Triangulated points reproject onto the original pixels."""
    world, gt, seq = make_two_frames()
    uv1, uv2, _ = correspondences_by_id(seq)
    T_wc1 = synthetic.camera_pose_from_gt(gt[0], CFG)
    T_wc2 = synthetic.camera_pose_from_gt(gt[1], CFG)
    pts, _ = triangulate.triangulate_two_view(
        K, jnp.asarray(T_wc1), jnp.asarray(T_wc2), jnp.asarray(uv1), jnp.asarray(uv2)
    )
    from jaxvo.ops import camera as cam_ops

    uv_re, valid = cam_ops.project_points(
        K, lie.inv_se3(jnp.asarray(T_wc1)), pts, CFG.width, CFG.height
    )
    err = np.linalg.norm(np.asarray(uv_re) - uv1, axis=1)
    assert np.median(err[np.asarray(valid)]) < 1e-2


def test_real_bootstrap_frames01(sequence, world):
    """Bootstrap on the real frames 0-1 (the icp_test path) and check the
    triangulated map against world.dat through a similarity alignment."""
    s = sequence
    res = match_descriptors(
        jnp.asarray(s.desc[0]), jnp.asarray(s.valid[0]),
        jnp.asarray(s.desc[1]), jnp.asarray(s.valid[1]),
    )
    m_valid = np.asarray(res.valid)
    idx = np.asarray(res.idx)
    uv1 = s.uv[0]
    uv2 = s.uv[1][idx]
    key = jax.random.PRNGKey(42)
    T21, rres, pres = twoview.bootstrap_pose(
        key, K, jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(m_valid), CFG.ransac
    )
    n_matches = m_valid.sum()
    assert int(rres.num_inliers) > 0.7 * n_matches
    # triangulate all matches (reference triangulates without masking)
    pts, _ = triangulate.triangulate_two_view(
        K, jnp.eye(4), T21, jnp.asarray(uv1), jnp.asarray(uv2)
    )
    pts = np.asarray(pts)
    # compare against GT world points by id_real, for RANSAC inliers only
    ids = s.id_real[0]
    inl = m_valid & np.asarray(rres.inliers)
    gt_idx = np.searchsorted(world.ids, ids[inl])
    gt_pts = world.xyz[gt_idx]
    est = jnp.asarray(pts[inl])
    T_align = np.asarray(lie.umeyama(est, jnp.asarray(gt_pts)))
    aligned = pts[inl] @ T_align[:3, :3].T + T_align[:3, 3]
    err = np.linalg.norm(aligned - gt_pts, axis=1)
    # scale of the alignment should be near the GT scale ~0.2 (unit-norm t
    # vs 0.2 m first step)
    scale = np.linalg.norm(T_align[:3, 0])
    assert 0.1 < scale < 0.4
    assert np.median(err) < 0.2  # metres, in GT world units


def test_ransac_deterministic():
    world, gt, seq = make_two_frames(pixel_noise=0.3)
    uv1, uv2, _ = correspondences_by_id(seq)
    uv1p, m = pad(uv1, 256)
    uv2p, _ = pad(uv2, 256)
    key = jax.random.PRNGKey(7)
    r1 = twoview.ransac_essential(
        key, twoview.normalize_points(jnp.asarray(uv1p), K),
        twoview.normalize_points(jnp.asarray(uv2p), K),
        jnp.asarray(m), CFG.ransac, float(K[0, 0]),
    )
    r2 = twoview.ransac_essential(
        key, twoview.normalize_points(jnp.asarray(uv1p), K),
        twoview.normalize_points(jnp.asarray(uv2p), K),
        jnp.asarray(m), CFG.ransac, float(K[0, 0]),
    )
    assert np.array_equal(np.asarray(r1.inliers), np.asarray(r2.inliers))
    assert np.allclose(np.asarray(r1.E), np.asarray(r2.E))


def test_ransac_rejects_outliers():
    world, gt, seq = make_two_frames(pixel_noise=0.2)
    uv1, uv2, _ = correspondences_by_id(seq)
    # corrupt 30% of correspondences
    rng = np.random.default_rng(0)
    n_bad = len(uv1) // 3
    bad = rng.choice(len(uv1), n_bad, replace=False)
    uv2c = uv2.copy()
    uv2c[bad] = rng.uniform(0, 600, (n_bad, 2))
    uv1p, m = pad(uv1, 256)
    uv2p, _ = pad(uv2c, 256)
    key = jax.random.PRNGKey(42)
    T21, rres, pres = twoview.bootstrap_pose(
        key, K, jnp.asarray(uv1p), jnp.asarray(uv2p), jnp.asarray(m), CFG.ransac
    )
    inl = np.asarray(rres.inliers)
    # outlier rows must be (almost all) excluded
    assert inl[bad].mean() < 0.1
    # and the pose still close to GT
    T_wc1 = synthetic.camera_pose_from_gt(gt[0], CFG)
    T_wc2 = synthetic.camera_pose_from_gt(gt[1], CFG)
    T12_gt = np.linalg.inv(T_wc1) @ T_wc2
    dR = np.asarray(T21)[:3, :3].T @ T12_gt[:3, :3]
    ang = np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))
    assert ang < 0.02
