import jax
import jax.numpy as jnp
import numpy as np
import pytest

from jaxvo.ops import lie


def rnd(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_rx_ry_rz_orthonormal():
    for f in (lie.rx, lie.ry, lie.rz):
        R = np.asarray(f(jnp.float32(0.3)))
        assert np.allclose(R @ R.T, np.eye(3), atol=1e-6)
        assert np.isclose(np.linalg.det(R), 1.0, atol=1e-6)


def test_v2t_euler_matches_reference_composition():
    v = jnp.array([1.0, 2.0, 3.0, 0.1, -0.2, 0.3], jnp.float32)
    T = np.asarray(lie.v2t_euler(v))
    R = np.asarray(lie.rx(jnp.float32(0.1)) @ lie.ry(jnp.float32(-0.2)) @ lie.rz(jnp.float32(0.3)))
    assert np.allclose(T[:3, :3], R, atol=1e-6)
    assert np.allclose(T[:3, 3], [1, 2, 3])
    assert np.allclose(T[3], [0, 0, 0, 1])


def test_skew_antisymmetric_cross():
    v = jnp.array([1.0, 2.0, 3.0])
    u = jnp.array([-0.5, 0.4, 2.0])
    S = np.asarray(lie.skew(v))
    assert np.allclose(S, -S.T)
    assert np.allclose(S @ np.asarray(u), np.cross(np.asarray(v), np.asarray(u)), atol=1e-6)


def test_inv_se3_roundtrip():
    v = jnp.array([0.3, -1.0, 2.0, 0.5, 0.2, -0.7], jnp.float32)
    T = lie.v2t_euler(v)
    I = np.asarray(T @ lie.inv_se3(T))
    assert np.allclose(I, np.eye(4), atol=1e-5)


def test_se3_exp_small_angle():
    xi = jnp.array([1e-9, 2e-9, 0.0, 1e-9, 0.0, 0.0], jnp.float32)
    T = np.asarray(lie.se3_exp(xi))
    assert np.all(np.isfinite(T))
    assert np.allclose(T, np.eye(4), atol=1e-6)


def test_v2t_quat_matches_rotation():
    # quaternion chart (defs.h:59-75): imaginary part in v[3:6]
    v = jnp.array([0.0, 0.0, 0.0, 0.1, 0.2, 0.05], jnp.float32)
    T = np.asarray(lie.v2t_quat(v))
    assert np.allclose(T[:3, :3] @ T[:3, :3].T, np.eye(3), atol=1e-6)
    # w >= 1 branch: identity rotation
    v_big = jnp.array([0.0, 0.0, 0.0, 1.0, 1.0, 1.0], jnp.float32)
    assert np.allclose(np.asarray(lie.v2t_quat(v_big))[:3, :3], np.eye(3))


def test_augment_pose():
    # my_utilities.cpp:245-260
    T = np.asarray(lie.augment_pose(jnp.array([1.0, 2.0, np.pi / 2], jnp.float32)))
    assert np.allclose(T[:3, 3], [1, 2, 0], atol=1e-6)
    assert np.allclose(T[:3, :3], [[0, -1, 0], [1, 0, 0], [0, 0, 1]], atol=1e-6)


def test_wrap_angle():
    assert np.isclose(abs(float(lie.wrap_angle(jnp.float32(3 * np.pi)))), np.pi, atol=1e-5)
    assert np.isclose(float(lie.wrap_angle(jnp.float32(2 * np.pi + 0.3))), 0.3, atol=1e-5)
    assert np.isclose(float(lie.wrap_angle(jnp.float32(-0.1))), -0.1, atol=1e-6)


def test_umeyama_recovers_similarity():
    rng = np.random.default_rng(3)
    src = rng.standard_normal((50, 3)).astype(np.float32)
    R = np.asarray(lie.rz(jnp.float32(0.7)) @ lie.rx(jnp.float32(-0.2)))
    c, t = 0.35, np.array([1.0, -2.0, 0.5], np.float32)
    dst = c * src @ R.T + t
    T = np.asarray(lie.umeyama(jnp.asarray(src), jnp.asarray(dst)))
    scale = np.linalg.norm(T[:3, 0])  # scale extraction as icp_test.cpp:169
    assert np.isclose(scale, c, atol=1e-4)
    assert np.allclose(T[:3, :3] / scale, R, atol=1e-4)
    assert np.allclose(T[:3, 3], t, atol=1e-4)
    # masked version ignores garbage rows
    src_pad = np.concatenate([src, 1e3 * np.ones((10, 3), np.float32)])
    dst_pad = np.concatenate([dst, np.zeros((10, 3), np.float32)])
    mask = np.concatenate([np.ones(50), np.zeros(10)]).astype(bool)
    T2 = np.asarray(lie.umeyama(jnp.asarray(src_pad), jnp.asarray(dst_pad), jnp.asarray(mask)))
    assert np.allclose(T2, T, atol=1e-3)


def test_umeyama_reflection_correction():
    # degenerate planar points must still produce det(R) = +1
    src = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0]], np.float32)
    dst = src[:, [1, 0, 2]].astype(np.float32)  # mirrored
    T = np.asarray(lie.umeyama(jnp.asarray(src), jnp.asarray(dst)))
    s = np.linalg.norm(T[:3, 0])
    assert np.linalg.det(T[:3, :3] / s) > 0


def test_se3_log_exp_roundtrip():
    rng = np.random.default_rng(7)
    for _ in range(20):
        xi = rng.uniform(-1.0, 1.0, 6).astype(np.float32)
        T = np.asarray(lie.se3_exp(jnp.asarray(xi)))
        xi2 = np.asarray(lie.se3_log(jnp.asarray(T)))
        assert np.allclose(xi2, xi, atol=1e-4), (xi, xi2)
    # small-angle branch
    xi = np.array([0.3, -0.2, 0.1, 1e-8, -1e-8, 1e-9], np.float32)
    T = np.asarray(lie.se3_exp(jnp.asarray(xi)))
    xi2 = np.asarray(lie.se3_log(jnp.asarray(T)))
    assert np.allclose(xi2, xi, atol=1e-5)
