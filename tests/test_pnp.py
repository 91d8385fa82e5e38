"""DLT PnP (ops/pnp.py) — pose from 2D-3D correspondences, no init.

No reference counterpart (the reference's only pose estimator, PICP, is a
local GN method, picp_solver.cpp); PnP is the basin-free initializer the
loop-closure relocalization needs (ba/loop.py).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from jaxvo.config import EngineConfig
from jaxvo.ops import lie
from jaxvo.ops.pnp import pnp_dlt, pnp_solve

CFG = EngineConfig()
K = jnp.asarray(CFG.K())


def _random_pose_and_points(seed, n=64, n_valid=None, noise_px=0.0):
    rng = np.random.default_rng(seed)
    xi = rng.uniform(-1, 1, 6).astype(np.float32)
    xi[3:] *= 0.5
    T = np.array(lie.se3_exp(jnp.asarray(xi)))  # world-in-camera
    T[:3, 3] = rng.uniform(-30, 30, 3)
    p_cam = np.stack([rng.uniform(-2, 2, n), rng.uniform(-2, 2, n),
                      rng.uniform(2, 10, n)], -1).astype(np.float32)
    X = (p_cam - T[:3, 3]) @ T[:3, :3]  # world pts: R X + t = p_cam
    ph = p_cam @ np.asarray(K).T
    uv = (ph[:, :2] / ph[:, 2:]).astype(np.float32)
    if noise_px:
        uv = uv + noise_px * rng.standard_normal(uv.shape).astype(np.float32)
    valid = np.zeros(n, bool)
    valid[: (n_valid if n_valid is not None else n)] = True
    return T, X.astype(np.float32), uv, valid


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_dlt_exact(seed):
    T, X, uv, valid = _random_pose_and_points(seed, n_valid=50)
    Td, ok = pnp_dlt(K, jnp.asarray(X), jnp.asarray(uv), jnp.asarray(valid))
    assert bool(ok)
    assert np.abs(np.asarray(Td) - T).max() < 1e-3


def test_dlt_ignores_invalid_rows():
    T, X, uv, valid = _random_pose_and_points(5, n_valid=40)
    # poison the invalid rows — they must not affect the solution
    X2 = X.copy()
    X2[~valid] = 1e4
    uv2 = uv.copy()
    uv2[~valid] = -1e5
    Td, ok = pnp_dlt(K, jnp.asarray(X2), jnp.asarray(uv2), jnp.asarray(valid))
    assert bool(ok)
    assert np.abs(np.asarray(Td) - T).max() < 1e-3


def test_dlt_too_few_points():
    T, X, uv, valid = _random_pose_and_points(6, n_valid=5)
    Td, ok = pnp_dlt(K, jnp.asarray(X), jnp.asarray(uv), jnp.asarray(valid))
    assert not bool(ok)
    np.testing.assert_allclose(np.asarray(Td), np.eye(4))  # safe fallback


def test_polish_tightens_noisy_dlt():
    T, X, uv, valid = _random_pose_and_points(7, noise_px=0.5)
    Td, _ = pnp_dlt(K, jnp.asarray(X), jnp.asarray(uv), jnp.asarray(valid))
    Tp, ok = pnp_solve(K, jnp.asarray(X), jnp.asarray(uv), jnp.asarray(valid),
                       CFG.width, CFG.height)
    assert bool(ok)
    err_d = np.abs(np.asarray(Td) - T).max()
    err_p = np.abs(np.asarray(Tp) - T).max()
    # the polish optimum is the ML reprojection fit — close to but not
    # identical with the DLT algebraic fit under noise
    assert err_p <= max(1.5 * err_d, 0.01)
    assert err_p < 0.15  # ~dm translation accuracy at 0.5 px noise


def test_pnp_vmappable():
    Ts, Xs, uvs, valids = zip(*[_random_pose_and_points(s) for s in range(4)])
    f = jax.vmap(lambda X, uv, v: pnp_dlt(K, X, uv, v))
    Td, ok = f(jnp.asarray(np.stack(Xs)), jnp.asarray(np.stack(uvs)),
               jnp.asarray(np.stack(valids)))
    assert bool(jnp.all(ok))
    assert np.abs(np.asarray(Td) - np.stack(Ts)).max() < 1e-3
