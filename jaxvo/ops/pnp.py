"""Batched DLT PnP: camera pose from 2D-3D correspondences, no init needed.

NEW layer with no reference counterpart.  The reference's only pose
estimator is PICP (picp_solver.cpp) — a local Gauss-Newton method that
needs an initialization inside its convergence basin.  Loop-closure
relocalization (ba/loop.py) has no such initialization: the drifted
estimate can be tens of meters off, far outside any reprojection-GN
basin.  The Direct Linear Transform solves the projection equations
globally (one eigendecomposition, no basin), and a short PICP polish
(ops/picp.py) then reaches GN accuracy.

Algorithm (Hartley-Zisserman ch. 7, with both normalizations):
  * pixels -> normalized image coords via K^-1 (calibrated DLT, so the
    recovered P is [R|t] up to scale)
  * 3D points centered/scaled to RMS sqrt(3) (f32 conditioning: world
    coords reach ~1e2, products ~1e4 — un-normalized A^T A loses the
    small singular values)
  * each correspondence contributes 2 rows of A (2N, 12); the solution is
    the least eigenvector of A^T A (12, 12) — a fixed-shape eigh, cheaper
    and friendlier to XLA than an SVD of the tall matrix
  * un-normalize, orthonormalize M = P[:, :3] by SVD -> R, recover scale
    and translation, fix the global sign by majority positive depth

Everything is fixed-shape and vmappable: invalid correspondences weight
their rows to zero.  ``pnp_ransac`` is left to callers — with descriptor
matching the correspondences are already near-outlier-free, and the PICP
polish's robust kernel absorbs the rest.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from jaxvo.config import PICPConfig
from jaxvo.ops import picp


def pnp_dlt(K, X, uv, valid):
    """Pose from >= 6 valid 2D-3D correspondences via calibrated DLT.

    K: (3, 3) intrinsics; X: (N, 3) world points; uv: (N, 2) pixels;
    valid: (N,) bool.  Returns (T (4, 4) world-in-camera, ok bool).
    """
    n_valid = jnp.sum(valid)
    w = valid.astype(X.dtype)

    # normalized image coordinates (calibrated DLT)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    xn = (uv[:, 0] - cx) / fx
    yn = (uv[:, 1] - cy) / fy

    # Hartley-normalize the 3D points (masked statistics)
    denom = jnp.maximum(n_valid.astype(X.dtype), 1.0)
    mean = jnp.sum(X * w[:, None], 0) / denom
    Xc = X - mean
    rms = jnp.sqrt(jnp.sum(jnp.sum(Xc * Xc, -1) * w) / denom)
    s3 = jnp.sqrt(jnp.asarray(3.0, X.dtype)) / jnp.maximum(rms, 1e-12)
    Xn = Xc * s3

    ones = jnp.ones_like(xn)
    Xh = jnp.concatenate([Xn, ones[:, None]], -1)              # (N, 4)
    r1 = jnp.concatenate(
        [Xh, jnp.zeros_like(Xh), -xn[:, None] * Xh], -1)       # (N, 12)
    r2 = jnp.concatenate(
        [jnp.zeros_like(Xh), Xh, -yn[:, None] * Xh], -1)       # (N, 12)
    A = jnp.concatenate([r1 * w[:, None], r2 * w[:, None]], 0)  # (2N, 12)

    AtA = A.T @ A
    evals, evecs = jnp.linalg.eigh(AtA)
    p = evecs[:, 0]                                            # least eigvec
    Pn = p.reshape(3, 4)

    # un-normalize: X_h = T_norm @ [X; 1] with T_norm = [[s I, -s mean],[0,1]]
    Tn = jnp.concatenate(
        [s3 * jnp.eye(3, dtype=X.dtype), (-s3 * mean)[:, None]], -1)
    Tn = jnp.concatenate(
        [Tn, jnp.asarray([[0.0, 0.0, 0.0, 1.0]], X.dtype)], 0)  # (4, 4)
    P = Pn @ Tn                                                # (3, 4)

    # global sign first: P's third row dotted with a homogeneous point is
    # s·z (depth up to the positive scale), so the majority of valid
    # points must land positive — else negate all of P
    Xh_raw = jnp.concatenate([X, ones[:, None]], -1)
    zP = Xh_raw @ P[2]
    flip = jnp.sum((zP > 0) * w) < 0.5 * n_valid
    P = jnp.where(flip, -P, P)

    # extract R (closest rotation by SVD), scale, t; with the sign fixed,
    # det(M) = s^3 > 0 and d = det(U V^T) = +1 (d=-1 only on degeneracy)
    M = P[:, :3]
    U, S, Vt = jnp.linalg.svd(M)
    d = jnp.linalg.det(U @ Vt)
    R = U @ jnp.diag(jnp.asarray([1.0, 1.0, 0.0], X.dtype)
                     + jnp.asarray([0.0, 0.0, 1.0], X.dtype) * d) @ Vt
    scale = jnp.sum(S) / 3.0
    t = P[:, 3] / jnp.maximum(scale, 1e-12)

    T = jnp.eye(4, dtype=X.dtype)
    T = T.at[:3, :3].set(R).at[:3, 3].set(t)
    ok = (n_valid >= 6) & jnp.all(jnp.isfinite(T))
    T = jnp.where(ok, T, jnp.eye(4, dtype=X.dtype))
    return T, ok


def _reproj_err2(K, T, X, uv):
    """Squared reprojection error per point (culled/behind -> +inf)."""
    from jaxvo.ops.camera import project_points_with_cam

    uv_hat, _, p_cam, _ = project_points_with_cam(K, T, X, 10**9, 10**9)
    e2 = jnp.sum((uv_hat - uv) ** 2, -1)
    return jnp.where(p_cam[:, 2] > 0, e2, jnp.inf)


def pnp_ransac(key, K, X, uv, valid, width: int, height: int,
               iterations: int = 64, sample_size: int = 8,
               inlier_px: float = 8.0, polish_iterations: int = 10):
    """Robust PnP: vmapped minimal-DLT hypotheses + inlier voting + refit.

    The map positions a loop-closure relocalization consumes carry
    tracking noise including gross outliers (a mis-triangulated landmark
    can sit BEHIND the query camera); a single least-squares DLT fits
    them and the polish then diverges (measured 200+ px residuals on 13
    correspondences with ~2 outliers).  Standard RANSAC shape, all fixed
    shapes: per-hypothesis sampling is a Gumbel top-k over the valid
    rows, scoring is one vmapped reprojection pass, the winner's inliers
    get a full DLT refit + robust PICP polish.

    Returns (T world-in-camera, ok, n_inliers).
    """
    N = X.shape[0]
    thr2 = inlier_px * inlier_px

    logp = jnp.where(valid, 0.0, -jnp.inf)

    def hypothesis(k):
        g = -jnp.log(-jnp.log(
            jax.random.uniform(k, (N,), minval=1e-9, maxval=1.0)))
        _, idx = jax.lax.top_k(g + logp, sample_size)
        sel = jnp.zeros((N,), bool).at[idx].set(True) & valid
        T, ok = pnp_dlt(K, X, uv, sel)
        e2 = _reproj_err2(K, T, X, uv)
        n_inl = jnp.sum(valid & (e2 < thr2) & ok)
        return T, n_inl

    keys = jax.random.split(key, iterations)
    Ts, scores = jax.vmap(hypothesis)(keys)
    best = jnp.argmax(scores)
    T_best = Ts[best]

    # consensus refit + robust polish on the winning inlier set
    e2 = _reproj_err2(K, T_best, X, uv)
    inl = valid & (e2 < thr2)
    T_fit, ok_fit = pnp_dlt(K, X, uv, inl)
    T_fit = jnp.where(ok_fit, T_fit, T_best)
    cfg = PICPConfig(max_iterations=polish_iterations,
                     convergence_threshold=1e-6)
    res = picp.solve(K, T_fit, X, uv, None, inl, width, height, cfg,
                     kernel_threshold=jnp.asarray(9.0 * thr2))
    T = jnp.where(jnp.all(jnp.isfinite(res.T)), res.T, T_fit)
    e2_final = _reproj_err2(K, T, X, uv)
    n_inl = jnp.sum(valid & (e2_final < thr2))
    ok = (scores[best] >= 6) & jnp.all(jnp.isfinite(T))
    T = jnp.where(ok, T, jnp.eye(4, dtype=X.dtype))
    return T, ok, n_inl


def pnp_solve(K, X, uv, valid, width: int, height: int,
              polish_iterations: int = 10,
              kernel_threshold: float = 1.0e6):
    """DLT initialization + PICP Gauss-Newton polish.

    The polish runs with a very permissive robust threshold (the DLT init
    is already in-basin; the threshold only guards gross mismatches) and
    no bounds cull.  Returns (T world-in-camera, ok).
    """
    T0, ok = pnp_dlt(K, X, uv, valid)
    cfg = PICPConfig(max_iterations=polish_iterations,
                     convergence_threshold=1e-6)
    res = picp.solve(K, T0, X, uv, None, valid, width, height, cfg,
                     kernel_threshold=jnp.asarray(kernel_threshold))
    T = jnp.where(jnp.all(jnp.isfinite(res.T)), res.T, T0)
    return T, ok
