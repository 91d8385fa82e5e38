"""Batched DLT triangulation (replaces cv::triangulatePoints, cam.cpp:94-140).

The reference builds P = K·[T^-1]_(3x4) for both camera-in-world poses
(cam.cpp:108-112) and runs OpenCV's homogeneous DLT, then dehomogenizes
(cam.cpp:115-118) with **no cheirality or reprojection filtering** of the
outputs — a deliberate quirk we preserve in parity mode (a validity mask is
still returned for the ``fixed`` path and for downstream consumers that
want it).

Accelerator-first: each correspondence contributes a 4x4 normal matrix A^T A whose
smallest eigenvector is the homogeneous point — one vmapped ``eigh`` over
the whole batch, no per-pair host work.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from jaxvo.ops import lie


def projection_matrix(K, camera_in_world_T):
    """P = K · [T^-1]_(3x4)  (cam.cpp:108-112)."""
    T_inv = lie.inv_se3(camera_in_world_T)
    return K @ T_inv[:3, :4]


def _dlt_rows(P1, P2, uv1, uv2):
    def rows(P, uv):
        a = uv[:, 0:1] * P[2][None, :] - P[0][None, :]  # (N, 4)
        b = uv[:, 1:2] * P[2][None, :] - P[1][None, :]
        return a, b

    a1, b1 = rows(P1, uv1)
    a2, b2 = rows(P2, uv2)
    A = jnp.stack([a1, b1, a2, b2], axis=1)  # (N, 4, 4)
    return A / jnp.maximum(jnp.linalg.norm(A, axis=2, keepdims=True), 1e-20)


def triangulate_dlt(P1, P2, uv1, uv2, method: str = "inhomogeneous"):
    """DLT for batches of correspondences.

    P1, P2: (3, 4) projection matrices; uv1, uv2: (N, 2) image points.
    Returns (points (N, 3), w (N,) degeneracy indicator: ~0 marks a
    near-infinity point in either method).

    Per pair the classic system rows are u·P[2]-P[0] and v·P[2]-P[1] for
    both views.  ``homogeneous`` (the OpenCV formulation, cam.cpp:115)
    takes the smallest eigenvector of the row-normalized A^T A — a 4x4
    eigh, accurate but serial-latency-heavy.  ``inhomogeneous``
    (default) fixes w = 1 and solves the 4x3 least-squares system with a
    closed-form 3x3 adjugate solve — pure fused arithmetic, no
    factorization loop; combined with the GN reprojection polish
    (refine_points) the two are numerically equivalent away from the
    degenerate w ~ 0 set, where both produce (the same kind of) garbage
    that the reference also keeps unfiltered.
    """
    A = _dlt_rows(P1, P2, uv1, uv2)
    if method == "inhomogeneous":
        from jaxvo.ops.linalg_small import solve_dlt3

        X, det = solve_dlt3(A)
        return X, det
    AtA = jnp.einsum("nij,nik->njk", A, A)
    _, vecs = jnp.linalg.eigh(AtA)  # ascending eigenvalues
    X = vecs[..., 0]  # (N, 4) smallest eigenvector
    w = X[:, 3]
    # convertPointsFromHomogeneous divides unconditionally; we guard the
    # degenerate w ~ 0 case to keep NaNs out of downstream masked math.
    safe_w = jnp.where(jnp.abs(w) > 1e-12, w, 1e-12)
    pts = X[:, :3] / safe_w[:, None]
    return pts, w


def refine_points(P1, P2, uv1, uv2, pts, iterations: int = 2, damping: float = 1e-6):
    """Per-point Gauss-Newton polish of the reprojection error.

    The reference's OpenCV DLT runs in double precision internally; in fp32
    the (squared) DLT system loses several digits on low-parallax points.
    Two GN iterations on the true reprojection residual (4 residuals, 3
    unknowns, vmapped 3x3 Cholesky solves) recover — and typically beat —
    double-DLT accuracy while staying fp32 and fused.

    Divergent updates (non-finite, or residual increase on unobservable
    points) are rejected per-point, so degenerate geometry keeps its DLT
    estimate exactly as the reference keeps its unfiltered DLT output.
    """

    def residual(X):
        def proj(P):
            h = X @ P[:, :3].T + P[:, 3]  # (N, 3)
            z = h[:, 2]
            safe_z = jnp.where(jnp.abs(z) > 1e-12, z, 1e-12)
            return h[:, :2] / safe_z[:, None], safe_z, h

        u1, z1, h1 = proj(P1)
        u2, z2, h2 = proj(P2)
        r = jnp.concatenate([u1 - uv1, u2 - uv2], axis=1)  # (N, 4)
        return r, (z1, h1, z2, h2)

    def jacobian(X, aux):
        z1, h1, z2, h2 = aux

        def J_of(P, z, h):
            iz = 1.0 / z
            # d(u)/dX = (P[0,:3] - u * P[2,:3]) / z, with u = h0/z
            u = h[:, 0] * iz
            v = h[:, 1] * iz
            Ju = (P[0, :3][None, :] - u[:, None] * P[2, :3][None, :]) * iz[:, None]
            Jv = (P[1, :3][None, :] - v[:, None] * P[2, :3][None, :]) * iz[:, None]
            return jnp.stack([Ju, Jv], axis=1)  # (N, 2, 3)

        return jnp.concatenate([J_of(P1, z1, h1), J_of(P2, z2, h2)], axis=1)  # (N, 4, 3)

    def step(X):
        r, aux = residual(X)
        J = jacobian(X, aux)
        from jaxvo.ops.linalg_small import solve3

        H = jnp.einsum("nki,nkj->nij", J, J) + damping * jnp.eye(3, dtype=X.dtype)
        g = jnp.einsum("nki,nk->ni", J, r)
        dX = solve3(H, -g)
        X_new = X + dX
        r_new, _ = residual(X_new)
        better = (
            jnp.all(jnp.isfinite(X_new), axis=1)
            & (jnp.sum(r_new * r_new, 1) <= jnp.sum(r * r, 1))
        )
        return jnp.where(better[:, None], X_new, X)

    for _ in range(iterations):
        pts = step(pts)
    return pts


@jax.named_scope("triangulate")
def triangulate_two_view(K, T1, T2, uv1, uv2, refine_iterations: int = 2,
                         method: str = "inhomogeneous",
                         wic1=None, wic2=None):
    """Triangulate correspondences seen from camera-in-world poses T1, T2.

    Mirrors Cam::triangulatePoints (cam.cpp:94-140): builds the two
    projection matrices and runs the DLT (plus the fp32 GN polish — see
    refine_points).  Returns (points (N,3) in world frame, finite_mask (N,)).

    wic1/wic2: optional world-in-camera transforms; when given, the
    internal pose inversions are skipped (latency path: the tracker
    already holds both directions — see engine/vo.track_step).
    """
    P1 = K @ wic1[:3, :4] if wic1 is not None else projection_matrix(K, T1)
    P2 = K @ wic2[:3, :4] if wic2 is not None else projection_matrix(K, T2)
    pts, w = triangulate_dlt(P1, P2, uv1, uv2, method)
    if refine_iterations:
        pts = refine_points(P1, P2, uv1, uv2, pts, refine_iterations)
    finite = jnp.abs(w) > 1e-12
    return pts, finite


def triangulate_normalized(R, t, x1, x2):
    """DLT in normalized camera coordinates with P1=[I|0], P2=[R|t].

    Used for cheirality voting in pose recovery.  Returns (points in cam-1
    frame (N,3), depth1 (N,), depth2 (N,)).
    """
    P1 = jnp.concatenate([jnp.eye(3, dtype=x1.dtype), jnp.zeros((3, 1), x1.dtype)], 1)
    P2 = jnp.concatenate([R, t[:, None]], 1)
    pts, _ = triangulate_dlt(P1, P2, x1, x2)
    z1 = pts[:, 2]
    z2 = pts @ R[2].T + t[2]
    return pts, z1, z2
