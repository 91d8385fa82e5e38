"""Closed-form small linear algebra for the hot sequential path.

XLA's generic Cholesky/LU/eigh lower to loop-based algorithms that cost
microseconds of serial latency per call — fatal inside the per-frame
GN chain (SURVEY.md §6: single-chip frames/s is latency-bound).  These
replacements are branch-free arithmetic that XLA fuses into a handful of
vector ops:

  * det3/inv3/solve3 — adjugate 3x3 (batched), for DLT normal equations,
    triangulation refinement and BA landmark blocks
  * cholesky_solve6 — fully unrolled 6x6 Cholesky solve for the PICP
    normal equations (H is damped SPD)
  * solve_dlt3 — inhomogeneous two-view DLT: fixes the homogeneous scale
    w=1 and solves the 4x3 least-squares system in closed form, replacing
    the 4x4 eigh of the homogeneous formulation (points at infinity are
    degenerate in both formulations; the GN polish treats them alike)
"""

from __future__ import annotations

import jax.numpy as jnp


def det3(A):
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def inv3(A, eps: float = 0.0):
    """Adjugate inverse of (..., 3, 3); singular inputs yield large values
    (guard at call sites, as invert_hll does)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A00 = e * i - f * h
    A01 = c * h - b * i
    A02 = b * f - c * e
    A10 = f * g - d * i
    A11 = a * i - c * g
    A12 = c * d - a * f
    A20 = d * h - e * g
    A21 = b * g - a * h
    A22 = a * e - b * d
    det = a * A00 + b * A10 + c * A20
    inv_det = 1.0 / jnp.where(jnp.abs(det) > eps, det, jnp.where(det >= 0, eps + 1e-30, -(eps + 1e-30)))
    adj = jnp.stack(
        [
            jnp.stack([A00, A01, A02], -1),
            jnp.stack([A10, A11, A12], -1),
            jnp.stack([A20, A21, A22], -1),
        ],
        -2,
    )
    return adj * inv_det[..., None, None]


def solve3(A, b):
    """x = A^-1 b for (..., 3, 3) @ (..., 3)."""
    return jnp.einsum("...ij,...j->...i", inv3(A), b)


def cholesky_solve_unrolled(H, b, n: int):
    """Solve H x = b for symmetric positive-definite (.., n, n) H with a
    fully unrolled Cholesky (static n).

    Branch-free scalar arithmetic that XLA fuses, vs. the library
    factorization's sequential loop nest.  Batched over leading dims.
    """
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = H[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        Ljj = jnp.sqrt(jnp.maximum(s, 1e-30))
        L[j][j] = Ljj
        inv_Ljj = 1.0 / Ljj
        for i in range(j + 1, n):
            s = H[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv_Ljj
    # forward substitution L y = b
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    # backward substitution L^T x = y
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return jnp.stack(x, axis=-1)


def cholesky_solve6(H, b):
    """Unrolled 6x6 SPD solve (PICP normal equations)."""
    return cholesky_solve_unrolled(H, b, 6)


def smallest_eigvec_inverse_iteration(A, iterations: int = 8, shift: float = 1e-6):
    """Smallest eigenvector of symmetric PSD (.., n, n) A by inverse
    iteration with an unrolled Cholesky solve per step.

    Replaces a batched ``eigh`` in contexts where only the null-ish
    direction is needed (8-point RANSAC hypothesis solves): each step
    solves (A + shift·tr(A)·I) x = v and normalizes.  Deterministic start
    (ones) — adequate when the smallest eigenvalue is well separated, which
    RANSAC scoring tolerates by construction.
    """
    n = A.shape[-1]
    batch = A.shape[:-2]
    tr = jnp.trace(A, axis1=-2, axis2=-1)[..., None, None]
    Ad = A + shift * (tr + 1.0) * jnp.eye(n, dtype=A.dtype)
    v = jnp.ones(batch + (n,), A.dtype)
    for _ in range(iterations):
        v = cholesky_solve_unrolled(Ad, v, n)
        v = v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-30)
    return v


def solve_dlt3(A):
    """Inhomogeneous DLT: given the (N, 4, 4) homogeneous system rows A
    (A·(X,1) ≈ 0), fix w = 1 and least-squares solve for X.

    Returns (X (N, 3), det (N,) of the 3x3 normal matrix — ~0 flags a
    near-infinity/low-parallax point)."""
    A3 = A[..., :3]           # (N, 4, 3)
    a4 = A[..., 3]            # (N, 4)
    N_mat = jnp.einsum("nki,nkj->nij", A3, A3)  # (N, 3, 3)
    rhs = -jnp.einsum("nki,nk->ni", A3, a4)     # (N, 3)
    X = solve3(N_mat, rhs)
    return X, det3(N_mat)
