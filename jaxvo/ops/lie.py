"""SE(3)/SO(3) charts and similarity alignment, as pure jnp functions.

Replicates the semantics of the reference's Eigen helpers (src/defs.h):
``v2t_euler`` (defs.h:131-136, with R = Rx(w0)·Ry(w1)·Rz(w2) and a
left-multiplicative update convention in the PICP solver), ``skew``
(defs.h:139-145), quaternion chart ``v2t``/``t2v`` (defs.h:59-85), the
planar lift ``augment_pose`` (my_utilities.cpp:245-260), and
``Eigen::umeyama`` Sim(3) alignment (my_utilities.cpp:459-478).

Everything takes/returns fixed-shape float32 arrays and is batchable with
``jax.vmap``; transforms are 4x4 homogeneous matrices.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def rx(a):
    """Rotation about x (defs.h:100-107)."""
    c, s = jnp.cos(a), jnp.sin(a)
    z, o = jnp.zeros_like(a), jnp.ones_like(a)
    return jnp.stack(
        [jnp.stack([o, z, z], -1), jnp.stack([z, c, -s], -1), jnp.stack([z, s, c], -1)], -2
    )


def ry(a):
    """Rotation about y (defs.h:110-117)."""
    c, s = jnp.cos(a), jnp.sin(a)
    z, o = jnp.zeros_like(a), jnp.ones_like(a)
    return jnp.stack(
        [jnp.stack([c, z, s], -1), jnp.stack([z, o, z], -1), jnp.stack([-s, z, c], -1)], -2
    )


def rz(a):
    """Rotation about z (defs.h:119-126)."""
    c, s = jnp.cos(a), jnp.sin(a)
    z, o = jnp.zeros_like(a), jnp.ones_like(a)
    return jnp.stack(
        [jnp.stack([c, -s, z], -1), jnp.stack([s, c, z], -1), jnp.stack([z, z, o], -1)], -2
    )


def skew(v):
    """Cross-product matrix (defs.h:139-145). Batchable over leading dims."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    o = jnp.zeros_like(x)
    return jnp.stack(
        [
            jnp.stack([o, -z, y], -1),
            jnp.stack([z, o, -x], -1),
            jnp.stack([-y, x, o], -1),
        ],
        -2,
    )


def rt_to_T(R, t):
    """Assemble 4x4 homogeneous transform(s) from rotation + translation."""
    batch = R.shape[:-2]
    T = jnp.zeros(batch + (4, 4), R.dtype)
    T = T.at[..., :3, :3].set(R)
    T = T.at[..., :3, 3].set(t)
    T = T.at[..., 3, 3].set(1.0)
    return T


def v2t_euler(v):
    """6-vector -> SE(3): R = Rx(v3)·Ry(v4)·Rz(v5), t = v[:3] (defs.h:131-136).

    The product is written out entrywise (same multiplication grouping as
    the left-associated matmul chain, so bit-identical) — XLA fuses this
    into one elementwise kernel instead of two 3x3 matmul dispatches, and
    the GN retraction runs it every round.
    """
    ca, sa = jnp.cos(v[..., 3]), jnp.sin(v[..., 3])
    cb, sb = jnp.cos(v[..., 4]), jnp.sin(v[..., 4])
    cc, sc = jnp.cos(v[..., 5]), jnp.sin(v[..., 5])
    sasb = sa * sb
    casb = ca * sb
    R = jnp.stack(
        [
            jnp.stack([cb * cc, -(cb * sc), sb], -1),
            jnp.stack([sasb * cc + ca * sc, ca * cc - sasb * sc, -(sa * cb)], -1),
            jnp.stack([-(casb * cc) + sa * sc, sa * cc + casb * sc, ca * cb], -1),
        ],
        -2,
    )
    return rt_to_T(R, v[..., :3])


def v2t_quat(v):
    """6-vector -> SE(3) via unit-quaternion imaginary part (defs.h:59-75)."""
    w2 = jnp.sum(v[..., 3:6] ** 2, -1)
    w = jnp.sqrt(jnp.maximum(1.0 - w2, 0.0))
    q = jnp.concatenate([w[..., None], v[..., 3:6]], -1)  # (w, x, y, z)
    R = jnp.where((w2 < 1.0)[..., None, None], quat_to_rot(q), jnp.eye(3, dtype=v.dtype))
    return rt_to_T(R, v[..., :3])


def quat_to_rot(q):
    """Unit quaternion (w,x,y,z) -> rotation matrix."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return jnp.stack(
        [
            jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            jnp.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
            jnp.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
        ],
        -2,
    )


def so3_exp(w):
    """Rodrigues SO(3) exponential (used by BA's manifold retraction)."""
    theta2 = jnp.sum(w * w, -1)
    theta = jnp.sqrt(theta2 + 1e-32)
    W = skew(w)
    W2 = W @ W
    a = jnp.where(theta2 > 1e-12, jnp.sin(theta) / theta, 1.0 - theta2 / 6.0)
    b = jnp.where(theta2 > 1e-12, (1.0 - jnp.cos(theta)) / theta2, 0.5 - theta2 / 24.0)
    return jnp.eye(3, dtype=w.dtype) + a[..., None, None] * W + b[..., None, None] * W2


def se3_exp(xi):
    """SE(3) exponential of twist (v, w) — proper Lie retraction for BA."""
    v, w = xi[..., :3], xi[..., 3:6]
    theta2 = jnp.sum(w * w, -1)
    theta = jnp.sqrt(theta2 + 1e-32)
    W = skew(w)
    W2 = W @ W
    b = jnp.where(theta2 > 1e-12, (1.0 - jnp.cos(theta)) / theta2, 0.5 - theta2 / 24.0)
    c = jnp.where(theta2 > 1e-12, (theta - jnp.sin(theta)) / (theta2 * theta), 1.0 / 6.0)
    R = so3_exp(w)
    V = jnp.eye(3, dtype=xi.dtype) + b[..., None, None] * W + c[..., None, None] * W2
    t = jnp.einsum("...ij,...j->...i", V, v)
    return rt_to_T(R, t)


def so3_log(R):
    """Rotation matrix -> axis-angle vector (inverse of so3_exp).

    atan2 formulation, differentiable THROUGH theta = 0: the arccos form's
    derivative is -inf at cos = 1, which turned the pose-graph's jacfwd
    edge Jacobians into NaN exactly when an edge was satisfied (R_err = I).
    Valid for |theta| < pi (the chart's own domain); batchable.
    """
    v = jnp.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        -1,
    )  # = 2 sin(theta) * axis
    s2 = jnp.sum(v * v, -1)  # = 4 sin^2(theta)
    # eps inside the sqrt keeps its jvp finite at v = 0 (biases theta by
    # ~5e-13 rad, far below f32 resolution of any real rotation)
    sin_t = 0.5 * jnp.sqrt(s2 + 1e-24)
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = jnp.clip((tr - 1.0) * 0.5, -1.0, 1.0)
    theta = jnp.arctan2(sin_t, cos_t)
    scale = jnp.where(
        s2 > 1e-12, theta / (2.0 * sin_t), 0.5 + theta * theta / 12.0
    )
    return v * scale[..., None]


def se3_log(T):
    """SE(3) logarithm: 4x4 rigid transform -> twist (v, w) with
    se3_exp(se3_log(T)) = T.  Inverse of the V-matrix applied to t."""
    w = so3_log(T[:3, :3])
    theta2 = jnp.sum(w * w, -1)
    theta = jnp.sqrt(theta2 + 1e-32)
    W = skew(w)
    W2 = W @ W
    # V^-1 = I - W/2 + coef·W² with coef = (1 - θ·cos(θ/2)/(2·sin(θ/2)))/θ²
    half = 0.5 * theta
    cot_term = jnp.where(
        theta2 > 1e-12,
        (1.0 - half * jnp.cos(half) / jnp.maximum(jnp.sin(half), 1e-20)) / theta2,
        1.0 / 12.0 + theta2 / 720.0,
    )
    Vinv = jnp.eye(3, dtype=T.dtype) - 0.5 * W + cot_term * W2
    v = Vinv @ T[:3, 3]
    return jnp.concatenate([v, w], -1)


def scale_motion(T, alpha):
    """Fractional rigid motion: (R, t) -> (exp(alpha·log R), alpha·t).

    Used to damp the constant-velocity prediction — alpha < 1 shrinks the
    loop gain of the init -> solve -> velocity feedback (see engine/vo.py).
    """
    w = so3_log(T[:3, :3])
    R = so3_exp(alpha * w)
    out = jnp.eye(4, dtype=T.dtype)
    out = out.at[:3, :3].set(R)
    out = out.at[:3, 3].set(alpha * T[:3, 3])
    return out


def inv_se3(T):
    """Inverse of rigid transform(s) without a general solve."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = jnp.swapaxes(R, -1, -2)
    return rt_to_T(Rt, -jnp.einsum("...ij,...j->...i", Rt, t))


def transform_points(T, pts):
    """Apply 4x4 transform to (..., N, 3) points."""
    return jnp.einsum("...ij,...nj->...ni", T[..., :3, :3], pts) + T[..., None, :3, 3]


def augment_pose(pose_xyt):
    """Lift planar (x, y, theta) into SE(3) (my_utilities.cpp:245-260)."""
    theta = pose_xyt[..., 2]
    T = rt_to_T(
        rz(theta),
        jnp.stack(
            [pose_xyt[..., 0], pose_xyt[..., 1], jnp.zeros_like(theta)], -1
        ),
    )
    return T


def yaw(T):
    """Planar heading: atan2(R10, R00) (icp_test.cpp:177-178)."""
    return jnp.arctan2(T[..., 1, 0], T[..., 0, 0])


def wrap_angle(a):
    """Wrap to (-pi, pi] — the corrected rotation-error metric (the reference
    omits this, icp_test.cpp:190-191, producing wraparound artifacts)."""
    return jnp.arctan2(jnp.sin(a), jnp.cos(a))


def umeyama(src, dst, mask=None, with_scale: bool = True):
    """Similarity transform aligning src -> dst (Eigen::umeyama semantics,
    used at my_utilities.cpp:459-478 for Sim(3) trajectory alignment).

    src, dst: (N, 3); mask: optional (N,) validity weights.
    Returns a 4x4 matrix T with T[:3,:3] = c·R, T[:3,3] = t, such that
    dst ≈ c·R·src + t in the least-squares sense.
    """
    src = jnp.asarray(src)
    dst = jnp.asarray(dst)
    if mask is None:
        w = jnp.ones(src.shape[0], src.dtype)
    else:
        w = mask.astype(src.dtype)
    n = jnp.sum(w)
    mu_s = jnp.sum(src * w[:, None], 0) / n
    mu_d = jnp.sum(dst * w[:, None], 0) / n
    sc = src - mu_s
    dc = dst - mu_d
    cov = (dc * w[:, None]).T @ sc / n  # (3,3): dst-by-src cross covariance
    var_s = jnp.sum(jnp.sum(sc * sc, -1) * w) / n
    U, D, Vt = jnp.linalg.svd(cov)
    # Eigen::umeyama sign correction
    d = jnp.sign(jnp.linalg.det(U) * jnp.linalg.det(Vt))
    S = jnp.diag(jnp.array([1.0, 1.0, 0.0], src.dtype)) + jnp.diag(
        jnp.array([0.0, 0.0, 1.0], src.dtype)
    ) * d
    R = U @ S @ Vt
    c = jnp.where(
        with_scale, jnp.sum(D * jnp.diag(S)) / jnp.maximum(var_s, 1e-12), 1.0
    )
    t = mu_d - c * R @ mu_s
    return rt_to_T(c * R, t)
