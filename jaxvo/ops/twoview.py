"""Two-view bootstrap: 8-point essential matrix, deterministic vmapped
RANSAC, and cheirality-based pose recovery.

Replaces the reference's OpenCV calls ``cv::findEssentialMat`` +
``cv::recoverPose`` (cam.cpp:37-91; it seeds ``cv::setRNGSeed(42)`` and
passes library defaults — RANSAC threshold 1.0 px, confidence 0.999).
Bit-parity with OpenCV's RNG is impossible; per BASELINE.json the gate is
trajectory parity within the ATE bound, under a deterministic JAX PRNG.

Accelerator-first shape: RANSAC is a *fixed-size batch* of minimal solves —
``num_hypotheses`` 8-point problems solved in one vmapped 9x9 eigh — then a
masked inlier count per hypothesis and an argmax.  No data-dependent loop,
no early exit; the whole bootstrap is a single XLA program.

Conventions (OpenCV-compatible): x2^T E x1 = 0 with E = [t]x R, and the
recovered (R, t) satisfy X_cam2 = R · X_cam1 + t with |t| = 1.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from jaxvo.config import RansacConfig
from jaxvo.ops import triangulate


def normalize_points(uv, K):
    """Pixel -> normalized camera coordinates: (u-cx)/fx, (v-cy)/fy."""
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    return jnp.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy], -1)


def _epipolar_rows(x1, x2):
    """Rows of the 8-point design matrix: x2^T E x1 = 0, E row-major.

    Row = [x2·x1, x2·y1, x2, y2·x1, y2·y1, y2, x1, y1, 1].
    """
    a1, b1 = x1[..., 0], x1[..., 1]
    a2, b2 = x2[..., 0], x2[..., 1]
    one = jnp.ones_like(a1)
    return jnp.stack(
        [a2 * a1, a2 * b1, a2, b2 * a1, b2 * b1, b2, a1, b1, one], -1
    )


def essential_8pt(x1, x2, weights=None):
    """Weighted 8-point essential matrix from normalized correspondences.

    x1, x2: (N, 2); weights: optional (N,).  Returns E (3, 3) projected to
    the essential manifold (singular values (1, 1, 0)).
    """
    A = _epipolar_rows(x1, x2)  # (N, 9)
    if weights is not None:
        A = A * weights[:, None]
    AtA = A.T @ A  # (9, 9)
    _, vecs = jnp.linalg.eigh(AtA)
    e = vecs[:, 0]
    E = e.reshape(3, 3)
    # project to essential manifold
    U, s, Vt = jnp.linalg.svd(E)
    return U @ jnp.diag(jnp.array([1.0, 1.0, 0.0], E.dtype)) @ Vt


def sampson_error(E, x1, x2):
    """First-order geometric (Sampson) epipolar error in normalized coords."""
    x1h = jnp.concatenate([x1, jnp.ones_like(x1[..., :1])], -1)  # (N, 3)
    x2h = jnp.concatenate([x2, jnp.ones_like(x2[..., :1])], -1)
    Ex1 = x1h @ E.T       # (N, 3)
    Etx2 = x2h @ E        # (N, 3)
    num = jnp.sum(x2h * Ex1, -1) ** 2
    den = Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
    return num / jnp.maximum(den, 1e-12)


class RansacResult(NamedTuple):
    E: jnp.ndarray            # (3, 3) refined essential matrix
    inliers: jnp.ndarray      # (N,) bool
    num_inliers: jnp.ndarray  # () int32
    best_hypothesis: jnp.ndarray  # () int32 (diagnostic)


def ransac_essential(key, x1, x2, valid, cfg: RansacConfig, focal: float) -> RansacResult:
    """Deterministic batched RANSAC over ``cfg.num_hypotheses`` minimal sets.

    Distinct 8-subsets are drawn per hypothesis via Gumbel top-k over the
    validity mask (vectorized sampling without replacement).  The pixel
    threshold is converted to normalized coordinates via the focal length.
    After voting, the essential matrix is re-estimated on the winning
    hypothesis's inlier set (the analog of OpenCV's final refinement).
    """
    N = x1.shape[0]
    H = cfg.num_hypotheses
    S = cfg.sample_size
    gumbel = jax.random.gumbel(key, (H, N))
    scores = jnp.where(valid[None, :], gumbel, -jnp.inf)
    _, sample_idx = jax.lax.top_k(scores, S)  # (H, S) distinct valid indices

    from jaxvo.ops.linalg_small import smallest_eigvec_inverse_iteration

    # Gather-free hypothesis solves: the 9 epipolar features are computed
    # once per point (N, 9); each hypothesis's 9x9 normal matrix is a
    # 0/1-weighted sum of per-point outer products — ONE (H, N) @ (N, 81)
    # matmul — rather than materializing (H, S, 9) gathered sample
    # tensors, whose memory grows with every vmapped batch axis.
    rows = _epipolar_rows(x1, x2)  # (N, 9)
    member = jnp.sum(
        (
            jnp.arange(N, dtype=sample_idx.dtype)[None, None, :]
            == sample_idx[:, :, None]
        ).astype(x1.dtype),
        axis=1,
    )  # (H, N) exact 0/1 sample membership
    P = jnp.concatenate([rows[:, i : i + 1] * rows for i in range(9)], axis=1)
    AtA = jnp.dot(
        member, P, precision=jax.lax.Precision.HIGHEST
    ).reshape(H, 9, 9)
    es = smallest_eigvec_inverse_iteration(AtA)  # (H, 9)
    Es = es.reshape(H, 3, 3)

    thr = (cfg.inlier_threshold_px / focal) ** 2
    # Sampson scores for every hypothesis in (3, N) layout — points ride the
    # 128-lane axis; the (N, 3) orientation pads 3 -> 128 lanes instead.
    # Precision pinned explicitly: hypothesis voting is decision-sensitive
    # (the bootstrap E seeds the entire map), so this must stay true-f32
    # even if the package-level jax_default_matmul_precision override
    # (jaxvo/__init__.py) is relaxed via JAXVO_MATMUL_PRECISION.
    hp = jax.lax.Precision.HIGHEST
    x1h_T = jnp.concatenate([x1.T, jnp.ones((1, N), x1.dtype)], 0)  # (3, N)
    x2h_T = jnp.concatenate([x2.T, jnp.ones((1, N), x2.dtype)], 0)
    Ex1 = jnp.einsum("hij,jn->hin", Es, x1h_T, precision=hp)  # (H, 3, N)
    Etx2 = jnp.einsum("hji,jn->hin", Es, x2h_T, precision=hp)
    num = jnp.sum(x2h_T[None] * Ex1, axis=1) ** 2  # (H, N)
    den = Ex1[:, 0] ** 2 + Ex1[:, 1] ** 2 + Etx2[:, 0] ** 2 + Etx2[:, 1] ** 2
    errs = num / jnp.maximum(den, 1e-12)
    inl = (errs < thr) & valid[None, :]
    # Inlier-count voting (cv::findEssentialMat RANSAC semantics).  Round 2
    # briefly used MSAC (truncated-loss argmin) here; it picked different,
    # geometrically tighter-scoring winners whose *inlier sets* seeded a
    # worse map under another fp reduction order (ATE 0.54 vs 0.19) and
    # regressed the synthetic-noise suite on CPU too — reverted.
    counts = jnp.sum(inl, axis=1)
    best = jnp.argmax(counts)

    # refinement on the winning inlier set with the accurate
    # (eigh + manifold-projection) 8-point solve — the analog of
    # cv::findEssentialMat's final polish.  Kept only if it does not lose
    # inliers (the raw minimal solve stays as fallback).
    w = inl[best].astype(x1.dtype)
    E_ref = essential_8pt(x1, x2, w)
    err_ref = sampson_error(E_ref, x1, x2)
    inl_ref = (err_ref < thr) & valid
    better = jnp.sum(inl_ref) >= counts[best]
    E_fin = jnp.where(better, E_ref, Es[best])
    inl_fin = jnp.where(better, inl_ref, inl[best])
    return RansacResult(E_fin, inl_fin, jnp.sum(inl_fin), best.astype(jnp.int32))


def decompose_essential(E):
    """E -> two rotations + translation direction (the classic U W V^T)."""
    U, _, Vt = jnp.linalg.svd(E)
    # enforce proper rotations
    U = U * jnp.sign(jnp.linalg.det(U))
    Vt = Vt * jnp.sign(jnp.linalg.det(Vt))
    W = jnp.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], E.dtype)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[:, 2]
    return R1, R2, t


class PoseResult(NamedTuple):
    R: jnp.ndarray          # (3, 3): X_cam2 = R X_cam1 + t
    t: jnp.ndarray          # (3,), unit norm
    cheirality: jnp.ndarray  # (N,) bool — positive depth in both views
    num_good: jnp.ndarray


def recover_pose(E, x1, x2, mask):
    """Disambiguate the 4 (R, t) candidates by cheirality voting
    (cv::recoverPose semantics, used at cam.cpp:61-69).

    mask: (N,) bool — typically the RANSAC inlier set; votes count only
    masked correspondences.  Also applies recoverPose's default distance
    gate (depth < 50) when voting.
    """
    R1, R2, t = decompose_essential(E)
    cands_R = jnp.stack([R1, R1, R2, R2])
    cands_t = jnp.stack([t, -t, t, -t])

    def vote(R, tt):
        _, z1, z2 = triangulate.triangulate_normalized(R, tt, x1, x2)
        good = (z1 > 0) & (z2 > 0) & (z1 < 50.0) & (z2 < 50.0) & mask
        return jnp.sum(good), good

    counts, goods = jax.vmap(vote)(cands_R, cands_t)
    best = jnp.argmax(counts)
    return PoseResult(cands_R[best], cands_t[best], goods[best], counts[best])


def bootstrap_pose(key, K, uv1, uv2, valid, cfg: RansacConfig):
    """Full two-view initializer: RANSAC E + pose recovery.

    Returns (camera2-in-world 4x4 pose with world = camera-1 frame,
    RansacResult, PoseResult).  The reference stores T^-1 as the new pose
    (cam.cpp:71-81): with X_c2 = R X_c1 + t, camera-2-in-world is
    (R, t)^-1 — exactly what we return.
    """
    from jaxvo.ops import lie

    x1 = normalize_points(uv1, K)
    x2 = normalize_points(uv2, K)
    focal = float(K[0, 0]) if not isinstance(K, jnp.ndarray) else K[0, 0]
    rres = ransac_essential(key, x1, x2, valid, cfg, focal)
    pres = recover_pose(rres.E, x1, x2, rres.inliers)
    T = lie.rt_to_T(pres.R, pres.t)
    return lie.inv_se3(T), rres, pres
