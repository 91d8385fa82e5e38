"""Projective-ICP: Gauss-Newton on SE(3) with a saturating robust kernel.

Replaces pr::PICPSolver (src/picp_solver.cpp:26-105).  Reference semantics,
per correspondence (image point z_i, world point X_j):

  * residual  e = pi(K · T · X) - z          (picp_solver.cpp:33-35)
  * Jacobian  J = Jp · K · Jr with Jr = [I | skew(-p_cam)] (3x6) and Jp the
    2x3 perspective derivative                (picp_solver.cpp:37-53)
  * chi = e·e; if chi > kernel_threshold the point is an *outlier* with
    weight lambda = sqrt(thr/chi), else an inlier with lambda = 1
                                              (picp_solver.cpp:74-84)
  * outliers are excluded from H, b unless keep_outliers
                                              (picp_solver.cpp:86-89)
  * H += damping·I;  dx = solve(H, -b);  T <- v2tEuler(dx) · T
    (left-multiplicative Euler update)        (picp_solver.cpp:96-103)
  * skip the update when num_inliers < min_num_inliers
                                              (picp_solver.cpp:97-100)

The driver loop (icp_test.cpp:88-107) runs <= 50 rounds and stops when the
relative improvement of chi_inliers drops below 1e-5 (checked *after* the
update, with prev initialized to FLT_MAX).

Accelerator-first: every ``continue`` above is a weight-0 mask; H and b
are fused einsum reductions over the correspondence batch; the whole GN
loop is a ``lax.while_loop`` inside one jitted program.  On a GPU, XLA
reads that loop's predicate back to the host every round;
ops/pallas/picp_kernel.py is the fused kernel that does not.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from jaxvo.config import PICPConfig
from jaxvo.ops import lie
from jaxvo.ops.camera import project_points_with_cam

# First-iteration sentinel for the previous-chi value.  The reference uses
# FLT_MAX (icp_test.cpp:89), but a device that flushes subnormals breaks
# it: XLA lowers x/prev as x·reciprocal(prev), and 1/3.4e38 is subnormal
# -> 0, which made the loop "converge" after one round.  1e30 behaves
# identically (first-round relative improvement ~1) while keeping the
# reciprocal normal.
PREV_CHI_INIT = jnp.float32(1e30)


class Linearization(NamedTuple):
    H: jnp.ndarray            # (6, 6)
    b: jnp.ndarray            # (6,)
    num_inliers: jnp.ndarray  # () int32
    chi_inliers: jnp.ndarray  # () float32
    chi_outliers: jnp.ndarray # () float32


class PICPResult(NamedTuple):
    T: jnp.ndarray             # (4, 4) final world-in-camera pose
    num_inliers: jnp.ndarray   # () int32 — from the last linearization
    chi_inliers: jnp.ndarray   # () float32
    chi_outliers: jnp.ndarray  # () float32
    iterations: jnp.ndarray    # () int32 — rounds actually executed
    converged: jnp.ndarray     # () bool


def linearize(
    K,
    T,
    world_pts,
    image_uv,
    corr_idx,
    corr_valid,
    width: int,
    height: int,
    kernel_threshold: float,
    keep_outliers: bool = False,
) -> Linearization:
    """Masked batch linearization (the reference's per-point loop,
    picp_solver.cpp:56-91, as one fused pass).

    world_pts: (M, 3) map positions — OR pre-gathered (N, 3) points when
    corr_idx is None (the GN loop hoists the gather out of the iteration);
    image_uv: (N, 2) measurements; corr_idx: (N,) index into world_pts for
    each measurement; corr_valid: (N,) correspondence mask.
    """
    X = world_pts if corr_idx is None else world_pts[corr_idx]  # (N, 3)
    uv, proj_ok, p_cam, phom = project_points_with_cam(K, T, X, width, height)
    e = uv - image_uv  # (N, 2)

    # J = Jp·K·Jr with Jr = [I3 | skew(-p_cam)], written out entrywise so
    # the whole Jacobian build is one elementwise fusion (the einsum form
    # forces per-round transposes + batched-matmul dispatches):
    #   C  = Jp·K  (2x3 per point; K's rows are compile-time constants)
    #   J  = [ C | C·skew(-p_cam) ]   and  row·skew(w) = row x w.
    iz = 1.0 / jnp.where(jnp.abs(phom[:, 2]) > 1e-12, phom[:, 2], 1.0)
    k0, k1, k2 = K[0], K[1], K[2]
    # Jp rows are (1/z)·(e_i - (p_i/z)·e_z), so C rows are
    # (1/z)·(K_i - (p_i/z)·K_2) with p = phom.
    a0 = phom[:, 0] * iz  # x/z
    a1 = phom[:, 1] * iz  # y/z
    C0 = iz[:, None] * (k0[None, :] - a0[:, None] * k2[None, :])  # (N, 3)
    C1 = iz[:, None] * (k1[None, :] - a1[:, None] * k2[None, :])  # (N, 3)
    w_ax = -p_cam  # (N, 3) the skew argument
    J = jnp.stack(
        [
            jnp.concatenate([C0, jnp.cross(C0, w_ax)], -1),
            jnp.concatenate([C1, jnp.cross(C1, w_ax)], -1),
        ],
        -2,
    )  # (N, 2, 6)

    valid = corr_valid & proj_ok
    # Zero masked rows *before* reduction: a culled point can carry inf in
    # its Jacobian/residual, and inf * 0-weight = NaN would poison the sums.
    e = jnp.where(valid[:, None], e, 0.0)
    J = jnp.where(valid[:, None, None], J, 0.0)
    chi = jnp.sum(e * e, -1)
    is_inlier = chi <= kernel_threshold
    lam = jnp.where(is_inlier, 1.0, jnp.sqrt(kernel_threshold / jnp.maximum(chi, 1e-20)))
    contrib = valid & (is_inlier if not keep_outliers else jnp.ones_like(is_inlier))
    w = lam * contrib.astype(X.dtype)

    # One reduction for H, b: augment the residual column, H_aug = A^T·W·A
    # with A = [J | e]; H = H_aug[:6,:6], b = H_aug[:6,6].
    A = jnp.concatenate([J, e[:, :, None]], -1)  # (N, 2, 7)
    H_aug = jnp.einsum("nki,nkj,n->ij", A, A, w)
    H = H_aug[:6, :6]
    b = H_aug[:6, 6]
    # ... and one reduction for the three inlier statistics.
    in_mask = (valid & is_inlier).astype(chi.dtype)
    out_mask = (valid & ~is_inlier).astype(chi.dtype)
    stats = jnp.sum(
        jnp.stack([chi * in_mask, chi * out_mask, in_mask], 0), axis=1
    )
    num_inliers = stats[2].astype(jnp.int32)
    return Linearization(H, b, num_inliers, stats[0], stats[1])


def one_round(
    K, T, world_pts, image_uv, corr_idx, corr_valid,
    width: int, height: int, cfg: PICPConfig, kernel_threshold=None,
):
    """One GN round (picp_solver.cpp:93-105). Returns (T', Linearization, ok).

    kernel_threshold may be a traced scalar overriding cfg (enables the
    vmapped threshold sweep, BASELINE.json config 2)."""
    thr = cfg.kernel_threshold if kernel_threshold is None else kernel_threshold
    lin = linearize(
        K, T, world_pts, image_uv, corr_idx, corr_valid,
        width, height, thr, cfg.keep_outliers,
    )
    from jaxvo.ops.linalg_small import cholesky_solve6

    H = lin.H + cfg.damping * jnp.eye(6, dtype=lin.H.dtype)
    ok = lin.num_inliers >= cfg.min_num_inliers
    # unrolled closed-form Cholesky: the library factorization's loop nest
    # costs serial microseconds per GN round (this runs ~20x/frame)
    dx = cholesky_solve6(H, -lin.b)
    T_new = lie.v2t_euler(dx) @ T
    T_out = jnp.where(ok, T_new, T)
    return T_out, lin, ok


@jax.named_scope("picp")
def solve(
    K, T_init, world_pts, image_uv, corr_idx, corr_valid,
    width: int, height: int, cfg: PICPConfig, kernel_threshold=None,
) -> PICPResult:
    """Full GN loop with the icp_test stopping rule (icp_test.cpp:88-107),
    compiled as a single lax.while_loop."""
    # hoist the correspondence gather out of the GN loop — X is constant
    # across iterations
    if corr_idx is not None:
        world_pts = world_pts[corr_idx]
        corr_idx = None

    def cond(carry):
        T, prev, it, done, *_ = carry
        return (~done) & (it < cfg.max_iterations)

    thr_cfg = cfg.kernel_threshold if kernel_threshold is None else kernel_threshold

    def _annealed_thr(T):
        """max(thr, anneal_mult · median chi at the current estimate) —
        see PICPConfig.annealed_kernel for why."""
        uv_hat, ok, _, _ = project_points_with_cam(
            K, T, world_pts, width, height)
        e = uv_hat - image_uv
        chi = jnp.sum(e * e, -1)
        use = corr_valid & ok
        n = jnp.sum(use)
        chi_sorted = jnp.sort(jnp.where(use, chi, jnp.inf))
        med = chi_sorted[jnp.maximum((n - 1) // 2, 0)]
        med = jnp.where(jnp.isfinite(med), med, 0.0)
        return jnp.maximum(jnp.asarray(thr_cfg, chi.dtype),
                           cfg.anneal_mult * med)

    def body(carry):
        T, prev, it, done, _n, _ci, _co, _conv = carry
        thr = _annealed_thr(T) if cfg.annealed_kernel else kernel_threshold
        T2, lin, ok = one_round(
            K, T, world_pts, image_uv, corr_idx, corr_valid, width, height,
            cfg, thr,
        )
        curr = lin.chi_inliers
        rel = jnp.where(prev > 1e-10, jnp.abs(prev - curr) / prev, 0.0)
        converged = ok & (rel < cfg.convergence_threshold)
        done2 = (~ok) | converged
        return (T2, curr, it + 1, done2, lin.num_inliers, lin.chi_inliers,
                lin.chi_outliers, converged)

    init = (
        T_init, PREV_CHI_INIT, jnp.int32(0), jnp.bool_(False),
        jnp.int32(0), jnp.float32(0.0), jnp.float32(0.0), jnp.bool_(False),
    )
    T, _prev, it, _done, n_in, chi_in, chi_out, conv = jax.lax.while_loop(cond, body, init)
    return PICPResult(T, n_in, chi_in, chi_out, it, conv)


@jax.named_scope("picp")
def solve_unrolled(
    K, T_init, world_pts, image_uv, corr_idx, corr_valid,
    width: int, height: int, cfg: PICPConfig, kernel_threshold=None,
    rounds: int = 8,
) -> PICPResult:
    """GN loop with the same stopping rule as ``solve`` but a static,
    fully unrolled round count (convergence via a done-mask select).

    The while_loop's on-device condition check costs serial latency every
    round of a body this small; unrolling removes it and lets XLA schedule
    across rounds.  ``rounds`` caps iterations (vs max_iterations) — on the
    bundled data GN converges in <= 8 rounds on every frame, and callers
    get the same converged flag to detect when the cap bites.
    """
    if corr_idx is not None:
        world_pts = world_pts[corr_idx]
        corr_idx = None

    T, prev = T_init, PREV_CHI_INIT
    done = jnp.bool_(False)
    n_in = jnp.int32(0)
    chi_in = jnp.float32(0.0)
    chi_out = jnp.float32(0.0)
    it = jnp.int32(0)
    conv = jnp.bool_(False)
    for _ in range(rounds):
        T2, lin, ok = one_round(
            K, T, world_pts, image_uv, corr_idx, corr_valid, width, height,
            cfg, kernel_threshold,
        )
        curr = lin.chi_inliers
        rel = jnp.where(prev > 1e-10, jnp.abs(prev - curr) / prev, 0.0)
        converged = ok & (rel < cfg.convergence_threshold)
        T = jnp.where(done, T, T2)
        n_in = jnp.where(done, n_in, lin.num_inliers)
        chi_in = jnp.where(done, chi_in, lin.chi_inliers)
        chi_out = jnp.where(done, chi_out, lin.chi_outliers)
        it = jnp.where(done, it, it + 1)
        conv = jnp.where(done, conv, converged)
        prev = jnp.where(done, prev, curr)
        done = done | (~ok) | converged
    return PICPResult(T, n_in, chi_in, chi_out, it, conv)


def solve_fixed_rounds(
    K, T_init, world_pts, image_uv, corr_idx, corr_valid,
    width: int, height: int, cfg: PICPConfig, rounds: int = 5,
):
    """The Cam::oneRound variant: exactly ``rounds`` GN rounds, no
    convergence check (cam.cpp:214-216, used by the vo.cpp driver)."""
    if corr_idx is not None:
        world_pts = world_pts[corr_idx]
        corr_idx = None

    def body(_, carry):
        T, *_ = carry
        T2, lin, ok = one_round(
            K, T, world_pts, image_uv, corr_idx, corr_valid, width, height, cfg
        )
        return (T2, lin.num_inliers, lin.chi_inliers, lin.chi_outliers)

    T, n_in, chi_in, chi_out = jax.lax.fori_loop(
        0, rounds, body,
        (T_init, jnp.int32(0), jnp.float32(0.0), jnp.float32(0.0)),
    )
    return PICPResult(T, n_in, chi_in, chi_out, jnp.int32(rounds), jnp.bool_(True))
