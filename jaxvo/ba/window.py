"""Sliding-window bundle adjustment with Schur-complement landmark reduction.

NEW layer with no reference counterpart (SURVEY.md §2 "Parallelism
strategies": the reference is single-threaded per-frame PICP only; this is
the TP/PP analog mandated by BASELINE.json's north star).

Formulation — classic visual BA:
  * state: W camera poses (world-in-camera T_f) + L landmarks X_l
  * per observation (f, l): residual e = pi(K · T_f · X_l) - uv
    with the same saturating robust kernel as PICP (sqrt(thr/chi) weight)
  * pose Jacobian A (2x6) as in picp_solver.cpp:37-53; landmark Jacobian
    B = Jp · K · R_f (2x3)
  * normal equations in block form:
        [ Hpp  Hpl ] [dx_p]   [-bp]
        [ Hlp  Hll ] [dx_l] = [-bl]
    with Hll block-diagonal (3x3 per landmark) -> Schur complement
        S = Hpp - Hpl Hll^-1 Hlp   (dense (6W, 6W), W is small)
    reduced solve for poses, then trivially-parallel back-substitution for
    landmarks.
  * gauge: the first window pose is held fixed by a large diagonal prior.

Accelerator-first: every per-observation quantity is one vmapped/fused pass; the
per-(landmark, frame) coupling blocks W[l, f] (6x3) are assembled by
segment-sum scatter; Hll inversion is a vmapped 3x3 solve; S assembly is a
single einsum over the landmark axis — which is exactly the axis
``jaxvo.parallel`` shards across devices (each shard computes its partial
S and the psum over shards rides NCCL).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from jaxvo.config import BAConfig, EngineConfig
from jaxvo.ops import lie
from jaxvo.ops.camera import project_points_with_cam


class BAProblem(NamedTuple):
    """Fixed-shape BA problem.

    poses:    (W, 4, 4) world-in-camera transforms
    points:   (L, 3) landmark positions
    obs_uv:   (W, N, 2) pixel measurements
    obs_lm:   (W, N) int32 landmark index per observation
    obs_valid:(W, N) bool
    point_valid: (L,) bool
    fixed:    (W,) bool — poses held fixed (gauge)
    """

    poses: jnp.ndarray
    points: jnp.ndarray
    obs_uv: jnp.ndarray
    obs_lm: jnp.ndarray
    obs_valid: jnp.ndarray
    point_valid: jnp.ndarray
    fixed: jnp.ndarray


class BAStats(NamedTuple):
    chi: jnp.ndarray          # robust total chi
    num_inliers: jnp.ndarray
    num_obs: jnp.ndarray


def _per_obs_blocks(K, T, X, uv, valid, width, height, kernel_threshold,
                    keep_outliers: bool = False, cull_bounds: bool = True):
    """Linearize one frame's observations.

    X: (N, 3) gathered landmark positions; returns per-obs A (N,2,6),
    B (N,2,3), e (N,2), w (N,) robust weight (0 for culled/invalid)."""
    uv_hat, proj_ok, p_cam, phom = project_points_with_cam(K, T, X, width, height)
    e = uv_hat - uv
    # closed-form JpK (same derivation as ops/picp.linearize: JpK rows are
    # (1/z)(K_i - (p_i/z) K_2)), and A = JpK·[I | skew(-p)] = [JpK | JpK x w]
    # — all elementwise, one fusion instead of per-frame einsum dispatches
    iz = 1.0 / jnp.where(jnp.abs(phom[:, 2]) > 1e-12, phom[:, 2], 1.0)
    a0 = phom[:, 0] * iz
    a1 = phom[:, 1] * iz
    C0 = iz[:, None] * (K[0][None, :] - a0[:, None] * K[2][None, :])  # (N, 3)
    C1 = iz[:, None] * (K[1][None, :] - a1[:, None] * K[2][None, :])
    w_ax = -p_cam
    A = jnp.stack(
        [jnp.concatenate([C0, jnp.cross(C0, w_ax)], -1),
         jnp.concatenate([C1, jnp.cross(C1, w_ax)], -1)], -2)  # (N, 2, 6)
    JpK = jnp.stack([C0, C1], -2)                              # (N, 2, 3)
    B = jnp.einsum("nik,kl->nil", JpK, T[:3, :3])  # (N, 2, 3) point Jacobian

    ok = valid & (proj_ok if cull_bounds else (p_cam[:, 2] > 0.0))
    # zero masked rows before any reduction (inf·0 = NaN hazard, see picp)
    e = jnp.where(ok[:, None], e, 0.0)
    A = jnp.where(ok[:, None, None], A, 0.0)
    B = jnp.where(ok[:, None, None], B, 0.0)
    chi = jnp.sum(e * e, -1)
    inlier = chi <= kernel_threshold
    lam = jnp.where(inlier, 1.0, jnp.sqrt(kernel_threshold / jnp.maximum(chi, 1e-20)))
    contrib = ok if keep_outliers else (ok & inlier)
    w = lam * contrib.astype(X.dtype)
    return A, B, e, w, chi, ok, inlier


def linearize_ba(problem: BAProblem, K, width, height, cfg: BAConfig):
    """Assemble all Schur ingredients in fused batched passes.

    Returns (Hpp (W,6,6), bp (W,6), Hll (L,3,3), bl (L,3),
    Wfl (L,W,6,3) coupling blocks, stats)."""
    W = problem.poses.shape[0]
    L = problem.points.shape[0]

    def per_frame(T, uv, lm, valid):
        X = problem.points[lm]  # (N, 3)
        valid = valid & problem.point_valid[lm]
        A, B, e, w, chi, ok, inlier = _per_obs_blocks(
            K, T, X, uv, valid, width, height, cfg.huber_threshold,
            cfg.keep_outliers, cfg.cull_bounds,
        )
        Hpp_f = jnp.einsum("nki,nkj,n->ij", A, A, w)
        bp_f = jnp.einsum("nki,nk,n->i", A, e, w)
        # per-obs landmark-indexed contributions (scattered below)
        HB = jnp.einsum("nki,nkj,n->nij", B, B, w)      # (N, 3, 3)
        blB = jnp.einsum("nki,nk,n->ni", B, e, w)       # (N, 3)
        Wb = jnp.einsum("nki,nkj,n->nij", A, B, w)      # (N, 6, 3)
        return Hpp_f, bp_f, HB, blB, Wb, w, chi, ok, inlier

    Hpp, bp, HB, blB, Wb, w, chi, ok, inlier = jax.vmap(per_frame)(
        problem.poses, problem.obs_uv, problem.obs_lm, problem.obs_valid
    )
    N = problem.obs_lm.shape[1]
    if cfg.assembly == "onehot":
        # per-frame one-hot matmul assembly: scatter-adds serialized on
        # the first target (the L·W-segment Wfl scatter dominated the
        # in-scan local-BA iteration), but the same sums are a (W, L, N) x (W, N, 30)
        # batched matmul — tensor-core work with f32 accumulation (exact for the
        # 0/1 one-hot; accumulation order differs from segment_sum by
        # ~1e-6 relative).  Rows with w=0 contribute zero blocks, so no
        # masking of the one-hot itself is needed.
        slots = jnp.arange(L, dtype=jnp.int32)
        oh = (slots[None, :, None] == problem.obs_lm[:, None, :]).astype(
            HB.dtype)                                   # (W, L, N)
        payload = jnp.concatenate(
            [HB.reshape(W, N, 9), blB, Wb.reshape(W, N, 18)], axis=-1)
        out = jnp.einsum("wln,wnp->wlp", oh, payload,
                         preferred_element_type=jnp.float32)  # (W, L, 30)
        Hll = jnp.sum(out[..., :9], axis=0).reshape(L, 3, 3)
        bl = jnp.sum(out[..., 9:12], axis=0)
        Wfl = jnp.transpose(out[..., 12:], (1, 0, 2)).reshape(L, W, 6, 3)
    else:
        # scatter per-obs landmark blocks into (L, ...) via segment-sum
        lm_flat = problem.obs_lm.reshape(-1)
        Hll = jax.ops.segment_sum(
            HB.reshape(-1, 3, 3), lm_flat, num_segments=L
        )
        bl = jax.ops.segment_sum(blB.reshape(-1, 3), lm_flat, num_segments=L)
        # coupling blocks per (landmark, frame): scatter with combined index
        fidx = jnp.broadcast_to(
            jnp.arange(W, dtype=jnp.int32)[:, None], problem.obs_lm.shape
        ).reshape(-1)
        Wfl = jax.ops.segment_sum(
            Wb.reshape(-1, 6, 3), lm_flat * W + fidx, num_segments=L * W
        ).reshape(L, W, 6, 3)

    stats = BAStats(
        chi=jnp.sum(chi * (w > 0) * jnp.minimum(w, 1.0)),
        num_inliers=jnp.sum(ok & inlier),
        num_obs=jnp.sum(ok),
    )
    return Hpp, bp, Hll, bl, Wfl, stats


def invert_hll(Hll, damping):
    """Damped inverse of the landmark blocks (vmapped 3x3).

    Symmetrize + scale-relative damping: Hll entries reach ~1e6, where f32
    roundoff (~eps·|H| ≈ 0.1) dwarfs an absolute damping and can leave a
    near-singular block; the trace-relative term keeps the inverse sane.
    Non-finite inverses are zeroed (the landmark is skipped this step)."""
    I3 = jnp.eye(3, dtype=Hll.dtype)
    Hll_s = 0.5 * (Hll + jnp.swapaxes(Hll, -1, -2))
    tr = Hll_s[:, 0, 0] + Hll_s[:, 1, 1] + Hll_s[:, 2, 2]
    # scale-relative LM damping (see finalize_reduced) + the trace-relative
    # f32 conditioning floor
    lam_l = damping * (tr / 3.0 + 1.0) + 1e-5 * tr
    Hll_d = Hll_s + lam_l[:, None, None] * I3[None]
    from jaxvo.ops.linalg_small import inv3

    Hll_inv = inv3(Hll_d)
    finite = jnp.all(jnp.isfinite(Hll_inv), axis=(1, 2))
    return jnp.where(finite[:, None, None], Hll_inv, 0.0)


def schur_parts(Hpp, bp, Hll, bl, Wfl, damping):
    """Per-landmark-set contribution to the reduced camera system.

    Returns (S_contrib (6W, 6W), b_contrib (6W,), Hll_inv) — pure sums over
    the landmark axis, so the sharded backend computes these per shard and
    psums them (jaxvo/parallel/ba_sharded.py); only the (6W)^2 reduced
    system crosses the interconnect, never the landmark blocks."""
    W = Hpp.shape[0]
    Hll_inv = invert_hll(Hll, damping)
    WHinv = jnp.einsum("lfij,ljk->lfik", Wfl, Hll_inv)        # (L, W, 6, 3)
    S_red = jnp.einsum("lfik,lgjk->figj", WHinv, Wfl)          # (W,6,W,6)
    S = -S_red
    S = S.at[jnp.arange(W), :, jnp.arange(W), :].add(Hpp)
    bp_red = bp - jnp.einsum("lfik,lk->fi", WHinv, bl)         # (W, 6)
    return S.reshape(W * 6, W * 6), bp_red.reshape(W * 6), Hll_inv


def finalize_reduced(S, b_red, fixed, damping):
    """Gauge-fix + damp the (psum-combined) reduced system.

    Gauge: zero the rows/cols of fixed poses and pin their diagonal to 1
    (exact, and keeps the f32 Cholesky well-conditioned).

    Damping is Marquardt SCALE-RELATIVE: S_ii·(1+lambda) + lambda.  An
    absolute lambda cannot control this system — with the coarse
    (keep-outliers) kernel on a badly drifted trajectory the diagonal
    reaches ~1e10+, so any absolute lambda the LM loop can reach leaves
    the step unchanged and every trial is rejected at the same chi."""
    free = jnp.repeat(~fixed, 6).astype(S.dtype)
    S = S * free[:, None] * free[None, :]
    d = jnp.diagonal(S)
    diag = jnp.eye(S.shape[0], dtype=S.dtype)
    S = S + diag * (damping * (d + 1.0) * free + (1.0 - free))
    return S, b_red * free


def backsubstitute(Hll_inv, bl, Wfl, dx_p):
    """Landmark updates given the pose solution: dx_l = -Hll^-1 (bl + W^T dx_p).
    Embarrassingly parallel over landmarks (local per shard)."""
    rhs = bl + jnp.einsum("lfij,fi->lj", Wfl, dx_p)
    return -jnp.einsum("lij,lj->li", Hll_inv, rhs)


def schur_reduce(Hpp, bp, Hll, bl, Wfl, fixed, damping):
    """Single-device reduced camera system (parts + finalize)."""
    S, b_red, Hll_inv = schur_parts(Hpp, bp, Hll, bl, Wfl, damping)
    S, b_red = finalize_reduced(S, b_red, fixed, damping)
    return S, b_red, Hll_inv, None


def eval_robust_chi(problem: BAProblem, K, width, height, cfg: BAConfig):
    """Truncated robust objective sum(min(chi_i, thr)) over valid obs.

    Used by the LM accept/reject test.  A VALID observation whose point
    projects outside the image/z-range counts the full threshold — else a
    diverging pose that culls its own residuals would look like progress.
    """
    thr = cfg.huber_threshold

    def per_frame(T, uv, lm, valid):
        X = problem.points[lm]
        valid = valid & problem.point_valid[lm]
        uv_hat, ok, p_cam, _ = project_points_with_cam(K, T, X, width, height)
        if not cfg.cull_bounds:  # same cull as the linearization
            ok = p_cam[:, 2] > 0.0
        e = jnp.where((valid & ok)[:, None], uv_hat - uv, 0.0)
        chi = jnp.sum(e * e, -1)
        per = jnp.where(ok, jnp.minimum(chi, thr), thr)
        return jnp.sum(jnp.where(valid, per, 0.0))

    return jnp.sum(jax.vmap(per_frame)(
        problem.poses, problem.obs_uv, problem.obs_lm, problem.obs_valid))


def ba_step(problem: BAProblem, K, width, height, cfg: BAConfig, damping=None):
    """One Levenberg-damped GN iteration of windowed BA.

    damping: optional traced scalar overriding cfg.damping (the adaptive
    LM loop in ba_solve threads its current lambda through here)."""
    damping = cfg.damping if damping is None else damping
    Hpp, bp, Hll, bl, Wfl, stats = linearize_ba(problem, K, width, height, cfg)
    S, b_red, Hll_inv, WHinv = schur_reduce(
        Hpp, bp, Hll, bl, Wfl, problem.fixed, damping
    )
    c, low = jax.scipy.linalg.cho_factor(S)
    dx_p = jax.scipy.linalg.cho_solve((c, low), -b_red).reshape(-1, 6)  # (W, 6)

    dx_l = backsubstitute(Hll_inv, bl, Wfl, dx_p)

    new_poses = jax.vmap(lambda d, T: lie.se3_exp(d) @ T)(dx_p, problem.poses)
    new_poses = jnp.where(problem.fixed[:, None, None], problem.poses, new_poses)
    touched = Hll[:, 0, 0] + Hll[:, 1, 1] + Hll[:, 2, 2] > 0
    upd = problem.point_valid & touched
    new_points = jnp.where(upd[:, None], problem.points + dx_l, problem.points)
    return problem._replace(poses=new_poses, points=new_points), stats


def _compact_active(obs_lm, obs_valid, L: int, La: int):
    """On-device active-first landmark renumbering.

    Maps the <= W·N observed landmark ids into a compact [0, La) index
    space (first occurrence order after sort), so every O(L) per-iteration
    term (Hll inversion, Wfl coupling, segment-sums) runs at O(La) instead
    of O(map capacity).  Invalid observations and the overflow group land
    in the inert last slot.

    Returns (new_obs_lm (W,N), active_old (La,) original ids with L as the
    'unused slot' sentinel).
    """
    flat = obs_lm.reshape(-1)
    valid = obs_valid.reshape(-1)
    key = jnp.where(valid, flat, L)           # invalid -> sentinel group
    order = jnp.argsort(key)
    sv = key[order]
    first = jnp.concatenate([jnp.ones((1,), bool), sv[1:] != sv[:-1]])
    nid_sorted = jnp.cumsum(first.astype(jnp.int32)) - 1
    nid_sorted = jnp.where(sv == L, La - 1, jnp.minimum(nid_sorted, La - 1))
    new_flat = jnp.zeros_like(flat).at[order].set(nid_sorted)
    active_old = (
        jnp.full((La,), L, jnp.int32).at[nid_sorted].set(
            sv.astype(jnp.int32), mode="drop")
    )
    # the last slot is the inert sentinel: when La caps below the unique
    # count (BAConfig.compact_cap), overflow landmarks collide into it —
    # pin it to L so they are DROPPED (point_valid false) instead of
    # aggregated into one corrupted pseudo-landmark
    active_old = active_old.at[La - 1].set(L)
    return new_flat.reshape(obs_lm.shape), active_old


def _compact_active_mask(obs_lm, obs_valid, L: int, La: int):
    """Sort-free twin of ``_compact_active`` (same renumbering: observed
    landmarks packed ascending-id into [0, La-1), overflow + invalid to
    the inert sentinel slot La-1).

    Rationale: the argsort over the W·N observation ids dominated the
    in-scan local-BA solve's FIXED cost on the first target (not yet
    measured on the GPU).  Presence is instead computed by a
    one-hot matmul over the map axis, the new ids by a cumsum, and
    the slot->old-id table by a second small one-hot matmul — no sort,
    no scatter."""
    flat = obs_lm.reshape(-1)
    valid = obs_valid.reshape(-1)
    slots = jnp.arange(L, dtype=jnp.int32)
    # (L, M) one-hot: presence[l] = any valid obs of landmark l
    oh = ((slots[:, None] == flat[None, :]) & valid[None, :]).astype(
        jnp.float32)
    presence = jnp.dot(oh, jnp.ones((flat.shape[0],), jnp.float32),
                       preferred_element_type=jnp.float32) > 0.5  # (L,)
    newid = jnp.cumsum(presence.astype(jnp.int32)) - 1          # (L,)
    kept = presence & (newid < La - 1)
    newid_c = jnp.where(kept, newid, La - 1)
    new_flat = jnp.where(valid, newid_c[flat], La - 1).astype(jnp.int32)
    # slot -> original id via one-hot matmul (ids < 2^24: exact in f32)
    rows = jnp.arange(La, dtype=jnp.int32)
    oh2 = ((rows[:, None] == newid_c[None, :]) & kept[None, :]).astype(
        jnp.float32)                                             # (La, L)
    active_old = jnp.dot(oh2, slots.astype(jnp.float32),
                         preferred_element_type=jnp.float32)
    hit = jnp.dot(oh2, jnp.ones((L,), jnp.float32),
                  preferred_element_type=jnp.float32) > 0.5
    active_old = jnp.where(hit, jnp.round(active_old), L).astype(jnp.int32)
    active_old = active_old.at[La - 1].set(L)
    return new_flat.reshape(obs_lm.shape), active_old


@jax.named_scope("ba")
def ba_solve(problem: BAProblem, K, width, height, cfg: BAConfig,
             compact: bool = True):
    """Run cfg.iterations BA steps (fori_loop — static, compile-once).

    compact=True (default) renumbers the observed landmarks into a compact
    prefix once per solve — the iteration loop then scales with the number
    of observations, not the map capacity (about 9x fewer per-iteration
    FLOPs at a 16k-landmark map, W=10, N=128).
    """
    Wf, N = problem.obs_lm.shape
    L = problem.points.shape[0]
    La = min(L, Wf * N + 1)
    if cfg.compact_cap:
        # hard cap on the active-landmark prefix: every O(La) term
        # (invert_hll, the WHinv/S einsums, scatter-back) shrinks to the
        # cap; landmarks past it (highest-indexed = newest) are dropped
        # from THIS solve via the inert sentinel slot, not corrupted
        La = min(La, cfg.compact_cap)
    use_compact = compact and La < L

    if use_compact:
        compact_fn = (_compact_active_mask if cfg.compact_method == "mask"
                      else _compact_active)
        new_lm, active_old = compact_fn(
            problem.obs_lm, problem.obs_valid, L, La)
        slot_used = active_old < L
        gather_idx = jnp.clip(active_old, 0, L - 1)
        prob_act = problem._replace(
            points=problem.points[gather_idx],
            point_valid=problem.point_valid[gather_idx] & slot_used,
            obs_lm=new_lm,
        )
    else:
        prob_act = problem

    if cfg.lm_adaptive:
        # Levenberg-Marquardt trust-region loop: one trial step per
        # iteration against the truncated robust objective.  Rejected or
        # non-finite steps are rolled back with lambda x4; accepted steps
        # relax lambda x0.5.  This is what lets ONE solver config cover
        # both near-converged windows (tiny lambda ~ pure GN) and
        # far-from-optimum full-trajectory restarts, where fixed small
        # damping diverges (non-finite poses at damping 1e-3 on the
        # 60-frame KITTI-scale fixture).
        def body(_, carry):
            prob, lam, chi_prev, stats = carry
            prob_new, stats_new = ba_step(prob, K, width, height, cfg, lam)
            chi_new = eval_robust_chi(prob_new, K, width, height, cfg)
            finite = (
                jnp.isfinite(chi_new)
                & jnp.all(jnp.isfinite(prob_new.poses))
                & jnp.all(jnp.isfinite(prob_new.points))
            )
            accept = finite & (chi_new <= chi_prev)
            prob = jax.tree.map(
                lambda a, b: jnp.where(accept, a, b), prob_new, prob)
            stats = jax.tree.map(
                lambda a, b: jnp.where(accept, a, b), stats_new, stats)
            lam = jnp.where(
                accept,
                jnp.maximum(lam * 0.5, cfg.damping),
                jnp.minimum(lam * 4.0, 1e8),
            )
            chi_prev = jnp.where(accept, chi_new, chi_prev)
            return prob, lam, chi_prev, stats

        chi0 = eval_robust_chi(prob_act, K, width, height, cfg)
        dummy = BAStats(chi0, jnp.int32(0), jnp.int32(0))
        prob, _, _, stats = jax.lax.fori_loop(
            0, cfg.iterations, body,
            (prob_act, jnp.float32(cfg.damping_init), chi0, dummy))
    else:
        def body(_, carry):
            prob, _ = carry
            return ba_step(prob, K, width, height, cfg)

        dummy = BAStats(jnp.float32(0), jnp.int32(0), jnp.int32(0))
        prob, stats = jax.lax.fori_loop(0, cfg.iterations, body, (prob_act, dummy))

    if use_compact:
        scatter_idx = jnp.where(slot_used, active_old, L)
        if cfg.compact_method == "mask":
            # one-hot matmul scatter-back (slots are unique, so a matmul
            # replaces the row-scatter of La rows)
            rows = jnp.arange(L, dtype=jnp.int32)
            oh = (rows[:, None] == scatter_idx[None, :]).astype(
                prob.points.dtype)                       # (L, La)
            hit = jnp.dot(oh, jnp.ones((scatter_idx.shape[0],),
                                       prob.points.dtype),
                          preferred_element_type=jnp.float32) > 0.5
            upd = jnp.dot(oh, prob.points,
                          preferred_element_type=jnp.float32)
            new_points = jnp.where(hit[:, None], upd, problem.points)
        else:
            new_points = problem.points.at[scatter_idx].set(
                prob.points, mode="drop")
        prob = problem._replace(poses=prob.poses, points=new_points)
    return prob, stats


def build_problem_from_vo(state, seq, frame_indices, cfg: EngineConfig) -> BAProblem:
    """Adapter: a VO map + a window of frames -> a BAProblem.

    Correspondences come from re-matching each window frame's descriptors
    against the (frozen) map — the same matcher the tracker uses.  Host-side
    convenience (numpy in, device arrays out); the solve itself is jitted.
    """
    import numpy as np

    from jaxvo.ops.match import match_descriptors

    W = len(frame_indices)
    L = state.map_xyz.shape[0]
    N = seq.uv.shape[1]
    obs_uv = np.zeros((W, N, 2), np.float32)
    obs_lm = np.zeros((W, N), np.int32)
    obs_valid = np.zeros((W, N), bool)
    poses = np.zeros((W, 4, 4), np.float32)

    map_desc = jnp.asarray(state.map_desc)
    map_valid = jnp.asarray(state.map_valid)
    for k, fi in enumerate(frame_indices):
        res = match_descriptors(
            jnp.asarray(seq.desc[fi]), jnp.asarray(seq.valid[fi]),
            map_desc, map_valid,
            cfg.matcher.distance_threshold, cfg.matcher.ratio_threshold,
        )
        obs_uv[k] = seq.uv[fi]
        obs_lm[k] = np.asarray(res.idx)
        obs_valid[k] = np.asarray(res.valid)

    return BAProblem(
        poses=jnp.asarray(poses),  # caller overwrites with tracked poses
        points=jnp.asarray(state.map_xyz),
        obs_uv=jnp.asarray(obs_uv),
        obs_lm=jnp.asarray(obs_lm),
        obs_valid=jnp.asarray(obs_valid),
        point_valid=jnp.asarray(state.map_valid),
        fixed=jnp.asarray(np.eye(1, W, 0, dtype=bool)[0]),
    )
