"""Windowed BA refinement of a tracked trajectory ("full BA" pass).

The tracker (engine/vo.py) is frame-to-frame PICP; this pass re-optimizes
poses + landmarks jointly over sliding windows — the layer the reference
lacks entirely (SURVEY.md §2 parallelism table, BASELINE.json configs 3/4).

Strategy: slide a W-frame window with 50% overlap along the trajectory.
Each window re-matches its frames against the (frozen-topology) map, fixes
its first two poses (gauge + scale anchor to the already-refined prefix),
runs the Schur BA solver, and writes back the improved poses and landmark
positions.

Accelerator-first: the ENTIRE refinement is one compiled program — per-frame map
matching rides an on-device ``lax.map``, and the sequential window sweep is
a ``lax.scan`` whose carry is (all poses, all landmarks), with
dynamic-slice window extraction and masked writeback.  The first version
looped windows on the host and round-tripped the full landmark set per
window, so host syncs set its pace — the on-device sweep removes every
per-window host sync.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from jaxvo.ba.window import BAProblem, ba_solve
from jaxvo.config import BAConfig, EngineConfig
from jaxvo.ops import lie
from jaxvo.ops.match import match_descriptors


@partial(jax.jit, static_argnames=("cfg", "ba_cfg", "n_windows", "step"))
def _refine_run(poses_all, points, point_valid, map_desc, desc, valid,
                obs_uv, K, cfg, ba_cfg, n_windows, step):
    """One compiled program for the whole refinement (module-level jit so
    repeated calls with the same shapes/config hit the compile cache)."""
    W = ba_cfg.window
    fixed = jnp.arange(W) < 2  # gauge + scale anchor to the refined prefix

    # per-frame correspondences vs the (frozen) final map, on device
    def match_frame(inp):
        d, v = inp
        r = match_descriptors(
            d, v, map_desc, point_valid,
            cfg.matcher.distance_threshold, cfg.matcher.ratio_threshold,
            cfg.matcher.method,
        )
        return r.idx, r.valid

    obs_lm, obs_valid = jax.lax.map(match_frame, (desc, valid))

    def window_step(carry, w):
        poses_all, points = carry
        lo = w * step
        sl = lambda a: jax.lax.dynamic_slice_in_dim(a, lo, W, axis=0)
        win_poses = sl(poses_all)                      # camera-in-world
        wic = jax.vmap(lie.inv_se3)(win_poses)         # world-in-camera
        prob = BAProblem(
            poses=wic, points=points,
            obs_uv=sl(obs_uv), obs_lm=sl(obs_lm), obs_valid=sl(obs_valid),
            point_valid=point_valid, fixed=fixed,
        )
        prob2, stats = ba_solve(prob, K, cfg.width, cfg.height, ba_cfg)
        # graceful degradation: a diverged (non-finite) window is
        # skipped — its frames keep the incoming poses and points
        ok = jnp.all(jnp.isfinite(prob2.poses))
        new_cw = jax.vmap(lie.inv_se3)(prob2.poses)
        upd = jnp.where((ok & ~fixed)[:, None, None], new_cw, win_poses)
        poses_all = jax.lax.dynamic_update_slice_in_dim(
            poses_all, upd, lo, axis=0)
        pt_ok = ok & jnp.all(jnp.isfinite(prob2.points), axis=1)
        points = jnp.where(pt_ok[:, None], prob2.points, points)
        return (poses_all, points), (stats.chi, stats.num_inliers, ~ok)

    (poses_all, points), ys = jax.lax.scan(
        window_step, (poses_all, points),
        jnp.arange(n_windows, dtype=jnp.int32))
    return poses_all, points, ys


@partial(jax.jit, static_argnames=("cfg",))
def _global_topology(map_desc, point_valid, desc, valid, cfg):
    """Frozen correspondence topology (computed once per refinement)."""

    def match_frame(inp):
        d, v = inp
        r = match_descriptors(
            d, v, map_desc, point_valid,
            cfg.matcher.distance_threshold, cfg.matcher.ratio_threshold,
            cfg.matcher.method,
        )
        return r.idx, r.valid

    return jax.lax.map(match_frame, (desc, valid))


@partial(jax.jit, static_argnames=("cfg", "ba_cfg"))
def _global_sweep(poses_all, points, point_valid, obs_uv, obs_lm, obs_valid,
                  K, cfg, ba_cfg):
    """One full-trajectory BA sweep (jit-cached per static ba_cfg: the
    coarse and fine configs each compile once per shape)."""
    F = poses_all.shape[0]
    fixed = jnp.arange(F) < 2
    wic = jax.vmap(lie.inv_se3)(poses_all)
    prob = BAProblem(
        poses=wic, points=points,
        obs_uv=obs_uv, obs_lm=obs_lm, obs_valid=obs_valid,
        point_valid=point_valid, fixed=fixed,
    )
    prob2, stats = ba_solve(prob, K, cfg.width, cfg.height, ba_cfg)
    ok = jnp.all(jnp.isfinite(prob2.poses))
    new_cw = jax.vmap(lie.inv_se3)(prob2.poses)
    poses_out = jnp.where((ok & ~fixed)[:, None, None], new_cw, poses_all)
    pt_ok = ok & jnp.all(jnp.isfinite(prob2.points), axis=1)
    points_out = jnp.where(pt_ok[:, None], prob2.points, points)
    return poses_out, points_out, stats.chi, stats.num_inliers, ~ok


def refine_trajectory_global(
    state,
    seq,
    poses,
    cfg: EngineConfig | None = None,
    ba_cfg: BAConfig | None = None,
    n_sweeps: int = 2,
    max_sweeps: int = 10,
    rel_improvement_stop: float = 0.01,
    topology=None,
):
    """Joint BA over ALL poses + landmarks (the accuracy-first refiner).

    poses: (F, 4, 4) camera-in-world from the tracker.
    Returns (refined poses, refined map_xyz, stats list — one per sweep).

    ADAPTIVE sweep count (round 4): at least ``max(n_sweeps, 3)`` sweeps
    run (1 coarse + two fine — the plateau test needs a fine-vs-fine
    pair); fine sweeps then continue while the robust chi still improves
    by more than ``rel_improvement_stop`` per sweep, up to ``max_sweeps``.
    A fixed schedule is basin-sensitive — a ~2 ATE shift in the tracked
    start (fp-level chaos on KITTI-scale fixtures) moved the 2-sweep
    result from 0.05 to 5.6, while sweeping-to-convergence lands at 0.36
    regardless.  Host-side loop over jit-cached single-sweep programs
    (the coarse and fine configs each compile once).

    topology: optional precomputed ``(obs_lm, obs_valid)`` frozen
    correspondences (e.g. from the loop refiner, which needs the same
    matching for loop detection — avoids running the F x map matcher
    twice).
    """
    cfg = cfg or EngineConfig()
    ba_cfg = ba_cfg or BAConfig()
    K = jnp.asarray(cfg.K())
    poses_all = jnp.asarray(poses, jnp.float32)
    points = jnp.asarray(state.map_xyz)
    point_valid = jnp.asarray(state.map_valid)
    obs_uv = jnp.asarray(seq.uv)
    if topology is not None:
        obs_lm, obs_valid = topology
    else:
        obs_lm, obs_valid = _global_topology(
            jnp.asarray(state.map_desc), point_valid,
            jnp.asarray(seq.desc), jnp.asarray(seq.valid), cfg)

    # Graduated robustness: sweep 0 runs COARSE — no image-bounds cull
    # (cheirality only) and a saturating-weight kernel at a huge
    # threshold, so loop-closure correspondences whose residuals are
    # hundreds of pixels at the drifted estimate still pull (a trimming
    # kernel at the tracking threshold zeroes exactly those constraints).
    # Later sweeps tighten to the caller's threshold.  Gauge fixed ONLY
    # at poses 0/1 (identity + monocular scale anchor) so the optimizer
    # can move the whole trajectory, not re-anchor to a drifted prefix.
    coarse_cfg = ba_cfg.replace(
        keep_outliers=True, cull_bounds=False,
        huber_threshold=max(ba_cfg.huber_threshold, 1.0e8),
    )
    fine_cfg = ba_cfg.replace(cull_bounds=False)

    stats_out = []
    prev_fine_chi = None
    i = 0
    # an explicit n_sweeps above the adaptive cap means the caller wants
    # that many sweeps — honor it rather than silently clamping
    max_sweeps = max(max_sweeps, n_sweeps)
    while i < max_sweeps:
        sweep_cfg = coarse_cfg if i == 0 else fine_cfg
        poses_all, points, chi, inliers, skipped = _global_sweep(
            poses_all, points, point_valid, obs_uv, obs_lm, obs_valid,
            K, cfg, sweep_cfg)
        chi = float(chi)
        stats_out.append({"sweep": i, "chi": chi,
                          "inliers": int(inliers),
                          "skipped": bool(skipped)})
        i += 1
        if i >= n_sweeps and i > 1:
            # stop when the FINE objective plateaus (coarse chi uses a
            # different kernel and is not comparable)
            if prev_fine_chi is not None and (
                    chi >= prev_fine_chi * (1.0 - rel_improvement_stop)):
                break
        if sweep_cfg is fine_cfg:
            prev_fine_chi = chi
    poses_ref, points_ref = jax.device_get((poses_all, points))
    return poses_ref, points_ref, stats_out


def refine_trajectory_loop(
    state,
    seq,
    poses,
    cfg: EngineConfig | None = None,
    ba_cfg: BAConfig | None = None,
    n_sweeps: int = 3,
):
    """Loop-closure refinement: detect loops, PGO, then graduated global BA.

    The full drift-repair stack (ba/loop.py pipeline + the graduated
    global refiner).  On the 200-frame / 199 m synthetic loop circuit this
    takes the tracked ATE from 28.6 (plain tracker) / 1.42 (SLAM-mode
    tracker) to 0.20.  Poses pass through unchanged when no loop
    qualifies (open trajectory) except for the global-BA polish.
    Returns (poses, points, stats) like the other refiners, with a
    leading PGO stats entry.
    """
    from jaxvo.ba.loop import close_loops

    cfg = cfg or EngineConfig()
    ba_cfg = ba_cfg or BAConfig(window=int(np.asarray(poses).shape[0]),
                                iterations=15, huber_threshold=500.0)
    K = jnp.asarray(cfg.K())
    poses0 = jnp.asarray(poses, jnp.float32)

    # frozen topology via the same jit-cached helper the global refiner
    # uses (it recomputes the identical matching right after — reuse the
    # compiled program instead of paying the F x map matcher twice)
    obs_lm, obs_valid = _global_topology(
        jnp.asarray(state.map_desc), jnp.asarray(state.map_valid),
        jnp.asarray(seq.desc), jnp.asarray(seq.valid), cfg)
    poses_pgo, n_loops, chi = close_loops(
        K, poses0, jnp.asarray(state.map_xyz), jnp.asarray(state.map_valid),
        jnp.asarray(seq.uv), obs_lm, obs_valid, cfg.width, cfg.height)
    poses_ref, points_ref, stats = refine_trajectory_global(
        state, seq, poses_pgo, cfg, ba_cfg, n_sweeps=n_sweeps,
        topology=(obs_lm, obs_valid))
    stats = [{"stage": "pgo", "n_loop_edges": int(n_loops),
              "chi": float(chi)}] + stats
    return poses_ref, points_ref, stats


def refine_trajectory(
    state,
    seq,
    poses,
    cfg: EngineConfig | None = None,
    ba_cfg: BAConfig | None = None,
):
    """poses: (F, 4, 4) camera-in-world from the tracker.

    Returns (refined poses (F, 4, 4), refined map_xyz (C, 3), stats list).
    """
    cfg = cfg or EngineConfig()
    ba_cfg = ba_cfg or BAConfig()
    W = ba_cfg.window
    F = seq.uv.shape[0]
    K = jnp.asarray(cfg.K())
    step = max(W // 2, 1)
    n_windows = len(range(0, F - W + 1, step))
    if n_windows == 0:
        return np.asarray(poses), np.asarray(state.map_xyz), []

    # jnp.asarray is a no-op for arrays already on device — callers that
    # keep (seq, poses, state) device-resident pay zero re-upload here
    poses0 = jnp.asarray(poses, jnp.float32)                   # (F, 4, 4)
    poses_ref, points_ref, (chis, inliers, skipped) = _refine_run(
        poses0, jnp.asarray(state.map_xyz), jnp.asarray(state.map_valid),
        jnp.asarray(state.map_desc), jnp.asarray(seq.desc),
        jnp.asarray(seq.valid), jnp.asarray(seq.uv), K,
        cfg, ba_cfg, n_windows, step,
    )
    # one device->host pull for everything (a per-element float()/int()
    # pull is a device sync each — 117 of them per refine)
    poses_ref, points_ref, chis, inliers, skipped = jax.device_get(
        (poses_ref, points_ref, chis, inliers, skipped))
    stats_out = [
        {"window": int(i * step), "chi": float(chis[i]),
         "inliers": int(inliers[i]), "skipped": bool(skipped[i])}
        for i in range(n_windows)
    ]
    return poses_ref, points_ref, stats_out
