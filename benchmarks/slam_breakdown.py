"""Stage-cost attribution for SLAM-mode tracking (engine/slam.py).

This probe times the pieces of the interleaved local-BA branch in
isolation so the optimization targets the real cost, not a guess:

  tracker      — the plain scanned tracker (the floor)
  slam         — the full _slam_scan program
  win_match    — one window re-match: lax.map of W matches vs the full map
  ba_solve     — one local-BA solve on a realistic window problem
  ba_solve_it1 — same with iterations=1 (isolates per-iteration cost)

Run: python benchmarks/slam_breakdown.py [--frames 200]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from jaxvo.ba.window import BAProblem, ba_solve
from jaxvo.config import BAConfig, EngineConfig, PICPConfig
from jaxvo.data import synthetic
from jaxvo.engine import vo
from jaxvo.engine.slam import _local_ba_cfg, run_sequence_slam
from jaxvo.ops import lie
from jaxvo.ops.match import match_descriptors


def timeit(fn, reps=5):
    fn()  # warm
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return min(ts)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--landmarks", type=int, default=10000)
    ap.add_argument("--map-capacity", type=int, default=8192)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()

    cfg = EngineConfig(
        mode="fixed",
        n_frames=args.frames,
        map_capacity=args.map_capacity,
        fuse_frame_matchers=True,
        picp=PICPConfig(convergence_threshold=1e-4),
    )
    gt = synthetic.make_loop_trajectory(args.frames, step=1.0, seed=args.seed)
    extent = float(np.abs(gt[:, :2]).max()) + 15.0
    world = synthetic.make_world(args.seed, n_landmarks=args.landmarks,
                                 xy_extent=extent, z_range=(0.0, 8.0))
    seq = synthetic.render_sequence(world, gt, cfg, pixel_noise=0.3,
                                    seed=args.seed)
    seq = jax.tree.map(jnp.asarray, seq)
    F = seq.uv.shape[0]

    # plain tracker floor
    key = jax.random.PRNGKey(args.seed)
    f0, f1 = vo.frame_of(seq, 0), vo.frame_of(seq, 1)
    fc, fn_ = vo.frames_of(seq, 0, F - 1), vo.frames_of(seq, 1, F)
    boot = jax.jit(lambda k, a, b: vo.bootstrap(k, a, b, cfg))
    tracker = vo.make_tracker(cfg)
    state0, _ = boot(key, f0, f1)
    t_track = timeit(lambda: jax.block_until_ready(
        tracker(state0, fc, fn_)[1].pose))

    # full slam program
    def slam():
        _, _, poses, _ = run_sequence_slam(seq, cfg, seed=args.seed)
        jax.block_until_ready(poses)
    t_slam = timeit(slam, reps=3)

    # a realistic mid-run state: track to frame W for the window problem
    state, logs = tracker(state0, fc, fn_)
    W = cfg.local_ba_window
    n_ba = sum(1 for k in range(1, F) if k >= W and k % cfg.local_ba_every == 0)

    # one window re-match (as do_ba does): lax.map of W matches vs the map
    frames = vo.frames_of(seq, 0, F)

    @jax.jit
    def win_match(state, lo):
        sl = lambda a: jax.lax.dynamic_slice_in_dim(a, lo, W, axis=0)
        def m(iv):
            d, v = iv
            r = match_descriptors(d, v, state.map_desc, state.map_valid,
                                  cfg.matcher.distance_threshold,
                                  cfg.matcher.ratio_threshold,
                                  cfg.matcher.method)
            return r.idx, r.valid
        return jax.lax.map(m, (sl(frames.desc), sl(frames.valid)))

    obs_lm, obs_valid = win_match(state, F - W - 1)
    t_match = timeit(lambda: jax.block_until_ready(
        win_match(state, F - W - 1)[0]))

    # one local-BA solve on that window
    lo = F - W - 1
    sl = lambda a: jax.lax.dynamic_slice_in_dim(a, lo, W, axis=0)
    poses_all = jnp.concatenate(
        [jnp.eye(4, dtype=jnp.float32)[None], logs.pose], 0)
    wic = jax.vmap(lie.inv_se3)(sl(poses_all))
    prob = BAProblem(
        poses=wic, points=state.map_xyz, obs_uv=sl(frames.uv),
        obs_lm=obs_lm, obs_valid=obs_valid,
        point_valid=state.map_valid,
        fixed=jnp.arange(W) < 2,
    )
    K = jnp.asarray(cfg.K())
    ba_cfg = _local_ba_cfg(cfg)
    solve = jax.jit(lambda p: ba_solve(p, K, cfg.width, cfg.height, ba_cfg))
    t_solve = timeit(lambda: jax.block_until_ready(solve(prob)[0].poses))
    ba1 = ba_cfg.replace(iterations=1)
    solve1 = jax.jit(lambda p: ba_solve(p, K, cfg.width, cfg.height, ba1))
    t_solve1 = timeit(lambda: jax.block_until_ready(solve1(prob)[0].poses))

    # fixed-overhead attribution inside ba_solve
    from jaxvo.ba.window import _compact_active, eval_robust_chi

    L = prob.points.shape[0]
    La = min(L, W * prob.obs_lm.shape[1] + 1)
    compact_j = jax.jit(lambda lm, v: _compact_active(lm, v, L, La))
    t_compact = timeit(lambda: jax.block_until_ready(
        compact_j(prob.obs_lm, prob.obs_valid)[0]))
    new_lm, active_old = compact_j(prob.obs_lm, prob.obs_valid)
    slot_used = active_old < L
    scatter_idx = jnp.where(slot_used, active_old, L)
    pts_act = prob.points[jnp.clip(active_old, 0, L - 1)]
    scatter_j = jax.jit(
        lambda pts, act: pts.at[scatter_idx].set(act, mode="drop"))
    t_scatter = timeit(lambda: jax.block_until_ready(
        scatter_j(prob.points, pts_act)))
    chi_j = jax.jit(lambda p: eval_robust_chi(p, K, cfg.width, cfg.height,
                                              ba_cfg))
    t_chi = timeit(lambda: jax.block_until_ready(chi_j(prob)))
    solve1nc = jax.jit(lambda p: ba_solve(p, K, cfg.width, cfg.height, ba1,
                                          compact=False))
    t_solve1_nocompact = timeit(lambda: jax.block_until_ready(
        solve1nc(prob)[0].poses))

    out = {
        "bench": "slam_breakdown",
        "frames": F,
        "n_ba_runs": n_ba,
        "tracker_s": round(t_track, 4),
        "slam_s": round(t_slam, 4),
        "slam_minus_track_per_ba_ms": round(
            1e3 * (t_slam - t_track) / max(n_ba, 1), 3),
        "win_match_ms": round(1e3 * t_match, 3),
        "ba_solve10_ms": round(1e3 * t_solve, 3),
        "ba_solve1_ms": round(1e3 * t_solve1, 3),
        "ba_solve1_nocompact_ms": round(1e3 * t_solve1_nocompact, 3),
        "compact_ms": round(1e3 * t_compact, 3),
        "scatter_back_ms": round(1e3 * t_scatter, 3),
        "chi_eval_ms": round(1e3 * t_chi, 3),
        "slam_fps": round((F - 1) / t_slam, 1),
        "track_fps": round((F - 1) / t_track, 1),
        "platform": jax.devices()[0].platform,
        "device_kind": jax.devices()[0].device_kind,
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
