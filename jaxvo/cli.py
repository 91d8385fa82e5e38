"""Command-line interface: ``python -m jaxvo <subcommand>``.

Replaces the reference's four executables (CMakeLists.txt:25-59) with one
CLI (SURVEY.md §2 "Drivers" row):

  run          — canonical icp_test pipeline; writes the reference-format
                 artifacts + headless plots
  vo           — the vo.cpp driver variant (kernel 1000, fixed 5 rounds,
                 path-length scale)
  match-test   — per-pair matcher precision probe (match_points_test)
  pose-recovery— chained two-view odometry (pose_recovery_test)
  triangulate  — bootstrap-only landmark dump vs world.dat
                 (triangulate_points_test)
  ba           — sliding-window bundle adjustment refinement over a run
  slam         — SLAM-mode tracking (interleaved local BA) + optional
                 loop-closure/global refinement; writes run artifacts
  bench        — the benchmark harness (same as python bench.py)
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def _apply_options(cfg, args):
    """The engine options every subcommand shares."""
    import dataclasses

    from jaxvo.config import MatcherConfig

    if getattr(args, "evict_age", 0):
        cfg = cfg.replace(map_evict_age=args.evict_age)
    if getattr(args, "matcher", None):
        cfg = cfg.replace(matcher=MatcherConfig(method=args.matcher))
    if getattr(args, "picp", None):
        cfg = cfg.replace(picp=dataclasses.replace(cfg.picp, backend=args.picp))
    return cfg


def _load(args):
    from jaxvo.config import EngineConfig
    from jaxvo.data import load_camera_config, load_sequence

    camera_dat = os.path.join(args.data, "camera.dat")
    if os.path.exists(camera_dat):
        cfg = load_camera_config(camera_dat, mode=args.mode)
    else:
        cfg = EngineConfig(mode=args.mode)
    cfg = _apply_options(cfg, args)
    seq = load_sequence(args.data, args.frames)
    return cfg, seq


def cmd_run(args):
    from jaxvo.engine.drivers import run_icp
    from jaxvo.engine.eval import evaluate, metrics_dict, write_outputs
    from jaxvo.engine import plots
    from jaxvo.utils.metrics import MetricsLogger, log_frame_logs

    cfg, seq = _load(args)
    logs = None
    if getattr(args, "online", False):
        # streaming session: one frame at a time through OnlineVO (the
        # serving interface) — pose-for-pose identical to the batch run
        import jax.numpy as jnp
        import numpy as _np

        from jaxvo.engine import vo as _vo

        sess = _vo.OnlineVO(cfg, seed=args.seed)
        sess.start(_vo.frame_of(seq, 0), _vo.frame_of(seq, 1))
        plist = [_np.eye(4, dtype=_np.float32)]
        for i in range(1, seq.uv.shape[0]):
            plist.append(_np.asarray(sess.step(_vo.frame_of(seq, i))))
        state, poses = sess.state, _np.stack(plist)
    elif args.checkpoint_every > 0:
        # checkpointed chunked tracking with automatic resume (the
        # checkpoint lives under --out; delete it to restart from scratch)
        from jaxvo.engine.vo import run_sequence_chunked

        os.makedirs(args.out, exist_ok=True)
        state, poses, step = run_sequence_chunked(
            seq, cfg, seed=args.seed,
            checkpoint_path=os.path.join(args.out, "checkpoint.npz"),
            checkpoint_every=args.checkpoint_every,
        )
    else:
        state, logs, poses, diag = run_icp(seq, cfg, seed=args.seed)
    res = evaluate(poses, seq.gt_pose, cfg)
    os.makedirs(args.out, exist_ok=True)
    write_outputs(args.out, res, state, cfg)
    if not plots.render_all(args.out, res, state, cfg):
        print("plots skipped: matplotlib is not installed", file=sys.stderr)
    logger = MetricsLogger(os.path.join(args.out, "metrics.jsonl"))
    if logs is not None:
        log_frame_logs(logger, logs)
    m = metrics_dict(res)
    logger.log({"event": "summary", **m, "map_count": int(state.map_count)})
    logger.close()
    print(json.dumps({"map_count": int(state.map_count), **m}, indent=2))


def cmd_vo(args):
    from jaxvo.engine.drivers import run_vo
    from jaxvo.engine.eval import evaluate, metrics_dict

    cfg, seq = _load(args)
    state, logs, poses, diag = run_vo(seq, cfg, seed=args.seed)
    res = evaluate(poses, seq.gt_pose, cfg)
    print(json.dumps({
        "map_count": int(state.map_count),
        "scale_path_ratio": diag["scale_path_ratio"],
        "duplicate_landmarks": diag["duplicates"],
        **metrics_dict(res),
    }, indent=2))


def cmd_match_test(args):
    from jaxvo.engine.drivers import run_match_test

    cfg, seq = _load(args)
    rows = run_match_test(seq, cfg)
    total_f = sum(r.found for r in rows)
    total_c = sum(r.correct for r in rows)
    for r in rows:
        print(f"frame {r.frame:3d}: possible {r.possible:4d} found {r.found:4d} correct {r.correct:4d}")
    print(f"TOTAL: found {total_f} correct {total_c} precision {total_c/max(total_f,1):.4f}")


def cmd_pose_recovery(args):
    from jaxvo.engine.drivers import run_pose_recovery

    cfg, seq = _load(args)
    poses_world, inliers = run_pose_recovery(seq, cfg, seed=args.seed)
    print(f"chained {len(poses_world)} poses; mean pair inliers {np.mean(inliers):.1f}")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        np.savetxt(
            os.path.join(args.out, "chained_trajectory.txt"),
            np.c_[np.arange(len(poses_world)), poses_world[:, 0, 3], poses_world[:, 1, 3]],
            fmt="%g",
        )


def cmd_triangulate(args):
    from jaxvo.data import load_world_points
    from jaxvo.engine.drivers import run_triangulate_test

    cfg, seq = _load(args)
    world = load_world_points(os.path.join(args.data, "world.dat"))
    ids, pts, gt = run_triangulate_test(seq, world, cfg, seed=args.seed)
    for i in range(min(len(ids), args.limit)):
        print(f"id {int(ids[i]):4d} est {pts[i].round(3).tolist()} gt {gt[i].round(3).tolist()}")
    print(f"({len(ids)} landmarks triangulated)")


def cmd_ba(args):
    import jax.numpy as jnp

    from jaxvo.ba.window import ba_solve, build_problem_from_vo
    from jaxvo.config import BAConfig
    from jaxvo.engine.drivers import run_icp
    from jaxvo.ops import lie

    cfg, seq = _load(args)
    state, logs, poses, diag = run_icp(seq, cfg, seed=args.seed)
    lo = max(0, args.window_start)
    hi = min(seq.uv.shape[0], lo + args.window)
    idxs = list(range(lo, hi))
    prob = build_problem_from_vo(state, seq, idxs, cfg)
    # world-in-camera poses of the window from the tracked trajectory
    # (one vmapped inversion — a per-index device loop cost ~2.9 s here)
    import jax

    wic = jax.vmap(lie.inv_se3)(jnp.asarray(np.asarray(poses)[idxs]))
    prob = prob._replace(poses=wic)
    ba_cfg = BAConfig(window=len(idxs), iterations=args.iterations)
    prob2, stats = ba_solve(prob, jnp.asarray(cfg.K()), cfg.width, cfg.height, ba_cfg)
    print(json.dumps({
        "window": idxs,
        "iterations": args.iterations,
        "chi": float(stats.chi),
        "num_inliers": int(stats.num_inliers),
        "num_obs": int(stats.num_obs),
    }, indent=2))


def cmd_slam(args):
    """SLAM-mode tracking (PTAM-style local BA interleaved with the
    tracker, engine/slam.py) + optional loop-closure refinement.

    Reproduces the flagship drift-repair result in two flags:
      python -m jaxvo slam --out out_slam                 # tracking only
      python -m jaxvo slam --refine loop --out out_slam   # + PGO/global BA
    (measured on the 200-frame KITTI-scale loop circuit: plain-tracked
    ATE 26.0 -> SLAM-tracked ~1.0 -> loop-refined 0.077)."""
    from jaxvo.engine import plots
    from jaxvo.engine.eval import evaluate, metrics_dict, write_outputs
    from jaxvo.engine.slam import run_sequence_slam
    from jaxvo.utils.metrics import MetricsLogger, log_frame_logs

    cfg, seq = _load(args)
    # local-BA shape overrides (long sequences want W32-40/S2, see
    # EngineConfig.local_ba_stride's measured landscape)
    if args.window:
        cfg = cfg.replace(local_ba_window=args.window)
    if args.every:
        cfg = cfg.replace(local_ba_every=args.every)
    if args.stride:
        cfg = cfg.replace(local_ba_stride=args.stride)
    state, logs, poses, diag = run_sequence_slam(seq, cfg, seed=args.seed)
    poses = np.asarray(poses)
    res = evaluate(poses, seq.gt_pose, cfg)
    out = {"n_local_ba_runs": int(diag["n_local_ba_runs"]),
           "tracked": metrics_dict(res)}
    if args.refine != "none":
        from jaxvo.config import BAConfig
        from jaxvo.engine.ba_refine import (refine_trajectory_global,
                                            refine_trajectory_loop)

        gcfg = BAConfig(window=poses.shape[0], iterations=args.iterations,
                        huber_threshold=500.0,
                        max_landmarks=cfg.map_capacity)
        refiner = (refine_trajectory_loop if args.refine == "loop"
                   else refine_trajectory_global)
        poses, points2, stats = refiner(state, seq, poses, cfg, gcfg,
                                        n_sweeps=args.sweeps)
        import jax.numpy as jnp

        state = state._replace(map_xyz=jnp.asarray(points2))
        res = evaluate(poses, seq.gt_pose, cfg)  # refined trajectory
        out["refined"] = metrics_dict(res)
    os.makedirs(args.out, exist_ok=True)
    write_outputs(args.out, res, state, cfg)
    if not plots.render_all(args.out, res, state, cfg):
        print("plots skipped: matplotlib is not installed", file=sys.stderr)
    logger = MetricsLogger(os.path.join(args.out, "metrics.jsonl"))
    if logs is not None:
        log_frame_logs(logger, logs)
    logger.log({"event": "summary", **out.get("refined", out["tracked"]),
                "map_count": int(state.map_count)})
    logger.close()
    print(json.dumps({"map_count": int(state.map_count), **out}, indent=2))


def cmd_sweep(args):
    """Batched inlier-rejection sweep (BASELINE config 2)."""
    from jaxvo.engine.eval import evaluate, metrics_dict
    from jaxvo.engine.vo import run_threshold_sweep

    cfg, seq = _load(args)
    thresholds = [float(t) for t in args.thresholds.split(",")]
    states, logs, poses = run_threshold_sweep(seq, thresholds, cfg, seed=args.seed)
    out = {}
    for i, t in enumerate(thresholds):
        m = metrics_dict(evaluate(np.asarray(poses[i]), seq.gt_pose, cfg))
        out[str(t)] = {**m, "map_count": int(states.map_count[i])}
    print(json.dumps(out, indent=2))


def cmd_refine(args):
    """Tracking + BA refinement over the whole trajectory.

    --strategy global (default): joint BA over all poses + landmarks,
    gauge anchored at the trajectory start — the accuracy refiner.
    --strategy windowed: overlapping-window sweep (the sharded/scaling
    formulation; local smoothing only).
    --strategy posegraph: windowed BA for local relative poses, then a
    pose-graph solve fusing the window estimates globally (the
    hierarchical shape that scales past what global BA can hold).
    --strategy loop: loop-closure detection + PnP relocalization + PGO +
    graduated global BA (ba/loop.py — the full drift-repair stack).
    """
    from jaxvo.config import BAConfig
    from jaxvo.engine.ba_refine import (refine_trajectory,
                                        refine_trajectory_global,
                                        refine_trajectory_loop)
    from jaxvo.engine.drivers import run_icp
    from jaxvo.engine.eval import evaluate, metrics_dict

    cfg, seq = _load(args)
    state, logs, poses, diag = run_icp(seq, cfg, seed=args.seed)
    m0 = metrics_dict(evaluate(poses, seq.gt_pose, cfg))
    if args.strategy == "global":
        poses2, points2, stats = refine_trajectory_global(
            state, seq, poses, cfg,
            BAConfig(window=seq.uv.shape[0], iterations=args.iterations),
            n_sweeps=args.sweeps,
        )
    elif args.strategy == "loop":
        poses2, points2, stats = refine_trajectory_loop(
            state, seq, poses, cfg,
            BAConfig(window=seq.uv.shape[0], iterations=args.iterations),
            n_sweeps=args.sweeps,
        )
    elif args.strategy == "posegraph":
        # hierarchical SLAM shape: windowed BA for accurate LOCAL relative
        # poses, then a pose graph fusing the overlapping window estimates
        # with the odometry backbone into one consistent trajectory
        from jaxvo.ba.posegraph import build_graph, pgo_solve, window_edges

        poses_w, _, stats = refine_trajectory(
            state, seq, poses, cfg,
            BAConfig(window=args.window, iterations=args.iterations),
        )
        import jax.numpy as jnp

        W = args.window
        edges = window_edges(jnp.asarray(poses_w), W, max(W // 2, 1))
        graph = build_graph(poses, extra_edges=[edges])
        graph2, pgo_stats = pgo_solve(graph, iterations=20)
        poses2 = np.asarray(graph2.poses)
        stats = stats + [{"pgo_chi": float(pgo_stats.chi),
                          "pgo_inliers": int(pgo_stats.num_inliers)}]
    else:
        poses2, points2, stats = refine_trajectory(
            state, seq, poses, cfg,
            BAConfig(window=args.window, iterations=args.iterations),
        )
    m1 = metrics_dict(evaluate(poses2, seq.gt_pose, cfg))
    print(json.dumps({
        "strategy": args.strategy,
        "tracked": m0, "refined": m1,
        "windows": len(stats),
        "skipped": sum(s.get("skipped", False) for s in stats),
    }, indent=2))


def cmd_bench(args):
    import bench

    bench.main()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="jaxvo", description=__doc__)
    p.add_argument("--data", default="/root/reference/data", help="dataset dir")
    p.add_argument("--frames", type=int, default=121)
    # "fixed" (landmark gating, wrapped angles) is the production default:
    # "parity" reproduces the reference's fragile unfiltered map, which is
    # marginally stable and can lose track under another fp reduction
    # order (DESIGN.md §4).
    p.add_argument("--mode", default="fixed", choices=["parity", "fixed"])
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--evict-age", type=int, default=0,
                   help="landmark lifecycle: evict map slots unmatched for "
                        "this many frames and recycle them (0 = append-only)")
    p.add_argument("--matcher", default="",
                   choices=["", "direct", "mxu", "mxu_bf16"],
                   help="descriptor distance form")
    p.add_argument("--picp", default="xla", choices=["xla", "pallas"],
                   help="PICP Gauss-Newton solver: 'xla' (lax.while_loop, "
                        "every platform) or 'pallas' (the whole GN loop as "
                        "one fused kernel, NVIDIA GPU only; the solver that "
                        "bench.py measures on the GPU)")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("run")
    s.add_argument("--out", default="output")
    s.add_argument("--online", action="store_true",
                   help="stream frames one at a time through the OnlineVO "
                        "serving session (identical trajectory to batch)")
    s.add_argument("--checkpoint-every", type=int, default=0,
                   help="checkpoint the tracker state every N frames "
                        "(0 = off); an existing checkpoint resumes")
    s.set_defaults(fn=cmd_run)
    s = sub.add_parser("vo"); s.set_defaults(fn=cmd_vo)
    s = sub.add_parser("match-test"); s.set_defaults(fn=cmd_match_test)
    s = sub.add_parser("pose-recovery"); s.add_argument("--out", default=""); s.set_defaults(fn=cmd_pose_recovery)
    s = sub.add_parser("triangulate"); s.add_argument("--limit", type=int, default=20); s.set_defaults(fn=cmd_triangulate)
    s = sub.add_parser("ba")
    s.add_argument("--window", type=int, default=10)
    s.add_argument("--window-start", type=int, default=0)
    s.add_argument("--iterations", type=int, default=10)
    s.set_defaults(fn=cmd_ba)
    s = sub.add_parser("slam")
    s.add_argument("--out", default="output_slam")
    s.add_argument("--refine", default="none", choices=["none", "global", "loop"])
    s.add_argument("--iterations", type=int, default=15)
    s.add_argument("--sweeps", type=int, default=3)
    s.add_argument("--window", type=int, default=0,
                   help="local-BA window size W (0 = engine default 16)")
    s.add_argument("--every", type=int, default=0,
                   help="run local BA every E frames (0 = default 2)")
    s.add_argument("--stride", type=int, default=0,
                   help="keyframe spacing S of the local window (0 = "
                        "default 1; long sequences: W32-40, S2)")
    s.set_defaults(fn=cmd_slam)
    s = sub.add_parser("sweep")
    s.add_argument("--thresholds", default="1000,3000,10000")
    s.set_defaults(fn=cmd_sweep)
    s = sub.add_parser("refine")
    s.add_argument("--strategy", default="global",
                   choices=["global", "windowed", "posegraph", "loop"])
    s.add_argument("--window", type=int, default=10)
    s.add_argument("--iterations", type=int, default=15)
    s.add_argument("--sweeps", type=int, default=2)
    s.set_defaults(fn=cmd_refine)
    s = sub.add_parser("bench"); s.set_defaults(fn=cmd_bench)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    # multi-host entry: initializes jax.distributed when the coordinator
    # env vars are set (no-op single-host); raises loudly on failure
    from jaxvo.parallel.mesh import maybe_distributed_init
    from jaxvo.utils.compile_cache import enable_compile_cache

    maybe_distributed_init()
    enable_compile_cache()
    args.fn(args)


if __name__ == "__main__":
    main()
