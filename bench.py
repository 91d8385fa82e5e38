"""Benchmark harness — prints ONE JSON line with the headline metric.

Headline: frames/s of the full VO pipeline (bootstrap + 120-frame tracking:
matching, PICP GN, triangulation, map growth) on the 121-frame control
sequence, measured on the GPU.  Frames/s counts the F-1 = 120 tracked
frames, as chip_smoke.py does.

Two modes are measured (configurations in jaxvo/profiles.py):
  * latency    — one sequence, one fused bootstrap+scan program,
                 frames/s = (F-1) / wall (median of the timed reps);
  * throughput — vmap over B DISTINCT sequences (per-lane pixel noise +
                 PRNG keys, so per-lane match/iteration schedules differ),
                 frames/s = B*(F-1) / wall;
plus SLAM with local BA on the 200-frame loop circuit and its loop-closure
refinement.

The bench refuses to run without a GPU.  ``JAX_PLATFORMS=cpu`` asks for a
CPU run explicitly; every number is then labelled ``cpu``.

vs_baseline anchors against the C++ reference compiled in Release (-O3):
3584.35 frames/s (BASELINE.md "Measured C++ baseline"; other data, other
host — history, not a like-for-like comparison).
"""

import json
import os
import sys
import time

import numpy as np

CPP_BASELINE_FPS = 3584.35


def main():
    import jax
    import jax.numpy as jnp

    from jaxvo.utils.compile_cache import enable_compile_cache
    from jaxvo.utils.measure import device_line, median, query_cards, timed

    enable_compile_cache()
    dev = device_line(jax, query_cards())
    platform = dev["platform"]
    cpu_asked = os.environ.get("JAX_PLATFORMS") == "cpu"
    if platform != "gpu" and not cpu_asked:
        print(json.dumps({"error": f"no GPU found (platform {platform}); "
                          "set JAX_PLATFORMS=cpu to ask for a CPU run",
                          "device": dev}))
        sys.exit(2)

    from jaxvo import profiles
    from jaxvo.data import load_sequence
    from jaxvo.engine import vo
    from jaxvo.engine.eval import evaluate, metrics_dict

    # the fused GN kernel compiles only for the GPU; a CPU run, which must
    # be asked for, takes the XLA solver
    picp = "xla" if cpu_asked else "pallas"
    cfg = profiles.throughput_config(picp_backend=picp)
    cfg_lat = profiles.latency_config(picp_backend=picp)
    data_dir = os.environ.get("JAXVO_DATA", "")
    if data_dir and os.path.isdir(data_dir):
        seq = load_sequence(data_dir, cfg.n_frames)
        data = f"dataset {data_dir}"
    else:
        seq = profiles.control_sequence(cfg.n_frames)
        data = "synthetic control sequence (seed 0)"

    F = seq.uv.shape[0]
    key = jax.random.PRNGKey(42)
    f0 = vo.frame_of(seq, 0)
    f1 = vo.frame_of(seq, 1)
    frames_curr = vo.frames_of(seq, 0, F - 1)
    frames_next = vo.frames_of(seq, 1, F)

    # ---- accuracy gate (the bench is invalid if parity breaks) -----------
    # HARD gate: if the tracked trajectory leaves the reference's error
    # envelope (mean 0.210 / max 0.371 from output/errors.txt; gate at
    # ate<=0.25, mean<=0.30), vs_baseline is zeroed so a fast-but-wrong
    # operating point can never post a headline.
    state0, _ = vo.bootstrap_jit(key, f0, f1, cfg)
    state, logs = vo.make_tracker(cfg)(state0, frames_curr, frames_next)
    poses = jnp.concatenate([jnp.eye(4, dtype=jnp.float32)[None], logs.pose], 0)
    res = evaluate(np.asarray(poses), seq.gt_pose, cfg)
    acc = metrics_dict(res)
    accuracy_ok = acc["ate_rmse"] <= 0.25 and acc["trans_err_mean"] <= 0.30

    # per-frame row-wise deviation vs the reference's shipped scaled
    # trajectory (icp_test.cpp:147-210 output), when the dataset ships it:
    # a drift localized in a few frames can hide under the aggregate ATE,
    # the per-frame max cannot.  Thresholds = 2x the measured fixed-mode
    # envelope (dev mean 0.058 / max 0.137).
    golden = {"golden_gate": "skipped: no reference trajectory"}
    ref_traj = os.path.join(os.path.dirname(data_dir or "."), "output",
                            "estimated_trajectory_scaled.txt")
    if data_dir and os.path.exists(ref_traj):
        ref = np.loadtxt(ref_traj)
        est_t = res.poses_world[:, :3, 3] * res.scale
        if len(ref) == len(est_t):
            dev_t = np.linalg.norm(est_t[:, :2] - ref[:, 1:3], axis=1)
            golden = {"golden_dev_mean": float(dev_t.mean()),
                      "golden_dev_max": float(dev_t.max())}
            accuracy_ok &= dev_t.mean() <= 0.12 and dev_t.max() <= 0.30
        else:
            golden = {"golden_gate": f"skipped: len {len(est_t)} vs ref {len(ref)}"}
    accuracy_ok = bool(accuracy_ok)

    # ---- latency mode: one fused bootstrap+scan program per rep ---------
    args = (key, f0, f1, frames_curr, frames_next)
    t0 = time.perf_counter()
    lat_prog = vo.full_run_jit.lower(*args, cfg=cfg_lat).compile()
    lat_compile_s = time.perf_counter() - t0
    lg_lat = lat_prog(*args)[1]
    poses_lat = jnp.concatenate(
        [jnp.eye(4, dtype=jnp.float32)[None], lg_lat.pose], 0)
    acc_lat = metrics_dict(evaluate(np.asarray(poses_lat), seq.gt_pose, cfg_lat))
    latency_accuracy_ok = (
        acc_lat["ate_rmse"] <= 0.25 and acc_lat["trans_err_mean"] <= 0.30)
    lat_reps = int(os.environ.get("JAXVO_BENCH_LAT_REPS", "21"))
    lat_times = timed(lambda: lat_prog(*args)[1].pose, lat_reps)
    lat_fps_all = sorted((F - 1) / t for t in lat_times)
    fps_latency = lat_fps_all[len(lat_fps_all) // 2]  # median

    # ---- throughput mode: vmapped batch of DISTINCT sequences ------------
    B = int(os.environ.get("JAXVO_BENCH_BATCH", "256"))

    bargs = profiles.batched_inputs(seq, B)
    batched_prog = jax.jit(profiles.batched_tracker(cfg)).lower(*bargs).compile()
    jax.block_until_ready(batched_prog(*bargs))
    reps = 5
    thr_s = median(timed(lambda: batched_prog(*bargs), reps))
    fps_throughput = B * (F - 1) / thr_s

    # ---- SLAM mode, gated ------------------------------------------------
    # 200-frame KITTI-scale loop circuit: tracking with interleaved local
    # BA (engine/slam.py), then the loop-closure + global-BA refinement.
    # If ATE leaves the envelope the SLAM numbers are zeroed.
    run_slam = os.environ.get("JAXVO_BENCH_SLAM",
                              "1" if platform == "gpu" else "0") == "1"
    if run_slam:
        s = profiles.slam_run(
            n_frames=int(os.environ.get("JAXVO_BENCH_SLAM_FRAMES", "200")),
            map_capacity=int(os.environ.get("JAXVO_BENCH_SLAM_CAP", "8192")))
        slam = {
            "slam_fps": s["fps"] if s["ok"] else 0.0,
            "ate_slam": s["ate_slam"],
            "ate_refined": s["ate_refined"],
            "slam_gate_ok": s["ok"],
            "slam_frames": s["frames"],
            "slam_refine_first_call_s": s["refine_first_call_s"],
        }
    else:
        slam = {"slam": "skipped: CPU run (JAXVO_BENCH_SLAM=1 runs it)"}

    fps = max(fps_latency, fps_throughput)
    # the headline is gated by the accuracy of WHICHEVER mode supplies it
    headline_ok = accuracy_ok and (
        fps_throughput >= fps_latency or latency_accuracy_ok)
    out = {
        "metric": "vo_frames_per_second",
        "value": fps,
        "unit": "frames/s",
        "platform": platform,
        "vs_baseline": fps / CPP_BASELINE_FPS if headline_ok else 0.0,
        "extra": {
            "device": {k: dev[k] for k in ("platform", "kind", "count", "cards")},
            "data": data,
            "accuracy_gate_ok": accuracy_ok,
            "fps_latency_1seq": fps_latency,
            "latency_vs_baseline": (
                fps_latency / CPP_BASELINE_FPS if latency_accuracy_ok else 0.0),
            "latency_fps_min": lat_fps_all[0],
            "latency_fps_max": lat_fps_all[-1],
            "latency_reps": lat_reps,
            "latency_compile_s": lat_compile_s,
            "latency_accuracy_ok": latency_accuracy_ok,
            "latency_ate_rmse": acc_lat["ate_rmse"],
            "fps_throughput_batch": fps_throughput,
            "batch": B,
            "ate_rmse": acc["ate_rmse"],
            "trans_err_mean": acc["trans_err_mean"],
            "ate_robot": acc["ate_robot"],
            **golden,
            **slam,
            "map_count": int(state.map_count),
            "cpp_baseline_fps": CPP_BASELINE_FPS,
        },
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
