"""The operating points that ``bench.py`` and ``chip_smoke.py`` run.

One place for the configurations and the seeded sequences, so the
benchmark and the on-device smoke check measure the same thing:

  * ``control_sequence``   — 121 frames of the bundled dataset's shape
    (<= 128 observations, 10-dim descriptors, 1,000 landmarks, planar
    trajectory, exact measurements), generated from a seed;
  * ``throughput_config``  — the batched-streams tracker;
  * ``latency_config``     — the single-stream tracker (one fused
    bootstrap + scan program);
  * ``batched_inputs`` / ``batched_tracker`` — many distinct streams,
    vmapped;
  * ``loop_circuit`` / ``slam_config`` / ``slam_run`` — the 200-frame
    KITTI-scale loop circuit with local BA inside the scan, then loop
    refinement;
  * ``picp_problems`` — standalone PICP solves for kernel parity.

Frames per second count the tracked frames: a sequence of F frames
tracks F - 1 of them (frame 0 is the origin).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from jaxvo.config import (BAConfig, EngineConfig, MatcherConfig, PICPConfig,
                          RansacConfig)


def control_sequence(n_frames: int = 121, seed: int = 0):
    """Like the bundled data: its measurements reproduce from world.dat to
    ~0.002 px (no pixel noise), and the camera stays inside the landmark
    field (0.06 rad/frame turns keep a 0.2 m/frame path within 3.5 m of
    the start, so every frame sees 128 landmarks).  A path that leaves
    the 20 x 20 m field, or 0.1 px noise, drifts to ATE > 2 on any
    backend."""
    from jaxvo.data import synthetic

    cfg = EngineConfig(n_frames=n_frames)
    world = synthetic.make_world(seed, n_landmarks=1000)
    gt = synthetic.make_planar_trajectory(n_frames, turn=0.06, seed=seed)
    return synthetic.render_sequence(world, gt, cfg, pixel_noise=0.0)


def throughput_config(n_frames: int = 121,
                      picp_backend: str = "pallas") -> EngineConfig:
    """``picp_backend="pallas"`` is the fused GN kernel, which compiles
    only for a GPU; CPU runs pass "xla"."""
    # "fixed" mode: landmark parallax gating keeps the tracker robust
    # through the sparse section (parity mode reproduces the reference's
    # fragile unfiltered map).  rel-chi 1e-4: fewer GN rounds than 1e-5,
    # no accuracy cost.
    return EngineConfig(
        mode="fixed",
        n_frames=n_frames,
        matcher=MatcherConfig(method="mxu_bf16"),
        picp=PICPConfig(convergence_threshold=1e-4, backend=picp_backend),
        triangulation_refine_iters=2,
    )


def latency_config(n_frames: int = 121, picp_backend: str = "pallas",
                   scan_unroll: int = 8) -> EngineConfig:
    return dataclasses.replace(
        throughput_config(n_frames, picp_backend),
        scan_unroll=scan_unroll,
        log_stats=False,           # poses only: XLA drops the diagnostics
        fuse_frame_matchers=True,  # one distance matmul for both matches
        ransac=RansacConfig(num_hypotheses=256),
        max_new_landmarks_per_frame=24,  # dataset peak is 21 per frame
    )


def loop_circuit(n_frames: int = 200, n_landmarks: int = 20000,
                 cfg: EngineConfig | None = None):
    """The 200-frame / 199 m KITTI-scale loop circuit (seed 7)."""
    from jaxvo.data import synthetic

    gt = synthetic.make_loop_trajectory(n_frames, step=1.0, seed=7)
    extent = float(np.abs(gt[:, :2]).max()) + 15.0
    world = synthetic.make_world(7, n_landmarks=n_landmarks,
                                 xy_extent=extent, z_range=(0.0, 8.0))
    return synthetic.render_sequence(world, gt, cfg, pixel_noise=0.3, seed=7)


def slam_config(n_frames: int = 200, map_capacity: int = 8192,
                picp_backend: str = "xla") -> EngineConfig:
    return EngineConfig(
        mode="fixed", n_frames=n_frames, map_capacity=map_capacity,
        fuse_frame_matchers=True,
        matcher=MatcherConfig(method="mxu"),
        picp=PICPConfig(convergence_threshold=1e-4, backend=picp_backend),
        ba=dataclasses.replace(EngineConfig().ba, max_landmarks=map_capacity),
    )


def refine_config(n_frames: int, map_capacity: int) -> BAConfig:
    return BAConfig(window=n_frames, iterations=15, huber_threshold=500.0,
                    max_landmarks=map_capacity)


def slam_run(n_frames: int = 200, n_landmarks: int = 20000,
             map_capacity: int = 8192, reps: int = 3,
             picp_backend: str = "xla") -> dict:
    """SLAM on the loop circuit, then ``refine_trajectory_loop`` (3
    sweeps): first-call and median wall, tracked frames/s, and both ATEs
    against their gates (ate_slam <= 1.0, ate_refined <= 0.2)."""
    import jax
    import jax.numpy as jnp

    from jaxvo.engine.ba_refine import refine_trajectory_loop
    from jaxvo.engine.eval import evaluate, metrics_dict
    from jaxvo.engine.slam import run_sequence_slam
    from jaxvo.utils.measure import median, timed

    cfg = slam_config(n_frames, map_capacity, picp_backend)
    seq = jax.tree.map(jnp.asarray, loop_circuit(n_frames, n_landmarks, cfg))
    t0 = time.perf_counter()
    state, _, poses, diag = run_sequence_slam(seq, cfg, seed=7)
    jax.block_until_ready(poses)
    first_s = time.perf_counter() - t0
    times = timed(lambda: run_sequence_slam(seq, cfg, seed=7)[2], reps)
    m_slam = metrics_dict(evaluate(np.asarray(poses), seq.gt_pose, cfg))

    gcfg = refine_config(n_frames, map_capacity)
    t0 = time.perf_counter()
    poses_ref, _, _ = refine_trajectory_loop(state, seq, poses, cfg, gcfg,
                                             n_sweeps=3)
    refine_s = time.perf_counter() - t0
    m_ref = metrics_dict(evaluate(np.asarray(poses_ref), seq.gt_pose, cfg))
    return {
        "frames": n_frames, "landmarks": n_landmarks,
        "map_capacity": map_capacity, "picp_backend": picp_backend,
        "n_local_ba_runs": int(diag["n_local_ba_runs"]),
        "first_call_s": first_s, "median_s": median(times), "reps": reps,
        "fps": (n_frames - 1) / median(times),
        "refine_first_call_s": refine_s,
        "ate_slam": m_slam["ate_rmse"], "ate_refined": m_ref["ate_rmse"],
        "ok": bool(m_slam["ate_rmse"] <= 1.0 and m_ref["ate_rmse"] <= 0.2),
    }


def batched_inputs(seq, batch: int):
    """``batch`` distinct streams: each lane gets its own pixel noise
    (0.25 px) and PRNG key, so its matches, inlier sets and GN iteration
    counts differ from every other lane's."""
    import jax
    import jax.numpy as jnp

    from jaxvo.engine import vo

    F = seq.uv.shape[0]
    tile = lambda x: jnp.broadcast_to(x[None], (batch,) + x.shape)
    t = jax.tree.map(tile, vo.frames_of(seq, 0, F))
    noise = 0.25 * jax.random.normal(jax.random.PRNGKey(1000), t.uv.shape,
                                     t.uv.dtype)
    # frame i is frames_next[i-1] AND frames_curr[i]: perturb once
    ball = t._replace(uv=t.uv + noise * t.valid[..., None])
    sl = lambda lo, hi: jax.tree.map(lambda x: x[:, lo:hi], ball)
    return (jax.random.split(jax.random.PRNGKey(42), batch),
            jax.tree.map(lambda x: x[:, 0], ball),
            jax.tree.map(lambda x: x[:, 1], ball),
            sl(0, F - 1), sl(1, F))


def batched_tracker(cfg: EngineConfig):
    """Bootstrap + scan tracker vmapped over the lanes of
    ``batched_inputs``; returns the tracked poses (B, F-1, 4, 4)."""
    import jax

    from jaxvo.engine import vo

    def run(k, bf0, bf1, bc, bn):
        s, _ = jax.vmap(lambda kk, a, b: vo.bootstrap(kk, a, b, cfg))(k, bf0, bf1)
        s, lg = jax.vmap(lambda st, c, n: vo.scan_tracker(st, c, n, cfg))(s, bc, bn)
        return lg.pose

    return run


def picp_problems(batch: int, n: int = 128, seed: int = 0):
    """``batch`` distinct PICP problems of ``n`` observations each: world
    points seen from a perturbed pose, 0.5 px noise, initial pose 0.05
    off.  Returns (T0, X, Z, V) stacked on a leading batch axis."""
    from jaxvo.data import synthetic
    from jaxvo.ops import lie

    cfg = EngineConfig()
    K = cfg.K()
    rng = np.random.default_rng(seed)
    T0s, Xs, Zs, Vs = [], [], [], []
    for b in range(batch):
        world = synthetic.make_world(seed + b, n_landmarks=1500, xy_extent=6.0)
        gt = np.array([0.4, 0.1, 0.1], np.float32) + rng.normal(0, 0.05, 3)
        T_cw = np.linalg.inv(synthetic.camera_pose_from_gt(gt, cfg))
        p = world.xyz @ T_cw[:3, :3].T + T_cw[:3, 3]
        with np.errstate(divide="ignore", invalid="ignore"):
            uv = (p @ K.T)[:, :2] / p[:, 2:3]
        ok = ((p[:, 2] > 0.1) & (uv[:, 0] >= 0) & (uv[:, 0] <= cfg.width - 1)
              & (uv[:, 1] >= 0) & (uv[:, 1] <= cfg.height - 1))
        sel = np.nonzero(ok)[0][:n]
        X = np.zeros((n, 3), np.float32)
        Z = np.zeros((n, 2), np.float32)
        V = np.zeros(n, bool)
        X[: len(sel)] = world.xyz[sel]
        Z[: len(sel)] = uv[sel] + 0.5 * rng.standard_normal((len(sel), 2))
        V[: len(sel)] = True
        dv = (0.05 * rng.standard_normal(6)).astype(np.float32)
        T0 = np.asarray(lie.v2t_euler(dv)) @ T_cw
        T0s.append(T0.astype(np.float32)); Xs.append(X); Zs.append(Z); Vs.append(V)
    return tuple(np.stack(a) for a in (T0s, Xs, Zs, Vs))
