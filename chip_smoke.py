"""End-to-end smoke check of jaxvo on an NVIDIA GPU.

    python chip_smoke.py          # phases 0-5 on one GPU
    python chip_smoke.py --four   # the sharded BA, PGO and matcher on four
                                  # GPUs, each against one device

Each phase prints one JSON line.  The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``
when every phase passed its gate; any failure prints ``"ok": false`` last
and exits non-zero.  The script never carries on without a GPU.

Phases (one GPU):
  0  device: platform, device kind, count, card name and power limit
     (nvidia-smi in a child process), JAX version, XLA_FLAGS, compile
     cache, matmul precision;
  1  kernel parity: every hand-written kernel compiled for the card
     against its plain reference at real widths;
  2  control VO: the 121-frame control sequence through the fused
     single-stream program, plus 20 frames through OnlineVO checked pose
     for pose; gate ate_rmse <= 0.25 and trans_err_mean <= 0.30;
  3  batched streams: 256 distinct streams, vmapped; gated on the
     unbatched sequence's accuracy;
  4  SLAM + loop refine on the 200-frame loop circuit (20,000 landmarks,
     8,192 map slots); gate ate_slam <= 1.0, ate_refined <= 0.2;
  5  the tests marked ``gpu``, run in this process (one process per card).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

from jaxvo import profiles
from jaxvo.utils.measure import (device_line, median, memory, query_cards,
                                 timed)

ROOT = os.path.dirname(os.path.abspath(__file__))


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


# ---------------------------------------------------------------------------
# phase 0: the device (device_line, from jaxvo.utils.measure)
# ---------------------------------------------------------------------------
def result_line(ok: bool, dev: dict | None) -> dict:
    device = None
    if dev is not None:
        device = {"platform": dev["platform"], "kind": dev["kind"],
                  "count": dev["count"]}
    return {"ok": ok, "device": device}


# ---------------------------------------------------------------------------
# phase 1: kernels against their plain references
# ---------------------------------------------------------------------------
def phase_kernels(batches=(1, 256), tracker_frames: int = 40,
                  interpret: bool = False, reps: int = 21) -> dict:
    """The fused PICP kernel against ``picp.solve``: per-solve parity at
    each batch size, iteration parity under the production stopping rule,
    and the first ``tracker_frames`` frames of the tracker."""
    import jax
    import jax.numpy as jnp

    from jaxvo.config import EngineConfig, PICPConfig
    from jaxvo.engine import vo
    from jaxvo.ops import picp
    from jaxvo.ops.pallas.picp_kernel import solve_pallas

    cfg = EngineConfig()
    K = cfg.K()
    pcfg = PICPConfig(convergence_threshold=1e-4)
    out = {"phase": "kernels", "kernel": "picp_gn_loop", "checks": []}
    ok = True
    for B in batches:
        T0, X, Z, V = (jnp.asarray(a) for a in profiles.picp_problems(B, seed=B))

        def ref_fn(T0, X, Z, V):
            return jax.vmap(lambda t, x, z, v: picp.solve(
                jnp.asarray(K), t, x, z, None, v, cfg.width, cfg.height,
                pcfg))(T0, X, Z, V)

        def ker_fn(T0, X, Z, V):
            return jax.vmap(lambda t, x, z, v: solve_pallas(
                K, t, x, z, None, v, cfg.width, cfg.height, pcfg,
                interpret=interpret))(T0, X, Z, V)

        args = (T0, X, Z, V)
        ref_c = jax.jit(ref_fn).lower(*args).compile()
        ker_c = jax.jit(ker_fn).lower(*args).compile()
        ref, got = ref_c(*args), ker_c(*args)
        d_pose = float(jnp.max(jnp.abs(got.T - ref.T)))
        inl_eq = bool(jnp.all(got.num_inliers == ref.num_inliers))
        chi_rel = float(jnp.max(jnp.abs(got.chi_inliers - ref.chi_inliers)
                                / jnp.maximum(jnp.abs(ref.chi_inliers), 1e-6)))
        d_it = int(jnp.max(jnp.abs(got.iterations - ref.iterations)))
        check = {
            "batch": B, "n_obs": int(X.shape[1]),
            "max_pose_diff": d_pose, "inliers_equal": inl_eq,
            "max_chi_rel": chi_rel, "max_iteration_diff": d_it,
            "ok": inl_eq and d_pose <= 5e-3 and chi_rel <= 5e-2 and d_it <= 1,
            "kernel_memory": memory(ker_c), "xla_memory": memory(ref_c),
        }
        if not interpret:
            check["kernel_s"] = median(timed(lambda: ker_c(*args), reps))
            check["xla_s"] = median(timed(lambda: ref_c(*args), reps))
        ok &= check["ok"]
        out["checks"].append(check)

    # in the tracker: identical match decisions, poses within 1e-3 (the
    # tracker compiles the kernel for the card, so not in interpret mode)
    if not interpret:
        seq = profiles.control_sequence(tracker_frames)
        runs = {}
        for backend in ("xla", "pallas"):
            _, logs, poses, _ = vo.run_sequence(
                seq, profiles.throughput_config(tracker_frames, backend))
            runs[backend] = (np.asarray(logs.n_map_matches), np.asarray(poses))
        same = bool(np.array_equal(runs["xla"][0], runs["pallas"][0]))
        d = float(np.max(np.abs(runs["xla"][1] - runs["pallas"][1])))
        tr = {"frames": tracker_frames, "n_map_matches_equal": same,
              "max_pose_diff": d, "ok": same and d <= 1e-3}
        ok &= tr["ok"]
        out["tracker"] = tr
    out["ok"] = bool(ok)
    return out


# ---------------------------------------------------------------------------
# phase 2: the control sequence, single stream
# ---------------------------------------------------------------------------
def phase_control_vo(n_frames: int = 121, reps: int = 21,
                     online_frames: int = 20, cfg=None) -> dict:
    import jax

    from jaxvo.engine import vo
    from jaxvo.engine.eval import evaluate, metrics_dict

    seq = profiles.control_sequence(n_frames)
    cfg = cfg or profiles.latency_config(n_frames)
    F = seq.uv.shape[0]
    key = jax.random.PRNGKey(42)
    args = (key, vo.frame_of(seq, 0), vo.frame_of(seq, 1),
            vo.frames_of(seq, 0, F - 1), vo.frames_of(seq, 1, F))

    t0 = time.perf_counter()
    compiled = vo.full_run_jit.lower(*args, cfg=cfg).compile()
    compile_s = time.perf_counter() - t0
    _, logs = compiled(*args)
    poses = np.concatenate([np.eye(4, dtype=np.float32)[None],
                            np.asarray(logs.pose)], 0)
    acc = metrics_dict(evaluate(poses, seq.gt_pose, cfg))
    times = timed(lambda: compiled(*args)[1].pose, reps)

    # the serving interface, frame by frame, against the batch run
    sess = vo.OnlineVO(cfg, seed=42)
    sess.start(vo.frame_of(seq, 0), vo.frame_of(seq, 1))
    online = [np.eye(4, dtype=np.float32)]
    for i in range(1, online_frames):
        online.append(np.asarray(sess.step(vo.frame_of(seq, i))))
    d_online = float(np.max(np.abs(np.stack(online) - poses[:online_frames])))

    gate = acc["ate_rmse"] <= 0.25 and acc["trans_err_mean"] <= 0.30
    return {
        "phase": "control_vo", "frames": F,
        "picp": dataclasses.asdict(cfg.picp), "scan_unroll": cfg.scan_unroll,
        "compile_s": compile_s, "median_s": median(times),
        "min_s": min(times), "max_s": max(times), "reps": reps,
        "fps": (F - 1) / median(times),
        "ate_rmse": acc["ate_rmse"], "trans_err_mean": acc["trans_err_mean"],
        "online_frames": online_frames, "online_max_pose_diff": d_online,
        "memory": memory(compiled),
        "ok": bool(gate and d_online <= 1e-3),
    }


# ---------------------------------------------------------------------------
# phase 3: many distinct streams, vmapped
# ---------------------------------------------------------------------------
def phase_batched(n_frames: int = 121, batch: int = 256, reps: int = 5,
                  cfg=None) -> dict:
    import jax
    import jax.numpy as jnp

    from jaxvo.engine import vo
    from jaxvo.engine.eval import evaluate, metrics_dict

    seq = profiles.control_sequence(n_frames)
    cfg = cfg or profiles.throughput_config(n_frames)
    F = seq.uv.shape[0]

    # the accuracy gate: the unbatched sequence under the same config
    _, _, poses, _ = vo.run_sequence(seq, cfg)
    acc = metrics_dict(evaluate(np.asarray(poses), seq.gt_pose, cfg))

    args = profiles.batched_inputs(seq, batch)
    t0 = time.perf_counter()
    compiled = jax.jit(profiles.batched_tracker(cfg)).lower(*args).compile()
    compile_s = time.perf_counter() - t0
    out = compiled(*args)
    finite = bool(jnp.all(jnp.isfinite(out)))
    times = timed(lambda: compiled(*args), reps)
    gate = acc["ate_rmse"] <= 0.25 and acc["trans_err_mean"] <= 0.30
    return {
        "phase": "batched", "batch": batch, "frames": F,
        "picp": dataclasses.asdict(cfg.picp),
        "compile_s": compile_s, "median_s": median(times), "reps": reps,
        "fps": batch * (F - 1) / median(times),
        "shape": list(out.shape), "finite": finite,
        "ate_rmse": acc["ate_rmse"], "trans_err_mean": acc["trans_err_mean"],
        "memory": memory(compiled),
        "ok": bool(gate and finite
                   and out.shape == (batch, F - 1, 4, 4)),
    }


# ---------------------------------------------------------------------------
# phase 4: SLAM with local BA, then loop refinement
# ---------------------------------------------------------------------------
def phase_slam(n_frames: int = 200, n_landmarks: int = 20000,
               map_capacity: int = 8192, reps: int = 3) -> dict:
    return {"phase": "slam", **profiles.slam_run(n_frames, n_landmarks,
                                                 map_capacity, reps)}


# ---------------------------------------------------------------------------
# phase 5: the GPU-marked tests, in this process
# ---------------------------------------------------------------------------
def phase_gpu_tests() -> dict:
    import pytest

    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(ROOT, "tests")])
    return {"phase": "gpu_tests", "pytest_rc": int(rc), "ok": int(rc) == 0}


# ---------------------------------------------------------------------------
# --four: the sharded paths against one device
# ---------------------------------------------------------------------------
def distinct_devices(mesh) -> int:
    return len({d.id for d in np.asarray(mesh.devices).flat})


def phase_sharded_ba(n_devices: int, L: int = 100_000, obs: int = 8192,
                     W: int = 10, iterations: int = 8) -> dict:
    import jax.numpy as jnp

    sys.path.insert(0, os.path.join(ROOT, "benchmarks"))
    from ba_scaling import build_problem

    from jaxvo.ba.window import ba_solve
    from jaxvo.config import BAConfig
    from jaxvo.parallel import local_mesh, shard_ba_problem, sharded_ba_solve
    from jaxvo.parallel.ba_sharded import gather_points

    cfg, prob = build_problem(W, L, obs)
    K = jnp.asarray(cfg.K())
    # fixed damping on both sides: the sharded driver does identical work
    # every iteration by design
    ba_cfg = BAConfig(window=W, iterations=iterations, damping=1e-3,
                      lm_adaptive=False, max_landmarks=L)
    ref, _ = ba_solve(prob, K, cfg.width, cfg.height, ba_cfg)
    mesh = local_mesh(n_devices, axis="lm")
    sp = shard_ba_problem(prob, n_devices)
    got, _ = sharded_ba_solve(mesh, sp, K, cfg.width, cfg.height, ba_cfg)
    pts = gather_points(got, L)
    seen = np.zeros(L, bool)
    seen[np.unique(np.asarray(prob.obs_lm)[np.asarray(prob.obs_valid)])] = True
    d_pose = float(np.max(np.abs(np.asarray(got.poses) - np.asarray(ref.poses))))
    d_pts = float(np.max(np.abs(pts[seen] - np.asarray(ref.points)[seen])))
    placed = len({s.device.id for s in got.points.addressable_shards})
    return {
        "phase": "sharded_ba", "landmarks": L,
        "observations": int(np.asarray(prob.obs_valid).sum()),
        "mesh_devices": distinct_devices(mesh), "shard_devices": placed,
        "max_pose_diff": d_pose, "max_point_diff": d_pts,
        "ok": bool(d_pose <= 5e-4 and d_pts <= 5e-3
                   and placed == n_devices
                   and distinct_devices(mesh) == n_devices),
    }


def pgo_problem(F: int = 512, n_loops: int = 500, seed: int = 3):
    """Circle of F poses: odometry chain + ``n_loops`` loop edges measured
    from ground truth with noise; the initial poses carry accumulated
    drift."""
    import jax
    import jax.numpy as jnp

    from jaxvo.ba.posegraph import PoseGraph
    from jaxvo.ops import lie

    rng = np.random.default_rng(seed)
    theta = np.linspace(0, 2 * np.pi, F, endpoint=False)
    gt = np.tile(np.eye(4, dtype=np.float32), (F, 1, 1))
    gt[:, 0, 3] = 30.0 * np.cos(theta)
    gt[:, 1, 3] = 30.0 * np.sin(theta)
    c, s = np.cos(theta + np.pi / 2), np.sin(theta + np.pi / 2)
    gt[:, 0, 0], gt[:, 0, 1], gt[:, 1, 0], gt[:, 1, 1] = c, -s, s, c
    gtj = jnp.asarray(gt)
    ii = np.arange(F - 1)
    li = rng.integers(0, F - 40, n_loops)
    lj = li + rng.integers(20, 40, n_loops)
    eij = np.concatenate([np.stack([ii, ii + 1], 1), np.stack([li, lj], 1)])
    eij = jnp.asarray(eij.astype(np.int32))
    eT = jax.vmap(lambda i, j: lie.inv_se3(gtj[i]) @ gtj[j])(eij[:, 0], eij[:, 1])
    # measured edges: 1 cm of translation noise, so the optimum has chi > 0
    eT = eT.at[:, :3, 3].add(
        jnp.asarray(rng.normal(0, 0.01, (eT.shape[0], 3)), jnp.float32))
    # drifted initial guess: compose noisy odometry from the first pose
    drift = np.cumsum(rng.normal(0, 0.02, (F, 3)), 0).astype(np.float32)
    init = gt.copy()
    init[:, :3, 3] += drift
    ew = jnp.concatenate([jnp.ones(F - 1), jnp.full(n_loops, 10.0)]).astype(jnp.float32)
    return PoseGraph(jnp.asarray(init), eij, eT, ew,
                     jnp.zeros(F, bool).at[0].set(True))


def phase_sharded_pgo(n_devices: int, F: int = 512, n_loops: int = 500,
                      iterations: int = 15) -> dict:
    from jaxvo.ba import posegraph as pg
    from jaxvo.parallel import local_mesh, sharded_pgo_solve

    graph = pgo_problem(F, n_loops)
    ref, s_ref = pg.pgo_solve(graph, iterations=iterations)
    mesh = local_mesh(n_devices, axis="edge")
    got, s_got = sharded_pgo_solve(mesh, graph, iterations=iterations,
                                   axis="edge")
    d = float(np.max(np.abs(np.asarray(got.poses) - np.asarray(ref.poses))))
    d_chi = abs(float(s_got.chi) - float(s_ref.chi))
    return {
        "phase": "sharded_pgo", "poses": F,
        "edges": int(graph.edges_ij.shape[0]),
        "mesh_devices": distinct_devices(mesh),
        "max_pose_diff": d, "chi_ref": float(s_ref.chi), "chi_diff": d_chi,
        # the optimum is flat along weakly observed directions: two
        # reduction orders stop within 1e-4 of the 60 m circle's extent
        # at equal chi
        "ok": bool(d <= 6e-3 and d_chi <= 1e-3 * abs(float(s_ref.chi)) + 1e-5
                   and distinct_devices(mesh) == n_devices),
    }


def phase_sharded_match(n_devices: int, M: int = 131_072, N: int = 128,
                        methods=("direct", "mxu")) -> dict:
    import jax.numpy as jnp

    from jaxvo.ops.match import match_descriptors
    from jaxvo.parallel import local_mesh, sharded_match_descriptors

    rng = np.random.default_rng(11)
    d1 = rng.uniform(-1, 1, (N, 10)).astype(np.float32)
    d2 = rng.uniform(-1, 1, (M, 10)).astype(np.float32)
    hits = rng.choice(M, N // 2, replace=False)
    d2[hits] = d1[: N // 2] + rng.normal(0, 0.01, (N // 2, 10))
    v2 = rng.uniform(size=M) > 0.01
    mesh = local_mesh(n_devices, axis="lm")
    out = {"phase": "sharded_match", "queries": N, "map": M,
           "mesh_devices": distinct_devices(mesh), "methods": {}}
    ok = distinct_devices(mesh) == n_devices
    for method in methods:
        args = (jnp.asarray(d1), jnp.ones(N, bool), jnp.asarray(d2),
                jnp.asarray(v2))
        ref = match_descriptors(*args, method=method)
        got = sharded_match_descriptors(mesh, *args, method=method)
        m = np.asarray(ref.valid)
        same = (np.array_equal(m, np.asarray(got.valid))
                and np.array_equal(np.asarray(ref.idx)[m],
                                   np.asarray(got.idx)[m]))
        d_best = float(np.max(np.abs(np.asarray(ref.best)
                                     - np.asarray(got.best))))
        out["methods"][method] = {"accepted": int(m.sum()),
                                  "decisions_equal": bool(same),
                                  "max_best_diff": d_best}
        ok &= same and d_best <= 1e-4
    out["ok"] = bool(ok)
    return out


# ---------------------------------------------------------------------------
def run(four: bool) -> int:
    cards = query_cards()
    import jax

    from jaxvo.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    dev = device_line(jax, cards)
    emit(dev)
    print(cards, flush=True)
    if dev["platform"] != "gpu":
        emit(result_line(False, dev))
        return 2
    if four:
        n = 4
        if dev["count"] < n:
            emit({"phase": "sharded", "error": f"{dev['count']} devices"})
            emit(result_line(False, dev))
            return 1
        phases = [lambda: phase_sharded_ba(n), lambda: phase_sharded_pgo(n),
                  lambda: phase_sharded_match(n)]
    else:
        phases = [phase_kernels, phase_control_vo, phase_batched, phase_slam,
                  phase_gpu_tests]
    ok = True
    for phase in phases:
        t0 = time.perf_counter()
        try:
            res = phase()
        except Exception as e:  # report the failed phase, then fail the run
            import traceback

            traceback.print_exc()
            res = {"phase": getattr(phase, "__name__", "phase"),
                   "error": f"{type(e).__name__}: {e}"[:2000], "ok": False}
        res["wall_s"] = time.perf_counter() - t0
        emit(res)
        ok &= bool(res.get("ok"))
    emit(result_line(ok, dev))
    return 0 if ok else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four", action="store_true",
                   help="run the sharded BA, PGO and matcher on four GPUs, "
                        "each against its single-device result, and nothing "
                        "else")
    args = p.parse_args(argv)
    return run(args.four)


if __name__ == "__main__":
    sys.exit(main())
