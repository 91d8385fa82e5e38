"""Distributed-BA scaling benchmark (BASELINE.json configs 3 & 5).

Measures BA iterations/s for the windowed Schur solver:
  * single device, window=10, bundled-map scale (512 landmarks)
  * sharded across N devices at 100k synthetic landmarks, reporting
    scaling efficiency vs N=1

A CPU-process proxy: its numbers are CPU numbers, labelled so, and say
nothing about the GPU (chip_smoke.py --four checks the sharded solve on
four GPUs).

Virtual 8-device CPU:   XLA_FLAGS=--xla_force_host_platform_device_count=8 \
                        JAX_PLATFORMS=cpu python benchmarks/ba_scaling.py
Results are appended to benchmarks/results.jsonl (not tracked).
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_problem(W: int, L: int, obs_per_frame: int, seed: int = 0):
    import jax.numpy as jnp

    from jaxvo.ba.window import BAProblem
    from jaxvo.config import EngineConfig
    from jaxvo.data import synthetic

    cfg = EngineConfig()
    rng = np.random.default_rng(seed)
    world = synthetic.make_world(seed, n_landmarks=L, xy_extent=50.0, z_range=(0.0, 10.0))
    gt = synthetic.make_planar_trajectory(W, step=1.0, turn=0.03, seed=seed)

    poses = np.stack(
        [np.linalg.inv(synthetic.camera_pose_from_gt(g, cfg)) for g in gt]
    ).astype(np.float32)

    # synthetic observation set: each frame observes obs_per_frame random
    # landmarks (projected exactly, then perturbed)
    obs_uv = np.zeros((W, obs_per_frame, 2), np.float32)
    obs_lm = np.zeros((W, obs_per_frame), np.int32)
    obs_valid = np.zeros((W, obs_per_frame), bool)
    K = cfg.K()
    for f in range(W):
        lm = rng.choice(L, obs_per_frame, replace=False)
        p_cam = world.xyz[lm] @ poses[f][:3, :3].T + poses[f][:3, 3]
        ok = p_cam[:, 2] > 0.1
        ph = p_cam @ K.T
        with np.errstate(divide="ignore", invalid="ignore"):
            uv = ph[:, :2] / ph[:, 2:3]
        ok &= np.isfinite(uv).all(1)
        obs_uv[f] = np.nan_to_num(uv) + 0.3 * rng.standard_normal((obs_per_frame, 2))
        obs_lm[f] = lm
        obs_valid[f] = ok
    fixed = np.zeros(W, bool)
    fixed[:2] = True
    return cfg, BAProblem(
        poses=jnp.asarray(poses),
        points=jnp.asarray(world.xyz + 0.05 * rng.standard_normal(world.xyz.shape).astype(np.float32)),
        obs_uv=jnp.asarray(obs_uv),
        obs_lm=jnp.asarray(obs_lm),
        obs_valid=jnp.asarray(obs_valid),
        point_valid=jnp.ones(L, bool),
        fixed=jnp.asarray(fixed),
    )


def bench_single(W=10, L=512, obs=128, iters=20, reps=3):
    import jax
    import jax.numpy as jnp

    from jaxvo.ba.window import ba_solve
    from jaxvo.config import BAConfig

    cfg, prob = build_problem(W, L, obs)
    # fixed-damping GN: every iteration is identical work (the adaptive-LM
    # accept/reject adds a chi evaluation, which would skew iters/s)
    ba_cfg = BAConfig(iterations=iters, lm_adaptive=False)
    K = jnp.asarray(cfg.K())
    solve = jax.jit(lambda p: ba_solve(p, K, cfg.width, cfg.height, ba_cfg))
    jax.block_until_ready(solve(prob)[0].poses)
    t0 = time.perf_counter()
    for _ in range(reps):
        jax.block_until_ready(solve(prob)[0].poses)
    dt = (time.perf_counter() - t0) / reps
    return iters / dt


def bench_sharded(n_devices, W=10, L=100_000, obs=128, iters=10, reps=3):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from jaxvo.config import BAConfig
    from jaxvo.parallel.ba_sharded import shard_ba_problem, sharded_ba_solve

    cfg, prob = build_problem(W, L, obs)
    ba_cfg = BAConfig(iterations=iters)
    K = jnp.asarray(cfg.K())
    sp = shard_ba_problem(prob, n_devices)
    mesh = Mesh(np.array(jax.devices()[:n_devices]), ("lm",))

    @jax.jit
    def solve(poses, points):
        sp2 = sp._replace(poses=poses, points=points)
        out, stats = sharded_ba_solve(mesh, sp2, K, cfg.width, cfg.height, ba_cfg)
        return out.poses, out.points

    jax.block_until_ready(solve(sp.poses, sp.points)[0])
    t0 = time.perf_counter()
    for _ in range(reps):
        jax.block_until_ready(solve(sp.poses, sp.points)[0])
    dt = (time.perf_counter() - t0) / reps
    return iters / dt


def _worker(n_devices: int, big_L: int, obs: int):
    """Subprocess entry: run the sharded solve on ``n_devices`` virtual CPU
    devices (the parent pinned this process to ``n_devices`` physical cores)
    and print iters/s on stdout."""
    print(json.dumps({"iters_per_s": bench_sharded(n_devices, L=big_L, obs=obs)}))


def fair_scaling(big_L: int, obs: int = 128, reps_note: str = ""):
    """Strong-scaling measurement that is fair on a shared-core host.

    ``--xla_force_host_platform_device_count=N`` devices all share this
    machine's physical cores, so comparing an N-virtual-device run against a
    1-device run that already uses every core can never show speedup — it
    measures the core count, not the algorithm (observed 0.12 "efficiency"
    on this 2-core box for a solve whose only per-iteration communication is
    one (6W)^2 psum).  The fair experiment: pin a 1-device worker to 1 core
    and an N-device worker to N cores, so each virtual device owns one core
    — the same resource ratio a real multi-chip mesh has.  N = #cores.
    """
    import subprocess

    n = min(os.cpu_count() or 1, 8)
    if n < 2:
        return None
    here = os.path.abspath(__file__)
    reps = int(os.environ.get("JAXVO_BA_FAIR_REPS", "5"))

    def run_once(n_dev, cores):
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n_dev}"
        env["JAXVO_BA_WORKER"] = str(n_dev)
        env["JAXVO_BA_L"] = str(big_L)
        env["JAXVO_BA_OBS"] = str(obs)
        cmd = ["taskset", "-c", cores, sys.executable, here]
        out = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=1200)
        if out.returncode != 0:
            raise RuntimeError(f"worker failed: {out.stderr[-2000:]}")
        return json.loads(out.stdout.strip().splitlines()[-1])["iters_per_s"]

    def run_median(n_dev, cores):
        # median-of-N against run-to-run noise (one cold subprocess each —
        # compile time is excluded inside the worker, but the OS scheduler
        # is not; report the spread alongside the median)
        vals = sorted(run_once(n_dev, cores) for _ in range(reps))
        return vals[len(vals) // 2], vals[0], vals[-1]

    one, one_lo, one_hi = run_median(1, "0")
    many, many_lo, many_hi = run_median(n, ",".join(str(i) for i in range(n)))
    return {
        "fair_reps": reps,
        "fair_1dev_1core_iters_per_s": round(one, 2),
        "fair_1dev_spread": [round(one_lo, 2), round(one_hi, 2)],
        f"fair_{n}dev_{n}core_iters_per_s": round(many, 2),
        f"fair_{n}dev_spread": [round(many_lo, 2), round(many_hi, 2)],
        "fair_scaling_efficiency": round(many / (one * n), 3),
        "fair_n": n,
    }


def main():
    import jax

    big_L = int(os.environ.get("JAXVO_BA_L", "100000"))
    # observations per frame: at the default 128 the 100k-landmark problem
    # holds only W*128 = 1,280 observations, so after active-landmark
    # compaction there is almost no local work to parallelize — a dense
    # problem (e.g. JAXVO_BA_OBS=8192 -> ~82k observations) is the workload
    # where landmark sharding is meaningful
    big_obs = int(os.environ.get("JAXVO_BA_OBS", "128"))
    worker = os.environ.get("JAXVO_BA_WORKER")
    if worker:
        _worker(int(worker), big_L, big_obs)
        return

    out = {
        "platform": jax.devices()[0].platform,
        "device_kind": jax.devices()[0].device_kind,
        "n_devices": jax.device_count(),
    }
    out["ba_iters_per_s_w10_L512"] = round(bench_single(), 2)
    n = jax.device_count()
    if n >= 2:
        one = bench_sharded(1, L=big_L, obs=big_obs)
        many = bench_sharded(n, L=big_L, obs=big_obs)
        out["ba_iters_per_s_100k_1dev"] = round(one, 2)
        out[f"ba_iters_per_s_100k_{n}dev"] = round(many, 2)
        out["shared_core_efficiency"] = round(many / (one * n), 3)
    if os.environ.get("JAXVO_BA_FAIR", "1") != "0":
        try:
            fair = fair_scaling(big_L, big_obs)
            if fair:
                out.update(fair)
        except Exception as e:  # pragma: no cover — diagnostics only
            out["fair_scaling_error"] = str(e)[:500]
    print(json.dumps(out))
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "results.jsonl")
    with open(path, "a") as f:
        f.write(json.dumps({"ts": time.time(), **out}) + "\n")


if __name__ == "__main__":
    import jax.numpy as jnp  # noqa: F401  (import after flags)

    main()
