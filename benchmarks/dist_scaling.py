"""Multi-rep, core-pinned 1-vs-2-process scaling for every parallel/ module.

A CPU-process proxy (its numbers are CPU numbers, not GPU ones):
ba_scaling.py measures only the sharded Schur BA; this benchmark makes
the same marginal-cost, taskset-pinned measurement for ALL THREE distributed
paths — sharded BA (parallel/ba_sharded.py), the landmark-sharded
matcher at 131k landmarks (parallel/match_sharded.py), and the
edge-sharded PGO at ~1k edges (parallel/posegraph_sharded.py) — and
repeats the whole 1-proc/2-proc pair ``--fair-reps`` times, recording
median + min/max so a single noisy rep can no longer masquerade as the
scaling efficiency.

Methodology per rep (inherited from tests/test_distributed.py):
  * real ``jax.distributed`` processes, one CPU device each,
    taskset-pinned to distinct cores;
  * per-unit cost = marginal between a 2-unit and a 22-unit jit-cached
    solve (cancels dispatch + compile fixed costs);
  * efficiency = units/s(2 procs) / (2 x units/s(1 proc)).

Usage: python benchmarks/dist_scaling.py [--what ba,match,pgo] [--fair-reps 5]
Appends one row per workload to results.jsonl.
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

COMMON = textwrap.dedent(
    """
    import json
    import os
    import time

    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    jax.config.update("jax_platforms", "cpu")

    from jaxvo.parallel.mesh import maybe_distributed_init

    expect = int(os.environ.get("JAXVO_EXPECT_PROCS", "2"))
    n_proc = maybe_distributed_init()
    assert n_proc == expect, f"expected {expect} processes, got {n_proc}"

    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, PartitionSpec as P

    n_dev = jax.device_count()

    def timed(solve, *args, reps=3):
        out = solve(*args)
        jax.block_until_ready(jax.tree.leaves(out)[0])   # warm
        t0 = time.perf_counter()
        for _ in range(reps):
            out = solve(*args)
            jax.block_until_ready(jax.tree.leaves(out)[0])
        return (time.perf_counter() - t0) / reps, out

    def report(t2, t22):
        marginal = (t22 - t2) / 20.0
        if jax.process_index() == 0:
            print("TIMING " + json.dumps({
                "n_proc": n_proc,
                "marginal_ms_per_unit": round(1e3 * marginal, 3),
                "units_per_s": round(1.0 / marginal, 2)}))
    """
)

WORKER_BA = COMMON + textwrap.dedent(
    """
    from jaxvo.ba.window import BAProblem
    from jaxvo.config import BAConfig
    from benchmarks.ba_scaling import build_problem
    from jaxvo.parallel.ba_sharded import shard_ba_problem, sharded_ba_solve

    cfg, prob = build_problem(W=6, L=16384, obs_per_frame=16384, seed=5)
    K = jnp.asarray(cfg.K())
    sp = shard_ba_problem(prob, n_dev)
    mesh = Mesh(np.array(jax.devices()), ("lm",))

    def make(iters):
        ba_cfg = BAConfig(iterations=iters, lm_adaptive=False)

        @jax.jit
        def solve(poses, points):
            sp2 = sp._replace(poses=poses, points=points)
            out, stats = sharded_ba_solve(
                mesh, sp2, K, cfg.width, cfg.height, ba_cfg)
            return out.poses, out.points
        return solve

    t2, _ = timed(make(2), sp.poses, sp.points)
    t22, out = timed(make(22), sp.poses, sp.points)
    assert np.all(np.isfinite(np.asarray(out[0])))
    report(t2, t22)
    print(f"OK process={jax.process_index()}")
    """
)

WORKER_MATCH = COMMON + textwrap.dedent(
    """
    from jaxvo.parallel.match_sharded import sharded_match_descriptors

    N, M, D = 128, 131072, 10
    rng = np.random.default_rng(0)
    d1 = jnp.asarray(rng.uniform(-1, 1, (N, D)).astype(np.float32))
    v1 = jnp.ones((N,), bool)
    d2 = jnp.asarray(rng.uniform(-1, 1, (M, D)).astype(np.float32))
    v2 = jnp.ones((M,), bool)
    mesh = Mesh(np.array(jax.devices()), ("lm",))

    def make(chain):
        @jax.jit
        def solve(q):
            def body(_, q_c):
                r = sharded_match_descriptors(
                    mesh, q_c, v1, d2, v2, method="mxu")
                # feed the result back so the chain cannot collapse
                return q_c * (1.0 + 1e-7 * r.best[:, None])
            return jax.lax.fori_loop(0, chain, body, q)
        return solve

    t2, _ = timed(make(2), d1)
    t22, out = timed(make(22), d1)
    assert np.all(np.isfinite(np.asarray(out)))
    report(t2, t22)
    print(f"OK process={jax.process_index()}")
    """
)

WORKER_PGO = COMMON + textwrap.dedent(
    """
    from jaxvo.ba.posegraph import build_graph, odometry_edges
    from jaxvo.parallel.posegraph_sharded import sharded_pgo_solve
    from jaxvo.ops import lie

    # noisy circle trajectory, odometry backbone + random loop edges.
    # The sharded axis is EDGES; the per-iteration psum carries the full
    # replicated (6F, 6F) H — the compute/comm ratio is edges/F^2, so the
    # meaningful scaling regime is dense graphs (many edges per pose).
    # Defaults: F=128, 4000 extra edges (H = 2.3 MB/psum).  F=512/500
    # edges is the communication-bound counterexample (H = 37 MB/psum,
    # efficiency ~0.39 on loopback TCP) — settable via env to record it.
    F = int(os.environ.get("JAXVO_PGO_F", "128"))
    NE = int(os.environ.get("JAXVO_PGO_EXTRA", "4000"))
    rng = np.random.default_rng(3)
    theta = np.linspace(0, 2 * np.pi, F).astype(np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (F, 1, 1))
    poses[:, 0, 3] = 30.0 * np.cos(theta)
    poses[:, 1, 3] = 30.0 * np.sin(theta)
    poses[:, :3, 3] += rng.normal(0, 0.3, (F, 3)).astype(np.float32)
    gt = jnp.asarray(poses)
    extra_i = rng.integers(0, F - 40, NE)
    extra_j = extra_i + rng.integers(20, 40, NE)
    eij = jnp.asarray(np.stack([extra_i, extra_j], 1).astype(np.int32))
    eT = jax.vmap(lambda i, j: lie.inv_se3(gt[i]) @ gt[j])(eij[:, 0], eij[:, 1])
    ew = jnp.ones((NE,), jnp.float32)
    graph = build_graph(gt, extra_edges=[(eij, eT, ew)])
    mesh = Mesh(np.array(jax.devices()), ("edge",))

    def make(iters):
        @jax.jit
        def solve(poses):
            g = graph._replace(poses=poses)
            out, stats = sharded_pgo_solve(mesh, g, iterations=iters)
            return out.poses
        return solve

    t2, _ = timed(make(2), graph.poses)
    t22, out = timed(make(22), graph.poses)
    assert np.all(np.isfinite(np.asarray(out)))
    report(t2, t22)
    print(f"OK process={jax.process_index()}")
    """
)

WORKERS = {"ba": WORKER_BA, "match": WORKER_MATCH, "pgo": WORKER_PGO}
SCALE_DESC = {
    "ba": "sharded Schur BA, W=6 L=16384 98k obs, unit=GN iteration",
    "match": "landmark-sharded matcher, 128 queries x 131072 landmarks, "
             "unit=full match",
    "pgo": "edge-sharded PGO (env JAXVO_PGO_F/JAXVO_PGO_EXTRA; default "
           "F=128, 4000 extra edges), unit=LM iteration",
}


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_workers(worker_src, n_procs, tmpdir, timeout=600):
    port = _free_port()
    env_base = {
        **os.environ,
        "JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
        "JAX_NUM_PROCESSES": str(n_procs),
        "JAXVO_EXPECT_PROCS": str(n_procs),
        "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
        "XLA_FLAGS": "--xla_force_host_platform_device_count=1",
    }
    env_base.pop("JAX_PROCESS_ID", None)
    script = os.path.join(tmpdir, "worker.py")
    with open(script, "w") as f:
        f.write(worker_src)
    procs = []
    for pid in range(n_procs):
        env = {**env_base, "JAX_PROCESS_ID": str(pid)}
        cmd = [sys.executable, script]
        if (os.cpu_count() or 1) >= n_procs:
            cmd = ["taskset", "-c", str(pid)] + cmd
        procs.append(subprocess.Popen(
            cmd, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, cwd=REPO))
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise RuntimeError(f"{n_procs}-proc worker timed out")
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"process {pid} failed:\n{out}")
    for out in outs:
        for line in out.splitlines():
            if line.startswith("TIMING "):
                return json.loads(line[len("TIMING "):])
    raise RuntimeError("no TIMING line")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--what", default="ba,match,pgo")
    ap.add_argument("--fair-reps", type=int, default=5)
    args = ap.parse_args()

    import tempfile

    results_path = os.path.join(REPO, "benchmarks", "results.jsonl")
    for what in args.what.split(","):
        worker = WORKERS[what]
        effs, ups1, ups2 = [], [], []
        with tempfile.TemporaryDirectory() as td:
            for rep in range(args.fair_reps):
                t2 = run_workers(worker, 2, td)
                t1 = run_workers(worker, 1, td)
                eff = t2["units_per_s"] / (2.0 * t1["units_per_s"])
                effs.append(round(eff, 3))
                ups1.append(t1["units_per_s"])
                ups2.append(t2["units_per_s"])
                print(json.dumps({"workload": what, "rep": rep,
                                  "efficiency": round(eff, 3),
                                  "units_per_s_1proc": t1["units_per_s"],
                                  "units_per_s_2proc": t2["units_per_s"]}),
                      flush=True)
        s = sorted(effs)
        row = {
            "bench": "dist_scaling",
            "platform": "cpu",
            "workload": what,
            "fair_reps": args.fair_reps,
            "efficiency_median": s[len(s) // 2],
            "efficiency_min": s[0],
            "efficiency_max": s[-1],
            "efficiencies": effs,
            "units_per_s_1proc_median": sorted(ups1)[len(ups1) // 2],
            "units_per_s_2proc_median": sorted(ups2)[len(ups2) // 2],
            "scale": SCALE_DESC[what],
            "method": "real jax.distributed procs, taskset-pinned 1 core "
                      "each; marginal unit cost between 2- and 22-unit "
                      "jit-cached solves; efficiency = units/s(2p)/(2 x "
                      "units/s(1p)); median over fair_reps full pairs",
        }
        print(json.dumps(row), flush=True)
        with open(results_path, "a") as f:
            f.write(json.dumps(row) + "\n")


if __name__ == "__main__":
    main()
