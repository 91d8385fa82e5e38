"""Real multi-process jax.distributed path: 2 CPU processes, localhost
coordinator, multi-iteration sharded BA across the global mesh, a
cross-process orbax checkpoint/restore, and a core-pinned 1-proc-vs-2-proc
iters/s comparison appended to benchmarks/results.jsonl.

Everything else in the suite exercises sharding on a single-process
virtual mesh; this is the only test where ``jax.distributed.initialize``
actually runs and the psum crosses a process boundary (SURVEY.md §5
"Distributed communication backend").
"""

import json
import os
import socket
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = textwrap.dedent(
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
    assert jax.device_count() == expect
    assert jax.local_device_count() == 1

    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, PartitionSpec as P

    from jaxvo.ba.window import BAProblem
    from jaxvo.config import BAConfig
    from benchmarks.ba_scaling import build_problem
    from jaxvo.parallel.ba_sharded import shard_ba_problem, sharded_ba_solve

    # a DENSE synthetic problem (obs drive the per-shard work; see
    # benchmarks/ba_scaling.py).  Timing methodology: jit ONCE per
    # iteration count (re-tracing sharded_ba_solve each call costs ~3 s of
    # recompilation and swamps the signal), then take the MARGINAL
    # per-iteration cost between a 2-iter and a 22-iter solve — this
    # cancels dispatch/compile fixed costs and isolates compute + the one
    # cross-process psum per iteration.  Fixed-damping GN so every
    # iteration is identical work.
    n_dev = jax.device_count()
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
            return out.poses, out.points, stats
        return solve

    def timed(solve, reps=3):
        out = solve(sp.poses, sp.points)
        jax.block_until_ready(out[0])           # warm (compile excluded)
        t0 = time.perf_counter()
        for _ in range(reps):
            out = solve(sp.poses, sp.points)
            jax.block_until_ready(out[0])
        return (time.perf_counter() - t0) / reps, out

    t2, _ = timed(make(2))
    t22, (poses22, points22, stats) = timed(make(22))
    marginal = (t22 - t2) / 20.0
    chi = float(stats.chi)
    assert np.isfinite(chi), chi
    assert np.all(np.isfinite(np.asarray(poses22)))
    sp2 = sp._replace(poses=poses22, points=points22)
    if jax.process_index() == 0:
        print("TIMING " + json.dumps({
            "n_proc": n_proc,
            "marginal_ms_per_iter": round(1e3 * marginal, 2),
            "iters_per_s": round(1.0 / marginal, 2),
            "chi": round(chi, 3)}))

    # ---- cross-process sharded checkpoint/restore (2-proc mode only) ----
    ckpt_dir = os.environ.get("JAXVO_CKPT_DIR")
    if ckpt_dir and n_proc == 2:
        from jaxvo.utils.checkpoint import OrbaxCheckpointer

        # the solve outputs (poses, points) ARE live mesh-sharded global
        # arrays; checkpoint them, each host writing only its own shards
        # (the other problem fields are host-local inputs, not solve state)
        state = {"poses": sp2.poses, "points": sp2.points}
        ck = OrbaxCheckpointer(ckpt_dir, keep=2)
        ck.save(7, state)
        target = jax.tree.map(
            lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype,
                                           sharding=x.sharding), state)
        restored, _ = ck.restore(7, target=target)
        for k in state:
            a, b = state[k], restored[k]
            assert a.sharding.is_equivalent_to(b.sharding, a.ndim), k
            for sa, sb in zip(a.addressable_shards, b.addressable_shards):
                np.testing.assert_array_equal(np.asarray(sa.data),
                                              np.asarray(sb.data))
        ck.close()
        print(f"CKPT_OK process={jax.process_index()}")

    print(f"OK process={jax.process_index()} chi={chi:.3f}")
    """
)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_workers(tmp_path, n_procs, ckpt_dir=None, pin_cores=True,
                 timeout=420):
    port = _free_port()
    env_base = {
        **os.environ,
        "JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
        "JAX_NUM_PROCESSES": str(n_procs),
        "JAXVO_EXPECT_PROCS": str(n_procs),
        "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
        # each process contributes exactly one CPU device to the global mesh
        "XLA_FLAGS": "--xla_force_host_platform_device_count=1",
    }
    env_base.pop("JAX_PROCESS_ID", None)
    if ckpt_dir:
        env_base["JAXVO_CKPT_DIR"] = str(ckpt_dir)
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    procs = []
    for pid in range(n_procs):
        env = {**env_base, "JAX_PROCESS_ID": str(pid)}
        cmd = [sys.executable, str(script)]
        if pin_cores and (os.cpu_count() or 1) >= n_procs:
            cmd = ["taskset", "-c", str(pid)] + cmd
        procs.append(
            subprocess.Popen(
                cmd, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True, cwd=REPO,
            )
        )
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"{n_procs}-process jax.distributed test timed out")
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid} failed:\n{out}"
        assert "OK process=" in out
    return outs


def _parse_timing(outs):
    for out in outs:
        for line in out.splitlines():
            if line.startswith("TIMING "):
                return json.loads(line[len("TIMING "):])
    raise AssertionError("no TIMING line in worker output")


@pytest.mark.slow
def test_two_process_sharded_ba_step(tmp_path):
    """Multi-iteration sharded BA solve + orbax checkpoint across a real
    2-process mesh, and a core-pinned 1-proc-vs-2-proc iters/s comparison
    (appended to benchmarks/results.jsonl: the fair strong-scaling row)."""
    outs2 = _run_workers(tmp_path, 2, ckpt_dir=tmp_path / "ckpt")
    t2 = _parse_timing(outs2)
    assert any("CKPT_OK" in o for o in outs2), "sharded checkpoint not exercised"
    # per-host orbax artifacts exist
    assert (tmp_path / "ckpt" / "7").exists()

    outs1 = _run_workers(tmp_path, 1)
    t1 = _parse_timing(outs1)
    eff = t2["iters_per_s"] / (2.0 * t1["iters_per_s"])
    row = {
        "bench": "two_process_fair_scaling",
        "platform": "cpu",
        "iters_per_s_1proc_1core": t1["iters_per_s"],
        "iters_per_s_2proc_2core": t2["iters_per_s"],
        "marginal_ms_per_iter_1proc": t1["marginal_ms_per_iter"],
        "marginal_ms_per_iter_2proc": t2["marginal_ms_per_iter"],
        "scaling_efficiency": round(eff, 3),
        "method": "real jax.distributed processes, taskset-pinned 1 core "
                  "each; marginal per-iteration cost between 2- and 22-iter "
                  "jit-cached solves (cancels dispatch/compile fixed costs); "
                  "W=6, L=16384, 98k obs",
    }
    with open(os.path.join(REPO, "benchmarks", "results.jsonl"), "a") as f:
        f.write(json.dumps(row) + "\n")
    # floor below the measured 0.82 to absorb run-to-run noise on this
    # 2-core box; the recorded results.jsonl row is the honest number
    # (the multi-host bar: >= 0.7)
    assert eff > 0.5, row
