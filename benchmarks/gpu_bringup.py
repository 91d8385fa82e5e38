"""GPU bring-up measurements: which PICP solver and matcher to keep, and
where the host holds the card back.

    python benchmarks/gpu_bringup.py [--out output/gpu_bringup.jsonl]
                                     [--only step,step,...]

One JSON line per measurement, on stdout and in ``--out``:
  * the fused PICP kernel (Pallas on the Triton route) against
    ``picp.solve`` (XLA while_loop) and ``picp.solve_unrolled`` (8 fixed
    rounds): standalone at batch 1 and 256, end to end in the
    single-stream program (chip_smoke phase 2) and in 256 vmapped
    streams (phase 3);
  * device traces of the single-stream program and the SLAM scan:
    busy time, idle share, device-to-host copies (one per host-side loop
    predicate), and device time by layer (``jax.named_scope`` spans);
  * compile time of the single-stream program at scan_unroll 1 and 8;
  * SLAM with the XLA PICP solver and with the fused kernel: wall, and
    the device-to-host copies per frame left once the GN loop stays on
    the device;
  * whether the mxu_bf16 matcher decides like ``direct`` on the GPU.

Needs a GPU; every number names the card (nvidia-smi) it ran on.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from jaxvo import profiles  # noqa: E402
from jaxvo.utils.measure import (device_line, median, query_cards,  # noqa: E402
                                 timed)

SCOPES = ["bootstrap", "match", "picp", "triangulate", "map_update", "ba"]


def _picp(cfg, **kw):
    return cfg.replace(picp=dataclasses.replace(cfg.picp, **kw))


def solver_variants(cfg):
    return {
        "xla_while": _picp(cfg, backend="xla", unrolled_rounds=0),
        "xla_unrolled8": _picp(cfg, backend="xla", unrolled_rounds=8),
        "pallas_triton": _picp(cfg, backend="pallas", unrolled_rounds=0),
    }


def trace_program(fn, scopes_from=None) -> dict:
    """Run ``fn`` once under the profiler; summarize the device plane."""
    import jax

    from jaxvo.utils import profiling

    d = tempfile.mkdtemp(prefix="jaxvo_trace_")
    with profiling.trace(d):
        jax.block_until_ready(fn())
    events = profiling.load_device_events(d)
    out = profiling.device_summary(events)
    if scopes_from is not None:
        ops = profiling.hlo_op_names(scopes_from)
        out["ms_by_scope"] = profiling.time_by_scope(events, ops, SCOPES)
    top = {}
    for e in events:
        top[e["name"]] = top.get(e["name"], 0) + e["dur_ns"]
    out["top_kernels_ms"] = {k: v / 1e6 for k, v in
                             sorted(top.items(), key=lambda kv: -kv[1])[:12]}
    out["sample_stats"] = [
        {"name": e["name"], "line": e["line"],
         "stats": {k: str(v)[:120] for k, v in e["stats"].items()}}
        for e in events[:4]]
    return out


def kernel_standalone(warps_list=(1, 4), batches=(1, 256), reps=51):
    """The kernel alone against both XLA solvers, per warp count."""
    import jax
    import jax.numpy as jnp

    from jaxvo.config import EngineConfig, PICPConfig
    from jaxvo.ops import picp
    from jaxvo.ops.pallas import picp_kernel

    cfg = EngineConfig()
    K = cfg.K()
    pcfg = PICPConfig(convergence_threshold=1e-4)
    rows = []
    for B in batches:
        args = tuple(jnp.asarray(a) for a in profiles.picp_problems(B, seed=B))

        def xla(solver):
            return jax.jit(lambda T0, X, Z, V: jax.vmap(
                lambda t, x, z, v: solver(jnp.asarray(K), t, x, z, None, v,
                                          cfg.width, cfg.height, pcfg)
            )(T0, X, Z, V)).lower(*args).compile()

        row = {"batch": B}
        for name, solver in (("xla_while", picp.solve),
                             ("xla_unrolled8", picp.solve_unrolled)):
            c = xla(solver)
            row[name + "_s"] = median(timed(lambda: c(*args).T, reps))
        for w in warps_list:
            picp_kernel.NUM_WARPS = w
            jax.clear_caches()
            c = jax.jit(lambda T0, X, Z, V: jax.vmap(
                lambda t, x, z, v: picp_kernel.solve_pallas(
                    K, t, x, z, None, v, cfg.width, cfg.height, pcfg)
            )(T0, X, Z, V)).lower(*args).compile()
            row[f"pallas_warps{w}_s"] = median(timed(lambda: c(*args).T, reps))
        picp_kernel.NUM_WARPS = 1
        jax.clear_caches()
        rows.append(row)
    return {"what": "picp_standalone", "rows": rows}


def latency_trace(cfg, n_frames=121):
    import jax

    from jaxvo.engine import vo

    seq = profiles.control_sequence(n_frames)
    F = seq.uv.shape[0]
    args = (jax.random.PRNGKey(42), vo.frame_of(seq, 0), vo.frame_of(seq, 1),
            vo.frames_of(seq, 0, F - 1), vo.frames_of(seq, 1, F))
    c = vo.full_run_jit.lower(*args, cfg=cfg).compile()
    jax.block_until_ready(c(*args))
    out = trace_program(lambda: c(*args)[1].pose, c.as_text())
    # GN rounds the traced run took (same program, diagnostics on)
    _, logs, _, _ = vo.run_sequence(seq, cfg.replace(log_stats=True))
    out["gn_rounds_total"] = int(np.asarray(logs.iterations).sum())
    out["frames"] = F - 1
    return out


def slam_trace(n_frames=200, n_landmarks=20000, cap=8192, picp_backend="xla"):
    import jax
    import jax.numpy as jnp

    from jaxvo.engine import slam, vo

    cfg = profiles.slam_config(n_frames, cap, picp_backend)
    seq = jax.tree.map(jnp.asarray,
                       profiles.loop_circuit(n_frames, n_landmarks, cfg))
    F = seq.uv.shape[0]
    state, _ = vo.bootstrap_jit(jax.random.PRNGKey(7), vo.frame_of(seq, 0),
                                vo.frame_of(seq, 1), cfg)
    poses_all = jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (F, 4, 4))
    args = (state, poses_all, vo.frames_of(seq, 0, F - 1),
            vo.frames_of(seq, 1, F))
    c = slam._slam_scan.lower(*args, cfg=cfg).compile()
    jax.block_until_ready(c(*args))
    out = trace_program(lambda: c(*args)[1], c.as_text())
    out["frames"] = F - 1
    out["n_local_ba_runs"] = int(c(*args)[3])
    return out


def match_share(slam_busy_ms_per_frame, n_frames=199, cap=8192, n_obs=128):
    """Device time of the SLAM frame's fused 2D-3D + 2D-2D match (mxu
    form, 128 queries against the 8,192-slot map and the next frame) as a
    scan over ``n_frames`` distinct query sets, per frame and as a share
    of the traced SLAM frame."""
    import jax
    import jax.numpy as jnp

    from jaxvo.ops.match import match_descriptors_pair

    rng = np.random.default_rng(0)
    q = jnp.asarray(rng.uniform(-1, 1, (n_frames, n_obs, 10)).astype(np.float32))
    nxt = jnp.asarray(rng.uniform(-1, 1, (n_frames, n_obs, 10)).astype(np.float32))
    m = jnp.asarray(rng.uniform(-1, 1, (cap, 10)).astype(np.float32))
    mv = jnp.asarray(rng.uniform(size=cap) < 0.6)
    v = jnp.ones(n_obs, bool)

    @jax.jit
    def run(q, nxt, m, mv):
        def body(acc, xs):
            a, b = xs
            r1, r2 = match_descriptors_pair(a, v, m, mv, a, v, b, v)
            return acc + jnp.sum(r1.idx) + jnp.sum(r2.idx), None
        return jax.lax.scan(body, jnp.int32(0), (q, nxt))[0]

    jax.block_until_ready(run(q, nxt, m, mv))
    out = trace_program(lambda: run(q, nxt, m, mv))
    per_frame = out["busy_ms"] / n_frames
    return {"what": "match_share", "match_ms_per_frame": per_frame,
            "slam_busy_ms_per_frame": slam_busy_ms_per_frame,
            "share": per_frame / slam_busy_ms_per_frame,
            "idle_share": out["idle_share"]}


def matcher_decisions(n_frames=121):
    """Tracker and raw 2D-2D match decisions, direct vs mxu_bf16."""
    import jax.numpy as jnp

    from jaxvo.config import MatcherConfig
    from jaxvo.engine import vo
    from jaxvo.ops.match import match_descriptors

    seq = profiles.control_sequence(n_frames)
    base = profiles.throughput_config(n_frames)
    runs = {}
    for m in ("direct", "mxu_bf16"):
        _, logs, poses, _ = vo.run_sequence(
            seq, base.replace(matcher=MatcherConfig(method=m)))
        runs[m] = (np.asarray(logs.n_map_matches),
                   np.asarray(logs.n_frame_matches), np.asarray(poses))
    flips = 0
    total = 0
    for i in range(n_frames - 1):
        a = [jnp.asarray(x) for x in (seq.desc[i], seq.valid[i],
                                      seq.desc[i + 1], seq.valid[i + 1])]
        r_d = match_descriptors(*a, method="direct")
        r_b = match_descriptors(*a, method="mxu_bf16")
        vd, vb = np.asarray(r_d.valid), np.asarray(r_b.valid)
        flips += int(np.sum(vd != vb)) + int(np.sum(
            (np.asarray(r_d.idx) != np.asarray(r_b.idx)) & vd & vb))
        total += int(vd.sum())
    return {
        "what": "matcher_bf16_vs_direct",
        "tracker_map_matches_equal": bool(np.array_equal(runs["direct"][0],
                                                         runs["mxu_bf16"][0])),
        "tracker_frame_matches_equal": bool(np.array_equal(
            runs["direct"][1], runs["mxu_bf16"][1])),
        "tracker_max_pose_diff": float(np.max(np.abs(
            runs["direct"][2] - runs["mxu_bf16"][2]))),
        "frame_pair_flips": flips, "frame_pair_matches": total,
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=os.path.join(ROOT, "output",
                                                 "gpu_bringup.jsonl"))
    p.add_argument("--skip", default="", help="comma-separated steps to skip")
    p.add_argument("--only", default="",
                   help="comma-separated steps to run (default: all)")
    args = p.parse_args(argv)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    sink = open(args.out, "a")

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        sink.write(line + "\n")
        sink.flush()

    import jax

    from jaxvo.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    dev = device_line(jax, query_cards())
    emit(dev)
    if dev["platform"] != "gpu":
        emit({"ok": False, "error": "no GPU"})
        return 2

    lat = profiles.latency_config()
    thr = profiles.throughput_config()
    steps = [
        ("kernels", lambda: chip_smoke.phase_kernels(reps=51)),
        ("standalone", kernel_standalone),
    ]
    for name, cfg in solver_variants(lat).items():
        steps.append((f"latency_{name}",
                      lambda cfg=cfg: chip_smoke.phase_control_vo(cfg=cfg)))
    for name, cfg in solver_variants(thr).items():
        steps.append((f"batched_{name}",
                      lambda cfg=cfg: chip_smoke.phase_batched(cfg=cfg)))
    results = {}
    steps += [
        ("trace_slam", slam_trace),
        ("trace_slam_pallas", lambda: slam_trace(picp_backend="pallas")),
        ("match_share", lambda: match_share(
            results["trace_slam"]["busy_ms"] / results["trace_slam"]["frames"])),
        ("trace_latency_xla_while", lambda: latency_trace(
            _picp(lat, backend="xla"))),
        ("trace_latency_pallas", lambda: latency_trace(
            _picp(lat, backend="pallas"))),
        ("latency_unroll1", lambda: chip_smoke.phase_control_vo(
            cfg=lat.replace(scan_unroll=1))),
        ("slam", profiles.slam_run),
        ("slam_pallas", lambda: profiles.slam_run(picp_backend="pallas")),
        ("matcher_decisions", matcher_decisions),
    ]
    skip = set(filter(None, args.skip.split(",")))
    only = set(filter(None, args.only.split(",")))
    for name, fn in steps:
        if name in skip or (only and name not in only):
            continue
        t0 = time.perf_counter()
        try:
            res = fn()
        except Exception as e:
            traceback.print_exc()
            res = {"error": f"{type(e).__name__}: {e}"[:3000]}
        res = {"step": name, **res, "wall_s": time.perf_counter() - t0,
               "card": dev["cards"]}
        results[name] = res
        emit(res)
    stats = jax.devices()[0].memory_stats() or {}
    emit({"step": "memory", "bytes_limit": stats.get("bytes_limit"),
          "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
          "card": dev["cards"]})
    sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
