"""Whole-program variant attribution for SLAM-mode tracking.

Standalone stage timings of small programs measure dispatch overhead as
much as the stage.  This probe instead times the FULL compiled slam
program (one dispatch) under config variants whose difference isolates
one stage:

  full     — production config (W=16, E=2, 10 LM iterations)
  it1/it5  — local_ba_iterations=1/5: per-LM-iteration marginal cost
  noba     — local_ba_every=10^6: BA branch never taken (cond + ring
             buffer overhead only)
  W8       — half window: window-size scaling
  gn       — lm_adaptive=False: LM accept/reject (chi eval, rollback) cost
  nocompact— ba_solve compact=False: active-landmark compaction cost

Run: python benchmarks/slam_variants.py [--frames 200]
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

from jaxvo.config import EngineConfig, PICPConfig
from jaxvo.data import synthetic
from jaxvo.engine import slam as slam_mod
from jaxvo.engine import vo
from jaxvo.engine.eval import evaluate, metrics_dict


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--landmarks", type=int, default=10000)
    ap.add_argument("--map-capacity", type=int, default=8192)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--variants", default="full,it1,it5,noba,W8,gn,nocompact")
    args = ap.parse_args()

    base = EngineConfig(
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
    seq = synthetic.render_sequence(world, gt, base, pixel_noise=0.3,
                                    seed=args.seed)
    seq = jax.tree.map(jnp.asarray, seq)
    F = seq.uv.shape[0]

    variants = {
        "full": (base, True),
        "it1": (base.replace(local_ba_iterations=1), True),
        "it5": (base.replace(local_ba_iterations=5), True),
        "it8": (base.replace(local_ba_iterations=8), True),
        "noba": (base.replace(local_ba_every=10**6), True),
        "W8": (base.replace(local_ba_window=8), True),
        "E3": (base.replace(local_ba_every=3), True),
        "E4": (base.replace(local_ba_every=4), True),
        "cap512": (base.replace(local_ba_compact_cap=512), True),
        "cap768": (base.replace(local_ba_compact_cap=768), True),
        "E3cap512": (base.replace(local_ba_every=3,
                                  local_ba_compact_cap=512), True),
        "it1cap512": (base.replace(local_ba_iterations=1,
                                   local_ba_compact_cap=512), True),
        "it8cap512": (base.replace(local_ba_iterations=8,
                                   local_ba_compact_cap=512), True),
        "cap256": (base.replace(local_ba_compact_cap=256), True),
        "W12cap512": (base.replace(local_ba_window=12,
                                   local_ba_compact_cap=512), True),
        "gn": (base.replace(ba=base.ba.replace(lm_adaptive=False)), True),
        "nocompact": (base, False),
    }
    want = args.variants.split(",")

    variants["basolve_id"] = (base.replace(local_ba_compact_cap=512), "id")
    for d, it in ((0.1, 10), (0.1, 6), (0.01, 6), (0.01, 4)):
        variants[f"d{d}it{it}cap512"] = (base.replace(
            local_ba_compact_cap=512, local_ba_damping_init=d,
            local_ba_iterations=it), True)

    orig_ba_solve = slam_mod.ba_solve
    prev_patched = False
    for name in want:
        cfg, compact = variants[name]
        patched = compact != True
        if patched or prev_patched:
            # the jit cache is keyed only by (static cfg, shapes): any
            # transition into OR out of a monkeypatched ba_solve must drop
            # cached compiles, or a later variant with the same cfg would
            # silently reuse the patched program
            slam_mod._slam_scan.clear_cache()
        prev_patched = patched
        if compact == "id":
            # branch overhead WITHOUT the solve: cond + problem assembly +
            # pose inversions + map/pose write-backs only
            slam_mod.ba_solve = lambda p, K, w, h, c: (p, None)
        elif not compact:
            slam_mod.ba_solve = (
                lambda p, K, w, h, c: orig_ba_solve(p, K, w, h, c,
                                                    compact=False))
        else:
            slam_mod.ba_solve = orig_ba_solve
        try:
            def run():
                _, _, poses, diag = slam_mod.run_sequence_slam(
                    seq, cfg, seed=args.seed)
                jax.block_until_ready(poses)
                return poses, diag

            poses, diag = run()  # warm/compile
            ts = []
            for _ in range(3):
                t0 = time.perf_counter()
                poses, diag = run()
                ts.append(time.perf_counter() - t0)
            t = min(ts)
            n_ba = int(diag["n_local_ba_runs"])
            m = metrics_dict(evaluate(np.asarray(poses), seq.gt_pose, cfg))
            print(json.dumps({
                "variant": name, "s": round(t, 4),
                "fps": round((F - 1) / t, 1), "n_ba": n_ba,
                "ms_per_ba": round(1e3 * t / max(n_ba, 1), 2),
                "ate": round(m["ate_rmse"], 4),
            }), flush=True)
        finally:
            slam_mod.ba_solve = orig_ba_solve


if __name__ == "__main__":
    main()
