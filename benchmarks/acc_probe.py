"""Accuracy probe: run the tracker at the bench operating point, print ATE.

Usage: python _acc_probe.py [label]
Env: JAXVO_PROBE_MODE (fixed|parity), standard bench env knobs honored.
"""
import os
import sys

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from jaxvo.config import EngineConfig, MatcherConfig, PICPConfig
    from jaxvo.data import load_sequence
    from jaxvo.engine import vo
    from jaxvo.engine.eval import evaluate, metrics_dict

    mode = os.environ.get("JAXVO_PROBE_MODE", "fixed")
    cfg = EngineConfig(
        mode=mode,
        matcher=MatcherConfig(method="direct"),
        picp=PICPConfig(convergence_threshold=float(os.environ.get("JAXVO_PROBE_CONV", "1e-4"))),
        triangulation_refine_iters=int(os.environ.get("JAXVO_PROBE_REFINE", "2")),
    )
    seq = load_sequence("/root/reference/data", cfg.n_frames)
    F = seq.uv.shape[0]
    key = jax.random.PRNGKey(42)
    f0 = vo.frame_of(seq, 0)
    f1 = vo.frame_of(seq, 1)
    fc = vo.frames_of(seq, 0, F - 1)
    fn = vo.frames_of(seq, 1, F)
    boot = jax.jit(lambda k, a, b: vo.bootstrap(k, a, b, cfg))
    tracker = vo.make_tracker(cfg)
    s0, _ = boot(key, f0, f1)
    s, logs = tracker(s0, fc, fn)
    poses = jnp.concatenate([jnp.eye(4, dtype=jnp.float32)[None], logs.pose], 0)
    res = evaluate(np.asarray(poses), seq.gt_pose, cfg)
    acc = metrics_dict(res)
    label = sys.argv[1] if len(sys.argv) > 1 else "probe"
    print(
        f"RESULT {label} dev={jax.devices()[0].platform} mode={mode} "
        f"ate={acc['ate_rmse']:.4f} trans_mean={acc['trans_err_mean']:.4f} "
        f"trans_max={acc.get('trans_err_max', float('nan')):.4f} "
        f"map={int(s.map_count)}"
    )


if __name__ == "__main__":
    main()
