"""Batched-throughput sweep: time the vmapped full tracker at several batch
sizes / matcher methods in one process to locate the scaling knee.

Usage: python benchmarks/throughput_sweep.py [--batches 128,256,512] \
           [--matcher direct,mxu] [--reps 3]
"""

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from jaxvo.config import EngineConfig, MatcherConfig, PICPConfig
from jaxvo.data import load_sequence
from jaxvo.engine import vo


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", default="128,256,512")
    ap.add_argument("--matcher", default="direct")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--data", default="/root/reference/data")
    ap.add_argument("--gn-unroll", type=int, default=0)
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--refine", type=int, default=2)
    args = ap.parse_args()

    seq = load_sequence(args.data, 121)
    F = seq.uv.shape[0]
    key = jax.random.PRNGKey(42)
    f0, f1 = vo.frame_of(seq, 0), vo.frame_of(seq, 1)
    fc, fn = vo.frames_of(seq, 0, F - 1), vo.frames_of(seq, 1, F)

    base = EngineConfig(
        mode="fixed",
        picp=PICPConfig(convergence_threshold=1e-4, unrolled_rounds=args.gn_unroll),
        triangulation_refine_iters=args.refine,
    )
    variants = {}
    for method in args.matcher.split(","):
        variants[method] = dataclasses.replace(
            base, matcher=MatcherConfig(method=method))
    if args.ablate:
        variants.update({
            "gn1": dataclasses.replace(
                base, picp=dataclasses.replace(base.picp, max_iterations=1)),
            "gn_unroll6": dataclasses.replace(
                base, picp=dataclasses.replace(base.picp, unrolled_rounds=6)),
            "refine0": dataclasses.replace(base, triangulation_refine_iters=0),
            "nogate": dataclasses.replace(base, gate_new_landmarks=False),
            "fused": dataclasses.replace(base, fuse_frame_matchers=True),
        })
    for name, cfg in variants.items():

        def batched(k, bf0, bf1, bc, bn):
            s, _ = jax.vmap(lambda kk, a, b: vo.bootstrap(kk, a, b, cfg))(k, bf0, bf1)
            s, lg = jax.vmap(lambda st, c, n: vo.scan_tracker(st, c, n, cfg))(s, bc, bn)
            return lg.pose

        batched_j = jax.jit(batched)
        for B in [int(x) for x in args.batches.split(",")]:
            tile = lambda x: jnp.broadcast_to(x[None], (B,) + x.shape)
            keys = jax.random.split(key, B)
            a = (keys, jax.tree.map(tile, f0), jax.tree.map(tile, f1),
                 jax.tree.map(tile, fc), jax.tree.map(tile, fn))
            jax.block_until_ready(batched_j(*a))
            t0 = time.perf_counter()
            for _ in range(args.reps):
                jax.block_until_ready(batched_j(*a))
            dt = (time.perf_counter() - t0) / args.reps
            # consistent denominators: fps counts frames (incl. the
            # bootstrap pair), ms_per_step divides by the same frame count
            print(json.dumps({
                "matcher": name, "batch": B,
                "fps": round(B * F / dt, 1),
                "ms_per_frame": round(1e3 * dt / F, 3),
            }), flush=True)


if __name__ == "__main__":
    main()
