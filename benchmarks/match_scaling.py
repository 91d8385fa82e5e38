"""Matcher map-size scaling: the direct, mxu and mxu_bf16 distance forms.

For map sizes 512 -> 131k landmarks it times one 128-query match per
method and appends the record to results.jsonl (not tracked).

Methodology: a single match is far shorter than one dispatch, so the
timed unit is a jitted CHAIN of dependent matches (output feeds the next
query perturbation), and the per-match cost is the MARGINAL between a
``chain`` and a ``chain+200`` program — the dispatch cost and the
chain-independent fixed costs cancel.  Median of --reps.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import jax
import jax.numpy as jnp

from jaxvo.ops.match import match_descriptors

MAP_SIZES = [512, 2048, 8192, 32768, 131072]
METHODS = ["direct", "mxu", "mxu_bf16"]
N_QUERIES = 128
DESC = 10


def make_timed_fn(method, chain):
    @jax.jit
    def run(q, valid_q, m, valid_m):
        # chain dependent matches: mix each result back into the query so
        # XLA cannot collapse the chain (the best-distance vector reorders
        # the queries' scale slightly; decisions stay nontrivial)
        def body(i, carry):
            q_c, acc = carry
            r = match_descriptors(q_c, valid_q, m, valid_m, 0.2, 0.8, method)
            q_c = q_c * (1.0 + 1e-7 * r.best[:, None])
            return q_c, acc + jnp.sum(r.idx)
        q_c, acc = jax.lax.fori_loop(0, chain, body, (q, jnp.int32(0)))
        return acc, q_c[0, 0]
    return run


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--chain", type=int, default=20)
    ap.add_argument("--chain-delta", type=int, default=200)
    args = ap.parse_args()

    rng = np.random.default_rng(0)
    q = jnp.asarray(rng.uniform(-1, 1, (N_QUERIES, DESC)).astype(np.float32))
    vq = jnp.ones((N_QUERIES,), bool)

    def timed_med(fn, m, vm):
        np.asarray(fn(q, vq, m, vm)[1])  # warm
        ts = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(q, vq, m, vm)[1])
            ts.append(time.perf_counter() - t0)
        return sorted(ts)[len(ts) // 2]

    rows = {}
    for M in MAP_SIZES:
        m = jnp.asarray(rng.uniform(-1, 1, (M, DESC)).astype(np.float32))
        vm = jnp.ones((M,), bool)
        rows[M] = {}
        for method in METHODS:
            if method == "direct" and M > 32768:
                continue  # (N, M, D) broadcast blows HBM: skip
            try:
                t_lo = timed_med(make_timed_fn(method, args.chain), m, vm)
                t_hi = timed_med(
                    make_timed_fn(method, args.chain + args.chain_delta),
                    m, vm)
                rows[M][method] = round(
                    1e6 * (t_hi - t_lo) / args.chain_delta, 1)  # us/match
            except Exception as e:
                rows[M][method] = f"error: {str(e)[:120]}"
            print(json.dumps({"map_size": M, "method": method,
                              "us_per_match": rows[M][method]}), flush=True)

    out = {
        "bench": "match_scaling",
        "n_queries": N_QUERIES,
        "chain": args.chain,
        "chain_delta": args.chain_delta,
        "reps": args.reps,
        "method": "marginal us/match between chain and chain+delta jitted "
                  "dependent-match programs (cancels the dispatch cost)",
        "us_per_match": {str(k): v for k, v in rows.items()},
        "platform": jax.devices()[0].platform,
        "device_kind": jax.devices()[0].device_kind,
    }
    print(json.dumps(out))
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "results.jsonl"), "a") as f:
        f.write(json.dumps(out) + "\n")


if __name__ == "__main__":
    main()
