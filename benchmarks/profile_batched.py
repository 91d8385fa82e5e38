"""Op-level profile of the batched tracker: trace one rep on the device and
aggregate XLA op self-times from the xplane, grouped by fusion name.

Usage: python benchmarks/profile_batched.py [--batch 256] [--top 30]
           [--data DATASET_DIR] [--outdir TRACE_DIR]

Without ``--data`` it traces the seeded control sequence
(``jaxvo.profiles.control_sequence``); without ``--outdir`` the trace goes
to a fresh temporary directory.
"""

import argparse
import collections
import glob
import json
import os
import re
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--data", default="",
                    help="dataset dir (default: the seeded control sequence)")
    ap.add_argument("--matcher", default="direct")
    ap.add_argument("--outdir", default="",
                    help="trace directory (default: a fresh temporary one)")
    args = ap.parse_args()

    from jaxvo import profiles
    from jaxvo.config import EngineConfig, MatcherConfig, PICPConfig
    from jaxvo.data import load_sequence

    cfg = EngineConfig(
        mode="fixed",
        matcher=MatcherConfig(method=args.matcher),
        picp=PICPConfig(convergence_threshold=1e-4),
    )
    seq = (load_sequence(args.data, 121) if args.data
           else profiles.control_sequence(121))
    batched_j = jax.jit(profiles.batched_tracker(cfg))
    a = profiles.batched_inputs(seq, args.batch)
    jax.block_until_ready(batched_j(*a))  # warm

    args.outdir = args.outdir or tempfile.mkdtemp(prefix="jaxvo_trace_")
    os.makedirs(args.outdir, exist_ok=True)
    with jax.profiler.trace(args.outdir):
        jax.block_until_ready(batched_j(*a))

    from jax.profiler import ProfileData

    paths = sorted(glob.glob(os.path.join(args.outdir, "**", "*.xplane.pb"),
                             recursive=True))
    if not paths:
        sys.exit(f"no *.xplane.pb trace found under {args.outdir} — "
                 "did the profiler run?")
    pd = ProfileData.from_file(paths[-1])
    agg = collections.Counter()
    events_total = 0
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                name = ev.name
                # strip ONLY a trailing '.N' fusion suffix (fusion.123 ->
                # fusion); a bare rstrip of digits would also mangle names
                # like convert_f32 -> convert_f
                base = re.sub(r"\.\d+$", "", name)
                agg[base] += ev.duration_ns
                events_total += 1
    total = sum(agg.values())
    print(json.dumps({"plane_total_ms": round(total / 1e6, 3),
                      "events": events_total}))
    for name, ns in agg.most_common(args.top):
        print(f"{ns/1e6:10.3f} ms  {100*ns/total:5.1f}%  {name}")


if __name__ == "__main__":
    main()
