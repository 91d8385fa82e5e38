"""Timing + profiling harness (SURVEY.md §5: the reference's getTime() is
dead code; this is its live equivalent).

``StageTimer`` gives per-stage wall timings with ``block_until_ready``
semantics (device work is async — naive timing measures dispatch, not
compute).  ``trace`` wraps ``jax.profiler`` for Perfetto/XPlane dumps.
"""

from __future__ import annotations

import contextlib
import re
import time
from collections import defaultdict

import jax


class StageTimer:
    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, block_on=None):
        t0 = time.perf_counter()
        yield
        if block_on is not None:
            jax.block_until_ready(block_on)
        dt = time.perf_counter() - t0
        self.totals[name] += dt
        self.counts[name] += 1

    def time_fn(self, name: str, fn, *args, warmup: int = 1, reps: int = 5):
        """Compile-excluded average wall time of fn(*args)."""
        for _ in range(warmup):
            jax.block_until_ready(fn(*args))
        t0 = time.perf_counter()
        for _ in range(reps):
            jax.block_until_ready(fn(*args))
        dt = (time.perf_counter() - t0) / reps
        self.totals[name] += dt
        self.counts[name] += 1
        return dt

    def report(self) -> dict:
        return {
            k: {"total_s": self.totals[k], "calls": self.counts[k],
                "mean_s": self.totals[k] / max(self.counts[k], 1)}
            for k in sorted(self.totals)
        }


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler trace context (view with XProf/Perfetto)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


# ---------------------------------------------------------------------------
# trace -> device metrics
# ---------------------------------------------------------------------------
def load_device_events(log_dir: str) -> list[dict]:
    """Every event on a device plane (``/device:GPU:n``) of the newest
    ``.xplane.pb`` under ``log_dir``: name, plane, start/duration (ns) and
    stats (``hlo_op`` names the HLO instruction a kernel came from)."""
    import glob
    import os

    files = sorted(glob.glob(os.path.join(log_dir, "**", "*.xplane.pb"),
                             recursive=True), key=os.path.getmtime)
    if not files:
        raise FileNotFoundError(f"no .xplane.pb under {log_dir}")
    data = jax.profiler.ProfileData.from_file(files[-1])
    events = []
    for plane in data.planes:
        if not plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            for ev in line.events:
                events.append({
                    "plane": plane.name, "line": line.name, "name": ev.name,
                    "start_ns": ev.start_ns, "dur_ns": ev.duration_ns,
                    "stats": {k: v for k, v in ev.stats},
                })
    return events


def busy_ns(events) -> int:
    """Length of the union of the events' intervals."""
    spans = sorted((e["start_ns"], e["start_ns"] + e["dur_ns"]) for e in events)
    total, end = 0, None
    for s, t in spans:
        if end is None or s > end:
            total += t - s
            end = t
        elif t > end:
            total += t - end
            end = t
    return total


def is_device_to_host_copy(name: str) -> bool:
    n = name.lower().replace(" ", "")
    return "memcpy" in n and ("dtoh" in n or "d2h" in n)


def device_summary(events) -> dict:
    """Busy time, idle share over the traced span, kernel and copy counts."""
    if not events:
        return {"events": 0, "span_ms": 0.0, "busy_ms": 0.0,
                "idle_share": None, "d2h_copies": 0}
    start = min(e["start_ns"] for e in events)
    end = max(e["start_ns"] + e["dur_ns"] for e in events)
    busy = busy_ns(events)
    return {
        "events": len(events),
        "span_ms": (end - start) / 1e6,
        "busy_ms": busy / 1e6,
        "idle_share": 1.0 - busy / max(end - start, 1),
        "d2h_copies": sum(is_device_to_host_copy(e["name"]) for e in events),
    }


_HLO_LINE = re.compile(
    r'^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?op_name="([^"]*)"')


def hlo_op_names(hlo_text: str) -> dict:
    """HLO instruction name -> its ``op_name`` metadata (the JAX name
    stack, which carries ``jax.named_scope`` spans)."""
    out = {}
    for line in hlo_text.splitlines():
        m = _HLO_LINE.match(line)
        if m:
            out[m.group(1)] = m.group(2)
            out[m.group(1).replace(".", "_").replace("-", "_")] = m.group(2)
    return out


def time_by_scope(events, op_names: dict, scopes) -> dict:
    """Device time (ms) of the kernels whose HLO op sits under each named
    scope; a kernel counts toward the innermost scope its name stack
    holds.  Library kernels (cuBLAS, cuSOLVER) carry no HLO name inside a
    CUDA graph and count as "other"."""
    out = {s: 0.0 for s in scopes}
    out["other"] = 0.0
    for e in events:
        # inside a CUDA graph the hlo_op stat names the command buffer;
        # the kernel name is then the fusion's own name
        op = (op_names.get(str(e["stats"].get("hlo_op", "")))
              or op_names.get(e["name"], ""))
        parts = op.split("/")
        hit = next((p for p in reversed(parts) if p in out), "other")
        out[hit] += e["dur_ns"] / 1e6
    return out
