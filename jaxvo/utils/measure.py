"""What every measurement records beside its numbers: the device (JAX's
view and nvidia-smi's card name and power limit), wall times with
``block_until_ready`` semantics, and a compiled program's memory use.

Shared by ``chip_smoke.py``, ``bench.py`` and ``benchmarks/gpu_bringup.py``.
"""

from __future__ import annotations

import os
import subprocess
import time

import numpy as np


def query_cards() -> str:
    """nvidia-smi's name and power limit, from a child that stays off JAX."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"
    return out.stdout.strip() if out.returncode == 0 else (
        f"nvidia-smi failed: {out.stderr.strip()}")


def parse_cards(text: str) -> list[dict]:
    """Parse ``name, power.limit`` CSV rows (one per card)."""
    cards = []
    for line in text.strip().splitlines():
        name, sep, limit = line.rpartition(",")
        if not sep:
            continue
        cards.append({"name": name.strip(), "power_limit": limit.strip()})
    return cards


def device_line(jax, cards_text: str) -> dict:
    devs = jax.devices()
    return {
        "phase": "device",
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
        "cards": parse_cards(cards_text),
        "nvidia_smi": cards_text,
        "jax": jax.__version__,
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
        "compile_cache": jax.config.jax_compilation_cache_dir,
        "matmul_precision": jax.config.jax_default_matmul_precision,
    }


def memory(compiled) -> dict:
    m = compiled.memory_analysis()
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")
    return {k: int(getattr(m, k)) for k in keys if hasattr(m, k)}


def timed(fn, reps: int) -> list[float]:
    """Wall seconds of ``reps`` calls, each waited on to completion."""
    import jax

    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        out.append(time.perf_counter() - t0)
    return out


def median(xs) -> float:
    return float(np.median(np.asarray(xs)))
