"""Fault injection for robustness testing (SURVEY.md §5 failure-detection
row: the reference's only "handling" is exit(EXIT_FAILURE); this hook lets
tests drive the engine through degraded inputs and assert graceful
degradation instead).

All injectors are pure host-side transforms of a FrameObservations batch —
the engine under test stays untouched.
"""

from __future__ import annotations

import numpy as np

from jaxvo.data.loader import FrameObservations


def drop_frames(seq: FrameObservations, frames, seed: int = 0) -> FrameObservations:
    """Invalidate all observations of the given frame indices (sensor
    dropout).  Poses/odometry stay (the loss is observational)."""
    valid = seq.valid.copy()
    n_obs = seq.n_obs.copy()
    for f in frames:
        valid[f] = False
        n_obs[f] = 0
    return seq._replace(valid=valid, n_obs=n_obs)


def corrupt_descriptors(
    seq: FrameObservations, fraction: float, sigma: float = 1.0, seed: int = 0
) -> FrameObservations:
    """Add gross noise to a random fraction of descriptors (appearance
    aliasing / sensor glitch)."""
    rng = np.random.default_rng(seed)
    desc = seq.desc.copy()
    F, N, D = desc.shape
    mask = (rng.random((F, N)) < fraction) & seq.valid
    desc[mask] += sigma * rng.standard_normal((int(mask.sum()), D)).astype(desc.dtype)
    return seq._replace(desc=desc)


def corrupt_pixels(
    seq: FrameObservations, fraction: float, magnitude: float = 100.0, seed: int = 0
) -> FrameObservations:
    """Displace a random fraction of keypoints (tracking outliers)."""
    rng = np.random.default_rng(seed)
    uv = seq.uv.copy()
    F, N, _ = uv.shape
    mask = (rng.random((F, N)) < fraction) & seq.valid
    uv[mask] += rng.uniform(-magnitude, magnitude, (int(mask.sum()), 2)).astype(uv.dtype)
    return seq._replace(uv=uv)
