"""Functional VO state: a small pytree of fixed-capacity arrays.

The reference scatters its state across the ``Cam`` facade, the solver and
the driver's local vectors (cam.cpp, icp_test.cpp); here it is one
immutable pytree threaded through ``lax.scan`` — pose + landmark map with a
validity count (the map grows by masked scatter, never reallocation).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from jaxvo.config import EngineConfig


class VOState(NamedTuple):
    pose: jnp.ndarray        # (4, 4) camera-in-world pose of the latest frame
    map_xyz: jnp.ndarray     # (C, 3) landmark positions (world = camera-0 frame)
    map_desc: jnp.ndarray    # (C, D) landmark appearance descriptors
    map_id_real: jnp.ndarray # (C,) GT landmark id oracle (from first view)
    map_id_meas: jnp.ndarray # (C,) measurement id of the first view
    map_valid: jnp.ndarray   # (C,) slot occupancy
    map_count: jnp.ndarray   # () int32 occupied slots
    vel: jnp.ndarray         # (4, 4) last relative motion (prev pose -> pose),
                             # identity until two frames tracked; feeds the
                             # constant-velocity PICP initialization
    map_last_seen: jnp.ndarray  # (C,) i32 frame index of the landmark's last
                             # 2D-3D match (or its founding frame); drives the
                             # opt-in eviction policy (EngineConfig.map_evict_age)
    frame_idx: jnp.ndarray   # () i32 frames tracked so far (0 after bootstrap)


def empty_state(cfg: EngineConfig) -> VOState:
    C, D = cfg.map_capacity, cfg.desc_dim
    return VOState(
        pose=jnp.eye(4, dtype=jnp.float32),
        vel=jnp.eye(4, dtype=jnp.float32),
        map_xyz=jnp.zeros((C, 3), jnp.float32),
        map_desc=jnp.zeros((C, D), jnp.float32),
        map_id_real=jnp.full((C,), -1, jnp.int32),
        map_id_meas=jnp.full((C,), -1, jnp.int32),
        map_valid=jnp.zeros((C,), bool),
        map_count=jnp.int32(0),
        map_last_seen=jnp.zeros((C,), jnp.int32),
        frame_idx=jnp.int32(0),
    )


class FrameLog(NamedTuple):
    """Per-frame diagnostics (the reference's stdout narration, structured)."""

    pose: jnp.ndarray          # (4, 4) camera-in-world after tracking
    num_inliers: jnp.ndarray   # PICP inliers
    chi_inliers: jnp.ndarray
    iterations: jnp.ndarray
    converged: jnp.ndarray
    n_map_matches: jnp.ndarray  # 2D-3D matches
    n_map_correct: jnp.ndarray  # ... of which GT-correct (id_real oracle)
    n_frame_matches: jnp.ndarray  # 2D-2D matches
    n_new_points: jnp.ndarray   # landmarks triangulated this frame
    map_count: jnp.ndarray
    # silent-cap visibility: candidates beyond max_new_landmarks_per_frame
    # and appends beyond map_capacity are DROPPED — these count them so a
    # dataset denser than the caps shows up in the logs, not as invisible
    # map corruption
    n_dropped_candidates: jnp.ndarray
    n_dropped_overflow: jnp.ndarray
