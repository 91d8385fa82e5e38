"""Numeric guards — the device-side analog of the reference's failure checks.

The reference fails hard: ``exit(EXIT_FAILURE)`` on a bad E-matrix or pose
mismatch (cam.cpp:56-59, 185-188, 220-223) and has a dead ``isNan`` helper
(defs.h:46-56).  On-device we cannot branch to exit; instead:

  * ``validate_state`` / ``validate_frame_log`` are host-side post-checks
    that raise with a diagnosis (run once per sequence, not per frame);
  * ``finite_or_previous`` is the in-graph graceful-degradation primitive:
    if an update produced non-finite values, keep the previous value — the
    moral equivalent of the reference's "reuse last pose when matching is
    too thin" fallback (my_utilities.cpp:269-273);
  * ``checked_solve`` wraps a solve with jax.experimental.checkify for
    debug runs (NaN/div-by-zero surfacing without killing the program).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


class StateValidationError(RuntimeError):
    pass


def finite_or_previous(new, old):
    """Elementwise-safe: use `new` only if ALL entries are finite."""
    ok = jnp.all(jnp.isfinite(new))
    return jnp.where(ok, new, old), ok


def validate_state(state) -> None:
    """Host-side invariant check of a VOState (raises on violation)."""
    pose = np.asarray(state.pose)
    if not np.all(np.isfinite(pose)):
        raise StateValidationError("non-finite pose")
    R = pose[:3, :3]
    if abs(np.linalg.det(R) - 1.0) > 1e-2:
        raise StateValidationError(f"pose rotation det {np.linalg.det(R):.4f} != 1")
    count = int(state.map_count)
    valid = np.asarray(state.map_valid)
    # map_count = occupancy.  With the landmark lifecycle
    # (EngineConfig.map_evict_age) evicted slots leave holes mid-map, so
    # the valid set need not be a prefix — only the occupancy count and
    # the capacity bound are invariants.
    if valid.sum() != count:
        raise StateValidationError(
            f"map_valid occupancy {int(valid.sum())} != map_count {count}")
    if not np.all(np.isfinite(np.asarray(state.map_xyz)[valid])):
        raise StateValidationError("non-finite landmark in map")


def validate_frame_log(logs) -> dict:
    """Summarize tracking health; raise if the run degenerated."""
    n_inl = np.asarray(logs.num_inliers)
    n_match = np.asarray(logs.n_map_matches)
    report = {
        "frames": len(n_inl),
        "min_inliers": int(n_inl.min()),
        "frames_below_10_matches": int((n_match < 10).sum()),
        "non_finite_chi": int((~np.isfinite(np.asarray(logs.chi_inliers))).sum()),
    }
    if report["non_finite_chi"]:
        raise StateValidationError(f"non-finite chi on {report['non_finite_chi']} frames")
    return report


def checked_solve(fn, *args):
    """Run fn under checkify NaN/div checks (debugging aid; ~2x slower)."""
    from jax.experimental import checkify

    checked = checkify.checkify(fn, errors=checkify.float_checks)
    err, out = checked(*args)
    err.throw()
    return out
