"""Masked pinhole projection (semantics of pr::Camera, src/camera.h:24-36).

The reference's ``projectPoint`` returns false (and ``projectPoints`` marks
``(-1,-1)``, camera.cpp:14-35) when a point is behind the camera (z <= 0) or
projects outside [0, cols-1] x [0, rows-1].  Here validity is a boolean
mask, not control flow, and the whole batch projects in one fused pass.
"""

from __future__ import annotations

import jax.numpy as jnp


def project_points(K, world_in_camera_T, pts, width: int, height: int):
    """Project (N, 3) world points through a 4x4 world-in-camera transform.

    Returns (uv (N, 2) float32, valid (N,) bool).  Matches projectPoint
    (camera.h:24-36): cull z <= 0, dehomogenize, cull outside
    [0, width-1] x [0, height-1].  Invalid entries keep their computed uv
    (callers must consult the mask; there is no (-1,-1) sentinel — that was
    an artifact of the reference's dynamic-size output).
    """
    R = world_in_camera_T[..., :3, :3]
    t = world_in_camera_T[..., :3, 3]
    p_cam = pts @ R.T + t  # (N, 3)
    z = p_cam[..., 2]
    phom = p_cam @ K.T  # (N, 3)
    # guard the divide; invalidity is tracked by the mask
    iz = 1.0 / jnp.where(jnp.abs(phom[..., 2]) > 1e-12, phom[..., 2], 1.0)
    uv = phom[..., :2] * iz[..., None]
    in_front = z > 0.0
    in_bounds = (
        (uv[..., 0] >= 0.0)
        & (uv[..., 0] <= width - 1)
        & (uv[..., 1] >= 0.0)
        & (uv[..., 1] <= height - 1)
    )
    return uv, in_front & in_bounds


def project_points_with_cam(K, world_in_camera_T, pts, width: int, height: int):
    """Like project_points but also returns the camera-frame points and the
    K-homogeneous points — the PICP Jacobian needs both (picp_solver.cpp:37-49).
    """
    R = world_in_camera_T[..., :3, :3]
    t = world_in_camera_T[..., :3, 3]
    p_cam = pts @ R.T + t
    phom = p_cam @ K.T
    iz = 1.0 / jnp.where(jnp.abs(phom[..., 2]) > 1e-12, phom[..., 2], 1.0)
    uv = phom[..., :2] * iz[..., None]
    in_front = p_cam[..., 2] > 0.0
    in_bounds = (
        (uv[..., 0] >= 0.0)
        & (uv[..., 0] <= width - 1)
        & (uv[..., 1] >= 0.0)
        & (uv[..., 1] <= height - 1)
    )
    return uv, in_front & in_bounds, p_cam, phom
