"""The reference's four executables as library entry points (SURVEY.md §3).

  * run_icp      — exec/icp_test.cpp   (canonical pipeline; engine/vo.py)
  * run_vo       — exec/vo.cpp         (kernel 1000, fixed 5 GN rounds,
                                        path-length-ratio scale, per-frame
                                        map sanity check)
  * run_match_test        — exec/match_points_test.cpp
  * run_pose_recovery     — exec/pose_recovery_test.cpp
  * run_triangulate_test  — exec/triangulate_points_test.cpp
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from jaxvo.config import EngineConfig, PICPConfig
from jaxvo.data.loader import FrameObservations
from jaxvo.engine import vo as vo_mod
from jaxvo.engine.eval import EvalResult, evaluate
from jaxvo.ops import lie, picp, triangulate, twoview
from jaxvo.ops.match import match_descriptors, match_stats


def run_icp(seq: FrameObservations, cfg: EngineConfig | None = None, seed: int = 42):
    """The canonical icp_test pipeline."""
    return vo_mod.run_sequence(seq, cfg, seed)


def duplicate_landmark_count(state) -> int:
    """check_world_points_sanity (my_utilities.cpp:437-456): number of GT ids
    owning more than one map entry."""
    ids = np.asarray(state.map_id_real)[np.asarray(state.map_valid)]
    counts = np.bincount(ids[ids >= 0], minlength=1000)
    return int((counts > 1).sum())


def run_vo(seq: FrameObservations, cfg: EngineConfig | None = None, seed: int = 42):
    """The vo.cpp driver variant (exec/vo.cpp:19-251): same skeleton as
    icp_test but PICP uses kernel threshold 1000 with a fixed 5 rounds and
    no convergence check (cam.cpp:183, cam.cpp:214-216), and the final
    scale comes from the path-length ratio (vo.cpp:216-223)."""
    cfg = cfg or EngineConfig()
    cfg = cfg.replace(
        picp=PICPConfig(
            kernel_threshold=1000.0,
            max_iterations=5,
            convergence_threshold=0.0,  # never triggers: rel >= 0 > -eps
        )
    )
    state, logs, poses, diag = vo_mod.run_sequence(seq, cfg, seed)

    # path-length-ratio scale (vo.cpp:216-223) instead of Umeyama
    cam_to_image = cfg.cam_to_image()
    poses_world = np.einsum("ij,fjk->fik", cam_to_image, np.asarray(poses))
    est_t = poses_world[:, :3, 3]
    gt_T = np.asarray(lie.augment_pose(jnp.asarray(seq.gt_pose)))
    gt_t = gt_T[:, :3, 3]
    est_len = np.linalg.norm(np.diff(est_t, axis=0), axis=1).sum()
    gt_len = np.linalg.norm(np.diff(gt_t, axis=0), axis=1).sum()
    scale = float(gt_len / est_len) if est_len > 0 else 1.0
    return state, logs, poses, {**diag, "scale_path_ratio": scale,
                                "duplicates": duplicate_landmark_count(state)}


class MatchTestRow(NamedTuple):
    frame: int
    possible: int
    found: int
    correct: int


def run_match_test(seq: FrameObservations, cfg: EngineConfig | None = None):
    """match_points_test (exec/match_points_test.cpp:11-40): match every
    consecutive pair, report possible/found/GT-correct counts."""
    cfg = cfg or EngineConfig()
    F = seq.uv.shape[0]

    # all pairs in ONE vmapped dispatch and one device->host pull (the
    # per-pair loop paid a dispatch + 3 scalar round-trips per frame)
    @jax.jit
    def all_pairs(d, v, ids):
        def pair(d1, v1, i1, d2, v2, i2):
            res = match_descriptors(
                d1, v1, d2, v2,
                cfg.matcher.distance_threshold, cfg.matcher.ratio_threshold,
            )
            st = match_stats(res, i1, v1, i2, v2)
            return st.possible, st.found, st.correct

        return jax.vmap(pair)(d[:-1], v[:-1], ids[:-1], d[1:], v[1:], ids[1:])

    p, f, c = jax.device_get(all_pairs(
        jnp.asarray(seq.desc), jnp.asarray(seq.valid), jnp.asarray(seq.id_real)
    ))
    return [MatchTestRow(i, int(p[i]), int(f[i]), int(c[i]))
            for i in range(F - 1)]


def run_pose_recovery(seq: FrameObservations, cfg: EngineConfig | None = None, seed: int = 42):
    """pose_recovery_test (exec/pose_recovery_test.cpp): chain two-view
    essential-matrix poses over consecutive pairs (unit-norm translations —
    scale drift is expected), axis-remap, return (F, 4, 4) chained poses."""
    cfg = cfg or EngineConfig()
    K = jnp.asarray(cfg.K())
    F = seq.uv.shape[0]
    key = jax.random.PRNGKey(seed)

    # every pair pose is independent — one vmapped dispatch solves all
    # F-1 two-view problems; only the trivial 4x4 chaining stays on host
    @jax.jit
    def all_pair_poses(ks, d, v, uv):
        def pair_pose(k, d1, v1, uv1, d2, v2, uv2):
            res = match_descriptors(
                d1, v1, d2, v2,
                cfg.matcher.distance_threshold, cfg.matcher.ratio_threshold,
            )
            T21, rres, pres = twoview.bootstrap_pose(
                k, K, uv1, uv2[res.idx], res.valid, cfg.ransac
            )
            return T21, rres.num_inliers

        return jax.vmap(pair_pose)(
            ks, d[:-1], v[:-1], uv[:-1], d[1:], v[1:], uv[1:])

    keys = jax.random.split(key, F - 1)
    T21s, n_inl = jax.device_get(all_pair_poses(
        keys, jnp.asarray(seq.desc), jnp.asarray(seq.valid), jnp.asarray(seq.uv)
    ))
    poses = [np.eye(4, dtype=np.float32)]
    for i in range(F - 1):
        poses.append(poses[-1] @ T21s[i])
    inliers = [int(x) for x in n_inl]
    poses = np.stack(poses)
    cam_to_image = cfg.cam_to_image()
    poses_world = np.einsum("ij,fjk->fik", cam_to_image, poses)
    return poses_world, inliers


def run_triangulate_test(seq: FrameObservations, world, cfg: EngineConfig | None = None, seed: int = 42):
    """triangulate_points_test (exec/triangulate_points_test.cpp): bootstrap
    on frames 0-1, triangulate, and return (id_real, estimated-remapped
    point, GT point) triples for comparison against world.dat."""
    cfg = cfg or EngineConfig()
    key = jax.random.PRNGKey(seed)
    state, diag = vo_mod.bootstrap_jit(
        key, vo_mod.frame_of(seq, 0), vo_mod.frame_of(seq, 1), cfg
    )
    n = int(state.map_count)
    ids = np.asarray(state.map_id_real)[:n]
    pts = np.asarray(state.map_xyz)[:n]
    cam_to_image = cfg.cam_to_image()
    pts_world = pts @ cam_to_image[:3, :3].T + cam_to_image[:3, 3]
    gt_lookup = {int(i): world.xyz[k] for k, i in enumerate(world.ids)}
    gt = np.stack([gt_lookup.get(int(i), np.full(3, np.nan)) for i in ids])
    return ids, pts_world, gt
