"""Landmark-sharded distributed bundle adjustment (the flagship collective).

MegBA-style distributed Schur (SURVEY.md §5): landmarks (and the
observations that reference them) are partitioned across devices; each
device linearizes only its own observations, Schur-eliminates its landmark
blocks locally (block-diagonal => embarrassingly parallel), and contributes
a partial reduced camera system.  The ONLY cross-device traffic per
iteration is ``psum`` of the (6W)^2 + 6W reduced system — independent of
the landmark count — which XLA hands to NCCL (NVLink within a host).  Every device then
solves the same small dense system (replicated, cheaper than sharding it)
and back-substitutes its local landmarks with zero further communication.

Scaling to 100k+ landmarks across N >= 2 hosts is a data-layout exercise:
``shard_ba_problem`` partitions observations by landmark owner on the host;
the per-iteration math is identical to the single-chip path
(jaxvo/ba/window.py — shared helpers, one code path to trust).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P
from jax import shard_map

from jaxvo.ba.window import (
    BAProblem,
    BAStats,
    backsubstitute,
    finalize_reduced,
    invert_hll,
    linearize_ba,
    schur_parts,
)
from jaxvo.config import BAConfig


class ShardedBAProblem(NamedTuple):
    """BAProblem re-laid-out with a leading shard axis.

    poses:     (W, 4, 4) — replicated
    points:    (S, Ls, 3) — landmark shard per device (local index space)
    point_valid: (S, Ls)
    obs_uv:    (S, W, Np, 2) — observations owned by each shard
    obs_lm:    (S, W, Np) int32 — LOCAL landmark indices
    obs_valid: (S, W, Np)
    fixed:     (W,) — replicated
    lm_perm:   (S * Ls,) global landmark id of each (shard, slot) — host-side
               bookkeeping for scattering results back
    """

    poses: jnp.ndarray
    points: jnp.ndarray
    point_valid: jnp.ndarray
    obs_uv: jnp.ndarray
    obs_lm: jnp.ndarray
    obs_valid: jnp.ndarray
    fixed: jnp.ndarray
    lm_perm: np.ndarray   # (S, Ls) new-local -> original-local (host bookkeeping)
    active: int = 0       # static: per-shard observed-landmark prefix length


def shard_ba_problem(problem: BAProblem, n_shards: int, obs_pad_to: int | None = None) -> ShardedBAProblem:
    """Host-side partitioner: contiguous landmark blocks -> shards, and each
    observation moves to its landmark's owner (re-padded per (shard, frame))."""
    poses = np.asarray(problem.poses)
    points = np.asarray(problem.points)
    pvalid = np.asarray(problem.point_valid)
    obs_uv = np.asarray(problem.obs_uv)
    obs_lm = np.asarray(problem.obs_lm)
    obs_valid = np.asarray(problem.obs_valid)
    W, N = obs_lm.shape
    L = points.shape[0]
    Ls = -(-L // n_shards)
    L_pad = Ls * n_shards

    pts_pad = np.zeros((L_pad, 3), points.dtype)
    pts_pad[:L] = points
    pv_pad = np.zeros(L_pad, bool)
    pv_pad[:L] = pvalid

    owner = obs_lm // Ls          # (W, N) shard of each observation
    local = obs_lm - owner * Ls   # local landmark slot

    # per-(shard, frame) packing
    if obs_pad_to is None:
        obs_pad_to = 0
        for s in range(n_shards):
            for f in range(W):
                obs_pad_to = max(obs_pad_to, int(((owner[f] == s) & obs_valid[f]).sum()))
        obs_pad_to = max(8, obs_pad_to)
    s_uv = np.zeros((n_shards, W, obs_pad_to, 2), obs_uv.dtype)
    s_lm = np.zeros((n_shards, W, obs_pad_to), np.int32)
    s_valid = np.zeros((n_shards, W, obs_pad_to), bool)
    for s in range(n_shards):
        for f in range(W):
            rows = np.nonzero((owner[f] == s) & obs_valid[f])[0][:obs_pad_to]
            n = len(rows)
            s_uv[s, f, :n] = obs_uv[f, rows]
            s_lm[s, f, :n] = local[f, rows]
            s_valid[s, f, :n] = True

    # Active-first renumbering: each shard's OBSERVED landmarks move to the
    # front of its local index space, so the per-iteration Schur assembly
    # (Hll/Wfl/back-substitution) only touches an O(#local obs) prefix
    # instead of all Ls slots — the difference between O(L·W) and
    # O(obs·W) work at 100k+ landmarks.
    pts_sh = pts_pad.reshape(n_shards, Ls, 3).copy()
    pv_sh = pv_pad.reshape(n_shards, Ls).copy()
    lm_perm = np.zeros((n_shards, Ls), np.int64)  # new local -> original local
    max_active = 8
    for s in range(n_shards):
        seen = np.unique(s_lm[s][s_valid[s]])
        rest = np.setdiff1d(np.arange(Ls), seen, assume_unique=False)
        perm = np.concatenate([seen, rest])
        lm_perm[s] = perm
        inv = np.empty(Ls, np.int64)
        inv[perm] = np.arange(Ls)
        s_lm[s] = inv[s_lm[s]].astype(np.int32)
        pts_sh[s] = pts_sh[s][perm]
        pv_sh[s] = pv_sh[s][perm]
        max_active = max(max_active, len(seen))
    active = min(Ls, -(-max_active // 8) * 8)

    return ShardedBAProblem(
        poses=jnp.asarray(poses),
        points=jnp.asarray(pts_sh),
        point_valid=jnp.asarray(pv_sh),
        obs_uv=jnp.asarray(s_uv),
        obs_lm=jnp.asarray(s_lm),
        obs_valid=jnp.asarray(s_valid),
        fixed=jnp.asarray(np.asarray(problem.fixed)),
        lm_perm=lm_perm,
        active=active,
    )


def _local_step(poses, points, point_valid, obs_uv, obs_lm, obs_valid, fixed,
                K, width, height, cfg: BAConfig, axis: str, active: int = 0):
    """Per-shard BA iteration body (runs under shard_map).

    ``active``: observed landmarks occupy the first ``active`` local slots
    (see shard_ba_problem's renumbering); the Schur assembly and
    back-substitution run on that prefix only.

    Exactly ONE collective per iteration: S_c (6W, 6W), b_c (6W) and the 3
    stat scalars ride a single fused psum buffer — collectives are
    latency-bound, so one big message beats five small ones (measured 9x
    per-iteration overhead from the unfused version on the 2-device CPU
    mesh; over NVLink not yet measured).

    Returns (new_poses, new_points, stats) with stats already reduced.
    """
    La = active if active else points.shape[0]
    pts_act = points[:La]
    pv_act = point_valid[:La]
    local = BAProblem(
        poses=poses, points=pts_act, obs_uv=obs_uv, obs_lm=obs_lm,
        obs_valid=obs_valid, point_valid=pv_act, fixed=fixed,
    )
    Hpp, bp, Hll, bl, Wfl, stats = linearize_ba(local, K, width, height, cfg)
    S_c, b_c, _ = schur_parts(Hpp, bp, Hll, bl, Wfl, cfg.damping)

    # THE collective: one psum of [S | b | stats] (ints < 2^24 exact in f32)
    n = S_c.shape[0]
    extra = jnp.stack([
        stats.chi.astype(jnp.float32),
        stats.num_inliers.astype(jnp.float32),
        stats.num_obs.astype(jnp.float32),
    ])
    buf = jnp.concatenate(
        [S_c, b_c[:, None],
         jnp.concatenate([extra, jnp.zeros(n - 3, jnp.float32)])[:, None]],
        axis=1,
    )  # (6W, 6W + 2)
    buf = jax.lax.psum(buf, axis)
    S, b_red = buf[:, :n], buf[:, n]
    stats = BAStats(
        chi=buf[0, n + 1],
        num_inliers=buf[1, n + 1].astype(jnp.int32),
        num_obs=buf[2, n + 1].astype(jnp.int32),
    )

    S, b_red = finalize_reduced(S, b_red, fixed, cfg.damping)
    c, low = jax.scipy.linalg.cho_factor(S)
    dx_p = jax.scipy.linalg.cho_solve((c, low), -b_red).reshape(-1, 6)

    Hll_inv = invert_hll(Hll, cfg.damping)
    dx_l = backsubstitute(Hll_inv, bl, Wfl, dx_p)

    from jaxvo.ops import lie

    new_poses = jax.vmap(lambda d, T: lie.se3_exp(d) @ T)(dx_p, poses)
    new_poses = jnp.where(fixed[:, None, None], poses, new_poses)
    touched = Hll[:, 0, 0] + Hll[:, 1, 1] + Hll[:, 2, 2] > 0
    upd = pv_act & touched
    new_active = jnp.where(upd[:, None], pts_act + dx_l, pts_act)
    new_points = jnp.concatenate([new_active, points[La:]], axis=0)
    return new_poses, new_points, stats


def sharded_ba_step(mesh, sp: ShardedBAProblem, K, width, height, cfg: BAConfig,
                    axis: str = "lm"):
    """One distributed BA iteration over the mesh."""

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P(axis), P(axis), P(axis), P(axis), P(axis), P()),
        out_specs=(P(), P(axis), P()),
        check_vma=False,
    )
    def step(poses, points, point_valid, obs_uv, obs_lm, obs_valid, fixed):
        new_poses, new_points, stats = _local_step(
            poses, points[0], point_valid[0], obs_uv[0], obs_lm[0],
            obs_valid[0], fixed, K, width, height, cfg, axis, sp.active,
        )
        return new_poses, new_points[None], stats

    poses, points, stats = step(
        sp.poses, sp.points, sp.point_valid, sp.obs_uv, sp.obs_lm,
        sp.obs_valid, sp.fixed,
    )
    return sp._replace(poses=poses, points=points), stats


def sharded_ba_solve(mesh, sp: ShardedBAProblem, K, width, height, cfg: BAConfig,
                     axis: str = "lm"):
    """cfg.iterations distributed BA steps under one jit."""

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P(axis), P(axis), P(axis), P(axis), P(axis), P()),
        out_specs=(P(), P(axis), P()),
        check_vma=False,
    )
    def solve(poses, points, point_valid, obs_uv, obs_lm, obs_valid, fixed):
        def body(_, carry):
            ps, pt, _ = carry
            ps2, pt2, stats = _local_step(
                ps, pt, point_valid[0], obs_uv[0], obs_lm[0], obs_valid[0],
                fixed, K, width, height, cfg, axis, sp.active,
            )
            return ps2, pt2, stats

        dummy = BAStats(jnp.float32(0), jnp.int32(0), jnp.int32(0))
        ps, pt, stats = jax.lax.fori_loop(
            0, cfg.iterations, body, (poses, points[0], dummy)
        )
        return ps, pt[None], stats

    poses, points, stats = solve(
        sp.poses, sp.points, sp.point_valid, sp.obs_uv, sp.obs_lm,
        sp.obs_valid, sp.fixed,
    )
    return sp._replace(poses=poses, points=points), stats


def gather_points(sp: ShardedBAProblem, L: int):
    """Collect the sharded landmark estimates back to a (L, 3) array,
    undoing the active-first renumbering."""
    pts_sh = np.asarray(sp.points)  # (S, Ls, 3)
    S, Ls, _ = pts_sh.shape
    out = np.zeros((S * Ls, 3), pts_sh.dtype)
    for s in range(S):
        out[s * Ls + np.asarray(sp.lm_perm[s])] = pts_sh[s]
    return out[:L]
