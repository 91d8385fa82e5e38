"""SLAM-mode tracking: the frame-to-frame tracker with an interleaved
local bundle-adjustment backend, as ONE compiled program.

NEW layer with no reference counterpart.  The reference (and the plain
``run_sequence`` tracker replicating it, exec/icp_test.cpp:61-136) never
revisits a pose: each frame's PICP solve is final, and newly triangulated
landmarks inherit whatever scale that single solve carried.  On
KITTI-scale forward motion (~1 m/frame) that per-frame scale handoff is
an un-damped multiplicative feedback loop — measured collapse to 20 m of
estimated path on a 199 m ground-truth loop (ATE 28.6).  Interleaving a
sliding-window BA (the standard modern-VO "local mapping" backend —
PTAM/ORB-SLAM architecture) re-estimates the last W poses and their
landmarks jointly every E frames, replacing the per-frame handoff with a
well-conditioned multi-view one: the same sequence tracks to ATE 0.46
(round-4 defaults), and the full backend stack (loop closure ba/loop.py +
graduated global BA engine/ba_refine.py) recovers ATE 0.077.

Accelerator-first: the whole run — every track step, every window
re-match, every BA solve — is a single ``lax.scan`` program.  The BA fires
inside ``lax.cond`` (a true branch: skipped steps cost nothing), window
extraction is a dynamic slice of the carried (F, 4, 4) pose array, and
the solve is the same Schur-complement ``ba_solve`` the offline refiners
and the sharded multi-chip path use (ba/window.py).
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from jaxvo.ba.window import BAProblem, ba_solve
from jaxvo.config import BAConfig, EngineConfig
from jaxvo.engine import vo
from jaxvo.ops import lie


def _check_evict_age(cfg: EngineConfig) -> None:
    """Ring-buffer observations reference map slots for up to W*S+E
    frames; reusing a slot inside that horizon would silently bind old
    observations to a NEW landmark in the local BA — fail loud.  Shared
    by every SLAM entry point (batch and streaming)."""
    horizon = (cfg.local_ba_window * cfg.local_ba_stride
               + cfg.local_ba_every)
    if 0 < cfg.map_evict_age <= horizon:
        raise ValueError(
            f"map_evict_age={cfg.map_evict_age} must exceed the ring "
            f"horizon local_ba_window*local_ba_stride+local_ba_every="
            f"{horizon} in SLAM mode")


def _local_ba_cfg(cfg: EngineConfig) -> BAConfig:
    return BAConfig(
        window=cfg.local_ba_window,
        iterations=cfg.local_ba_iterations,
        huber_threshold=cfg.ba.huber_threshold,
        lm_adaptive=cfg.ba.lm_adaptive,
        max_landmarks=cfg.map_capacity,
        cull_bounds=False,  # refinement semantics (see BAConfig.cull_bounds)
        assembly="onehot",  # matmul landmark-block assembly (see
                            # BAConfig.assembly)
        compact_cap=cfg.local_ba_compact_cap,
        compact_method="mask",  # sort-free renumbering (see BAConfig)
        damping_init=cfg.local_ba_damping_init,
    )


@partial(jax.jit, static_argnames=("cfg",))
def _slam_scan(state, poses_all, frames_curr: vo.Frame,
               frames_next: vo.Frame, cfg: EngineConfig):
    """Track frames 1..F-1 with interleaved local BA.  Returns
    (final state, corrected poses_all, FrameLog stack, n_ba_runs).

    ``frames_curr``/``frames_next``: the (F-1)-step frame pairs, scanned
    as scan-xs exactly like the plain tracker.

    Structure: everything the local-BA branch needs lives in the scan
    carry —

      * ring buffers (slot = frame % W) of each frame's 2D-3D map
        correspondences — indices, validity AND pixels — as computed by
        the tracker itself, replacing round 3's 16-frame re-match
        against the full map inside the branch;
      * plus the founding (next-view) observation of each landmark
        appended that step, which no later map lookup could recover for
        its first frame (dropping these cost ~0.5 ATE on the 200-frame
        loop fixture — ring buffers with founding obs measure ATE 1.00
        vs the old re-match's 1.05).

    A frame's carried matches only see landmarks that existed when it was
    tracked (standard local-mapping semantics).
    """
    def step(carry, xs):
        curr, nxt = xs
        carry, log = slam_step(carry, curr, nxt, cfg)
        return carry, vo._pack_log(log)

    N = frames_curr.uv.shape[1]
    Nb = N + cfg.max_new_landmarks_per_frame
    R = cfg.local_ba_window * cfg.local_ba_stride
    buf_lm = jnp.zeros((R, Nb), jnp.int32)
    buf_valid = jnp.zeros((R, Nb), bool)
    buf_uv = jnp.zeros((R, Nb, 2), jnp.float32)
    (state, poses_all, _, _, _, n_ba, _), (poses_y, stats_y) = jax.lax.scan(
        step,
        (state, poses_all, buf_lm, buf_valid, buf_uv, jnp.int32(0),
         jnp.int32(1)),
        (frames_curr, frames_next))
    return state, poses_all, vo._unpack_logs(poses_y, stats_y), n_ba


def slam_step(carry, curr: vo.Frame, nxt: vo.Frame, cfg: EngineConfig):
    """One SLAM step: track + ring-buffer write + conditional local BA.

    carry = (state, poses_all (F, 4, 4), buf_lm (R, Nb), buf_valid,
    buf_uv, n_ba, k); returns (carry', FrameLog).  Shared by the scanned
    whole-sequence program (_slam_scan) and the streaming OnlineSLAM
    session — identical math by construction.
    """
    K = jnp.asarray(cfg.K())
    W = cfg.local_ba_window
    E = cfg.local_ba_every
    S = cfg.local_ba_stride
    R = W * S                            # ring depth = temporal horizon
    ba_cfg = _local_ba_cfg(cfg)

    def do_ba(carry):
        # SLIM operands: the cond materializes every operand buffer on
        # entry/exit of the taken branch, so threading the full VOState
        # through copies the whole map per invocation; only what the solve
        # touches crosses the branch — map_desc/id arrays (~370 KB) stay
        # outside in the scan carry.
        map_xyz, map_valid, poses_all, buf_lm, buf_valid, buf_uv, k = carry
        # keyframe-strided window: W frames spaced S apart ending at k
        # (S=1 == the classic contiguous sliding window); frame f lives
        # in ring slot f % R
        idxs = k - S * (W - 1 - jnp.arange(W, dtype=jnp.int32))
        ring = jnp.mod(idxs, R)
        win_poses = poses_all[idxs]
        wic = jax.vmap(lie.inv_se3)(win_poses)
        fixed = jnp.arange(W) < 2  # gauge+scale anchor to the prefix
        prob = BAProblem(
            poses=wic, points=map_xyz, obs_uv=buf_uv[ring],
            obs_lm=buf_lm[ring], obs_valid=buf_valid[ring],
            point_valid=map_valid, fixed=fixed,
        )
        prob2, _ = ba_solve(prob, K, cfg.width, cfg.height, ba_cfg)
        ok = jnp.all(jnp.isfinite(prob2.poses)) & jnp.all(
            jnp.isfinite(prob2.points))
        new_cw = jax.vmap(lie.inv_se3)(prob2.poses)
        upd = jnp.where((ok & ~fixed)[:, None, None], new_cw, win_poses)
        # keyframe-only correction: non-keyframe poses keep their tracked
        # values.  A rigid retro-propagation of each keyframe's delta to
        # its trailing segment was tried and measured WORSE on both the
        # 60-frame fixture (ATE 1.40 -> 15.5) and conceptually couples
        # every past pose to the newest solve's noise; corrections still
        # flow forward because each new frame tracks from the corrected
        # poses_all[k].
        poses_all = poses_all.at[idxs].set(upd)
        map_xyz = jnp.where(ok, prob2.points, map_xyz)
        return map_xyz, poses_all, jnp.int32(1)

    state, poses_all, buf_lm, buf_valid, buf_uv, n_ba, k = carry
    state, log, (m_idx, m_valid, new_slots, new_uv, new_valid) = (
        vo.track_step(state, curr, nxt, cfg, return_matches=True))
    poses_all = poses_all.at[k].set(log.pose)
    slot = jnp.mod(k, R)
    buf_lm = buf_lm.at[slot].set(
        jnp.concatenate([m_idx, new_slots]))
    buf_valid = buf_valid.at[slot].set(
        jnp.concatenate([m_valid, new_valid]))
    buf_uv = buf_uv.at[slot].set(
        jnp.concatenate([nxt.uv, new_uv], axis=0))
    map_xyz, poses_all, ran = jax.lax.cond(
        (k >= R) & (k % E == 0),
        do_ba,
        lambda c: (c[0], c[2], jnp.int32(0)),
        (state.map_xyz, state.map_valid, poses_all, buf_lm, buf_valid,
         buf_uv, k),
    )
    # poses_all[k] is log.pose when BA did not run and the BA-corrected
    # newest pose when it did — either way the tracker resumes from it
    state = state._replace(map_xyz=map_xyz, pose=poses_all[k])
    return (state, poses_all, buf_lm, buf_valid, buf_uv,
            n_ba + ran, k + 1), log


from functools import partial as _partial

slam_step_jit = _partial(jax.jit, static_argnames=("cfg",))(slam_step)


class OnlineSLAM:
    """Streaming SLAM session: OnlineVO's serving interface with the
    interleaved local-BA backend — one ``slam_step_jit`` dispatch per
    frame, the SAME step function the scanned whole-sequence program
    runs, so trajectories match run_sequence_slam exactly.

        s = OnlineSLAM(cfg, max_frames=1000)
        s.start(f0, f1)
        for frame in stream:
            pose = s.step(frame)     # BA-corrected camera-in-world
        s.poses[: s.frame_count]     # trajectory incl. retro-corrections

    ``max_frames`` bounds the preallocated pose buffer (static shapes).
    """

    def __init__(self, cfg: EngineConfig | None = None,
                 max_frames: int = 1024, seed: int = 42):
        self.cfg = cfg or EngineConfig()
        self.max_frames = max_frames
        self._key = jax.random.PRNGKey(seed)
        self._carry = None
        self._prev = None
        self.frame_count = 0

    def start(self, f0: vo.Frame, f1: vo.Frame) -> dict:
        cfg = self.cfg
        _check_evict_age(cfg)
        state, diag = vo.bootstrap_jit(self._key, f0, f1, cfg)
        N = f0.uv.shape[0]
        Nb = N + cfg.max_new_landmarks_per_frame
        R = cfg.local_ba_window * cfg.local_ba_stride
        poses_all = jnp.broadcast_to(
            jnp.eye(4, dtype=jnp.float32), (self.max_frames, 4, 4)).copy()
        self._carry = (
            state, poses_all,
            jnp.zeros((R, Nb), jnp.int32), jnp.zeros((R, Nb), bool),
            jnp.zeros((R, Nb, 2), jnp.float32), jnp.int32(0), jnp.int32(1))
        self._prev = f0
        # poses in the trajectory (frame 0's identity); +1 per step —
        # so ``poses[: frame_count]`` is exactly the trajectory so far
        self.frame_count = 1
        return diag

    def step(self, frame: vo.Frame):
        if self._carry is None:
            raise RuntimeError("call start(f0, f1) before step()")
        # guard on the HOST-side counter (== the carried k): reading the
        # traced k back would force a device sync per frame in the
        # serving hot loop
        if self.frame_count >= self.max_frames:
            raise RuntimeError("max_frames exceeded — raise the buffer size")
        self._carry, log = slam_step_jit(
            self._carry, self._prev, frame, self.cfg)
        self._prev = frame
        self.frame_count += 1
        return self._carry[1][self.frame_count - 1]

    @property
    def state(self):
        return self._carry[0]

    @property
    def poses(self):
        """(max_frames, 4, 4) camera-in-world, BA-corrected; rows at
        ``frame_count`` and beyond are identity padding."""
        return self._carry[1]

    @property
    def n_local_ba_runs(self):
        return int(self._carry[5])


def run_sequence_slam(seq, cfg: EngineConfig | None = None, seed: int = 42
                      ) -> Tuple[object, object, jnp.ndarray, dict]:
    """End-to-end SLAM-mode VO: bootstrap + tracking with local BA.

    Same signature/returns as ``vo.run_sequence``: (final state, logs,
    poses (F, 4, 4) camera-in-world, diag).  The returned poses include
    the local-BA corrections (``logs.pose`` keeps the raw per-frame
    tracking estimates for diagnostics).
    """
    cfg = cfg or EngineConfig()
    _check_evict_age(cfg)
    key = jax.random.PRNGKey(seed)
    F = seq.uv.shape[0]

    f0 = vo.frame_of(seq, 0)
    f1 = vo.frame_of(seq, 1)
    state, diag = vo.bootstrap_jit(key, f0, f1, cfg)

    poses_all = jnp.broadcast_to(
        jnp.eye(4, dtype=jnp.float32), (F, 4, 4)).copy()
    state, poses_all, logs, n_ba = _slam_scan(
        state, poses_all, vo.frames_of(seq, 0, F - 1),
        vo.frames_of(seq, 1, F), cfg)
    diag = dict(diag)
    diag["n_local_ba_runs"] = n_ba
    return state, logs, poses_all, diag
