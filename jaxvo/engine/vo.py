"""The VO engine: bootstrap + per-frame tracking, fully on-device.

Replicates the canonical ``icp_test`` pipeline (exec/icp_test.cpp:17-136):

  bootstrap (frames 0, 1):
    match 2D-2D -> essential-matrix RANSAC -> recoverPose -> DLT
    triangulation of *all* matches into the initial map
    (icp_test.cpp:40-58; the estimated bootstrap pose is NOT pushed to the
    trajectory — poses stay [Identity], icp_test.cpp:59)

  per frame i in [0, 120):
    match frame i+1 vs map (2D-3D)            icp_test.cpp:75
    PICP from the previous pose, kernel 3000  icp_test.cpp:79-111
    match frame i vs frame i+1 (2D-2D)        icp_test.cpp:122
    triangulate matches not yet in the map    icp_test.cpp:124-132
    append new landmarks (first-view descriptor/ids, cam.cpp:122-139)

Accelerator-first: the tracking loop is ONE ``lax.scan`` over the whole
sequence — the entire 121-frame run compiles to a single XLA program with
no per-frame host work (the XLA PICP while_loop still reads its predicate
back per GN round on a GPU; the fused kernel does not).  Map growth is a
masked scatter into preallocated slots.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from jaxvo.config import EngineConfig
from jaxvo.engine.state import FrameLog, VOState, empty_state
from jaxvo.ops import lie, picp, triangulate, twoview
from jaxvo.ops.match import match_descriptors


class Frame(NamedTuple):
    """One frame's padded observations (device-side slice of the sequence)."""

    uv: jnp.ndarray       # (N, 2)
    desc: jnp.ndarray     # (N, D)
    id_meas: jnp.ndarray  # (N,)
    id_real: jnp.ndarray  # (N,)
    valid: jnp.ndarray    # (N,)


def frame_of(seq, i: int) -> Frame:
    return Frame(
        jnp.asarray(seq.uv[i]),
        jnp.asarray(seq.desc[i]),
        jnp.asarray(seq.id_meas[i]),
        jnp.asarray(seq.id_real[i]),
        jnp.asarray(seq.valid[i]),
    )


def frames_of(seq, lo: int, hi: int) -> Frame:
    return Frame(
        jnp.asarray(seq.uv[lo:hi]),
        jnp.asarray(seq.desc[lo:hi]),
        jnp.asarray(seq.id_meas[lo:hi]),
        jnp.asarray(seq.id_real[lo:hi]),
        jnp.asarray(seq.valid[lo:hi]),
    )


@jax.named_scope("map_update")
def _append_to_map(state: VOState, xyz, desc, id_real, id_meas, new_mask,
                   reuse_slots: bool = False):
    """Masked append preserving source-row order (push_back semantics).

    xyz: (N, 3) candidate landmarks; new_mask: (N,) which to insert.
    Entries that would overflow capacity are dropped (the reference's vector
    grows unboundedly; our capacity is sized so this never triggers on the
    bundled data — see EngineConfig.map_capacity).

    reuse_slots=False (parity): candidates land in sequential slots from
    ``map_count`` — exact push_back order.  True (lifecycle mode,
    EngineConfig.map_evict_age): candidates fill the FREE slots
    (``~map_valid`` — never-used or evicted) in ascending slot order, so
    evicted slots are recycled; still one one-hot matmul, no scatter.

    Returns (state, n_added, cand_slots (N,) i32 — the slot each candidate
    landed in (C when dropped), ok (N,) bool — actually inserted).
    """
    C = state.map_xyz.shape[0]
    slots = jnp.arange(C, dtype=jnp.int32)
    offs = jnp.cumsum(new_mask.astype(jnp.int32)) - 1  # position among kept
    if reuse_slots:
        free = ~state.map_valid
        # slot c takes candidate i iff rank-among-free(c) == offs[i]
        rank = jnp.where(free, jnp.cumsum(free.astype(jnp.int32)) - 1, -1)
        n_free = jnp.sum(free.astype(jnp.int32))
        ok = new_mask & (offs < n_free)
        tgt_rank = jnp.where(ok, offs, -2)
        onehot = (rank[:, None] == tgt_rank[None, :]).astype(xyz.dtype)  # (C, N)
        # per-candidate landing slot (exact through f32: C < 2^24)
        cand_slots = jnp.where(
            ok,
            jnp.dot(slots.astype(jnp.float32), onehot).astype(jnp.int32),
            C)
    else:
        pos = state.map_count + offs
        ok = new_mask & (pos < C)
        # One-hot matmul scatter: scatters serialized on the first target;
        # target positions are unique, so the append is exactly a (C, N)
        # one-hot times the value rows — matmul work instead.
        cand_slots = jnp.where(ok, pos, C)
        onehot = (slots[:, None] == cand_slots[None, :]).astype(xyz.dtype)  # (C, N)
    hit = jnp.sum(onehot, axis=1)  # (C,) 0/1
    keep = 1.0 - hit

    # all four arrays ride ONE one-hot matmul: concat the value columns
    # (int ids are small — exact through the f32 matmul)
    D = desc.shape[1]
    vals = jnp.concatenate(
        [xyz, desc, id_real.astype(jnp.float32)[:, None],
         id_meas.astype(jnp.float32)[:, None]], axis=1,
    )  # (N, 3 + D + 2)
    upd = jnp.dot(onehot, vals, preferred_element_type=jnp.float32)  # (C, 3+D+2)

    map_xyz = state.map_xyz * keep[:, None] + upd[:, :3]
    map_desc = state.map_desc * keep[:, None] + upd[:, 3:3 + D]
    map_id_real = jnp.where(
        hit > 0.5, jnp.round(upd[:, 3 + D]).astype(state.map_id_real.dtype),
        state.map_id_real)
    map_id_meas = jnp.where(
        hit > 0.5, jnp.round(upd[:, 4 + D]).astype(state.map_id_meas.dtype),
        state.map_id_meas)
    map_valid = state.map_valid | (hit > 0.5)
    # founding observation counts as "seen now" for the eviction clock
    map_last_seen = jnp.where(hit > 0.5, state.frame_idx, state.map_last_seen)
    n_added = jnp.sum(ok).astype(jnp.int32)
    # map_count = occupancy (== cumulative appends when nothing is evicted)
    map_count = jnp.sum(map_valid.astype(jnp.int32))
    return (
        state._replace(
            map_xyz=map_xyz,
            map_desc=map_desc,
            map_id_real=map_id_real,
            map_id_meas=map_id_meas,
            map_valid=map_valid,
            map_count=map_count,
            map_last_seen=map_last_seen,
        ),
        n_added,
        cand_slots,
        ok,
    )


@jax.named_scope("bootstrap")
def bootstrap(key, f0: Frame, f1: Frame, cfg: EngineConfig) -> Tuple[VOState, dict]:
    """Two-view initialization (icp_test.cpp:40-58). Jittable.

    Returns the initial state (pose = identity — the reference does not push
    the bootstrap pose) and diagnostics including the recovered camera-1
    pose T_boot used for triangulation.
    """
    K = jnp.asarray(cfg.K())
    res = match_descriptors(
        f0.desc, f0.valid, f1.desc, f1.valid,
        cfg.matcher.distance_threshold, cfg.matcher.ratio_threshold,
        cfg.matcher.method,
    )
    uv2 = f1.uv[res.idx]
    T_boot, rres, pres = twoview.bootstrap_pose(
        key, K, f0.uv, uv2, res.valid, cfg.ransac
    )
    # triangulate ALL matches (no inlier mask — cam.cpp:94-140 quirk)
    pts, finite = triangulate.triangulate_two_view(
        K, jnp.eye(4, dtype=jnp.float32), T_boot, f0.uv, uv2,
        refine_iterations=cfg.triangulation_refine_iters,
    )
    state = empty_state(cfg)
    state, n_added, _, _ = _append_to_map(
        state, pts, f0.desc, f0.id_real, f0.id_meas, res.valid
    )
    diag = {
        "T_boot": T_boot,
        "n_matches": jnp.sum(res.valid),
        "n_ransac_inliers": rres.num_inliers,
        "n_map_points": n_added,
    }
    return state, diag


def track_step(state: VOState, curr: Frame, nxt: Frame, cfg: EngineConfig,
               kernel_threshold=None, return_matches: bool = False):
    """One tracking iteration (icp_test.cpp:61-136). Jittable, scannable.

    kernel_threshold: optional traced scalar overriding cfg.picp's robust
    threshold — lets a whole tracker run be vmapped over a threshold axis
    (the batched inlier-rejection sweep).

    return_matches: additionally return the frame's map observations for
    the SLAM-mode ring buffer (engine/slam.py):
    ``(m_map.idx, m_map.valid, new_slots, new_uv, new_valid)`` — the 2D-3D
    correspondences of this frame against the (pre-append) map, plus the
    map slots and next-frame pixels of the landmarks appended THIS step
    (their founding observation, which no later re-match against the map
    could recover for this frame).  Carrying these lets the local-BA
    branch run entirely from scan state — no re-matching, and slightly
    BETTER accuracy than the re-match it replaced (loop-fixture ATE 1.00
    vs 1.05; see DESIGN.md §10)."""
    K = jnp.asarray(cfg.K())
    # frame clock (drives the landmark-eviction policy; bootstrap = 0)
    state = state._replace(frame_idx=state.frame_idx + 1)

    # --- 2D-3D: match next frame's descriptors against the map -----------
    # (and, when fused, the 2D-2D curr->next match in the same kernel chain)
    m_img = None
    if cfg.fuse_frame_matchers:
        from jaxvo.ops.match import match_descriptors_pair

        m_map, m_img = match_descriptors_pair(
            nxt.desc, nxt.valid, state.map_desc, state.map_valid,
            curr.desc, curr.valid, nxt.desc, nxt.valid,
            cfg.matcher.distance_threshold, cfg.matcher.ratio_threshold,
        )
    else:
        m_map = match_descriptors(
            nxt.desc, nxt.valid, state.map_desc, state.map_valid,
            cfg.matcher.distance_threshold, cfg.matcher.ratio_threshold,
            cfg.matcher.method,
        )
    map_ids = state.map_id_real[m_map.idx]
    n_map_correct = jnp.sum(m_map.valid & (nxt.id_real == map_ids))

    # --- landmark lifecycle (EngineConfig.map_evict_age) -----------------
    # mark matched slots seen this frame, then evict slots stale past the
    # age (one-hot matmul membership, no scatter).  A slot matched THIS frame
    # is by construction not stale; evicted slots are freed for reuse by
    # this frame's append below.  m_map itself is unaffected (it was
    # computed against the pre-eviction map, and every accepted match is
    # to a landmark that survives).
    if cfg.map_evict_age > 0:
        C = state.map_xyz.shape[0]
        slots_c = jnp.arange(C, dtype=jnp.int32)
        member = (slots_c[:, None] == m_map.idx[None, :]).astype(jnp.float32)
        seen = jnp.dot(
            member, m_map.valid.astype(jnp.float32),
            preferred_element_type=jnp.float32) > 0.5
        last_seen = jnp.where(seen, state.frame_idx, state.map_last_seen)
        stale = state.map_valid & (
            state.frame_idx - last_seen > cfg.map_evict_age)
        state = state._replace(
            map_last_seen=last_seen,
            map_valid=state.map_valid & ~stale,
        )

    # --- PICP initial guess (icp_test.cpp:79: previous pose; optionally a
    # constant-velocity prediction, which cuts GN iterations) --------------
    if cfg.motion_model_init:
        step_v = (lie.scale_motion(state.vel, cfg.motion_model_alpha)
                  if cfg.motion_model_alpha != 1.0 else state.vel)
        T_prev = state.pose @ step_v
    else:
        T_prev = state.pose
    T_init = lie.inv_se3(T_prev)  # world-in-camera initial guess
    if cfg.picp.backend == "pallas" and kernel_threshold is None:
        # (a traced kernel_threshold — the vmapped sweep — routes to the
        # XLA solver below, which DOES support annealing; only the actual
        # pallas path must reject the combination)
        if cfg.picp.annealed_kernel:
            # solve_pallas has no annealing schedule; silently changing
            # solver semantics bit round 3's advisor — fail loud
            raise ValueError(
                "picp.backend='pallas' does not support "
                "annealed_kernel=True; use backend='xla' for the "
                "annealed schedule")
        from jaxvo.ops.pallas.picp_kernel import solve_pallas

        # whole GN loop as one GPU kernel (see PICPConfig.backend);
        # K is baked from the concrete config, not the traced array
        sol = solve_pallas(
            cfg.K(), T_init, state.map_xyz, nxt.uv, m_map.idx, m_map.valid,
            cfg.width, cfg.height, cfg.picp,
        )
    elif cfg.picp.unrolled_rounds > 0:
        sol = picp.solve_unrolled(
            K, T_init, state.map_xyz, nxt.uv, m_map.idx, m_map.valid,
            cfg.width, cfg.height, cfg.picp, kernel_threshold,
            rounds=cfg.picp.unrolled_rounds,
        )
    else:
        sol = picp.solve(
            K, T_init, state.map_xyz, nxt.uv, m_map.idx, m_map.valid,
            cfg.width, cfg.height, cfg.picp, kernel_threshold,
        )
    new_pose = lie.inv_se3(sol.T)  # camera-in-world
    # graceful degradation: keep the previous pose on match starvation or a
    # non-finite solve (reference fallback, my_utilities.cpp:269-273)
    n_matches = jnp.sum(m_map.valid)
    healthy = (n_matches >= cfg.picp.min_matches_reuse_pose) & jnp.all(
        jnp.isfinite(new_pose)
    )
    new_pose = jnp.where(healthy, new_pose, state.pose)
    # world-in-camera twins, reused below (latency: each inv_se3 the step
    # can skip is one fewer fusion in the serial chain; without the motion
    # model wic_prev IS the PICP init)
    wic_prev = (lie.inv_se3(state.pose) if cfg.motion_model_init else T_init)
    wic_new = jnp.where(healthy, sol.T, wic_prev)

    # --- 2D-2D: match curr -> next for triangulation (icp_test.cpp:122) ---
    if m_img is None:
        m_img = match_descriptors(
            curr.desc, curr.valid, nxt.desc, nxt.valid,
            cfg.matcher.distance_threshold, cfg.matcher.ratio_threshold,
            cfg.matcher.method,
        )
    # add_new_world_points (my_utilities.cpp:413-434): keep 2D-2D matches
    # whose *next*-frame point was not matched to the map
    next_in_map = m_map.valid  # (N,) per next-frame row
    is_new = m_img.valid & ~next_in_map[m_img.idx]

    # --- compact the candidates, then triangulate (cam.cpp:94-140) --------
    # only ~3-21 of the 128 padded rows are new each frame; a one-hot
    # compaction to Kc slots cuts the DLT+refine work ~4x (order preserved)
    uv_next = nxt.uv[m_img.idx]
    Kc = cfg.max_new_landmarks_per_frame
    N = is_new.shape[0]
    offs_new = jnp.cumsum(is_new.astype(jnp.int32)) - 1
    slot = jnp.where(is_new & (offs_new < Kc), offs_new, Kc)
    sel = (jnp.arange(Kc, dtype=jnp.int32)[:, None] == slot[None, :]).astype(
        curr.uv.dtype
    )  # (Kc, N)
    cnt = jnp.sum(sel, axis=1)
    c_valid = cnt > 0.5
    # one fused (Kc, N) @ (N, 16) compaction matmul for all five payloads
    D = curr.desc.shape[1]
    payload = jnp.concatenate(
        [curr.uv, uv_next, curr.desc,
         curr.id_real.astype(jnp.float32)[:, None],
         curr.id_meas.astype(jnp.float32)[:, None]], axis=1,
    )  # (N, 4 + D + 2)
    comp = jnp.dot(sel, payload, preferred_element_type=jnp.float32)
    uv1_c = comp[:, :2]
    uv2_c = comp[:, 2:4]
    desc_c = comp[:, 4:4 + D]
    idr_c = jnp.round(comp[:, 4 + D]).astype(jnp.int32)
    idm_c = jnp.round(comp[:, 5 + D]).astype(jnp.int32)

    pts, finite = triangulate.triangulate_two_view(
        K, None, None, uv1_c, uv2_c,
        refine_iterations=cfg.triangulation_refine_iters,
        wic1=wic_prev, wic2=wic_new,
    )
    keep = c_valid
    if cfg.gating_enabled:
        from jaxvo.ops.camera import project_points

        thr = cfg.landmark_max_reproj_px
        uv1_re, ok1 = project_points(
            K, wic_prev, pts, cfg.width, cfg.height
        )
        uv2_re, ok2 = project_points(
            K, wic_new, pts, cfg.width, cfg.height
        )
        e1 = jnp.sum((uv1_re - uv1_c) ** 2, -1)
        e2 = jnp.sum((uv2_re - uv2_c) ** 2, -1)
        # parallax between the two viewing rays: low-parallax depth is
        # unobservable and poisons later pose solves
        c1 = state.pose[:3, 3]
        c2 = new_pose[:3, 3]
        r1 = pts - c1[None, :]
        r2 = pts - c2[None, :]
        cosang = jnp.sum(r1 * r2, -1) / jnp.maximum(
            jnp.linalg.norm(r1, axis=-1) * jnp.linalg.norm(r2, axis=-1), 1e-20
        )
        parallax_ok = cosang < jnp.cos(cfg.landmark_min_parallax_rad)
        keep = (
            keep & ok1 & ok2 & (e1 < thr * thr) & (e2 < thr * thr)
            & finite & parallax_ok
        )
    if cfg.motion_model_init:
        rel = lie.inv_se3(state.pose) @ new_pose
        vel_new = jnp.where(healthy, rel, state.vel)
    else:
        vel_new = state.vel
    state2, n_added, cand_slots, cand_ok = _append_to_map(
        state._replace(pose=new_pose, vel=vel_new),
        pts, desc_c, idr_c, idm_c, keep,
        reuse_slots=cfg.map_evict_age > 0,
    )
    # cap visibility (see FrameLog): candidates past the Kc compaction
    # slots, and keeps past map capacity, are dropped — count both
    n_cand_dropped = jnp.sum(is_new & (offs_new >= Kc)).astype(jnp.int32)
    n_overflow = (jnp.sum(keep) - n_added).astype(jnp.int32)

    log = FrameLog(
        pose=new_pose,
        num_inliers=sol.num_inliers,
        chi_inliers=sol.chi_inliers,
        iterations=sol.iterations,
        converged=sol.converged,
        n_map_matches=jnp.sum(m_map.valid),
        n_map_correct=n_map_correct,
        n_frame_matches=jnp.sum(m_img.valid),
        n_new_points=n_added,
        map_count=state2.map_count,
        n_dropped_candidates=n_cand_dropped,
        n_dropped_overflow=n_overflow,
    )
    if return_matches:
        # map slots the kept candidates landed in, straight from the
        # append (exact under BOTH slot policies — sequential push_back
        # and the lifecycle free-slot reuse)
        return state2, log, (m_map.idx, m_map.valid,
                             cand_slots, uv2_c, cand_ok)
    return state2, log


def _pack_log(log: FrameLog):
    """(pose, packed scalar vector): scan stacks 2 output arrays per step
    instead of 10 — each per-step dynamic-update-slice chain is serial
    latency.  All scalar fields are exact in f32 (counts < 2^24)."""
    stats = jnp.stack([
        log.num_inliers.astype(jnp.float32),
        log.chi_inliers,
        log.iterations.astype(jnp.float32),
        log.converged.astype(jnp.float32),
        log.n_map_matches.astype(jnp.float32),
        log.n_map_correct.astype(jnp.float32),
        log.n_frame_matches.astype(jnp.float32),
        log.n_new_points.astype(jnp.float32),
        log.map_count.astype(jnp.float32),
        log.n_dropped_candidates.astype(jnp.float32),
        log.n_dropped_overflow.astype(jnp.float32),
    ])
    return log.pose, stats


def _unpack_logs(poses, stats) -> FrameLog:
    s = stats.T if stats.ndim == 2 else jnp.moveaxis(stats, -1, 0)
    i32 = lambda x: x.astype(jnp.int32)
    return FrameLog(
        pose=poses,
        num_inliers=i32(s[0]), chi_inliers=s[1], iterations=i32(s[2]),
        converged=s[3] > 0.5, n_map_matches=i32(s[4]), n_map_correct=i32(s[5]),
        n_frame_matches=i32(s[6]), n_new_points=i32(s[7]), map_count=i32(s[8]),
        n_dropped_candidates=i32(s[9]), n_dropped_overflow=i32(s[10]),
    )


def scan_tracker(state: VOState, frames_curr: Frame, frames_next: Frame,
                 cfg: EngineConfig, kernel_threshold=None):
    """The full-sequence tracker as a traceable function (jit/vmap it)."""

    def step(s, fr):
        c, n = fr
        s2, log = track_step(s, c, n, cfg, kernel_threshold)
        if not cfg.log_stats:
            return s2, log.pose  # stats dropped -> XLA DCEs their work
        return s2, _pack_log(log)

    if not cfg.log_stats:
        state, poses = jax.lax.scan(
            step, state, (frames_curr, frames_next), unroll=cfg.scan_unroll
        )
        F = poses.shape[0]
        return state, _unpack_logs(poses, jnp.zeros((F, 11), jnp.float32))
    state, (poses, stats) = jax.lax.scan(
        step, state, (frames_curr, frames_next), unroll=cfg.scan_unroll
    )
    return state, _unpack_logs(poses, stats)


# Module-level cached jits: `jax.jit(lambda ...)` built inside a function
# is a FRESH jit object per call — every run_sequence()/run_sequence_slam()
# invocation recompiled the bootstrap, which once masqueraded as a 145x
# "SLAM slowdown" in the benchmarks.  One jit object per function, keyed
# by the static cfg + input shapes, makes repeat calls dispatch-only.
from functools import partial as _partial

bootstrap_jit = _partial(jax.jit, static_argnames=("cfg",))(bootstrap)
scan_tracker_jit = _partial(jax.jit, static_argnames=("cfg",))(scan_tracker)


def full_run(key, f0: Frame, f1: Frame, frames_curr: Frame,
             frames_next: Frame, cfg: EngineConfig):
    """Bootstrap + full-sequence tracking as ONE traced program.

    The latency path: ``run_sequence`` dispatches two compiled programs
    (bootstrap, then the scan) — fine for throughput, but the host->device
    dispatch gap between them is pure serial latency on the single-stream
    race (the C++ loop it races, exec/icp_test.cpp:61-136, has no such
    boundary).  Fusing both into one jit removes the gap and lets XLA
    overlap the RANSAC/triangulation tail with the first scan steps.

    Returns (final state, FrameLog stack) — same as ``scan_tracker``.
    """
    state, _ = bootstrap(key, f0, f1, cfg)
    return scan_tracker(state, frames_curr, frames_next, cfg)


full_run_jit = _partial(jax.jit, static_argnames=("cfg",))(full_run)


def make_tracker(cfg: EngineConfig):
    """The compiled full-sequence tracker (module-level jit cache — calling
    this repeatedly with the same cfg does NOT recompile)."""
    return lambda s, fc, fn: scan_tracker_jit(s, fc, fn, cfg)


def run_sequence(seq, cfg: EngineConfig | None = None, seed: int = 42):
    """End-to-end VO over a loaded sequence. Returns (final state, logs,
    poses (F,4,4) camera-in-world incl. the identity first pose, diag).

    Two compiled programs total: the bootstrap and the scanned tracker.
    """
    cfg = cfg or EngineConfig()
    key = jax.random.PRNGKey(seed)
    F = seq.uv.shape[0]

    f0 = frame_of(seq, 0)
    f1 = frame_of(seq, 1)
    state, diag = bootstrap_jit(key, f0, f1, cfg)

    tracker = make_tracker(cfg)
    frames_curr = frames_of(seq, 0, F - 1)
    frames_next = frames_of(seq, 1, F)
    state, logs = tracker(state, frames_curr, frames_next)

    poses = jnp.concatenate([jnp.eye(4, dtype=jnp.float32)[None], logs.pose], axis=0)
    return state, logs, poses, diag


track_step_jit = _partial(
    jax.jit, static_argnames=("cfg", "return_matches"))(track_step)


class OnlineVO:
    """Streaming (serving) interface: feed frames one at a time.

    The reference and the batch drivers consume a whole recorded sequence
    (exec/icp_test.cpp:26); a deployed VO system receives frames online.
    This wraps the SAME jitted ``track_step`` the scanned tracker uses —
    one compiled program per frame after warmup, module-level jit cache
    (no recompile across sessions with the same config/shapes).

        vo = OnlineVO(cfg)
        vo.start(frame0, frame1)          # two-view bootstrap
        for frame in stream:
            pose = vo.step(frame)         # (4, 4) camera-in-world
        vo.state                          # full VOState (map, clocks)

    Frames are ``Frame`` pytrees padded to cfg.max_obs (see
    ``frame_of``).  ``checkpoint(path)`` / ``OnlineVO.resume(path, cfg)``
    persist/restore a session (same npz format as the chunked runner).
    """

    def __init__(self, cfg: EngineConfig | None = None, seed: int = 42):
        self.cfg = cfg or EngineConfig()
        self._key = jax.random.PRNGKey(seed)
        self.state: VOState | None = None
        self._prev: Frame | None = None
        self.frame_count = 0

    def start(self, f0: Frame, f1: Frame) -> dict:
        """Two-view bootstrap (icp_test.cpp:40-58).  Returns diagnostics.

        ``frame_count`` counts POSES in the trajectory: 1 after start
        (frame 0's identity — the reference does not push the bootstrap
        pose), +1 per ``step``.  Frame 1 is consumed twice by design —
        by the bootstrap AND as the first tracked frame — exactly like
        the batch pipeline (icp_test.cpp:61-75)."""
        self.state, diag = bootstrap_jit(self._key, f0, f1, self.cfg)
        self._prev = f0
        self.frame_count = 1
        return diag

    def step(self, frame: Frame):
        """Track one new frame; returns the (4, 4) camera-in-world pose."""
        if self.state is None:
            raise RuntimeError("call start(f0, f1) before step()")
        self.state, log = track_step_jit(
            self.state, self._prev, frame, self.cfg)
        self._prev = frame
        self.frame_count += 1
        return log.pose

    def checkpoint(self, path: str):
        from jaxvo.utils.checkpoint import save_state

        save_state(path, jax.tree.map(jnp.asarray, self.state),
                   self.frame_count,
                   extra={k: jnp.asarray(v) for k, v in {
                       "prev_uv": self._prev.uv, "prev_desc": self._prev.desc,
                       "prev_id_meas": self._prev.id_meas,
                       "prev_id_real": self._prev.id_real,
                       "prev_valid": self._prev.valid}.items()})

    @classmethod
    def resume(cls, path: str, cfg: EngineConfig | None = None,
               seed: int = 42) -> "OnlineVO":
        from jaxvo.utils.checkpoint import load_state

        vo = cls(cfg, seed)
        state, frame_count, extra = load_state(path)
        vo.state = state
        vo.frame_count = frame_count
        vo._prev = Frame(
            jnp.asarray(extra["prev_uv"]), jnp.asarray(extra["prev_desc"]),
            jnp.asarray(extra["prev_id_meas"]),
            jnp.asarray(extra["prev_id_real"]),
            jnp.asarray(extra["prev_valid"]))
        return vo


def run_sequence_chunked(
    seq,
    cfg: EngineConfig | None = None,
    seed: int = 42,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 30,
    resume: bool = True,
    max_chunks: int | None = None,
):
    """Checkpointed tracking: the frame scan runs in ``checkpoint_every``-
    step chunks with a host checkpoint (state + poses-so-far) after each.

    Identical math to ``run_sequence`` — the same scanned ``track_step``,
    just with scan boundaries at chunk edges (two compiled programs: the
    chunk and the tail).  With ``resume=True`` an existing checkpoint at
    ``checkpoint_path`` restarts tracking mid-sequence; the returned
    trajectory matches the uninterrupted run.

    ``max_chunks`` stops after that many chunks (fault-injection hook for
    resume tests: simulates a crash between checkpoints).

    Returns (state, poses (F, 4, 4), step_idx) — step_idx < F-1 when
    interrupted by max_chunks.
    """
    from jaxvo.utils.checkpoint import load_state, save_state

    cfg = cfg or EngineConfig()
    F = seq.uv.shape[0]
    n_steps = F - 1

    start = 0
    poses_done = None
    if resume and checkpoint_path and os.path.exists(checkpoint_path):
        state, start, extra = load_state(checkpoint_path)
        poses_done = jnp.asarray(extra["poses"])
    else:
        key = jax.random.PRNGKey(seed)
        state, _ = bootstrap_jit(key, frame_of(seq, 0), frame_of(seq, 1), cfg)
        poses_done = jnp.zeros((0, 4, 4), jnp.float32)

    chunks_run = 0
    step = start
    pose_chunks = [poses_done]
    tracker = make_tracker(cfg)  # one jitted callable; caches per chunk shape
    while step < n_steps:
        if max_chunks is not None and chunks_run >= max_chunks:
            break
        hi = min(step + checkpoint_every, n_steps)
        state, logs = tracker(
            state, frames_of(seq, step, hi), frames_of(seq, step + 1, hi + 1)
        )
        pose_chunks.append(logs.pose)
        step = hi
        chunks_run += 1
        if checkpoint_path:
            save_state(
                checkpoint_path, jax.tree.map(jnp.asarray, state), step,
                extra={"poses": jnp.concatenate(pose_chunks, axis=0)},
            )

    poses_steps = jnp.concatenate(pose_chunks, axis=0)
    poses = jnp.concatenate(
        [jnp.eye(4, dtype=jnp.float32)[None], poses_steps], axis=0)
    return state, poses, step


def run_threshold_sweep(seq, thresholds, cfg: EngineConfig | None = None, seed: int = 42):
    """Batched inlier-rejection sweep (BASELINE.json config 2): the FULL
    tracker vmapped over a robust-kernel-threshold axis — e.g.
    thresholds=[1000, 3000, 10000] runs as 3 lanes of ONE compiled program
    (the bootstrap is threshold-independent and shared).

    CAVEAT: sharing the bootstrap is exact for the stated config-2
    semantics (the robust kernel only enters the per-frame PICP solves,
    icp_test.cpp:86), but it means RANSAC/triangulation are NOT re-run
    per lane — lane-to-lane differences measure the tracking loop's
    threshold sensitivity only, which understates full-pipeline
    sensitivity if the bootstrap itself were threshold-dependent.

    Returns (states, logs, poses) with a leading threshold axis.
    """
    cfg = cfg or EngineConfig()
    key = jax.random.PRNGKey(seed)
    F = seq.uv.shape[0]
    thr = jnp.asarray(thresholds, jnp.float32)
    B = thr.shape[0]

    f0 = frame_of(seq, 0)
    f1 = frame_of(seq, 1)
    state, diag = bootstrap_jit(key, f0, f1, cfg)
    states = jax.tree.map(lambda x: jnp.broadcast_to(x[None], (B,) + x.shape), state)

    frames_curr = frames_of(seq, 0, F - 1)
    frames_next = frames_of(seq, 1, F)

    @jax.jit
    def sweep(states, thr):
        return jax.vmap(
            lambda state, t: scan_tracker(
                state, frames_curr, frames_next, cfg, kernel_threshold=t)
        )(states, thr)

    states, logs = sweep(states, thr)
    eye = jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32)[None, None], (B, 1, 4, 4))
    poses = jnp.concatenate([eye, logs.pose], axis=1)
    return states, logs, poses
