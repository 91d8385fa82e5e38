"""Typed configuration for the whole engine.

The reference hard-codes every constant (intrinsics at ``cam.cpp:11-31``,
matcher thresholds at ``my_utilities.h:44-47``, kernel thresholds 3000/1000/100
at ``icp_test.cpp:86`` / ``cam.cpp:183`` / ``my_utilities.cpp:279``, damping 1
at ``picp_solver.cpp:11``, GN schedule at ``icp_test.cpp:88-91``) and ships a
``data/camera.dat`` config file that no code reads.  Here every one of those
constants is a named field with the reference value as default, and
``camera.dat`` is actually parsed (`EngineConfig.from_camera_dat`).

``parity`` mode preserves the reference's deliberate quirks (unwrapped
rotation error with a +pi/2 offset, ``icp_test.cpp:177-191``; ignored 0.2 m
camera x-offset, ``cam.cpp:18-26``); ``fixed`` mode corrects them.
"""

from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass, field
from typing import Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Static capacities (XLA needs static shapes; everything is padded + masked).
# ---------------------------------------------------------------------------
DESC_DIM = 10          # descriptor length (my_utilities.cpp:94)
MAX_OBS = 128          # max observations per frame (dataset max is 127, frame 0)
MAP_CAPACITY = 512     # landmark map capacity (reference map grows to 490)
N_GT_LANDMARKS = 1000  # world.dat size


@dataclass(frozen=True)
class MatcherConfig:
    """Brute-force descriptor matcher thresholds (my_utilities.h:44-47).

    method: "direct" expands (a-b)^2 elementwise — bit-faithful to the
    reference's per-pair squaredNorm; "mxu" uses |a|^2+|b|^2-2ab with the
    inner product as a matmul; "mxu_bf16" additionally feeds the cross
    term in bf16 (f32 accumulation).  Both matmul forms have decision
    parity with "direct" on the bundled data and on the GPU (0 flips over
    all matches) but theoretical near-tie flips.  The matcher benchmark
    (benchmarks/match_scaling.py) records their cost by map size.
    """

    distance_threshold: float = 0.2   # squared-L2 acceptance (DISTANCE_THRESHOLD)
    ratio_threshold: float = 0.8      # Lowe's ratio test (RATIO_THRESHOLD)
    method: str = "direct"


@dataclass(frozen=True)
class PICPConfig:
    """Projective-ICP Gauss-Newton schedule.

    Defaults follow the canonical ``icp_test`` driver: kernel threshold 3000
    (icp_test.cpp:86), <=50 iterations with relative-chi convergence 1e-5
    (icp_test.cpp:88-91), damping 1 and min_num_inliers 0 from the solver
    ctor (picp_solver.cpp:8-15).
    """

    kernel_threshold: float = 3000.0
    damping: float = 1.0
    max_iterations: int = 50
    convergence_threshold: float = 1e-5
    min_num_inliers: int = 0
    keep_outliers: bool = False
    # graceful degradation (my_utilities.cpp:269-273): reuse the previous
    # pose when fewer than this many 2D-3D matches survive.  0 = parity
    # with icp_test (which always solves).
    min_matches_reuse_pose: int = 0
    # > 0: replace the lax.while_loop GN driver with that many fully
    # unrolled rounds (convergence handled by a done-mask select, same
    # stopping rule but a hard iteration cap).  Trade-off: no per-round
    # host read of the loop predicate, but always executes all rounds
    # (8 fixed vs ~5 adaptive).  On an H100 80GB HBM3 (700 W limit) 8
    # rounds beat the while_loop (37.7 vs 55.1 ms per 121-frame sequence,
    # 76.8 vs 128.8 ms for 256 streams) and lose to the fused kernel
    # (backend="pallas"); PERF.md has the table.  0 = while_loop (parity,
    # default).
    unrolled_rounds: int = 0
    # Annealed robust kernel (off = reference parity).  The truncated
    # kernel at a FIXED threshold has a translation-shrinking local
    # minimum when per-frame motion is large: at the previous-pose init,
    # the high-flow (near, translation-informative) landmarks already
    # exceed the threshold, get trimmed, and the solve converges onto the
    # low-flow subset — a systematic undershoot whose triangulated
    # landmarks bake the shrunken scale into the map (measured: ~-5%%
    # scale/frame compounding on 1 m/frame KITTI-scale motion, estimated
    # path 20 m of a 199 m ground-truth loop).  Annealing sets the
    # effective threshold each round to max(kernel_threshold,
    # anneal_mult · median residual chi), so nothing is trimmed until the
    # solver is in basin; the threshold tightens to the configured value
    # as residuals shrink (GNC/MSAC-style schedule).
    annealed_kernel: bool = False
    anneal_mult: float = 4.0
    # "xla" (default) = ops/picp.py lax.while_loop solver, which runs on
    # every platform.  "pallas" = the fused GPU kernel
    # (ops/pallas/picp_kernel.py, Pallas on the Triton route): the ENTIRE
    # GN loop as one launch, with no per-round host read of the loop
    # predicate — the GPU profiles in jaxvo/profiles.py use it.  It
    # compiles only for an NVIDIA GPU.  Baked-constant threshold:
    # incompatible with the traced kernel_threshold sweep (falls back to
    # xla there).
    backend: str = "xla"


@dataclass(frozen=True)
class RansacConfig:
    """Essential-matrix RANSAC (replaces cv::findEssentialMat, cam.cpp:49-54).

    The reference calls OpenCV with library defaults (its locally declared
    threshold/confidence vars are never passed in); OpenCV defaults are
    threshold=1.0 px, prob=0.999.  We run a fixed-size batch of vmapped
    8-point minimal solves under a deterministic JAX PRNG (the analog of
    ``cv::setRNGSeed(42)``, cam.cpp:40).
    """

    num_hypotheses: int = 512       # batch of minimal solves (static shape)
    sample_size: int = 8            # 8-point algorithm
    inlier_threshold_px: float = 1.0
    seed: int = 42


@dataclass(frozen=True)
class BAConfig:
    """Sliding-window bundle adjustment (new layer; no reference counterpart)."""

    window: int = 10                 # keyframes per window (BASELINE.json config)
    max_landmarks: int = MAP_CAPACITY
    max_obs_per_frame: int = MAX_OBS
    iterations: int = 10
    # minimum / fixed-mode LM damping.  SCALE-RELATIVE (Marquardt): the
    # solver adds damping·diag(S), not damping·I — see
    # ba/window.finalize_reduced.  1e-6 barely perturbs converged GN steps
    # while the gauge pinning keeps the f32 Cholesky conditioned.
    damping: float = 1.0e-6
    huber_threshold: float = 3000.0  # same saturating kernel as PICP
    keep_outliers: bool = False      # False = exclude like PICP (picp_solver.cpp:86-89)
    # True: drop observations whose PREDICTED projection leaves the image
    # at the current estimate (tracking parity).  False: keep them (only
    # the z>0 cheirality cull applies) — refinement mode, where the
    # measured pixel is in-bounds by construction and bounds-culling at a
    # drifted estimate deletes exactly the loop-closure constraints that
    # make drift observable.
    cull_bounds: bool = True
    # Adaptive Levenberg-Marquardt: trial step per iteration, rejected /
    # non-finite steps roll back with lambda x4, accepted relax x0.5 toward
    # ``damping``.  Off = fixed-damping GN (the sharded scaling benchmark
    # keeps this off so every iteration is identical work).
    lm_adaptive: bool = True
    damping_init: float = 1.0
    # Landmark-block assembly: "segsum" scatters per-observation blocks
    # with jax.ops.segment_sum; "onehot" assembles them as per-frame
    # (La, N) one-hot matmuls — same sums, different accumulation order
    # (fp-equivalent to ~1e-6).  The in-scan local BA uses "onehot"; which
    # is faster on the GPU is not yet measured.
    assembly: str = "segsum"
    # Cap on the active-landmark compaction prefix in ba_solve (None =
    # W*N+1, the exact bound).  Every O(La) per-iteration term shrinks to
    # the cap; landmarks beyond it (the newest) are dropped from that
    # solve (inert sentinel slot), and the drop is visible in
    # stats.num_obs.  Speed/completeness knob for the in-scan local BA.
    compact_cap: int | None = None
    # Active-landmark renumbering implementation: "sort" (argsort over
    # the observation ids) or "mask" (one-hot-matmul presence + cumsum —
    # sort-free).  Identical renumbering either way (ascending-id
    # packing, inert sentinel slot); the in-scan local BA uses "mask".
    compact_method: str = "sort"

    def replace(self, **kw) -> "BAConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class EngineConfig:
    """Full engine configuration.

    Camera defaults replicate ``cam.cpp:10-35``: K = [[180,0,320],[0,180,240],
    [0,0,1]], 640x480 image, z in (0, 5], plus the camera->world axis remap
    ``cameraToImageTransform`` (cam.cpp:18-26).  ``data/camera.dat`` also
    specifies a 0.2 m x-offset that the reference silently drops; in
    ``parity`` mode we drop it too.
    """

    fx: float = 180.0
    fy: float = 180.0
    cx: float = 320.0
    cy: float = 240.0
    width: int = 640
    height: int = 480
    z_near: float = 0.0
    z_far: float = 5.0
    # camera->world axis remap (cam.cpp:18-26): m[0,2]=1, m[1,0]=-1, m[2,1]=-1
    cam_to_image_rotation: Tuple[Tuple[float, float, float], ...] = (
        (0.0, 0.0, 1.0),
        (-1.0, 0.0, 0.0),
        (0.0, -1.0, 0.0),
    )
    # translation part of cam_transform from camera.dat: the camera sits
    # 0.2 m ahead of the robot origin.  The reference ignores it
    # (cam.cpp:18-26) — parity mode's cam_to_image() drops it too — but the
    # bundled measurements were demonstrably rendered WITH it (projecting
    # world.dat through gt_pose·mount reproduces every observation to
    # ~0.002 px only when the offset is applied), so the honest robot-frame
    # evaluation metric needs it.
    cam_to_image_translation: Tuple[float, float, float] = (0.2, 0.0, 0.0)

    n_frames: int = 121
    max_obs: int = MAX_OBS
    map_capacity: int = MAP_CAPACITY
    desc_dim: int = DESC_DIM

    mode: str = "parity"  # "parity" | "fixed"

    # Landmark quality gate for newly triangulated points.  The reference
    # appends every DLT output unfiltered (cam.cpp:122-139) — low-parallax
    # garbage landmarks included — which leaves the tracking loop marginally
    # stable through the sparse mid-sequence section (frames with ~14 obs):
    # a slightly different fp reduction order tipped the ungated loop into
    # losing track there, while the gated loop beats the reference baseline
    # under both orders.  None = auto (enabled in "fixed" mode, disabled in
    # "parity" mode, which must reproduce the 490-landmark map).
    gate_new_landmarks: bool | None = None
    landmark_max_reproj_px: float = 5.0
    # GN polish iterations after the DLT (ops/triangulate.refine_points);
    # 1 suffices with the landmark gate (equal-or-better accuracy, half
    # the refine work per frame)
    triangulation_refine_iters: int = 2
    # Candidate rows are compacted to this many slots before triangulation
    # (the dataset peaks at 21 new landmarks/frame; triangulating all 128
    # padded rows wasted ~4x the DLT+refine work). Extras beyond the cap
    # are dropped for that frame.
    max_new_landmarks_per_frame: int = 32
    # Landmark lifecycle (map eviction / slot reuse) — NEW, no reference
    # counterpart (the reference map is an unbounded push_back vector that
    # never forgets, cam.cpp:122-139).  0 = off: slots are append-only
    # (parity; required for exact push_back-order reproduction).  N > 0: a
    # valid landmark whose last 2D-3D match is more than N frames old is
    # EVICTED — its slot is freed and reused by new triangulations (rank-
    # ordered free-slot scatter, still one one-hot matmul).  Keeps the
    # active map small on long sequences: fewer descriptor aliases in the
    # matcher, and the fixed capacity stops starving new landmarks.
    # MUST exceed local_ba_window*local_ba_stride + local_ba_every in
    # SLAM mode (ring-buffer observations reference map slots for up to
    # W*S frames; engine/slam.py validates this loudly).
    map_evict_age: int = 0
    # minimum triangulation parallax (radians) between the two viewing rays:
    # low-parallax points have unobservable depth (reprojection can't catch
    # them — they fit both views by construction)
    landmark_min_parallax_rad: float = 0.01
    # Fuse the two per-frame matcher calls (2D-3D vs map, 2D-2D vs next
    # frame) into one stacked distance matmul + one top-2 chain —
    # halves the matcher's serial kernel chain (latency win).  Uses the
    # "mxu" distance form for both; parity mode keeps two direct-method
    # calls (bit-faithful to the reference's per-pair squaredNorm).
    fuse_frame_matchers: bool = False
    # Initialize each PICP solve from a constant-velocity prediction
    # (pose · last relative motion) instead of the previous pose
    # (icp_test.cpp:79 semantics).  Cuts mean GN iterations; off in parity.
    motion_model_init: bool = False
    # Damping of the velocity prediction (fraction of the last motion
    # applied).  GN stops on relative-chi, so the stopped pose depends
    # slightly on its init; feeding the init forward through the velocity
    # creates a feedback loop whose gain scales with this factor — 1.0
    # measured locally unstable on the bundled data (divergence growing
    # ~2.5x/frame from 1e-5), while damped prediction keeps most of the
    # iteration savings.
    motion_model_alpha: float = 0.5
    # Emit the full per-frame FrameLog stats from the scan (the
    # reference's stdout narration, structured).  False = poses only: the
    # 11 per-step diagnostic scalars (inlier counts, chi, GT-oracle match
    # precision, drop counters) vanish from the program outputs, so XLA
    # dead-code-eliminates the work feeding them — a latency-profile
    # lever.  Default True everywhere else.
    log_stats: bool = True
    # lax.scan unroll factor for the frame loop: frames are sequentially
    # dependent, but unrolling lets XLA schedule/fuse across step bodies
    # (the latency profile uses 8).  Costs compile time roughly linearly.
    scan_unroll: int = 1
    # SLAM-mode local bundle adjustment (engine/slam.py): every
    # ``local_ba_every`` frames, jointly re-optimize the last
    # ``local_ba_window`` poses + their landmarks.  Replaces the per-frame
    # scale handoff (which collapses on KITTI-scale motion) with a
    # multi-view one; the knobs below are the measured sweet spot
    # (W=16/E=2: path 51/59 vs 29/59 plain on the 1 m/frame loop fixture).
    # Accuracy sweet spot on the 200-frame KITTI-scale loop circuit
    # (benchmarks/slam_variants.py): W16/E2/it6/cap512/lambda0 0.01 at
    # ATE 0.46 — vs it10/no-cap/lambda0 1.0 at ATE 1.00 and about 3x the
    # BA work.  (it10 + lambda0 0.1 reaches ATE 0.35.)
    local_ba_window: int = 16
    local_ba_every: int = 2
    local_ba_iterations: int = 6
    # Keyframe-style striding: the local window holds W poses spaced
    # ``local_ba_stride`` frames apart (1 = contiguous, the classic
    # sliding window).  Stride multiplies the temporal horizon the solve
    # anchors against at the SAME per-solve cost — the lever for slow
    # scale drift on long sequences.  In-between (non-keyframe) poses
    # keep their tracked values; corrections flow forward because each
    # new frame tracks from the BA-corrected previous pose.  Ring-buffer
    # depth becomes W*S.  Measured accuracy landscape on the 500-frame
    # open KITTI-scale fixture (ate_slam):
    # W16/S1/E2 (default) 30.5; W32/S1 15.2; W48/S1 13.0;
    # W32/S2 11.9; W40/S2 9.7; W32/S2/E1 6.5;
    # W40/S2/E1 3.7 — but
    # S3 or horizon > ~80 frames REGRESSES (21+): too-sparse keyframes
    # starve the windows of shared observations.  Long-sequence
    # recommendation: W32-40, S2, E1-2.  The 121-frame bundled sequence
    # and the 200-frame loop bench keep the W16/S1 default.
    local_ba_stride: int = 1
    # active-landmark cap for the in-scan local BA solve (see
    # BAConfig.compact_cap); None = exact W*N+1 bound.  Inert when the
    # map capacity is already <= the cap (e.g. the bundled 512 map).
    local_ba_compact_cap: int | None = 512
    # LM lambda warm-start for the local BA.  The global refiner needs
    # damping_init=1.0 (far-from-optimum restarts); an interleaved window
    # starts near the tracker's estimate, where a big initial lambda just
    # burns iterations halving itself toward the useful range (measured:
    # 1.0 needs all 10 iterations for ATE 1.0; 0.01 reaches ATE 0.46 in
    # 6).
    local_ba_damping_init: float = 0.01

    matcher: MatcherConfig = field(default_factory=MatcherConfig)
    picp: PICPConfig = field(default_factory=PICPConfig)
    ransac: RansacConfig = field(default_factory=RansacConfig)
    ba: BAConfig = field(default_factory=BAConfig)

    # ---- derived ---------------------------------------------------------
    @property
    def gating_enabled(self) -> bool:
        if self.gate_new_landmarks is not None:
            return self.gate_new_landmarks
        return self.mode == "fixed"

    def K(self) -> np.ndarray:
        return np.array(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=np.float32,
        )

    def cam_to_image(self) -> np.ndarray:
        """4x4 camera->world axis remap (cam.cpp:18-26, cam.cpp:234-236)."""
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = np.array(self.cam_to_image_rotation, dtype=np.float32)
        if self.mode == "fixed":
            T[:3, 3] = np.array(self.cam_to_image_translation, dtype=np.float32)
        return T

    def mount_T(self) -> np.ndarray:
        """4x4 camera-in-robot mount transform (camera.dat cam_transform),
        ALWAYS including the 0.2 m x-offset — used by the robot-frame
        evaluation metric, which must model how the data was generated
        rather than follow the reference's dropped-offset quirk."""
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = np.array(self.cam_to_image_rotation, dtype=np.float32)
        T[:3, 3] = np.array(self.cam_to_image_translation, dtype=np.float32)
        return T

    def replace(self, **kw) -> "EngineConfig":
        return dataclasses.replace(self, **kw)

    # ---- camera.dat parsing ---------------------------------------------
    @staticmethod
    def from_camera_dat(path: str, **overrides) -> "EngineConfig":
        """Parse ``data/camera.dat`` (the reference never reads it).

        Format::

            camera matrix:
            <3x3>
            cam_transform:
            <4x4>
            z_near: <f>
            z_far:  <f>
            width:  <i>
            height: <i>
        """
        with open(path) as f:
            text = f.read()
        nums = lambda line: [float(x) for x in line.split()]

        lines = [ln.strip() for ln in text.splitlines() if ln.strip()]
        K_rows, T_rows = [], []
        scalars = {}
        i = 0
        while i < len(lines):
            ln = lines[i]
            if ln.startswith("camera matrix"):
                K_rows = [nums(lines[i + j]) for j in (1, 2, 3)]
                i += 4
            elif ln.startswith("cam_transform"):
                T_rows = [nums(lines[i + j]) for j in (1, 2, 3, 4)]
                i += 5
            else:
                m = re.match(r"(\w+):\s*(-?[\d.]+)", ln)
                if m:
                    scalars[m.group(1)] = float(m.group(2))
                i += 1
        K = np.array(K_rows, dtype=np.float32)
        T = np.array(T_rows, dtype=np.float32)
        cfg = dict(
            fx=float(K[0, 0]),
            fy=float(K[1, 1]),
            cx=float(K[0, 2]),
            cy=float(K[1, 2]),
            width=int(scalars.get("width", 640)),
            height=int(scalars.get("height", 480)),
            z_near=float(scalars.get("z_near", 0.0)),
            z_far=float(scalars.get("z_far", 5.0)),
            cam_to_image_rotation=tuple(tuple(float(v) for v in row[:3]) for row in T[:3]),
            cam_to_image_translation=tuple(float(row[3]) for row in T[:3]),
        )
        cfg.update(overrides)
        return EngineConfig(**cfg)


DEFAULT_CONFIG = EngineConfig()
