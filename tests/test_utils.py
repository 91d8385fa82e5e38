"""Checkpoint, metrics, validation and degradation-path tests."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest

from jaxvo.config import EngineConfig, PICPConfig
from jaxvo.data import synthetic
from jaxvo.engine.state import empty_state
from jaxvo.engine.vo import bootstrap, frame_of, run_sequence, track_step
from jaxvo.utils.checkpoint import load_state, save_state
from jaxvo.utils.checks import (
    StateValidationError,
    finite_or_previous,
    validate_frame_log,
    validate_state,
)
from jaxvo.utils.metrics import MetricsLogger, log_frame_logs


def small_run():
    cfg = EngineConfig()
    world = synthetic.make_world(9, n_landmarks=500, xy_extent=7.0)
    gt = synthetic.make_planar_trajectory(10, seed=9)
    seq = synthetic.render_sequence(world, gt, cfg, seed=9)
    return run_sequence(seq, cfg), cfg, seq


def test_checkpoint_roundtrip(tmp_path):
    (state, logs, poses, diag), cfg, seq = small_run()
    path = str(tmp_path / "ckpt.npz")
    save_state(path, state, frame_idx=9, extra={"seed": 42})
    state2, fidx, extra = load_state(path)
    assert fidx == 9
    assert int(extra["seed"]) == 42
    for a, b in zip(state, state2):
        assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.slow
def test_orbax_checkpoint_roundtrip(tmp_path):
    pytest.importorskip("orbax.checkpoint")
    from jaxvo.utils.checkpoint import OrbaxCheckpointer

    (state, logs, poses, diag), cfg, seq = small_run()
    ckpt = OrbaxCheckpointer(str(tmp_path / "orbax"), keep=2)
    ckpt.save(9, state, extra={"seed": 42})
    ckpt.save(19, state._replace(frame_idx=state.frame_idx + 10)
              if hasattr(state, "frame_idx") else state)
    assert ckpt.latest_step() == 19
    state2, extra = ckpt.restore(step=9)
    assert int(extra["seed"]) == 42
    for a, b in zip(state, state2):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    ckpt.close()


def test_validate_state_ok_and_violations():
    (state, logs, poses, diag), cfg, seq = small_run()
    validate_state(state)  # must not raise
    bad = state._replace(pose=state.pose.at[0, 0].set(jnp.nan))
    with pytest.raises(StateValidationError):
        validate_state(bad)
    report = validate_frame_log(logs)
    assert report["frames"] == 9
    assert report["non_finite_chi"] == 0


def test_finite_or_previous():
    new = jnp.array([1.0, jnp.nan])
    old = jnp.array([0.0, 0.0])
    out, ok = finite_or_previous(new, old)
    assert not bool(ok)
    assert np.allclose(np.asarray(out), [0, 0])


def test_metrics_jsonl(tmp_path):
    (state, logs, poses, diag), cfg, seq = small_run()
    path = str(tmp_path / "m.jsonl")
    logger = MetricsLogger(path)
    log_frame_logs(logger, logs)
    logger.log({"event": "summary", "ok": True})
    logger.close()
    lines = [json.loads(l) for l in open(path)]
    assert len(lines) == 10
    assert lines[0]["event"] == "frame"
    assert lines[-1]["event"] == "summary"


def test_match_starvation_reuses_pose():
    """With min_matches_reuse_pose set, an empty map keeps the pose fixed."""
    cfg = EngineConfig(picp=PICPConfig(min_matches_reuse_pose=10))
    world = synthetic.make_world(3, n_landmarks=300)
    gt = synthetic.make_planar_trajectory(3, seed=3)
    seq = synthetic.render_sequence(world, gt, cfg, seed=3)
    state = empty_state(cfg)  # empty map -> zero matches
    f1, f2 = frame_of(seq, 1), frame_of(seq, 2)
    state2, log = track_step(state, f1, f2, cfg)
    np.testing.assert_array_equal(np.asarray(state2.pose), np.asarray(state.pose))


@pytest.mark.slow
def test_chunked_resume_matches_uninterrupted(tmp_path):
    """Crash-and-resume mid-sequence reproduces the uninterrupted
    trajectory: run 1 chunk, 'crash' (max_chunks), then resume from the
    checkpoint and compare against a straight run_sequence."""
    import jax.numpy as jnp

    from jaxvo.data import synthetic
    from jaxvo.engine.vo import run_sequence, run_sequence_chunked

    cfg = EngineConfig(mode="fixed")
    world = synthetic.make_world(13, n_landmarks=800, xy_extent=8.0)
    gt = synthetic.make_planar_trajectory(25, seed=13)
    seq = synthetic.render_sequence(world, gt, cfg, pixel_noise=0.2, seed=13)

    state_ref, logs_ref, poses_ref, _ = run_sequence(seq, cfg)

    ckpt = str(tmp_path / "vo_ckpt.npz")
    # phase 1: one 10-step chunk, then simulated crash
    _, poses_partial, step = run_sequence_chunked(
        seq, cfg, checkpoint_path=ckpt, checkpoint_every=10, max_chunks=1)
    assert step == 10
    # phase 2: resume from the checkpoint and finish
    state2, poses2, step2 = run_sequence_chunked(
        seq, cfg, checkpoint_path=ckpt, checkpoint_every=10)
    assert step2 == 24
    np.testing.assert_allclose(
        np.asarray(poses2), np.asarray(poses_ref), atol=1e-4)
    assert int(state2.map_count) == int(state_ref.map_count)


# ---------------------------------------------------------------------------
# trace -> device metrics (jaxvo.utils.profiling), on hand-made events
# ---------------------------------------------------------------------------
def _ev(name, start, dur, **stats):
    return {"plane": "/device:GPU:0", "line": "Stream #13", "name": name,
            "start_ns": start, "dur_ns": dur, "stats": stats}


def test_device_summary_busy_idle_and_copies():
    from jaxvo.utils.profiling import busy_ns, device_summary

    evs = [_ev("fusion_1", 0, 100), _ev("fusion_2", 50, 100),   # overlap
           _ev("MemcpyD2H", 300, 10), _ev("Memcpy DtoH (Device -> Pinned)", 390, 10)]
    assert busy_ns(evs) == 150 + 10 + 10
    s = device_summary(evs)
    assert s["events"] == 4 and s["d2h_copies"] == 2
    assert abs(s["span_ms"] - 400e-6) < 1e-12
    assert abs(s["idle_share"] - (1 - 170 / 400)) < 1e-12
    assert device_summary([])["busy_ms"] == 0.0


def test_time_by_scope_uses_innermost_scope_and_kernel_names():
    from jaxvo.utils.profiling import hlo_op_names, time_by_scope

    hlo = "\n".join([
        '  %fusion.3 = f32[8]{0} fusion(%p), kind=kLoop, '
        'metadata={op_name="jit(run)/while/body/match/dot_general"}',
        '  ROOT %loop_add_fusion.7 = f32[8]{0} fusion(%q), kind=kLoop, '
        'metadata={op_name="jit(run)/ba/while/body/picp/add"}',
    ])
    ops = hlo_op_names(hlo)
    assert ops["fusion.3"] == ops["fusion_3"]
    evs = [
        _ev("fusion_3", 0, 2_000_000, hlo_op="fusion.3"),
        # inside a CUDA graph the stat names the command buffer: the
        # kernel (fusion) name decides
        _ev("loop_add_fusion_7", 0, 1_000_000, hlo_op="command_buffer"),
        _ev("sm90_xmma_gemm", 0, 500_000, hlo_op="command_buffer"),
    ]
    ms = time_by_scope(evs, ops, ["match", "picp", "ba"])
    assert ms == {"match": 2.0, "picp": 1.0, "ba": 0.0, "other": 0.5}
