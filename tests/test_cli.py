"""CLI smoke tests (subcommands on a short prefix of the real data)."""

import json
import os

import numpy as np
import pytest

from jaxvo.cli import _apply_options, build_parser, main


def test_cli_run_writes_artifacts(tmp_path, data_dir, capsys):
    main(["--data", data_dir, "--frames", "20", "run", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    summary = json.loads(out[out.index("{"):])
    assert summary["map_count"] > 50
    for f in (
        "estimated_trajectory.txt", "estimated_trajectory_scaled.txt",
        "errors.txt", "estimated_world_points.txt", "metrics.jsonl",
        "gt_vs_est_trajectory.png",
    ):
        assert (tmp_path / f).exists(), f
    traj = np.loadtxt(tmp_path / "estimated_trajectory.txt")
    assert traj.shape == (20, 4)


def test_cli_match_test(data_dir, capsys):
    main(["--data", data_dir, "--frames", "6", "match-test"])
    out = capsys.readouterr().out
    assert "TOTAL" in out and "precision" in out


def test_cli_triangulate(data_dir, capsys):
    main(["--data", data_dir, "--frames", "5", "triangulate", "--limit", "3"])
    out = capsys.readouterr().out
    assert "landmarks triangulated" in out


@pytest.mark.slow
def test_cli_slam_writes_artifacts(tmp_path, data_dir, capsys):
    """The SLAM-mode tracker is reachable from the CLI (round-3 gap:
    run_sequence_slam was library-only) and writes the standard artifacts."""
    main(["--data", data_dir, "--frames", "40", "slam", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    summary = json.loads(out[out.index("{"):])
    assert summary["n_local_ba_runs"] > 0
    assert summary["tracked"]["ate_rmse"] < 0.5  # easy 40-frame prefix
    for f in ("estimated_trajectory.txt", "errors.txt", "metrics.jsonl",
              "gt_vs_est_trajectory.png"):
        assert (tmp_path / f).exists(), f


@pytest.mark.slow
def test_cli_slam_refine_loop(tmp_path, data_dir, capsys):
    """slam --refine loop runs the full drift-repair stack end-to-end."""
    main(["--data", data_dir, "--frames", "40", "slam", "--refine", "loop",
          "--sweeps", "1", "--iterations", "5", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    summary = json.loads(out[out.index("{"):])
    assert "refined" in summary
    # refinement must not blow up an already-good short trajectory
    assert summary["refined"]["ate_rmse"] < 2.0 * max(
        summary["tracked"]["ate_rmse"], 0.05)


@pytest.mark.parametrize("argv, backend, method", [
    ([], "xla", "direct"),
    (["--picp", "pallas"], "pallas", "direct"),
    (["--matcher", "mxu_bf16", "--picp", "xla"], "xla", "mxu_bf16"),
])
def test_cli_engine_options(argv, backend, method):
    """--picp picks the PICP solver (the XLA loop unless the fused GPU
    kernel is asked for); --matcher the distance form."""
    from jaxvo.config import EngineConfig

    args = build_parser().parse_args(argv + ["run"])
    cfg = _apply_options(EngineConfig(mode="fixed"), args)
    assert cfg.picp.backend == backend
    assert cfg.matcher.method == method
    assert cfg.picp.convergence_threshold == EngineConfig().picp.convergence_threshold


def test_cli_rejects_unknown_picp_solver():
    with pytest.raises(SystemExit):
        build_parser().parse_args(["--picp", "mosaic", "run"])
