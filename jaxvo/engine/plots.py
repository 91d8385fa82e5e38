"""Headless matplotlib plots reproducing the reference's output artifacts.

Replaces both the OpenCV-highgui online plot (create_plot,
my_utilities.cpp:318-398 — which blocks on waitKey) and the offline
matplotlib script (src/plot_data.py) with non-blocking PNG output:

  gt_vs_est_trajectory.png, scaled_est_trajectory.png,
  translational_error.png, rotational_error.png, world_points_3d.png
"""

from __future__ import annotations

import os

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_trajectories(out_dir: str, result, scaled: bool = False):
    """GT (blue) vs estimated (red) XY trajectories — create_plot's layout."""
    plt = _plt()
    est = result.poses_world[:, :3, 3] * (result.scale if scaled else 1.0)
    gt = result.gt_T[:, :3, 3]
    fig, ax = plt.subplots(figsize=(8, 6))
    ax.plot(gt[:, 0], gt[:, 1], "b-", label="ground truth")
    ax.plot(est[:, 0], est[:, 1], "r-", label="estimated" + (" (scaled)" if scaled else ""))
    ax.plot(gt[0, 0], gt[0, 1], "go", label="start")
    ax.plot(gt[-1, 0], gt[-1, 1], "ks", label="end")
    ax.set_xlabel("x [m]"); ax.set_ylabel("y [m]")
    ax.set_title("Trajectory"); ax.legend(); ax.axis("equal")
    name = "scaled_est_trajectory.png" if scaled else "gt_vs_est_trajectory.png"
    fig.savefig(os.path.join(out_dir, name), dpi=120, bbox_inches="tight")
    plt.close(fig)


def plot_errors(out_dir: str, result):
    plt = _plt()
    for name, vals, title in (
        ("translational_error.png", result.trans_err, "Translational error [m]"),
        ("rotational_error.png", result.rot_err_parity, "Rotational error [rad] (reference formula)"),
    ):
        fig, ax = plt.subplots(figsize=(8, 4))
        ax.plot(vals)
        ax.set_xlabel("frame"); ax.set_title(title); ax.grid(True, alpha=0.3)
        fig.savefig(os.path.join(out_dir, name), dpi=120, bbox_inches="tight")
        plt.close(fig)
    # honest wrapped-angle variant alongside
    fig, ax = plt.subplots(figsize=(8, 4))
    ax.plot(result.rot_err_fixed)
    ax.set_xlabel("frame"); ax.set_title("Rotational error [rad] (wrapped)")
    ax.grid(True, alpha=0.3)
    fig.savefig(os.path.join(out_dir, "rotational_error_wrapped.png"), dpi=120, bbox_inches="tight")
    plt.close(fig)


def plot_world_points(out_dir: str, ids, pts, gt_world=None):
    """3D scatter of the reconstructed landmarks (plot_data.py:6-32)."""
    plt = _plt()
    fig = plt.figure(figsize=(8, 6))
    ax = fig.add_subplot(projection="3d")
    ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=4, c="r", label="estimated")
    if gt_world is not None:
        ax.scatter(gt_world[:, 0], gt_world[:, 1], gt_world[:, 2], s=2, c="b", alpha=0.3, label="GT")
    ax.set_title(f"World points ({len(ids)})"); ax.legend()
    fig.savefig(os.path.join(out_dir, "world_points_3d.png"), dpi=120, bbox_inches="tight")
    plt.close(fig)


def render_all(out_dir: str, result, state=None, cfg=None, gt_world=None) -> bool:
    """Write every PNG; returns False (and writes none) when matplotlib is
    not installed — plots are an optional artifact, the text outputs are
    not."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    os.makedirs(out_dir, exist_ok=True)
    plot_trajectories(out_dir, result, scaled=False)
    plot_trajectories(out_dir, result, scaled=True)
    plot_errors(out_dir, result)
    if state is not None and cfg is not None:
        from jaxvo.engine.eval import world_points_output

        ids, pts = world_points_output(state, cfg, result.scale)
        plot_world_points(out_dir, ids, pts, gt_world)
    return True
