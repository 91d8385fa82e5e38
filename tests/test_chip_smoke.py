"""chip_smoke.py's phase functions at small sizes on the CPU, and its
refusal to report a result without a GPU."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from conftest import REPO_ROOT, selects_gpu_tests

sys.path.insert(0, str(REPO_ROOT))
import chip_smoke  # noqa: E402


@pytest.mark.parametrize("text, expect", [
    ("NVIDIA H100 80GB HBM3, 700.00 W",
     [{"name": "NVIDIA H100 80GB HBM3", "power_limit": "700.00 W"}]),
    ("NVIDIA H100 80GB HBM3, 500.00 W\nNVIDIA H100 80GB HBM3, 700.00 W\n",
     [{"name": "NVIDIA H100 80GB HBM3", "power_limit": "500.00 W"},
      {"name": "NVIDIA H100 80GB HBM3", "power_limit": "700.00 W"}]),
    ("nvidia-smi unavailable: [Errno 2] No such file or directory", []),
])
def test_parse_cards(text, expect):
    from jaxvo.utils.measure import parse_cards

    assert parse_cards(text) == expect


def test_result_line_shape():
    dev = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
           "cards": []}
    assert chip_smoke.result_line(True, dev) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                   "count": 1}}


def test_refuses_to_run_without_a_gpu(monkeypatch, capsys):
    import jaxvo.utils.compile_cache as cc

    monkeypatch.setattr(cc, "enable_compile_cache", lambda: "unused")
    rc = chip_smoke.run(four=False)
    lines = capsys.readouterr().out.strip().splitlines()
    assert rc != 0
    dev = json.loads(lines[0])
    assert dev["phase"] == "device" and dev["platform"] == "cpu"
    assert json.loads(lines[-1]) == {
        "ok": False, "device": {"platform": "cpu", "kind": "cpu",
                                "count": dev["count"]}}


def test_alone_in_a_directory_it_fails_and_reports_nothing(tmp_path):
    shutil.copy(REPO_ROOT / "chip_smoke.py", tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


@pytest.mark.parametrize("markexpr, gpu", [
    ("gpu", True), ("gpu and not slow", True), ("not slow", False),
    ("not gpu", False), ("", False), (None, False),
])
def test_gpu_runs_are_told_apart(markexpr, gpu):
    assert selects_gpu_tests(markexpr) is gpu


def test_control_vo_20_frames():
    from jaxvo import profiles

    res = chip_smoke.phase_control_vo(
        n_frames=20, reps=1, online_frames=6,
        cfg=profiles.latency_config(20, picp_backend="xla", scan_unroll=1))
    assert res["ok"], res
    assert res["frames"] == 20 and res["online_max_pose_diff"] <= 1e-3
    assert res["median_s"] > 0 and res["compile_s"] > 0


def test_batched_streams_small():
    from jaxvo import profiles

    res = chip_smoke.phase_batched(n_frames=10, batch=3, reps=1,
                                   cfg=profiles.throughput_config(10, "xla"))
    assert res["ok"], res
    assert res["shape"] == [3, 9, 4, 4]
    # frames/s counts the tracked frames: F - 1 per stream
    assert res["fps"] == pytest.approx(3 * 9 / res["median_s"])


def test_batched_lanes_are_distinct():
    from jaxvo import profiles

    keys, f0, f1, fc, fn = profiles.batched_inputs(
        profiles.control_sequence(6), 3)
    uv = np.asarray(fc.uv)
    assert not np.allclose(uv[0], uv[1])
    # frame i is both frames_next[i-1] and frames_curr[i]
    np.testing.assert_array_equal(np.asarray(fn.uv)[:, :-1], uv[:, 1:])


def test_picp_problems_are_distinct_and_full():
    from jaxvo import profiles

    T0, X, Z, V = profiles.picp_problems(3, n=128)
    assert T0.shape == (3, 4, 4) and X.shape == (3, 128, 3)
    assert V.sum(1).min() >= 100
    assert not np.allclose(T0[0], T0[1])


@pytest.mark.parametrize("phase, kw", [
    ("phase_sharded_match", dict(M=4096, N=16)),
    ("phase_sharded_pgo", dict(F=64, n_loops=8)),
    ("phase_sharded_ba", dict(L=2000, obs=256, W=6)),
])
def test_four_device_phases_on_virtual_devices(phase, kw):
    import jax

    assert jax.device_count() >= 4, "conftest must fake 8 devices"
    res = getattr(chip_smoke, phase)(4, **kw)
    assert res["ok"], res
    assert res["mesh_devices"] == 4


@pytest.mark.parametrize("environ, expect", [
    ({"JAX_COMPILATION_CACHE_DIR": "/some/shared/cache"}, None),
    ({}, str(REPO_ROOT / ".jax_cache")),
    ({"JAX_COMPILATION_CACHE_DIR": ""}, str(REPO_ROOT / ".jax_cache")),
])
def test_compile_cache_directory_choice(environ, expect):
    """The environment decides when it names a directory (nothing is set
    in code); otherwise the checkout's own .jax_cache, which git ignores."""
    from jaxvo.utils.compile_cache import default_cache_dir

    assert default_cache_dir(environ) == expect
    assert ".jax_cache/" in (REPO_ROOT / ".gitignore").read_text().split()


def test_kernel_phase_in_interpret_mode():
    """Phase 1's per-solve checks, with the kernel interpreted: parity at
    two batch sizes and the memory analysis of both programs."""
    res = chip_smoke.phase_kernels(batches=(1, 3), interpret=True)
    assert res["ok"], res
    assert [c["batch"] for c in res["checks"]] == [1, 3]
    assert all(c["max_iteration_diff"] <= 1 for c in res["checks"])
    assert "tracker" not in res
