"""Checks that need an NVIDIA GPU.  ``python chip_smoke.py`` runs them in
its own process (phase 5); elsewhere the ``gpu`` fixture skips them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.gpu


def test_matmul_runs_in_full_float32(gpu):
    """jaxvo/__init__ asks for 'highest' matmul precision: on a GPU that
    must rule out TF32 (about three decimal digits), which the geometry
    solvers cannot afford."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((256, 256)).astype(np.float32)
    b = rng.standard_normal((256, 256)).astype(np.float32)
    got = np.asarray(jax.device_put(a, gpu) @ jax.device_put(b, gpu))
    ref = a.astype(np.float64) @ b.astype(np.float64)
    rel = np.abs(got - ref).max() / np.abs(ref).max()
    assert rel < 1e-5, rel


def test_control_tracker_on_the_card(gpu):
    """40 frames of the control sequence on the card: finite poses inside
    the control cell's accuracy envelope."""
    from jaxvo import profiles
    from jaxvo.engine import vo
    from jaxvo.engine.eval import evaluate, metrics_dict

    seq = profiles.control_sequence(40)
    cfg = profiles.throughput_config(40)
    _, logs, poses, _ = vo.run_sequence(seq, cfg)
    assert poses.devices() == {gpu}
    poses = np.asarray(poses)
    assert np.all(np.isfinite(poses))
    m = metrics_dict(evaluate(poses, seq.gt_pose, cfg))
    assert m["ate_rmse"] <= 0.25 and m["trans_err_mean"] <= 0.30, m


def test_picp_kernel_compiled_matches_xla_solver(gpu):
    """The fused PICP kernel compiled for the card (no interpreter)
    against picp.solve on 32 distinct problems."""
    from jaxvo import profiles
    from jaxvo.config import EngineConfig, PICPConfig
    from jaxvo.ops import picp
    from jaxvo.ops.pallas.picp_kernel import solve_pallas

    cfg = EngineConfig()
    K = cfg.K()
    pcfg = PICPConfig(convergence_threshold=1e-4)
    T0, X, Z, V = (jnp.asarray(a) for a in profiles.picp_problems(32))
    ref = jax.vmap(lambda t, x, z, v: picp.solve(
        jnp.asarray(K), t, x, z, None, v, cfg.width, cfg.height, pcfg))(
        T0, X, Z, V)
    got = jax.vmap(lambda t, x, z, v: solve_pallas(
        K, t, x, z, None, v, cfg.width, cfg.height, pcfg))(T0, X, Z, V)
    np.testing.assert_array_equal(np.asarray(got.num_inliers),
                                  np.asarray(ref.num_inliers))
    np.testing.assert_allclose(np.asarray(got.T), np.asarray(ref.T), atol=5e-3)
    np.testing.assert_allclose(np.asarray(got.chi_inliers),
                               np.asarray(ref.chi_inliers), rtol=5e-2)
    assert np.max(np.abs(np.asarray(got.iterations)
                         - np.asarray(ref.iterations))) <= 1
