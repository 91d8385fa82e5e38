"""Multi-device tests on the 8-way virtual CPU mesh (conftest sets
xla_force_host_platform_device_count=8 — same Mesh/shard_map code paths as
a real multi-GPU host)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from jaxvo.ba.window import ba_solve
from jaxvo.config import BAConfig, EngineConfig
from jaxvo.ops.match import match_descriptors
from jaxvo.parallel import (
    local_mesh,
    shard_ba_problem,
    sharded_ba_solve,
    sharded_ba_step,
    sharded_match_descriptors,
)
from jaxvo.parallel.ba_sharded import gather_points

CFG = EngineConfig()
K = jnp.asarray(CFG.K())


@pytest.fixture(scope="module")
def mesh():
    assert jax.device_count() >= 8, "conftest must fake 8 devices"
    return local_mesh(8, axis="lm")


def test_sharded_match_exact_parity(mesh, sequence):
    s = sequence
    # use a map-sized second set: frame descriptors tiled to 512 columns
    rng = np.random.default_rng(0)
    desc2 = rng.uniform(-1, 1, (512, 10)).astype(np.float32)
    desc2[37] = s.desc[0][5]
    desc2[411] = s.desc[0][5] + 0.01
    valid2 = np.ones(512, bool)
    valid2[100:120] = False
    ref = match_descriptors(
        jnp.asarray(s.desc[0]), jnp.asarray(s.valid[0]),
        jnp.asarray(desc2), jnp.asarray(valid2),
    )
    got = sharded_match_descriptors(
        mesh,
        jnp.asarray(s.desc[0]), jnp.asarray(s.valid[0]),
        jnp.asarray(desc2), jnp.asarray(valid2),
    )
    assert np.array_equal(np.asarray(ref.valid), np.asarray(got.valid))
    m = np.asarray(ref.valid)
    assert np.array_equal(np.asarray(ref.idx)[m], np.asarray(got.idx)[m])
    np.testing.assert_allclose(
        np.asarray(ref.best), np.asarray(got.best), rtol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(ref.second), np.asarray(got.second), rtol=1e-6
    )


def test_sharded_match_cross_shard_top2(mesh):
    """Best and second-best in different shards must merge exactly."""
    N, M = 8, 512
    d1 = np.zeros((N, 10), np.float32)
    d2 = np.ones((M, 10), np.float32)
    d2[3] = 0.05    # shard 0: best
    d2[300] = 0.06  # shard 4: second
    ref = match_descriptors(
        jnp.asarray(d1), jnp.ones(N, bool), jnp.asarray(d2), jnp.ones(M, bool)
    )
    got = sharded_match_descriptors(
        mesh, jnp.asarray(d1), jnp.ones(N, bool), jnp.asarray(d2), jnp.ones(M, bool)
    )
    assert int(got.idx[0]) == 3
    assert np.isclose(float(got.second[0]), float(ref.second[0]))
    assert np.array_equal(np.asarray(ref.valid), np.asarray(got.valid))


def _make_problem(W=6, L=256, seed=0):
    import sys, os
    sys.path.insert(0, os.path.dirname(__file__))
    from test_ba import make_ba_problem

    return make_ba_problem(W=W, L=L, pose_noise=0.02, point_noise=0.03, seed=seed)


def test_sharded_ba_matches_single_device(mesh):
    prob, poses_gt, world = _make_problem()
    # fixed damping on BOTH sides: the sharded driver is fixed-damping by
    # design (identical work per iteration); with scale-relative damping
    # the adaptive path's early large lambdas are no longer negligible
    cfg = BAConfig(iterations=8, damping=1e-3, lm_adaptive=False)
    ref_prob, ref_stats = ba_solve(prob, K, CFG.width, CFG.height, cfg)

    sp = shard_ba_problem(prob, 8)
    sp2, stats = sharded_ba_solve(mesh, sp, K, CFG.width, CFG.height, cfg)

    # same pose solution (fp tolerance: reduction orders differ)
    np.testing.assert_allclose(
        np.asarray(sp2.poses), np.asarray(ref_prob.poses), atol=5e-4
    )
    pts = gather_points(sp2, world.xyz.shape[0])
    # compare on observed landmarks
    seen = np.zeros(world.xyz.shape[0], bool)
    seen[np.unique(np.asarray(prob.obs_lm)[np.asarray(prob.obs_valid)])] = True
    np.testing.assert_allclose(
        pts[seen], np.asarray(ref_prob.points)[seen], atol=5e-3
    )


def test_sharded_ba_converges(mesh):
    prob, poses_gt, world = _make_problem(seed=3)
    cfg = BAConfig(iterations=10, damping=1e-3)
    sp = shard_ba_problem(prob, 8)
    sp2, stats = sharded_ba_solve(mesh, sp, K, CFG.width, CFG.height, cfg)
    err_t = np.linalg.norm(
        np.asarray(sp2.poses)[:, :3, 3] - poses_gt[:, :3, 3], axis=1
    )
    assert err_t.max() < 1e-2


@pytest.mark.slow
def test_sharded_ba_step_runs_jitted(mesh):
    prob, *_ = _make_problem(W=4, L=64, seed=1)
    cfg = BAConfig(iterations=1)
    sp = shard_ba_problem(prob, 8)
    sp2, stats = sharded_ba_step(mesh, sp, K, CFG.width, CFG.height, cfg)
    assert np.isfinite(np.asarray(sp2.poses)).all()
    assert int(stats.num_obs) > 0


@pytest.mark.parametrize("method", ["direct", "mxu"])
def test_sharded_match_parity_by_method(mesh, method):
    """The sharded matcher per distance form: an exact hit in shard 0 and
    its runner-up in a later shard merge exactly; decisions match the
    dense single-device matcher of the same form."""
    rng = np.random.default_rng(5)
    d1 = jnp.asarray(rng.uniform(-1, 1, (64, 10)).astype(np.float32))
    v1 = jnp.ones(64, bool)
    desc2 = rng.uniform(-1, 1, (4096, 10)).astype(np.float32)
    desc2[100] = np.asarray(d1[3])            # exact hit, shard 0
    desc2[3000] = np.asarray(d1[3]) + 0.01    # runner-up in a later shard
    valid2 = np.ones(4096, bool)
    valid2[512:540] = False
    ref = match_descriptors(d1, v1, jnp.asarray(desc2), jnp.asarray(valid2),
                            method=method)
    got = sharded_match_descriptors(
        mesh, d1, v1, jnp.asarray(desc2), jnp.asarray(valid2),
        method=method)
    assert np.array_equal(np.asarray(ref.valid), np.asarray(got.valid))
    m = np.asarray(ref.valid)
    assert m[3] and int(got.idx[3]) == 100
    assert np.array_equal(np.asarray(ref.idx)[m], np.asarray(got.idx)[m])
    np.testing.assert_allclose(
        np.asarray(ref.best)[m], np.asarray(got.best)[m], atol=1e-5)
    np.testing.assert_allclose(
        np.asarray(ref.second)[m], np.asarray(got.second)[m], atol=1e-5)
