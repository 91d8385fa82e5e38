"""Landmark lifecycle (eviction + slot reuse, EngineConfig.map_evict_age).

NEW capability with no reference counterpart (the reference map is an
unbounded push_back vector, cam.cpp:122-139): long sequences need stale
landmarks evicted and their fixed-capacity slots recycled.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from jaxvo.config import EngineConfig
from jaxvo.data import synthetic
from jaxvo.engine import vo
from jaxvo.engine.state import empty_state


def small_cfg(**kw):
    return EngineConfig(mode="fixed", map_capacity=64, max_obs=32,
                        max_new_landmarks_per_frame=8, **kw)


def test_append_reuse_fills_free_slots_in_order():
    cfg = small_cfg()
    state = empty_state(cfg)
    D = cfg.desc_dim

    def mk(n, base):
        xyz = jnp.arange(n * 3, dtype=jnp.float32).reshape(n, 3) + base
        desc = jnp.ones((n, D), jnp.float32) * base
        ids = jnp.arange(n, dtype=jnp.int32) + int(base)
        return xyz, desc, ids

    xyz, desc, ids = mk(6, 0)
    state, n, slots, ok = vo._append_to_map(
        state, xyz, desc, ids, ids, jnp.ones(6, bool), reuse_slots=True)
    assert int(n) == 6
    assert np.array_equal(np.asarray(slots), np.arange(6))
    # evict slots 1 and 3
    state = state._replace(
        map_valid=state.map_valid.at[1].set(False).at[3].set(False))
    xyz, desc, ids = mk(3, 100)
    state, n, slots, ok = vo._append_to_map(
        state, xyz, desc, ids, ids, jnp.ones(3, bool), reuse_slots=True)
    assert int(n) == 3
    # freed slots recycled first (ascending), then the untouched tail
    assert np.array_equal(np.asarray(slots), [1, 3, 6])
    assert np.asarray(state.map_id_real)[1] == 100
    assert np.asarray(state.map_id_real)[3] == 101
    assert np.asarray(state.map_id_real)[6] == 102
    assert int(state.map_count) == 7  # occupancy


def test_append_reuse_overflow_dropped():
    cfg = small_cfg()
    state = empty_state(cfg)
    C, D = cfg.map_capacity, cfg.desc_dim
    n0 = C - 2
    xyz = jnp.zeros((n0, 3), jnp.float32)
    desc = jnp.zeros((n0, D), jnp.float32)
    ids = jnp.arange(n0, dtype=jnp.int32)
    state, n, _, _ = vo._append_to_map(
        state, xyz, desc, ids, ids, jnp.ones(n0, bool), reuse_slots=True)
    assert int(n) == n0
    xyz = jnp.zeros((5, 3), jnp.float32)
    desc = jnp.zeros((5, D), jnp.float32)
    ids = jnp.arange(5, dtype=jnp.int32)
    state, n, slots, ok = vo._append_to_map(
        state, xyz, desc, ids, ids, jnp.ones(5, bool), reuse_slots=True)
    assert int(n) == 2  # only 2 free slots remained
    assert np.asarray(ok).tolist() == [True, True, False, False, False]
    assert np.all(np.asarray(slots)[2:] == C)  # dropped sentinel


def run_synth(cfg, n_frames=30, seed=3):
    world = synthetic.make_world(seed, n_landmarks=400, xy_extent=8.0)
    gt = synthetic.make_planar_trajectory(n_frames, seed=seed)
    seq = synthetic.render_sequence(world, gt, cfg, seed=seed)
    return vo.run_sequence(seq, cfg)


def test_huge_age_matches_append_only():
    """With an age no landmark ever reaches, the lifecycle path must
    reproduce the append-only trajectory exactly (free slots are the
    suffix, so rank-ordered reuse == sequential push_back)."""
    cfg0 = small_cfg()
    cfg1 = small_cfg(map_evict_age=10_000)
    s0, lg0, p0, _ = run_synth(cfg0)
    s1, lg1, p1, _ = run_synth(cfg1)
    np.testing.assert_allclose(np.asarray(p0), np.asarray(p1), atol=1e-6)
    assert int(s0.map_count) == int(s1.map_count)
    assert np.array_equal(np.asarray(s0.map_valid), np.asarray(s1.map_valid))


def test_eviction_frees_and_recycles():
    """On a forward trajectory, landmarks left behind stop matching; with
    a small age the map occupancy stays below the append-only count and
    old slots get recycled (same slot, different landmark id)."""
    cfg = small_cfg(map_evict_age=5)
    s, lg, p, _ = run_synth(cfg, n_frames=40)
    cfg0 = small_cfg()
    s0, lg0, p0, _ = run_synth(cfg0, n_frames=40)
    # lifecycle mode inserted at least as many landmarks overall...
    assert int(np.sum(np.asarray(lg.n_new_points))) >= int(
        np.sum(np.asarray(lg0.n_new_points)))
    # ...while holding fewer live at the end than total-ever-inserted
    total_inserted = int(np.sum(np.asarray(lg.n_new_points)))
    assert int(s.map_count) < total_inserted
    # the eviction clock advanced
    assert int(s.frame_idx) == 39
    # tracking stays sane (forward planar walk, generous bound)
    assert np.all(np.isfinite(np.asarray(p)))


def test_slam_rejects_unsafe_age():
    from jaxvo.engine.slam import run_sequence_slam

    cfg = EngineConfig(mode="fixed", map_evict_age=4,
                       local_ba_window=16, local_ba_every=2)
    world = synthetic.make_world(1, n_landmarks=200, xy_extent=8.0)
    gt = synthetic.make_planar_trajectory(8, seed=1)
    seq = synthetic.render_sequence(world, gt, cfg, seed=1)
    with pytest.raises(ValueError, match="map_evict_age"):
        run_sequence_slam(seq, cfg)


def test_lifecycle_under_vmap():
    """Eviction + slot reuse must be vmappable (the throughput mode vmaps
    the whole tracker; rank-ordered one-hot reuse has no data-dependent
    shapes, so this is a compile+finiteness check over distinct lanes)."""
    import jax

    cfg = small_cfg(map_evict_age=6)
    world = synthetic.make_world(5, n_landmarks=300, xy_extent=8.0)
    gt = synthetic.make_planar_trajectory(20, seed=5)
    seq = synthetic.render_sequence(world, gt, cfg, seed=5)
    F = seq.uv.shape[0]
    B = 3
    key = jax.random.PRNGKey(0)
    keys = jax.random.split(key, B)
    tile = lambda x: jnp.broadcast_to(jnp.asarray(x)[None], (B,) + x.shape)
    ball = jax.tree.map(tile, vo.frames_of(seq, 0, F))
    noise = 0.3 * jax.random.normal(jax.random.PRNGKey(7), ball.uv.shape)
    ball = ball._replace(uv=ball.uv + noise * ball.valid[..., None])
    bf0 = jax.tree.map(lambda x: x[:, 0], ball)
    bf1 = jax.tree.map(lambda x: x[:, 1], ball)
    bc = jax.tree.map(lambda x: x[:, 0:F - 1], ball)
    bn = jax.tree.map(lambda x: x[:, 1:F], ball)

    @jax.jit
    def batched(k, f0, f1, c, n):
        s, _ = jax.vmap(lambda kk, a, b: vo.bootstrap(kk, a, b, cfg))(k, f0, f1)
        s, lg = jax.vmap(lambda st, cc, nn: vo.scan_tracker(st, cc, nn, cfg))(s, c, n)
        return s, lg

    s, lg = batched(keys, bf0, bf1, bc, bn)
    assert np.all(np.isfinite(np.asarray(lg.pose)))
    assert np.all(np.asarray(s.frame_idx) == F - 1)
    # per-lane noise -> lanes evolve distinct maps
    counts = np.asarray(s.map_count)
    assert counts.min() > 0
