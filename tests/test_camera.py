import jax.numpy as jnp
import numpy as np

from jaxvo.config import EngineConfig
from jaxvo.ops import camera, lie

CFG = EngineConfig()
K = jnp.asarray(CFG.K())


def test_project_center():
    pts = jnp.array([[0.0, 0.0, 2.0]])
    uv, valid = camera.project_points(K, jnp.eye(4), pts, CFG.width, CFG.height)
    assert bool(valid[0])
    assert np.allclose(np.asarray(uv[0]), [320, 240])


def test_project_culls_behind_camera():
    pts = jnp.array([[0.0, 0.0, -1.0], [0.0, 0.0, 1e-9], [0.0, 0.0, 0.0]])
    _, valid = camera.project_points(K, jnp.eye(4), pts, CFG.width, CFG.height)
    assert not bool(valid[0])
    assert bool(valid[1])  # z > 0 passes (reference culls z <= 0 only)
    assert not bool(valid[2])


def test_project_culls_out_of_bounds():
    # u = 180*x/z + 320; x/z = 1.8 -> u = 644 > 639
    pts = jnp.array([[1.8, 0.0, 1.0], [1.76, 0.0, 1.0]])
    uv, valid = camera.project_points(K, jnp.eye(4), pts, CFG.width, CFG.height)
    assert not bool(valid[0])
    assert bool(valid[1])  # u = 636.8 <= 639


def test_project_with_pose():
    # camera shifted +1 in x: world point at x=1 projects to center
    T = np.eye(4, dtype=np.float32)
    T[0, 3] = -1.0  # world_in_camera: p_cam = p_world - (1,0,0)
    pts = jnp.array([[1.0, 0.0, 3.0]])
    uv, valid = camera.project_points(K, jnp.asarray(T), pts, CFG.width, CFG.height)
    assert bool(valid[0]) and np.allclose(np.asarray(uv[0]), [320, 240])


def test_roundtrip_real_world_points(world):
    """Project GT landmarks through a made-up pose and check consistency of
    the two project variants."""
    T = lie.v2t_euler(jnp.array([0.1, -0.2, 0.3, 0.02, -0.05, 0.1], jnp.float32))
    pts = jnp.asarray(world.xyz[:100])
    uv1, v1 = camera.project_points(K, T, pts, CFG.width, CFG.height)
    uv2, v2, p_cam, phom = camera.project_points_with_cam(K, T, pts, CFG.width, CFG.height)
    assert np.allclose(np.asarray(uv1), np.asarray(uv2))
    assert np.array_equal(np.asarray(v1), np.asarray(v2))
    # phom = K p_cam
    assert np.allclose(np.asarray(phom), np.asarray(p_cam) @ np.asarray(K).T, atol=1e-4)
