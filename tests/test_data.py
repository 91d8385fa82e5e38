"""Data-layer tests against known dataset facts (SURVEY.md §6)."""

import os

import numpy as np

from jaxvo.config import DESC_DIM, EngineConfig
from jaxvo.data import load_camera_config, load_trajectory, load_world_points, parse_measurement


def test_parse_first_measurement(data_dir):
    seq, gt, odom, id_meas, id_real, uv, desc = parse_measurement(
        os.path.join(data_dir, "meas-00000.dat")
    )
    assert seq == 0
    assert np.allclose(gt, [0, 0, 0])
    assert len(id_meas) == 127  # frame 0 has 127 observations
    assert uv.shape == (127, 2)
    assert desc.shape == (127, DESC_DIM)
    # first point line: "point 0 6 522.119 187.968 -0.668052 ..."
    assert id_meas[0] == 0 and id_real[0] == 6
    assert np.allclose(uv[0], [522.119, 187.968], atol=1e-3)
    assert np.isclose(desc[0, 0], -0.668052, atol=1e-5)


def test_load_sequence_shapes(sequence):
    F = sequence.num_frames
    assert F == 121
    assert sequence.uv.shape == (121, 128, 2)
    assert sequence.desc.shape == (121, 128, DESC_DIM)
    assert sequence.n_obs[0] == 127
    assert sequence.n_obs.min() == 14  # sparsest frame
    assert np.isclose(sequence.n_obs.mean(), 82.7, atol=1.0)
    # padding is marked invalid
    assert not sequence.valid[0, 127]
    assert sequence.id_real[0, 127] == -1


def test_load_world_points(world):
    assert world.xyz.shape == (1000, 3)
    assert world.desc.shape == (1000, DESC_DIM)
    # first line: "0  6.80375 -2.11234   1.1324 ..."
    assert world.ids[0] == 0
    assert np.allclose(world.xyz[0], [6.80375, -2.11234, 1.1324], atol=1e-4)


def test_unique_observed_landmarks(sequence):
    ids = sequence.id_real[sequence.valid]
    assert len(np.unique(ids)) == 536  # SURVEY.md §6: 536 unique id_real observed


def test_load_trajectory(data_dir):
    odom, gt = load_trajectory(os.path.join(data_dir, "trajectoy.dat"))
    assert odom.shape[1] == 3 and gt.shape[1] == 3
    assert np.allclose(gt[0], [0, 0, 0])
    assert np.isclose(odom[0, 0], 0.00160159, atol=1e-6)


def test_camera_dat_parsing(data_dir):
    cfg = load_camera_config(os.path.join(data_dir, "camera.dat"))
    assert cfg.fx == 180 and cfg.fy == 180 and cfg.cx == 320 and cfg.cy == 240
    assert cfg.width == 640 and cfg.height == 480
    assert cfg.z_far == 5.0
    K = cfg.K()
    assert K.shape == (3, 3) and K[2, 2] == 1.0
    # cam_transform axis remap rows (camera.dat) match cam.cpp:18-26
    R = np.array(cfg.cam_to_image_rotation)
    assert np.allclose(R, [[0, 0, 1], [-1, 0, 0], [0, -1, 0]])
    # the 0.2 m x-offset is parsed but dropped in parity mode
    assert np.isclose(cfg.cam_to_image_translation[0], 0.2)
    assert np.allclose(cfg.cam_to_image()[:3, 3], 0.0)
    assert np.allclose(
        cfg.replace(mode="fixed").cam_to_image()[:3, 3], [0.2, 0, 0]
    )


def test_default_config_matches_reference():
    cfg = EngineConfig()
    assert cfg.picp.kernel_threshold == 3000.0
    assert cfg.picp.damping == 1.0
    assert cfg.matcher.distance_threshold == 0.2
    assert cfg.matcher.ratio_threshold == 0.8
