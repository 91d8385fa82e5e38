"""ctypes binding to the native C++ measurement parser (csrc/loader.cpp).

The reference's data layer is C++ (my_utilities.cpp:20-134); this is its
native equivalent in the new framework: a zero-dependency C++17 tokenizer
compiled to ``libjaxvo_io.so`` that fills caller-allocated padded arrays
directly, avoiding Python string overhead on large sequences.

Falls back gracefully: ``available()`` is False when the library has not
been built (build with ``make -C csrc``), and ``jaxvo.data.loader`` then
uses the pure-Python parser.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None
_LIB_TRIED = False


def _lib_path() -> str:
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(root, "csrc", "libjaxvo_io.so")


def _load():
    global _LIB, _LIB_TRIED
    if _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    path = _lib_path()
    if not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.jaxvo_parse_measurement.restype = ctypes.c_int
        lib.jaxvo_parse_measurement.argtypes = [
            ctypes.c_char_p,  # path
            ctypes.c_int,     # max_obs
            ctypes.c_int,     # desc_dim
            f32p,             # gt_pose (3,)
            f32p,             # odom_pose (3,)
            i32p,             # id_meas (max_obs,)
            i32p,             # id_real (max_obs,)
            f32p,             # uv (max_obs, 2)
            f32p,             # desc (max_obs, desc_dim)
        ]
        _LIB = lib
    except OSError:
        _LIB = None
    return _LIB


def available() -> bool:
    return _load() is not None


def load_sequence(data_dir: str, n_frames: int, prefix: str, max_obs: int):
    from jaxvo.config import DESC_DIM
    from jaxvo.data.loader import FrameObservations

    lib = _load()
    assert lib is not None, "native loader not built (make -C csrc)"

    F = n_frames
    uv = np.zeros((F, max_obs, 2), np.float32)
    desc = np.zeros((F, max_obs, DESC_DIM), np.float32)
    id_meas = np.full((F, max_obs), -1, np.int32)
    id_real = np.full((F, max_obs), -1, np.int32)
    valid = np.zeros((F, max_obs), bool)
    n_obs = np.zeros((F,), np.int32)
    gt_pose = np.zeros((F, 3), np.float32)
    odom_pose = np.zeros((F, 3), np.float32)

    for i in range(F):
        path = os.path.join(data_dir, f"{prefix}{i:05d}.dat").encode()
        n = lib.jaxvo_parse_measurement(
            path, max_obs, DESC_DIM, gt_pose[i], odom_pose[i],
            id_meas[i], id_real[i],
            uv[i].reshape(-1), desc[i].reshape(-1),
        )
        if n < 0:
            raise IOError(f"native parser failed on {path!r} (rc={n})")
        n_obs[i] = n
        valid[i, :n] = True

    return FrameObservations(uv, desc, id_meas, id_real, valid, n_obs, gt_pose, odom_pose)
