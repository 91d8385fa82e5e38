"""Native C++ loader: exact parity with the Python parser."""

import numpy as np
import pytest

from jaxvo.data import native
from jaxvo.data.loader import load_sequence

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native loader not built (make -C csrc)"
)


def test_native_matches_python(data_dir):
    s_native = native.load_sequence(data_dir, 121, "meas-", 128)
    s_py = load_sequence(data_dir, 121, use_native=False)
    for a, b, name in zip(s_native, s_py, s_native._fields):
        assert np.array_equal(np.asarray(a), np.asarray(b)), name


def test_loader_prefers_native(data_dir):
    s = load_sequence(data_dir, 5)
    assert s.n_obs[0] == 127
