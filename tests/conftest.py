"""Test configuration: CPU with 8 virtual devices, except for ``-m gpu``.

The CPU pin must land before any backend initializes, so it is applied in
``pytest_configure`` (before collection imports the test modules).  The
8 virtual CPU devices exercise the same Mesh/shard_map code paths as a
real multi-GPU host.  A ``-m gpu`` run (``python chip_smoke.py`` phase 5,
or ``pytest -m gpu tests/`` on a GPU host) keeps the default platform, and
its tests skip through the ``gpu`` fixture where there is no card.
"""

import os
import pathlib
import re

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
REFERENCE_DATA = pathlib.Path("/root/reference/data")
REFERENCE_OUTPUT = pathlib.Path("/root/reference/output")


@pytest.fixture(scope="session")
def data_dir():
    if not REFERENCE_DATA.exists():
        pytest.skip("reference dataset not available")
    return str(REFERENCE_DATA)


@pytest.fixture(scope="session")
def output_dir():
    if not REFERENCE_OUTPUT.exists():
        pytest.skip("reference output not available")
    return str(REFERENCE_OUTPUT)


@pytest.fixture(scope="session")
def sequence(data_dir):
    from jaxvo.data import load_sequence

    return load_sequence(data_dir, n_frames=121)


@pytest.fixture(scope="session")
def world(data_dir):
    from jaxvo.data import load_world_points

    return load_world_points(os.path.join(data_dir, "world.dat"))


def selects_gpu_tests(markexpr: str) -> bool:
    """True for a ``-m`` expression that asks for the gpu-marked tests."""
    return re.search(r"(?<!not )\bgpu\b", markexpr or "") is not None


@pytest.fixture(scope="session")
def gpu():
    """The first GPU; skips where JAX found none (decided at run time,
    never at import, so every xdist worker collects the same tests)."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run: python chip_smoke.py)")
    return jax.devices()[0]


def pytest_configure(config):
    """Pin the CPU unless this run selects the gpu-marked tests, and build
    the native loader so tests/test_native.py actually runs (one ~2 s g++
    invocation; test_native skips with a clear message only if the
    toolchain itself is unavailable)."""
    import subprocess

    if not selects_gpu_tests(config.getoption("markexpr")):
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax

        jax.config.update("jax_platforms", "cpu")

    csrc = REPO_ROOT / "csrc"
    if (csrc / "loader.cpp").exists() and not (csrc / "libjaxvo_io.so").exists():
        try:
            subprocess.run(
                ["make", "-C", str(csrc)],
                check=True, capture_output=True, timeout=120,
            )
        except (OSError, subprocess.SubprocessError):
            pass


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches_between_modules():
    """The full suite compiles hundreds of XLA programs in one process;
    letting executables accumulate exhausted memory far enough that the
    CPU compiler itself segfaulted (observed at ~50% of the -m '' run).
    Dropping the caches at module boundaries bounds the footprint; each
    module still shares compilations internally."""
    yield
    import jax

    jax.clear_caches()
