"""Test harness configuration.

Tests run on the CPU backend with 8 virtual devices (the standard way to
exercise multi-device sharding logic without several GPUs) and with
64-bit floats enabled, since golden-file parity against the reference's
double-precision C++ output requires f64 DP.  Tests that need a GPU carry
the `gpu` marker and decide inside the test whether one is present.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_enable_x64", True)

import pathlib

import pytest

from quaff_tpu.device import setup_compile_cache

# persistent compilation cache: the big banded-DP scans compile slowly on
# the CPU backend; cache them across test runs
setup_compile_cache()


@pytest.fixture(scope="session")
def data_dir() -> pathlib.Path:
    return pathlib.Path(__file__).parent / "data"


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided at run time)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (run with JAX_PLATFORMS=cuda,cpu on one)")


@pytest.fixture(autouse=True)
def _isolate_logger_state():
    """Snapshot/restore the module-level logger singleton around every test.

    CLI tests mutate the singleton (-v*/-log/-nocolor); without this, a
    test that raises verbosity leaks extra stderr into later byte-parity
    tests (e.g. the dpmatrix oracle dump)."""
    from quaff_tpu.logger import logger

    saved = (logger.verbosity, set(logger.tags), logger.use_color)
    thread_names = dict(logger._thread_names)
    try:
        yield
    finally:
        logger.verbosity, logger.tags, logger.use_color = saved[0], saved[1], saved[2]
        logger._thread_names = thread_names
        logger._last_owner = None
