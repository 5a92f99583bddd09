"""Test configuration: force the CPU backend with 8 virtual devices.

Tests validate float64 numerics (the reference is NumPy f64 and the parity
target is 1e-10); the GPU path is exercised by ``chip_smoke.py`` and the
``gpu``-marked tests on a machine with a card.  The 8 virtual CPU devices
back the multi-device sharding tests.
"""

import os
import sys

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

from dgtpu.utils.device import enable_compile_cache  # noqa: E402

# CPU unless JAX_PLATFORMS names others: the gpu-marked tests run on a card
# with JAX_PLATFORMS=cuda,cpu (set-up still needs the host CPU backend)
jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
# the suite keeps its own cache directory: loading CPU executables compiled
# by a process with a different XLA:CPU configuration logs target-feature
# mismatches
enable_compile_cache(".jax_cache_tests")

import dgtpu  # noqa: E402,F401  (enables x64)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from dgtpu.geometry import generate_rectangle_grid, write_plot3d  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INPUT_DIR = os.path.join(REPO, "input")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: heavy sharded/compile-bound tests — excluded from the "
        "fast lane (python -m pytest tests/ -q -m 'not slow')")
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA device; skips without one (run on the card with "
        "JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -q -m gpu)")


@pytest.fixture()
def gpu_device():
    """The first GPU device, or a skip when this process has none."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU device visible to JAX")


@pytest.fixture(scope="session", autouse=True)
def ensure_grids():
    """Generate the rectangle grid inputs used across the suite."""
    os.makedirs(INPUT_DIR, exist_ok=True)
    for n in (1, 2, 4, 8):
        for p in (1, 2, 5):
            path = os.path.join(INPUT_DIR, f"Rectangle_{n}X{n}_nPoly{p}.xyz")
            if not os.path.exists(path):
                write_plot3d(path, *generate_rectangle_grid(n, n, p))
    yield


@pytest.fixture()
def base_settings():
    from dgtpu.settings import Settings, load_params
    s = Settings(load_params())
    s.update_setting("visualization.automatically_open_paraview", False)
    s.update_setting("visualization.export", False)
    s.update_setting("caching.enabled", False)
    s.update_setting("logging.loglevel", "WARNING")
    return s
