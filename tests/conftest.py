"""Test harness: CPU backend with 8 virtual devices (SURVEY.md §4).

By default every test runs on the CPU: multi-device semantics (sharded step
== unsharded step) are validated on a virtual 8-device CPU mesh, and
float64 is enabled for oracle parity. The flags must be set before jax
initializes, hence this conftest.

Tests marked ``gpu`` need a CUDA GPU (the one-pass Hopper step kernel has
no CPU or interpret mode) and skip elsewhere. On a GPU machine run them
with the backend left on the GPU::

    GCM_TEST_GPU=1 python -m pytest -m gpu tests/
"""

import os

ON_GPU = os.environ.get("GCM_TEST_GPU") == "1"

if not ON_GPU:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA GPU; skipped elsewhere "
        "(run with GCM_TEST_GPU=1 python -m pytest -m gpu tests/)")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """The first JAX device when it is a GPU; skips the test otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a CUDA GPU: run GCM_TEST_GPU=1 python -m pytest "
                    "-m gpu tests/ on a GPU machine")
    return dev
