"""Test configuration: run on a virtual 8-device CPU mesh by default.

Tests exercise the jitted programs through XLA:CPU, including multi-device
sharding via the forced host platform device count, and Pallas kernels in
interpret mode. Tests marked `gpu` need the card: they skip unless JAX's
default device is a GPU, which takes an explicit JAX_PLATFORMS=cuda:

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
"""

import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")
# Tests compile small programs; a persistent cache would only collect other
# machines' CPU artifacts
os.environ.setdefault("SHADERFLOW_NO_COMPILE_CACHE", "1")

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a GPU (decided at run time, so
    every worker collects the same tests)."""
    device = jax.devices()[0]
    if device.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX platform {device.platform!r}); "
                    f"covered on the card by chip_smoke.py phase 3")
    return device
