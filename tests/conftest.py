"""Test configuration.

Tests run on the CPU with 8 virtual devices, so the sharding and
collective paths are exercised without accelerator hardware.  Set
BIGSI_TEST_DEVICE=1 to run on whatever JAX finds instead (the GPU);
tests marked ``gpu`` need that and skip without a GPU:

    BIGSI_TEST_DEVICE=1 python -m pytest tests/ -m gpu

A pytest plugin may import jax before this conftest runs, so both the
env var and the live jax config are set (the config update is safe any
time before the backend is first used).
"""

import os

import pytest

if not os.environ.get("BIGSI_TEST_DEVICE"):
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu():
    """The first GPU, or a skip: decided when the test runs, never at
    import or collection time."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU (JAX found %s)" % dev.platform)
    return dev
