"""Test configuration.

Tests run on the CPU with 8 virtual devices, so the multi-device sharding
path is exercised without accelerators. Tests that need the card carry the
``gpu`` marker and skip on the CPU; on a machine with a GPU run them with

    KMT_TESTS_ON_CARD=1 python -m pytest -m gpu tests/

(``KMT_TESTS_ON_CARD=1`` leaves JAX on its default platform instead of
forcing the CPU).
"""
import os

import pytest

if os.environ.get("KMT_TESTS_ON_CARD") != "1":
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    os.environ["JAX_PLATFORMS"] = "cpu"


@pytest.fixture
def gpu():
    """The GPU JAX runs on; skips the test when JAX's device is not a GPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(
            f"needs a GPU (JAX's device is {dev.platform}); "
            "run with KMT_TESTS_ON_CARD=1 on a GPU machine"
        )
    return dev
