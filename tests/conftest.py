"""Test configuration: run everything on the CPU with 8 virtual devices
so sharding tests exercise a real Mesh without accelerator hardware.

RSSYNC_GPU_TESTS=1 keeps the session's own backend instead, so that
the `-m gpu` tests (tests/test_gpu.py) compile kernels on the card.
"""

import os

if os.environ.get("RSSYNC_GPU_TESTS") != "1":
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    os.environ["JAX_PLATFORMS"] = "cpu"

    import jax

    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)
