"""Test harness config: the CPU backend with 8 virtual devices.

Must run before any jax import.  Multi-device tests then exercise the
shard_map/halo/scan-carry code paths on an 8-device CPU mesh exactly as
they run on several GPUs (SURVEY.md §4).

``STEREO_TESTS_GPU=1`` leaves the real backend in place so the gpu-marked
tests (test_gpu_smoke.py) can run compiled on the card:

    STEREO_TESTS_GPU=1 python -m pytest tests/test_gpu_smoke.py -m gpu -q
"""

import os

_ON_GPU = os.environ.get("STEREO_TESTS_GPU", "").lower() not in ("", "0", "false", "no")

if not _ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
    )

import jax  # noqa: E402

from stereo_match_traditional_tpu.utils.compile_cache import (  # noqa: E402
    configure_compile_cache,
)

if not _ON_GPU:
    jax.config.update("jax_platforms", "cpu")
# The suite is compile-bound, so warm re-runs come mostly from the cache.
configure_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from stereo_match_traditional_tpu.utils.synthetic import make_pair  # noqa: E402


@pytest.fixture(scope="session")
def tiny_pair():
    return make_pair(32, 44, 10, seed=3)


@pytest.fixture(scope="session")
def small_pair():
    return make_pair(48, 64, 12, seed=1)


@pytest.fixture
def gpu():
    """Skips the test unless JAX's default device is a GPU (decided here,
    at run time, never while the module is imported)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU (run with STEREO_TESTS_GPU=1 on the card)")
    return jax.devices()[0]
