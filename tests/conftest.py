"""Test environment: run everything on a virtual 8-device CPU mesh.

Must set XLA flags BEFORE jax is imported anywhere (SURVEY.md §4.4):
every mesh/sharding/collective test exercises real SPMD partitioning on
8 fake CPU devices, so pod runs are config-only changes.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
# Per-primitive compiles are slow on the CPU; the persistent cache makes
# repeat test runs fast.
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "0")

import jax  # noqa: E402

from davo_tpu.utils.compile_cache import setup_compile_cache  # noqa: E402

setup_compile_cache()
# Tests run on the local 8-virtual-device CPU backend, whatever
# platforms the environment lists; conftest runs before any backend is
# instantiated.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)
