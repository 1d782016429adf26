"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Mirrors the SURVEY.md §4 strategy: multi-device sharding is validated
without accelerators by forcing the CPU backend with 8 virtual devices;
the GPU path itself is exercised by ``chip_smoke.py`` on the card.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

# The tests compile for the CPU whatever accelerator the machine has, and
# keep nothing in the persistent compile cache (CLI tests call main(),
# which points the cache at the checkout).
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_compilation_cache", False)

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0xCCFB2D5055D8C990 % 2**32)
