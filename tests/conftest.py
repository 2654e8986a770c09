"""Test config: the tests run on the CPU, on a virtual 8-device CPU mesh, so
the multi-device sharding paths are exercised without accelerators (SURVEY.md
§4 implication). ``jax_platforms`` is pinned to 'cpu' before any backend
starts, whatever JAX_PLATFORMS says. The GPU runs through the normal entry
points: ``python chip_smoke.py`` (one GPU) and ``python chip_smoke.py --four``.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture()
def rng():
    return np.random.default_rng(0)
