"""Test harness config.

Tests run on the platform ``JAX_PLATFORMS`` names, the CPU when it names
none. On the CPU the backend gets 8 virtual devices, so multi-device
``shard_map`` code paths run unmodified (SURVEY.md §4 "Multi-chip without a
cluster"). Tests that need the card are marked ``gpu`` and take the ``gpu``
fixture, which skips them elsewhere; ``chip_smoke.py`` runs them on the card.
"""

import os

import jax
import pytest

if os.environ.get("JAX_PLATFORMS", "cpu") == "cpu":
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    jax.config.update("jax_platforms", "cpu")
# fp64 paths (reference validates at fp64) need x64 enabled.
jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu():
    """Skips the test unless JAX computes on a GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU; runs on the card through chip_smoke.py")
