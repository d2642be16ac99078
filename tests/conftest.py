"""Test harness configuration.

Tests run on the CPU backend with 8 virtual devices, so every sharding and
collective code path runs without an accelerator (``XLA_FLAGS`` is read
when the backend starts, so it is set before JAX is first used). What
only runs on the card is driven by ``chip_smoke.py``.
"""

import os
import sys

# XLA_FLAGS is read by the CPU client at backend init — set before first use.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

# Make the repo root importable regardless of how pytest is invoked.
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO_ROOT not in sys.path:
    sys.path.insert(0, _REPO_ROOT)

import jax  # noqa: E402

# the env var is read when jax is imported; a plugin may have been first
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_threefry_partitionable", True)

assert jax.devices()[0].platform == "cpu", jax.devices()
assert len(jax.devices()) == 8, jax.devices()
