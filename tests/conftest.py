"""Test configuration.

By default the tests run on the CPU backend with 8 virtual devices
(``JAX_PLATFORMS=cpu``), so the sharded paths run on a virtual mesh
exactly as ``__graft_entry__.dryrun_multichip`` does.

Tests marked ``gpu`` need an NVIDIA card: run them on the machine with
the card with ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.
The ``gpu`` fixture skips them, with a reason, wherever JAX finds no
GPU.
"""

import os

import pytest

platforms = os.environ.setdefault("JAX_PLATFORMS", "cpu")
if platforms == "cpu":
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", platforms)
if platforms == "cpu":
    jax.config.update("jax_num_cpu_devices", 8)


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU."""
    platform = jax.devices()[0].platform
    if platform != "gpu":
        pytest.skip(f"needs a GPU; JAX platform is {platform!r}")
