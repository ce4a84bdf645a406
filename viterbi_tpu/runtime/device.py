"""What ran a measurement: the JAX device and the card's own report.

Every benchmark line carries ``describe()``, so a number is never read
without the device, its count, and the card's name and power limit (a
card set below its maximum power runs slower under load).
"""

from __future__ import annotations

import subprocess

import jax


def nvidia_smi() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi prints
    them. Raises if nvidia-smi is missing or fails."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def require_gpu() -> None:
    """Refuse to measure anywhere but on a GPU: a number from another
    backend must never be read as a device number."""
    platform = jax.devices()[0].platform
    if platform != "gpu":
        raise SystemExit(f"no GPU: JAX platform is {platform!r}")


def describe() -> dict:
    """The device fields every result line carries."""
    devices = jax.devices()
    return {"platform": devices[0].platform,
            "device_kind": devices[0].device_kind,
            "device_count": len(devices),
            "gpu": nvidia_smi()}
