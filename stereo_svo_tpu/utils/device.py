"""The accelerator a measurement ran on, for the records that name it.

Every speed number this repo prints names its device: JAX's platform,
device kind and count, and the card's name and power limit as
``nvidia-smi`` reports them (a card set below its maximum power limit runs
slower under load). Measurement entry points refuse any device that is not
a GPU instead of falling back to the host CPU.
"""

from __future__ import annotations

import subprocess

import jax


def nvidia_smi_line() -> str | None:
    """``name, power.limit`` of the first card, or None without a driver."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if lines else None


def require_gpu() -> dict:
    """Device record of ``jax.devices()``.

    Raises RuntimeError unless the first device is a GPU.
    """
    devices = jax.devices()
    d0 = devices[0]
    if d0.platform != "gpu":
        raise RuntimeError(
            f"needs an NVIDIA GPU; JAX found {d0.platform!r} "
            f"({d0.device_kind}). No CPU fallback is measured.")
    smi = nvidia_smi_line()
    return {"platform": d0.platform, "kind": d0.device_kind,
            "count": len(devices),
            "power_limit": smi.split(",")[-1].strip() if smi else None,
            "nvidia_smi": smi}
