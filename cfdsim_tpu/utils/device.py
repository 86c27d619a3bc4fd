"""Which device a measurement runs on, and a guard for GPU-only paths.

Every speed figure this program prints names its device. A path that
measures the card refuses to run anywhere else rather than fall back to
the CPU, whose timings say nothing about the card.
"""

from __future__ import annotations

import subprocess


def device_info() -> dict:
    """Platform, kind and count of JAX's devices, as JAX reports them."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def require_gpu() -> dict:
    """``device_info()``; raises RuntimeError unless JAX's first device is
    a GPU."""
    info = device_info()
    if info["platform"] != "gpu":
        raise RuntimeError(
            f"this path measures the GPU, but JAX's first device is "
            f"{info['platform']!r} ({info['kind']}); no CPU fallback")
    return info


def gpu_name_and_power_limit() -> str:
    """The card's name and power limit, one line per card, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them (a child process: it stays off JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()
