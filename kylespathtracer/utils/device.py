"""What device a measurement ran on.

Every timing line names the platform, device kind and device count as JAX
reports them, and the card's name and power limit as nvidia-smi reports
them (a card set below its maximum power runs slower under load).
nvidia-smi runs in a child process that does not touch JAX.
"""

from __future__ import annotations

import subprocess

import jax


def nvidia_smi() -> str:
    """`name, power.limit` of each card, one line per card, as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` prints
    them; "nvidia-smi unavailable" where it cannot run."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        )
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"
    return out.stdout.strip()


def device_info() -> dict:
    d = jax.devices()
    return {
        "platform": d[0].platform,
        "kind": d[0].device_kind,
        "count": len(d),
    }


def require_gpu() -> dict:
    """The device info; raises SystemExit when JAX found no GPU (a
    measurement never falls back to the CPU)."""
    info = device_info()
    if info["platform"] != "gpu":
        raise SystemExit(
            f"no GPU: JAX's first device is {info['platform']!r} "
            f"({info['kind']}); this measurement runs only on the card"
        )
    return info
