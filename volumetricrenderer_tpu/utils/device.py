"""What a measurement needs to know about the card it runs on.

A number taken on the CPU is not a device number, so measuring entry
points (bench.py, chip_smoke.py) call require_gpu() first and fail when
JAX finds no GPU; card_description() names the card and its power limit
(a card set below its maximum power runs slower under load) for every
line they print.
"""
from __future__ import annotations

import subprocess

import jax

__all__ = ["require_gpu", "card_description"]


def require_gpu():
    """jax.devices() when they are GPUs; raises SystemExit otherwise."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"error: no GPU found (JAX platform {devices[0].platform!r}); "
            "device measurements need the card and never fall back to "
            "the CPU")
    return devices


def card_description() -> str:
    """`name, power.limit` of each card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return "; ".join(line.strip() for line in out.stdout.splitlines()
                     if line.strip())
