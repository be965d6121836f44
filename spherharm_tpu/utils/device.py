"""The one device check: measurement entry points run on a GPU or fail.

A number taken on the CPU must never be reported under a device metric,
so ``require_gpu`` raises instead of falling back. It also reads the
card's name and power limit, which belong beside every number taken on
it (a card capped below its maximum power runs slower under load).
"""

from __future__ import annotations

import subprocess


def card_name() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` of the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0].strip()


def require_gpu(count: int = 1):
    """Return (devices, card) if JAX sees at least ``count`` GPUs;
    raise RuntimeError otherwise."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX sees {len(devs)} {devs[0].platform!r} device(s)")
    if len(devs) < count:
        raise RuntimeError(f"need {count} GPUs, JAX sees {len(devs)}")
    return devs, card_name()


def describe(devs) -> dict:
    """The device record every reported result carries."""
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
