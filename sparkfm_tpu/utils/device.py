"""The accelerator a measurement ran on.

Every timed result names its device: JAX's platform, device kind and
count, and the card's name and power limit as nvidia-smi reports them (a
card set below its maximum power runs slower under load). A measurement
that finds no GPU fails instead of timing the CPU.
"""

from __future__ import annotations

import subprocess
from typing import Dict, Tuple

NVIDIA_SMI = ["nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader"]


def parse_gpu_line(text: str) -> Tuple[str, str]:
    """(name, power limit) of the first card in ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` output, e.g.
    ``NVIDIA H100 80GB HBM3, 700.00 W``."""
    lines = [ln.strip() for ln in text.splitlines() if ln.strip()]
    if not lines:
        raise ValueError("nvidia-smi printed no card")
    name, sep, limit = lines[0].rpartition(",")
    if not sep or not name.strip() or not limit.strip():
        raise ValueError(f"unexpected nvidia-smi line: {lines[0]!r}")
    return name.strip(), limit.strip()


def gpu_line() -> str:
    """The card's name and power limit, ``"<name>, <limit>"``."""
    out = subprocess.run(NVIDIA_SMI, check=True, capture_output=True,
                         text=True, timeout=30).stdout
    name, limit = parse_gpu_line(out)
    return f"{name}, {limit}"


def require_gpu() -> Dict:
    """JAX's view of the device ({"platform", "kind", "count"}); raises
    RuntimeError unless JAX's default backend is a GPU."""
    import jax
    backend = jax.default_backend()
    if backend != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's default backend is {backend!r} "
            f"({jax.devices()})")
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
