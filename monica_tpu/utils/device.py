"""The accelerator a measurement runs on: a gate that refuses to time
anything without a GPU (no CPU fallback), and the card's name and power
limit, printed beside every number."""

from __future__ import annotations

import subprocess


def card_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` of the first card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"
    return out.splitlines()[0] if out else "nvidia-smi: no output"


def require_gpu(count: int = 1, what: str = "this measurement"):
    """JAX's devices, or SystemExit unless the default platform is a GPU
    with at least ``count`` devices."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"{what}: no GPU found — JAX's default platform is "
            f"{devs[0].platform!r}; it runs only on an NVIDIA GPU"
        )
    if len(devs) < count:
        raise SystemExit(f"{what}: needs {count} GPUs, JAX sees {len(devs)}")
    return devs
