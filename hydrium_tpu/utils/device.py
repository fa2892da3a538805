"""The accelerator a measurement runs on.

Every timing this repository prints names its device: JAX's platform,
device kind and device count, and the card's name and power limit as
nvidia-smi reports them (a card set below its maximum power runs slower
under load).  A measurement that finds no GPU stops; it never falls
back to the CPU."""

from __future__ import annotations

import subprocess


def nvidia_smi_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`,
    or a note saying why it could not be read."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return (r.stdout.strip() or r.stderr.strip()
            or f"nvidia-smi rc={r.returncode}")


def require_gpu() -> dict:
    """{"platform", "kind", "count"} of JAX's devices; SystemExit when
    the first device is not a GPU."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX runs on {devs[0].platform}")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
