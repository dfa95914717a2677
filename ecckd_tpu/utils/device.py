"""The device a run is on, and the f64 CPU reference it is checked against.

A measurement path that finds no GPU fails: nothing here falls back to the
CPU.  The reference runs the same pipeline at float64 on the host CPU,
in the same process, so every device result has a comparison that does
not depend on the device's transcendentals or summation order.
"""
from __future__ import annotations

import contextlib
import subprocess
from typing import Iterator

import jax
import numpy as np


def require_gpu(min_count: int = 1) -> list:
    """The JAX devices, printed; exits non-zero unless they are at least
    ``min_count`` GPUs."""
    devices = jax.devices()
    print(f"# jax {jax.__version__}; devices: {devices}", flush=True)
    if devices[0].platform != "gpu":
        raise SystemExit(f"needs an NVIDIA GPU; JAX found platform "
                         f"{devices[0].platform!r}")
    if len(devices) < min_count:
        raise SystemExit(f"needs {min_count} GPUs; JAX found "
                         f"{len(devices)}")
    return devices


def card_name_and_power_limit() -> str:
    """``name, power.limit`` of the cards as nvidia-smi reports them (a
    child process that stays off JAX)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip()


def device_summary(devices: list) -> dict:
    """The device as JAX reports it, for result lines."""
    return {"platform": devices[0].platform,
            "kind": devices[0].device_kind, "count": len(devices)}


@contextlib.contextmanager
def f64_on_cpu() -> Iterator[None]:
    """Trace and run at float64 on the host CPU (the reference)."""
    with jax.enable_x64(True), jax.default_device(jax.devices("cpu")[0]):
        yield


def as_f64(tree):
    """Every floating array leaf of ``tree`` as a float64 numpy array."""
    def cast(x):
        x = np.asarray(x)
        return x.astype(np.float64) if np.issubdtype(x.dtype,
                                                     np.floating) else x
    return jax.tree_util.tree_map(cast, tree)


def max_rel_error(got, ref) -> float:
    """max |got - ref| over max |ref|: error relative to the product's
    scale, which small values near the top of the column cannot inflate."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())
