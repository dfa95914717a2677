"""Timing and trace utilities (SURVEY.md section 5.1).

The reference has no profiling at all (timing intent only hinted in a
comment, ecckd_rfmip_sw.F90:104-105).  Here: a steady-state step timer
that waits on the device with ``jax.block_until_ready``, a jax.profiler
trace context, and the reduction of a device trace to the operations that
took the most device time.
"""
from __future__ import annotations

import contextlib
import glob
import os
import time
from typing import Iterator, List, Tuple

import jax


def time_fn(fn, *args, iters: int = 10, warmup: int = 2) -> float:
    """Steady-state seconds per call of a jitted function: ``warmup``
    untimed calls (compilation included), then ``iters`` calls timed on
    the host clock up to ``jax.block_until_ready`` of the last result."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    out = None
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a jax.profiler device trace (view with TensorBoard/XProf)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def newest_trace(log_dir: str) -> jax.profiler.ProfileData:
    """The most recent ``*.xplane.pb`` that ``trace(log_dir)`` wrote."""
    paths = sorted(glob.glob(os.path.join(log_dir, "plugins", "profile",
                                          "*", "*.xplane.pb")))
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb trace under {log_dir}")
    return jax.profiler.ProfileData.from_file(paths[-1])


def top_device_ops(profile: jax.profiler.ProfileData, n: int | None = 5
                   ) -> List[Tuple[str, float, int]]:
    """The ``n`` operations (all with ``n=None``) with the most device time
    in a trace, as (name, seconds, count), summed over every ``/device:``
    plane.  Each plane's "XLA Ops" line is read where the trace has one,
    else its "Stream" lines (one event per kernel)."""
    totals: dict = {}
    for plane in profile.planes:
        if not plane.name.startswith("/device:"):
            continue
        lines = [ln for ln in plane.lines if ln.name == "XLA Ops"]
        if not lines:
            lines = [ln for ln in plane.lines if ln.name.startswith("Stream")]
        for line in lines:
            for ev in line.events:
                sec, count = totals.get(ev.name, (0.0, 0))
                totals[ev.name] = (sec + ev.duration_ns * 1e-9, count + 1)
    if not totals:
        raise ValueError("trace holds no device operations; planes: "
                         + ", ".join(p.name for p in profile.planes))
    ranked = sorted(totals.items(), key=lambda kv: -kv[1][0])[:n]
    return [(name, sec, count) for name, (sec, count) in ranked]


BACKEND_COMPILE_EVENT = "/jax/core/compile/backend_compile_duration"


class CompileCounter:
    """Counts XLA backend compilations (loads from the persistent cache
    included) from its creation on; read ``count`` before and after a
    timed window, which should contain none."""

    def __init__(self):
        self.count = 0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event: str, duration: float, **kwargs) -> None:
        if event == BACKEND_COMPILE_EVENT:
            self.count += 1
