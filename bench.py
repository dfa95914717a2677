"""Throughput benchmark: one LW+SW flux step on one NVIDIA GPU.

    python bench.py

Runs the combined LW (1 angle) + SW flux solve of ``pipeline.lw_sw_fluxes``
on 524,288 RFMIP-shaped 60-layer columns in 8,192-column chunks, with the
seeded fsck-LW and wide-SW ckd files as jit arguments.  It reports the
compile seconds, the steady seconds per step (timed to
``jax.block_until_ready`` after warm-up), the compilations inside the timed
window (there should be none) and the peak device memory.  The result
counts only if the step's f32 fluxes on a 2,048-column slice agree with the
f64 path on the CPU within 2e-4 of each product's scale; otherwise, or when
JAX finds no GPU, it exits non-zero.

Prints the card's name and power limit, then ONE JSON line.
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np

NCOL, NLAY, CHUNK = 524_288, 60, 8_192
GATE_COLUMNS = 2_048
FLUX_BOUND = 2e-4
"""max |f32 - f64| / max |f64| per flux product (see chip_smoke.py)."""


def measure_step(lw, sw, batch, chunk: int, trace_dir: str | None = None
                 ) -> dict:
    """Compile and time one jitted ``lw_sw_fluxes`` step on the default
    device (10 timed steps after warm-up).  ``lw``/``sw`` are models
    already on the device; ``batch`` is an ``example_flux_batch`` dict.
    Returns the fluxes of the first step and the step's metrics; with
    ``trace_dir`` also the five device operations that took the most
    time in one traced step."""
    import jax
    from ecckd_tpu.pipeline import lw_sw_fluxes
    from ecckd_tpu.utils import profiling

    step = jax.jit(lambda ml, ms, plev, tlay, tlev, tsfc, emis, concs, alb,
                   tsi, sza: lw_sw_fluxes(ml, ms, plev, tlay, tlev, tsfc,
                                          emis, concs, alb, tsi, sza,
                                          column_chunk=chunk))
    args = (lw, sw) + tuple(jax.device_put(batch[k]) for k in (
        "plev", "tlay", "tlev", "tsfc", "emis", "concs", "alb", "tsi",
        "sza"))
    counter = profiling.CompileCounter()
    t0 = time.perf_counter()
    compiled = step.lower(*args).compile()
    compile_s = time.perf_counter() - t0
    hlo = compiled.as_text()
    fluxes = jax.block_until_ready(step(*args))
    before = counter.count
    seconds = profiling.time_fn(step, *args, iters=10, warmup=1)
    out = {
        "columns": int(batch["tlay"].shape[0]),
        "column_chunk": chunk,
        "compile_s": compile_s,
        "seconds_per_step": seconds,
        "columns_per_sec": batch["tlay"].shape[0] / seconds,
        "compiles_in_timed_loop": counter.count - before,
        # None where the backend keeps no statistics (the CPU).
        "peak_bytes_in_use":
            (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use"),
        "memory_analysis": str(compiled.memory_analysis()),
        "hlo_dot_ops": hlo.count(" dot("),
        "hlo_cublas_calls": hlo.lower().count("cublas"),
    }
    if trace_dir is not None:
        with profiling.trace(trace_dir):
            jax.block_until_ready(step(*args))
        profile = profiling.newest_trace(trace_dir)
        ops = profiling.top_device_ops(profile, n=None)
        out["top_device_ops"] = ops[:5]
        out["device_op_seconds"] = sum(sec for _, sec, _ in ops)
        out["device_trace_lines"] = sorted({
            line.name for plane in profile.planes
            if plane.name.startswith("/device:") for line in plane.lines})
    return fluxes, out


def reference_f64(paths: dict, batch, n_gauss_angles: int = 1):
    """f64 LW+SW fluxes of ``batch`` on the CPU: (rlu, rld, rsu, rsd)."""
    import jax
    from ecckd_tpu.models.loader import load_ckd_model
    from ecckd_tpu.pipeline import lw_sw_fluxes
    from ecckd_tpu.utils.device import as_f64, f64_on_cpu

    with f64_on_cpu():
        lw = load_ckd_model(paths["lw_fsck"], dtype=np.float64)
        sw = load_ckd_model(paths["sw_wide"], dtype=np.float64)
        b = as_f64(batch)
        flw, fsw = jax.jit(lambda ml, ms, *a: lw_sw_fluxes(
            ml, ms, *a, n_gauss_angles=n_gauss_angles))(
            lw, sw, b["plev"], b["tlay"], b["tlev"], b["tsfc"], b["emis"],
            b["concs"], b["alb"], b["tsi"], b["sza"])
        return tuple(np.asarray(x) for x in (flw.flux_up, flw.flux_dn,
                                             fsw.flux_up, fsw.flux_dn))


def slice_batch(batch, n: int) -> dict:
    """The first ``n`` columns of an ``example_flux_batch`` dict."""
    import jax
    return jax.tree_util.tree_map(
        lambda x: x[:n] if np.ndim(x) >= 1 else x, batch)


def check_against_f64(paths: dict, batch, fluxes, n: int) -> dict:
    """Max relative error of each flux product on the first ``n`` columns
    against the f64 CPU reference."""
    from ecckd_tpu.utils.device import max_rel_error
    flw, fsw = fluxes
    got = (flw.flux_up, flw.flux_dn, fsw.flux_up, fsw.flux_dn)
    ref = reference_f64(paths, slice_batch(batch, n))
    return {name: max_rel_error(np.asarray(g)[:n], r)
            for name, g, r in zip(("rlu", "rld", "rsu", "rsd"), got, ref)}


def main() -> int:
    import jax
    from ecckd_tpu.config import setup_compilation_cache
    from ecckd_tpu.io.synthetic import example_flux_batch, synthetic_ckd_files
    from ecckd_tpu.models.loader import load_ckd_model
    from ecckd_tpu.utils.device import (card_name_and_power_limit,
                                        device_summary, require_gpu)

    setup_compilation_cache()
    devices = require_gpu()
    card = card_name_and_power_limit()
    print(f"# card: {card}", flush=True)
    paths = synthetic_ckd_files()
    lw = jax.device_put(load_ckd_model(paths["lw_fsck"], dtype=np.float32))
    sw = jax.device_put(load_ckd_model(paths["sw_wide"], dtype=np.float32))
    batch = example_flux_batch(NCOL, NLAY, np.float32)
    fluxes, m = measure_step(lw, sw, batch, CHUNK)
    errors = check_against_f64(paths, batch, fluxes, GATE_COLUMNS)
    ok = max(errors.values()) <= FLUX_BOUND and m[
        "compiles_in_timed_loop"] == 0
    print(json.dumps({
        "metric": "lw+sw_flux_step_throughput", "unit": "columns/s",
        "value": m["columns_per_sec"], "ok": ok,
        "seconds_per_step": m["seconds_per_step"],
        "compile_s": m["compile_s"], "nlay": NLAY,
        "columns": NCOL, "column_chunk": CHUNK,
        "compiles_in_timed_loop": m["compiles_in_timed_loop"],
        "peak_bytes_in_use": m["peak_bytes_in_use"],
        "max_rel_error_vs_f64": errors, "bound": FLUX_BOUND,
        "card": card, "device": device_summary(devices)}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
