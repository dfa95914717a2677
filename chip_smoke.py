"""Smoke test of the LW+SW flux pipeline on NVIDIA GPUs, through the entry
points a user calls, at the published widths.

    python chip_smoke.py                # phases 0-5 on one GPU
    python chip_smoke.py --four-cards   # phase 6 only, on four GPUs

Phases (any failure exits non-zero; nothing is caught and passed over):
  0 device      JAX version and devices, the card's name and power limit;
                fails unless JAX's platform is "gpu".  Builds the native
                netCDF engine (``make -C native``) and says which reader
                loads the files.
  1 generate    the three seeded ckd files and a 100-site x 18-experiment x
                60-layer synthetic RFMIP file.
  2 rfmip       ``cli.ecckd_rfmip`` file to file (LW+SW+heating rates) and
                ``cli.ecckd_rfmip_lw -p 2`` on the 16-band file, checked
                against the f64 path on the CPU in this process.
  3 throughput  a jitted ``lw_sw_fluxes`` step at the RFMIP shape and at
                65,536 columns in 8,192-column chunks: compile seconds,
                smoke timing, peak memory, top device ops; a 2,048-column
                slice checked against f64.
  4 gradient    ``jax.grad`` of the column-summed OLR with respect to the
                layer temperatures on 1,800 columns, against f64.
  5 streaming   ``cli.scale_bench`` over 262,144 columns in 65,536-column
                chunks with --out-dir --resume; each chunk checked against a
                direct solve.
  6 four cards  phase 2's RFMIP run on the 4-device columns mesh against the
                same run with --no-shard, and phase 5 over the mesh.

The last line printed is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

FLUX_BOUND = 2e-4
"""max |f32 - f64| / max |f64| per flux product.  The CPU's own f32 path
already sits ~1e-4 from f64 on deep columns; the GPU's transcendentals and
summation order add a little."""
HR_BOUND = 0.05
"""K/day: the SW model's stated heating-rate tolerance (BASELINE.md), for
layers at p >= HR_MIN_PRESSURE.  Thinner layers amplify the f32 flux error
through 1/dp; their maxima are printed, not bounded."""
HR_MIN_PRESSURE = 1.0e4
GRAD_BOUND = 1e-3
"""max |f32 - f64| / max |f64| of the OLR gradient: the adjoint runs the
sweeps backwards through exp/expm1 in f32."""
SAME_PROGRAM_BOUND = 1e-6
"""Relative agreement of runs that differ only in placement (sharded or
not, streamed or direct): the physics is column-independent."""

NLAY = 60
RFMIP_SITES, RFMIP_EXPERIMENTS = 100, 18
THROUGHPUT_COLUMNS, CHUNK, SLICE_COLUMNS = 65_536, 8_192, 2_048
STREAM_COLUMNS, STREAM_CHUNK = 262_144, 65_536


def check(ok: bool, message: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {message}")


def phase(name: str):
    print(f"\n== {name}", flush=True)
    return time.perf_counter()


def phase0_device(min_count: int):
    from ecckd_tpu.utils.device import card_name_and_power_limit, require_gpu
    t0 = phase("phase 0: device")
    devices = require_gpu(min_count)
    card = card_name_and_power_limit()
    print(f"card: {card}")
    subprocess.run(["make", "-C", os.path.join(REPO, "native")], check=True,
                   stdout=subprocess.DEVNULL)
    from ecckd_tpu.io import nc3_native
    reader = ("native C++ engine" if nc3_native.load_library() is not None
              else "scipy.io.netcdf_file")
    print(f"netCDF reader: {reader}")
    print(f"phase 0 ok ({time.perf_counter() - t0:.1f} s)")
    return devices, card


def phase1_generate(out: str, nsite: int, nexp: int, nlay: int):
    from ecckd_tpu.io.rfmip import write_synthetic_rfmip
    from ecckd_tpu.io.synthetic import synthetic_ckd_files
    t0 = phase("phase 1: generate")
    paths = synthetic_ckd_files(os.path.join(out, "ckd"), seed=0)
    rfmip = os.path.join(out, "rfmip.nc")
    write_synthetic_rfmip(rfmip, nsite=nsite, nlay=nlay, nexp=nexp, seed=0)
    for name, path in {**paths, "rfmip": rfmip}.items():
        print(f"{name}: {path} ({os.path.getsize(path)} bytes)")
    print(f"phase 1 ok ({time.perf_counter() - t0:.1f} s)")
    return paths, rfmip


def rfmip_reference(rfmip: str, paths: dict, lw_kind: str, n_angles: int,
                    shortwave: bool) -> dict:
    """f64 CPU fluxes and heating rates of an RFMIP file, prepared exactly
    as the drivers prepare it."""
    import jax
    from ecckd_tpu.cli.common import build_gas_concs
    from ecckd_tpu.fluxes import heating_rate
    from ecckd_tpu.io.rfmip import read_rfmip
    from ecckd_tpu.models.loader import load_ckd_model
    from ecckd_tpu.pipeline import clamp_top_pressure, lw_fluxes, sw_fluxes
    from ecckd_tpu.utils.device import f64_on_cpu

    f64 = np.float64
    with f64_on_cpu():
        data = read_rfmip(rfmip)
        lw = load_ckd_model(paths[lw_kind], dtype=f64)
        plev = clamp_top_pressure(data.plev.astype(f64), lw.get_press_min(),
                                  data.top_at_1)
        concs = build_gas_concs(data, f64)
        f = jax.jit(lambda m, *a: lw_fluxes(
            m, *a, n_gauss_angles=n_angles, top_at_1=data.top_at_1))(
            lw, plev, data.tlay.astype(f64), data.tlev.astype(f64),
            data.sfc_t.astype(f64), data.sfc_emis.astype(f64), concs)
        out = {"rlu": f.flux_up, "rld": f.flux_dn,
               "hrl": heating_rate(f.flux_up, f.flux_dn, plev)}
        if shortwave:
            sw = load_ckd_model(paths["sw_wide"], dtype=f64)
            f = jax.jit(lambda m, *a: sw_fluxes(m, *a,
                                                top_at_1=data.top_at_1))(
                sw, plev, data.tlay.astype(f64), concs,
                data.sfc_alb.astype(f64), data.tsi.astype(f64),
                data.sza.astype(f64))
            out.update(rsu=f.flux_up, rsd=f.flux_dn,
                       hrs=heating_rate(f.flux_up, f.flux_dn, plev))
        out = {k: np.asarray(v) for k, v in out.items()}
    out["play"] = 0.5 * (plev[:, 1:] + plev[:, :-1])
    return out


def rfmip_outputs(directory: str, physics_index: int, shortwave: bool
                  ) -> dict:
    """The flux and heating-rate files a driver wrote, as (ncol, n)."""
    from ecckd_tpu.io.rfmip import read_fluxes
    names = ("rlu", "rld", "hrl") + (("rsu", "rsd", "hrs") if shortwave
                                     else ())
    out = {}
    for name in names:
        p = physics_index if name in ("rlu", "rld", "hrl") else 1
        out[name] = read_fluxes(os.path.join(
            directory, f"{name}_Efx_RTE-ecckd_rad-irf_r1i1p{p}f1_gn.nc"),
            name)
    return out


def compare_rfmip(got: dict, ref: dict, label: str) -> None:
    from ecckd_tpu.utils.device import max_rel_error
    for name in ("rlu", "rld", "rsu", "rsd"):
        if name in got:
            err = max_rel_error(got[name], ref[name])
            print(f"{label} {name}: max|d|/max|F_f64| = {err:.3e} "
                  f"(bound {FLUX_BOUND:.0e}; scale "
                  f"{np.abs(ref[name]).max():.1f} W m-2)")
            check(err <= FLUX_BOUND, f"{label} {name} error {err:.3e}")
    deep = ref["play"] >= HR_MIN_PRESSURE
    for name in ("hrl", "hrs"):
        if name in got:
            d = np.abs(got[name] - ref[name])
            print(f"{label} {name}: max|d| = {d[deep].max():.4e} K/day at "
                  f"p >= {HR_MIN_PRESSURE:.0e} Pa (bound {HR_BOUND}); "
                  f"{d[~deep].max():.4e} K/day above")
            check(d[deep].max() <= HR_BOUND,
                  f"{label} {name} error {d[deep].max():.3e} K/day")


def phase2_rfmip(out: str, paths: dict, rfmip: str) -> None:
    from ecckd_tpu.cli import ecckd_rfmip, ecckd_rfmip_lw
    t0 = phase("phase 2: RFMIP file to file")
    d = os.path.join(out, "rfmip_lwsw")
    metrics = os.path.join(d, "metrics.json")
    check(ecckd_rfmip.main([rfmip, paths["lw_fsck"], paths["sw_wide"],
                            "--output-dir", d, "--heating-rates",
                            "--metrics-json", metrics]) == 0,
          "ecckd_rfmip returned non-zero")
    with open(metrics) as f:
        print(f"metrics: {f.read().strip()}")
    ref = rfmip_reference(rfmip, paths, "lw_fsck", 1, shortwave=True)
    compare_rfmip(rfmip_outputs(d, 1, True), ref, "lw_fsck+sw_wide")

    d = os.path.join(out, "rfmip_lw_p2")
    check(ecckd_rfmip_lw.main([rfmip, paths["lw_rrtmgp"], "-p", "2",
                               "--output-dir", d, "--heating-rates"]) == 0,
          "ecckd_rfmip_lw returned non-zero")
    ref = rfmip_reference(rfmip, paths, "lw_rrtmgp", 3, shortwave=False)
    compare_rfmip(rfmip_outputs(d, 2, False), ref, "lw_rrtmgp 3 angles")
    print(f"phase 2 ok ({time.perf_counter() - t0:.1f} s)")


def phase3_throughput(out: str, paths: dict, shapes, slice_columns: int
                      ) -> None:
    """``shapes``: (ncol, chunk) pairs; the last one is checked on its
    first ``slice_columns`` columns."""
    import jax
    from bench import check_against_f64, measure_step
    from ecckd_tpu.io.synthetic import example_flux_batch
    from ecckd_tpu.models.loader import load_ckd_model
    t0 = phase("phase 3: throughput shape")
    lw = jax.device_put(load_ckd_model(paths["lw_fsck"], dtype=np.float32))
    sw = jax.device_put(load_ckd_model(paths["sw_wide"], dtype=np.float32))
    for ncol, chunk in shapes:
        batch = example_flux_batch(ncol, NLAY, np.float32)
        fluxes, m = measure_step(lw, sw, batch, chunk,
                                 trace_dir=os.path.join(out, f"trace_{ncol}"))
        print(f"[{ncol} x {NLAY}, column_chunk={chunk}] memory_analysis: "
              f"{m['memory_analysis']}")
        print(f"[{ncol} x {NLAY}] compile {m['compile_s']:.2f} s; smoke "
              f"timing {m['seconds_per_step'] * 1e3:.3f} ms/step "
              f"({m['columns_per_sec']:.0f} columns/s); peak_bytes_in_use "
              f"{m['peak_bytes_in_use']}; compilations in timed loop "
              f"{m['compiles_in_timed_loop']}")
        print(f"[{ncol} x {NLAY}] optimized HLO: {m['hlo_dot_ops']} dot "
              f"ops, {m['hlo_cublas_calls']} cuBLAS calls")
        print(f"[{ncol} x {NLAY}] traced step: device ops sum to "
              f"{m['device_op_seconds'] * 1e3:.3f} ms; trace lines read "
              f"from {m['device_trace_lines']}")
        for name, sec, count in m["top_device_ops"]:
            print(f"[{ncol} x {NLAY}] top device op: {name}: "
                  f"{sec * 1e3:.3f} ms over {count} events")
        check(m["compiles_in_timed_loop"] == 0, "compiled inside timed loop")
    errors = check_against_f64(paths, batch, fluxes, slice_columns)
    for name, err in errors.items():
        print(f"[{slice_columns}-column slice] {name}: max|d|/max|F_f64| = "
              f"{err:.3e} (bound {FLUX_BOUND:.0e})")
        check(err <= FLUX_BOUND, f"throughput slice {name} error {err:.3e}")
    print(f"phase 3 ok ({time.perf_counter() - t0:.1f} s)")


def phase4_gradient(paths: dict, rfmip: str) -> None:
    import jax
    import jax.numpy as jnp
    from ecckd_tpu.cli.common import build_gas_concs
    from ecckd_tpu.io.rfmip import read_rfmip
    from ecckd_tpu.models.loader import load_ckd_model
    from ecckd_tpu.pipeline import clamp_top_pressure, lw_fluxes
    from ecckd_tpu.utils.device import f64_on_cpu, max_rel_error
    t0 = phase("phase 4: gradient")
    data = read_rfmip(rfmip)

    def olr(model, tlay, plev, tlev, tsfc, emis, concs):
        f = lw_fluxes(model, plev, tlay, tlev, tsfc, emis, concs)
        return jnp.sum(f.flux_up[:, 0])

    def grad(dtype):
        model = load_ckd_model(paths["lw_fsck"], dtype=dtype)
        plev = clamp_top_pressure(data.plev.astype(dtype),
                                  model.get_press_min())
        g = jax.jit(jax.grad(olr, argnums=1))(
            model, data.tlay.astype(dtype), plev, data.tlev.astype(dtype),
            data.sfc_t.astype(dtype), data.sfc_emis.astype(dtype),
            build_gas_concs(data, dtype))
        return np.asarray(g)

    got = grad(np.float32)
    with f64_on_cpu():
        ref = grad(np.float64)
    err = max_rel_error(got, ref)
    print(f"d(sum OLR)/d(tlay) on {data.ncol} columns: max|d|/max|g_f64| = "
          f"{err:.3e} (bound {GRAD_BOUND:.0e}); all finite: "
          f"{bool(np.isfinite(got).all())}")
    check(np.isfinite(got).all() and err <= GRAD_BOUND,
          f"gradient error {err:.3e}")
    print(f"phase 4 ok ({time.perf_counter() - t0:.1f} s)")


def run_scale_bench(argv) -> dict:
    """``cli.scale_bench.main(argv)``; returns its JSON metrics line."""
    from ecckd_tpu.cli import scale_bench
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = scale_bench.main(argv)
    print(buf.getvalue().strip())
    check(rc == 0, "scale_bench returned non-zero")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def check_stream(d: str, paths: dict, columns: int, chunk: int, nlay: int
                 ) -> None:
    """Each streamed chunk against a direct solve of the same chunk."""
    import jax
    from ecckd_tpu.io.synthetic import example_flux_batch
    from ecckd_tpu.models.loader import load_ckd_model
    from ecckd_tpu.pipeline import lw_sw_fluxes
    from ecckd_tpu.utils.device import max_rel_error
    f32 = np.float32
    lw = jax.device_put(load_ckd_model(paths["lw_fsck"], dtype=f32))
    sw = jax.device_put(load_ckd_model(paths["sw_wide"], dtype=f32))
    base = example_flux_batch(chunk, nlay, f32)
    solve = jax.jit(lw_sw_fluxes)
    streamed = {n: np.load(os.path.join(d, f"{n}.npy"))
                for n in ("rlu", "rld", "rsu", "rsd")}
    worst = 0.0
    for i in range(columns // chunk):
        tsfc = base["tsfc"] + f32(0.01) * f32(i % 7)
        flw, fsw = solve(lw, sw, base["plev"], base["tlay"], base["tlev"],
                         tsfc, base["emis"], base["concs"], base["alb"],
                         base["tsi"], base["sza"])
        rows = slice(i * chunk, (i + 1) * chunk)
        for name, ref in zip(("rlu", "rld", "rsu", "rsd"),
                             (flw.flux_up, flw.flux_dn, fsw.flux_up,
                              fsw.flux_dn)):
            worst = max(worst, max_rel_error(streamed[name][rows], ref))
    print(f"streamed chunks vs direct solves: max|d|/max|F| = {worst:.3e} "
          f"(bound {SAME_PROGRAM_BOUND:.0e})")
    check(worst <= SAME_PROGRAM_BOUND, f"streamed chunk error {worst:.3e}")


def phase5_streaming(out: str, paths: dict, columns: int, chunk: int,
                     nlay: int, shard: bool = False) -> dict:
    t0 = phase("phase 5: streaming" + (" over the mesh" if shard else ""))
    d = os.path.join(out, "stream_mesh" if shard else "stream")
    argv = ["--columns", str(columns), "--chunk", str(chunk), "--nlay",
            str(nlay), "--out-dir", d, "--resume", "--lw-file",
            paths["lw_fsck"], "--sw-file", paths["sw_wide"]]
    metrics = run_scale_bench(argv + ([] if shard else ["--no-shard"]))
    check_stream(d, paths, columns, chunk, nlay)
    print(f"phase 5 ok ({time.perf_counter() - t0:.1f} s)")
    return metrics


def phase6_four_cards(out: str, paths: dict, rfmip: str, n_devices: int,
                      columns: int, chunk: int, nlay: int) -> None:
    from ecckd_tpu.cli import ecckd_rfmip
    from ecckd_tpu.utils.device import max_rel_error
    t0 = phase(f"phase 6: {n_devices}-device columns mesh")
    runs = {}
    for label, extra in (("mesh", []), ("single", ["--no-shard"])):
        d = os.path.join(out, f"rfmip_{label}")
        metrics = os.path.join(d, "metrics.json")
        check(ecckd_rfmip.main([rfmip, paths["lw_fsck"], paths["sw_wide"],
                                "--output-dir", d, "--heating-rates",
                                "--metrics-json", metrics] + extra) == 0,
              f"ecckd_rfmip ({label}) returned non-zero")
        with open(metrics) as f:
            runs[label] = (json.load(f), rfmip_outputs(d, 1, True))
    shards = runs["mesh"][0]["output_devices"]
    print(f"sharded RFMIP outputs live on {shards} devices")
    check(shards == n_devices, f"outputs on {shards} devices, not "
          f"{n_devices}")
    check(runs["single"][0]["output_devices"] == 1, "--no-shard run sharded")
    for name, ref in runs["single"][1].items():
        err = max_rel_error(runs["mesh"][1][name], ref)
        print(f"mesh vs single-card {name}: max|d|/max|ref| = {err:.3e} "
              f"(bound {SAME_PROGRAM_BOUND:.0e})")
        check(err <= SAME_PROGRAM_BOUND, f"mesh {name} error {err:.3e}")
    metrics = phase5_streaming(out, paths, columns, chunk, nlay, shard=True)
    check(metrics["n_devices"] == n_devices,
          f"streaming ran on {metrics['n_devices']} devices")
    print(f"phase 6 ok ({time.perf_counter() - t0:.1f} s)")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only phase 6, on a 4-GPU columns mesh")
    args = p.parse_args(argv)
    n_devices = 4 if args.four_cards else 1
    out = os.path.join(REPO, ".smoke_out")
    t_start = time.perf_counter()

    from ecckd_tpu.config import setup_compilation_cache
    from ecckd_tpu.utils.device import device_summary

    devices, card = phase0_device(n_devices)
    setup_compilation_cache()
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    paths, rfmip = phase1_generate(out, RFMIP_SITES, RFMIP_EXPERIMENTS, NLAY)
    if args.four_cards:
        phase6_four_cards(out, paths, rfmip, n_devices, STREAM_COLUMNS,
                          STREAM_CHUNK, NLAY)
    else:
        phase2_rfmip(out, paths, rfmip)
        phase3_throughput(out, paths,
                          ((RFMIP_SITES * RFMIP_EXPERIMENTS, CHUNK),
                           (THROUGHPUT_COLUMNS, CHUNK)), SLICE_COLUMNS)
        phase4_gradient(paths, rfmip)
        phase5_streaming(out, paths, STREAM_COLUMNS, STREAM_CHUNK, NLAY)
    print(f"\nall phases ok in {time.perf_counter() - t_start:.1f} s on "
          f"{card}")
    print(json.dumps({"ok": True, "device": device_summary(devices)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
