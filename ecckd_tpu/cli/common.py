"""Shared driver plumbing for the RFMIP CLI entry points.

Mirrors the reference drivers' structure (rte-ecckd/example/
rfmip-rad-irf/ecckd_rfmip_lw.F90, ecckd_rfmip_sw.F90, utils.f90), with one
jitted, column-sharded program instead of a serial block loop.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Tuple

import jax
import numpy as np

from ecckd_tpu.config import setup_compilation_cache
from ecckd_tpu.gases import GasConcs
from ecckd_tpu.io.rfmip import RFMIPData, read_rfmip, rfmip_gas_names
from ecckd_tpu.models.ckd import CKDModel
from ecckd_tpu.models.loader import load_ckd_model
from ecckd_tpu.parallel import mesh as pmesh


def make_parser(prog: str) -> argparse.ArgumentParser:
    """CLI compatible with the reference's parse_args (utils.f90:74-134),
    plus framework extensions."""
    p = argparse.ArgumentParser(
        prog=prog, description="ecCKD RFMIP flux driver")
    p.add_argument("rfmip_file", help="RFMIP input file")
    p.add_argument("ecckd_file", help="ecckd ckd-definition input file")
    p.add_argument("-f", dest="forcing_index", type=int, default=1,
                   choices=(1, 2), help="Forcing index")
    p.add_argument("-p", dest="physics_index", type=int, default=1,
                   choices=(1, 2), help="Physics index")
    p.add_argument("--output-dir", default=".", help="Flux output directory")
    p.add_argument("--precision", default="f32", choices=("f32", "f64"),
                   help="Working precision (f64 for Fortran-parity runs)")
    p.add_argument("--no-shard", action="store_true",
                   help="Disable column sharding over the device mesh")
    p.add_argument("--metrics-json", default=None,
                   help="Write run metrics (columns/s, flux ranges, "
                        "config) as one JSON file")
    p.add_argument("--heating-rates", action="store_true",
                   help="Also write layer heating rates [K/day] "
                        "(hrl/hrs files; framework extension)")
    p.add_argument("--coordinator", default=None,
                   help="Multi-host SPMD coordinator address host:port "
                        "(jax.distributed); single-host if omitted")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--validate", action="store_true",
                   help="Validate physical input ranges and assert output "
                        "finiteness (utils/checks.py)")
    return p


def setup_distributed(args) -> None:
    """Multi-host SPMD init (SURVEY.md section 5.8): after this, the same
    1-D columns mesh spans every host's devices and each host feeds its
    local shard.  No-op single-host."""
    if getattr(args, "num_processes", None):
        pmesh.init_distributed(args.coordinator, args.num_processes,
                               args.process_id)


def setup_precision(precision: str) -> np.dtype:
    setup_compilation_cache()
    if precision == "f64":
        jax.config.update("jax_enable_x64", True)
        return np.dtype(np.float64)
    return np.dtype(np.float32)


def load_inputs(args) -> Tuple[RFMIPData, CKDModel]:
    setup_distributed(args)
    data = read_rfmip(args.rfmip_file, args.forcing_index)
    print(f" Using 1 fused batch of {data.ncol} columns "
          f"({data.nsite} sites x {data.nexp} experiments)", file=sys.stderr)
    kdist_names, rfmip_names = rfmip_gas_names(args.forcing_index)
    print(" Calculation uses RFMIP gases: " + " ".join(rfmip_names),
          file=sys.stderr)
    dtype = setup_precision(args.precision)
    model = load_ckd_model(args.ecckd_file, dtype=dtype)
    return data, model


def build_gas_concs(data: RFMIPData, dtype) -> GasConcs:
    """Requested-gas list in reference order: the 6 scalar gases, then h2o,
    o3, no2 (mo_rfmip_io.F90:199-260)."""
    items = [(name, data.gases_scalar[name].astype(dtype))
             for name in ("co2", "ch4", "n2o", "o2", "cfc11", "cfc12")]
    items += [("h2o", data.gases_3d["h2o"].astype(dtype)),
              ("o3", data.gases_3d["o3"].astype(dtype)),
              ("no2", data.gases_scalar["no2"].astype(dtype))]
    return GasConcs.create(items)


def place_on_mesh(arrays, use_mesh: bool, concs: GasConcs = None):
    """Shard column-axis arrays (and, if given, the GasConcs pytree) over
    all local devices, edge-padding the column axis to the mesh size — the
    padding must be applied to EVERY per-column input consistently or the
    jitted program sees mismatched batch extents.  Returns
    (placed_arrays, placed_concs, mesh)."""
    if not use_mesh or len(jax.devices()) == 1:
        placed = [jax.device_put(np.asarray(a)) for a in arrays]
        return placed, (None if concs is None else jax.device_put(concs)), \
            None
    m = pmesh.make_column_mesh()
    ncol = int(np.asarray(arrays[0]).shape[0])
    placed, _ = pmesh.shard_batch(arrays, m)
    placed_concs = None
    if concs is not None:
        col = pmesh.column_sharding(m)
        rep = pmesh.replicated(m)

        def put(v):
            v = np.asarray(v)
            if v.ndim >= 1 and v.shape[0] == ncol:
                # The ONE padding rule (pmesh.pad_to_mesh): per-column
                # conc profiles must pad exactly like the batch arrays
                # shard_batch placed above.
                return jax.device_put(
                    pmesh.pad_to_mesh(v, m.devices.size), col)
            return jax.device_put(v, rep)

        placed_concs = jax.tree_util.tree_map(put, concs)
    return placed, placed_concs, m


class Timer:
    def __init__(self, label: str):
        self.label = label
        self.seconds = 0.0

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self.t0
        print(f" {self.label}: {self.seconds*1e3:.1f} ms", file=sys.stderr)


def write_metrics(path, *, ncol: int, seconds: float, args, fluxes,
                  extra=None) -> None:
    """Per-run metrics JSON (SURVEY.md section 5.5): throughput +
    flux sanity ranges, for baseline tracking across runs."""
    import json
    up = np.asarray(fluxes.flux_up)
    dn = np.asarray(fluxes.flux_dn)
    m = {
        "columns": int(ncol),
        "seconds": round(seconds, 6),
        "columns_per_sec": round(ncol / max(seconds, 1e-12), 1),
        "n_devices": len(jax.devices()),
        "device_kind": jax.devices()[0].device_kind,
        "precision": args.precision,
        "flux_up_range": [float(up.min()), float(up.max())],
        "flux_dn_range": [float(dn.min()), float(dn.max())],
        "all_finite": bool(np.isfinite(up).all() and np.isfinite(dn).all()),
    }
    if extra:
        m.update(extra)
    import os
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    with open(path, "w") as f:
        json.dump(m, f, indent=1)
    print(f" Wrote metrics to {path}", file=sys.stderr)
