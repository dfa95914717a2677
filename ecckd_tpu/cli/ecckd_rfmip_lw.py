"""Longwave RFMIP driver.

Equivalent of the reference ``ecckd_rfmip_lw`` executable
(rte-ecckd/example/rfmip-rad-irf/ecckd_rfmip_lw.F90): reads the RFMIP
atmosphere, computes gas optics + Planck sources, solves longwave fluxes with
1 or 3 quadrature angles (physics index), writes CMIP-format rlu/rld files.

Unlike the reference (serial loop over 1700 of 1800 one-column blocks,
ecckd_rfmip_lw.F90:106-107), all columns are computed in one jitted,
column-sharded program.
"""
from __future__ import annotations

import functools
import os
import sys

import jax
import numpy as np

from ecckd_tpu.cli import common
from ecckd_tpu.io.rfmip import write_fluxes
from ecckd_tpu.pipeline import clamp_top_pressure, lw_fluxes


def main(argv=None) -> int:
    args = common.make_parser("ecckd_rfmip_lw").parse_args(argv)
    n_quad_angles = 3 if args.physics_index == 2 else 1
    print(f" Using forcing index {args.forcing_index} and physics index "
          f"{args.physics_index}", file=sys.stderr)

    data, model = common.load_inputs(args)
    if not model.source_is_internal():
        print("ecckd_rfmip_lw: k-distribution file isn't for longwave.",
              file=sys.stderr)
        return 1
    dtype = model.log_pressure.dtype

    top_at_1 = data.top_at_1
    plev = clamp_top_pressure(data.plev.astype(dtype), model.get_press_min(),
                              top_at_1)
    concs = common.build_gas_concs(data, dtype)

    if args.validate:
        from ecckd_tpu.utils.checks import validate_inputs
        validate_inputs(plev, data.tlay, data.tlev,
                        press_min=model.get_press_min(),
                        press_max=model.get_press_max())
    # The model is a jit *argument* (placed on device once), not a closure
    # that would be embedded in the program as constants.
    model_dev = jax.device_put(model)
    arrays, concs_dev, _ = common.place_on_mesh(
        [plev, data.tlay.astype(dtype), data.tlev.astype(dtype),
         data.sfc_t.astype(dtype), data.sfc_emis.astype(dtype)],
        not args.no_shard, concs)

    fn = functools.partial(lw_fluxes, n_gauss_angles=n_quad_angles,
                           top_at_1=top_at_1)
    with common.Timer("lw flux solve") as t:
        fluxes = jax.block_until_ready(jax.jit(fn)(
            model_dev, arrays[0], arrays[1], arrays[2], arrays[3],
            arrays[4], concs_dev))

    up = np.asarray(fluxes.flux_up)[:data.ncol]
    dn = np.asarray(fluxes.flux_dn)[:data.ncol]
    if args.validate and not (np.isfinite(up).all()
                              and np.isfinite(dn).all()):
        print("ecckd_rfmip_lw: non-finite fluxes in output", file=sys.stderr)
        return 1
    if args.metrics_json:
        common.write_metrics(args.metrics_json, ncol=data.ncol,
                             seconds=t.seconds, args=args, fluxes=fluxes,
                             extra={"driver": "lw",
                                    "n_quad_angles": n_quad_angles})
    suffix = f"r1i1p{args.physics_index}f{args.forcing_index}_gn.nc"
    os.makedirs(args.output_dir, exist_ok=True)
    up_path = os.path.join(args.output_dir,
                           f"rlu_Efx_RTE-ecckd_rad-irf_{suffix}")
    dn_path = os.path.join(args.output_dir,
                           f"rld_Efx_RTE-ecckd_rad-irf_{suffix}")
    write_fluxes(up_path, "rlu", up, data.nsite, data.nexp)
    write_fluxes(dn_path, "rld", dn, data.nsite, data.nexp)
    print(f" Wrote {up_path} and {dn_path}", file=sys.stderr)
    if args.heating_rates:
        from ecckd_tpu.fluxes import heating_rate
        from ecckd_tpu.io.rfmip import write_heating_rates
        hr = np.asarray(heating_rate(up, dn, plev[:data.ncol]))
        hr_path = os.path.join(args.output_dir,
                               f"hrl_Efx_RTE-ecckd_rad-irf_{suffix}")
        write_heating_rates(hr_path, "hrl", hr, data.nsite, data.nexp)
        print(f" Wrote {hr_path}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
