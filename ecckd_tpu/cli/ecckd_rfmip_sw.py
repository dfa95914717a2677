"""Shortwave RFMIP driver.

Equivalent of the reference ``ecckd_rfmip_sw`` executable
(rte-ecckd/example/rfmip-rad-irf/ecckd_rfmip_sw.F90): gas optics +
Rayleigh, TSI renormalization, two-stream/adding solve with night-column
masking, CMIP-format rsu/rsd output.  Note the reference hardcodes physics
index 1 in the SW output filenames (ecckd_rfmip_sw.F90:56-57); reproduced.
"""
from __future__ import annotations

import functools
import os
import sys

import jax
import numpy as np

from ecckd_tpu.cli import common
from ecckd_tpu.io.rfmip import write_fluxes
from ecckd_tpu.pipeline import clamp_top_pressure, sw_fluxes


def main(argv=None) -> int:
    args = common.make_parser("ecckd_rfmip_sw").parse_args(argv)
    print(f" Using forcing index {args.forcing_index} and physics index "
          f"{args.physics_index}", file=sys.stderr)

    data, model = common.load_inputs(args)
    if not model.source_is_external():
        print("ecckd_rfmip_sw: k-distribution file isn't for shortwave.",
              file=sys.stderr)
        return 1
    dtype = model.log_pressure.dtype

    top_at_1 = data.top_at_1
    plev = clamp_top_pressure(data.plev.astype(dtype), model.get_press_min(),
                              top_at_1)
    concs = common.build_gas_concs(data, dtype)

    if args.validate:
        from ecckd_tpu.utils.checks import validate_inputs
        validate_inputs(plev, data.tlay,
                        press_min=model.get_press_min(),
                        press_max=model.get_press_max())
    # Model passed as a jit argument, not a closure (see ecckd_rfmip_lw.py).
    model_dev = jax.device_put(model)
    arrays, concs_dev, _ = common.place_on_mesh(
        [plev, data.tlay.astype(dtype), data.sfc_alb.astype(dtype),
         data.tsi.astype(dtype), data.sza.astype(dtype)],
        not args.no_shard, concs)

    fn = functools.partial(sw_fluxes, top_at_1=top_at_1)
    with common.Timer("sw flux solve") as t:
        fluxes = jax.block_until_ready(jax.jit(fn)(
            model_dev, arrays[0], arrays[1], concs_dev, arrays[2],
            arrays[3], arrays[4]))

    up = np.asarray(fluxes.flux_up)[:data.ncol]
    dn = np.asarray(fluxes.flux_dn)[:data.ncol]
    if args.validate and not (np.isfinite(up).all()
                              and np.isfinite(dn).all()):
        print("ecckd_rfmip_sw: non-finite fluxes in output", file=sys.stderr)
        return 1
    if args.metrics_json:
        common.write_metrics(args.metrics_json, ncol=data.ncol,
                             seconds=t.seconds, args=args, fluxes=fluxes,
                             extra={"driver": "sw"})
    suffix = f"r1i1p1f{args.forcing_index}_gn.nc"
    os.makedirs(args.output_dir, exist_ok=True)
    up_path = os.path.join(args.output_dir,
                           f"rsu_Efx_RTE-ecckd_rad-irf_{suffix}")
    dn_path = os.path.join(args.output_dir,
                           f"rsd_Efx_RTE-ecckd_rad-irf_{suffix}")
    write_fluxes(up_path, "rsu", up, data.nsite, data.nexp)
    write_fluxes(dn_path, "rsd", dn, data.nsite, data.nexp)
    print(f" Wrote {up_path} and {dn_path}", file=sys.stderr)
    if args.heating_rates:
        from ecckd_tpu.fluxes import heating_rate
        from ecckd_tpu.io.rfmip import write_heating_rates
        hr = np.asarray(heating_rate(up, dn, plev[:data.ncol]))
        hr_path = os.path.join(args.output_dir,
                               f"hrs_Efx_RTE-ecckd_rad-irf_{suffix}")
        write_heating_rates(hr_path, "hrs", hr, data.nsite, data.nexp)
        print(f" Wrote {hr_path}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
