"""Public gas-optics API: optical properties + sources from atmospheric state.

Functional equivalents of the reference's type-bound ``gas_optics`` generic
(rte-ecckd/src/gas_optics_ecckd.f90:381-473):

* :func:`gas_optics_lw` ~ ``gas_optics_int`` — optical depth + Planck sources;
* :func:`gas_optics_sw` ~ ``gas_optics_ext`` — optical depth + Rayleigh,
  single-scattering albedo, and the TOA solar source.

As in the reference, the ``play`` layer-pressure argument is not needed: layer
pressures are re-derived from level pressures inside the optical-depth kernel
(gas_optics_ecckd.f90:120), and ``col_dry`` has no effect.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ecckd_tpu.gases import GasConcs
from ecckd_tpu.models.ckd import CKDModel
from ecckd_tpu.optics import OpticalProps1scl, OpticalProps2str, SourceFuncLW
from ecckd_tpu.ops.optical_depth import gas_optical_depth
from ecckd_tpu.ops.planck import planck_source
from ecckd_tpu.ops.rayleigh import rayleigh_optical_depth


def gas_optics_lw(model: CKDModel, plev: jax.Array, tlay: jax.Array,
                  tsfc: jax.Array, gas_concs: GasConcs,
                  tlev: jax.Array, play: jax.Array = None,
                  col_dry: jax.Array = None,
                  logarithmic_interpolation: bool = False
                  ) -> Tuple[OpticalProps1scl, SourceFuncLW]:
    """Longwave optical depth and Planck sources.

    Args:
      model: longwave CKD model.
      plev: level pressures [Pa], (ncol, nlay+1).
      tlay: layer temperatures [K], (ncol, nlay).
      tsfc: surface skin temperatures [K], (ncol,).
      gas_concs: gas volume mixing ratios.
      tlev: level temperatures [K], (ncol, nlay+1) — required, as in the
        reference (gas_optics_ecckd.f90:414-417).
      play, col_dry: accepted for reference API parity and IGNORED — the
        reference derives layer pressure from the level pressures and never
        reads either argument (gas_optics_ecckd.f90:120,381-426).
      logarithmic_interpolation: select the reference's alternate log-space
        table interpolation (live API, never selected by its drivers).

    Returns:
      (optical_props, sources)
    """
    if not model.source_is_internal():
        raise ValueError("gas_optics_lw requires a longwave ckd model")
    del play, col_dry  # parity-only arguments (see docstring)
    tau = gas_optical_depth(model, plev, tlay, gas_concs,
                            logarithmic_interpolation)

    pt, pf = model.planck_temperature, model.planck_function
    lay_source = planck_source(tlay, pt, pf)
    sfc_source = planck_source(tsfc, pt, pf)
    # One interpolation over all nlay+1 levels, then split into the
    # increasing/decreasing-index edge sources (gas_optics_ecckd.f90:419-424).
    lev = planck_source(tlev, pt, pf)
    sources = SourceFuncLW(
        lay_source=lay_source,
        lev_source_inc=lev[:, 1:, :],
        lev_source_dec=lev[:, :-1, :],
        sfc_source=sfc_source,
    )
    return OpticalProps1scl(tau=tau), sources


def gas_optics_sw(model: CKDModel, plev: jax.Array, tlay: jax.Array,
                  gas_concs: GasConcs, play: jax.Array = None,
                  col_dry: jax.Array = None,
                  logarithmic_interpolation: bool = False
                  ) -> Tuple[OpticalProps2str, jax.Array]:
    """Shortwave optical properties and TOA solar source.

    ``play``/``col_dry`` are accepted for reference API parity and ignored
    (see gas_optics_lw).

    Returns:
      (optical_props, toa_src) with toa_src (ncol, ngpt): the per-g-point
      solar irradiance broadcast over columns (gas_optics_ecckd.f90:468-472).
    """
    if not model.source_is_external():
        raise ValueError("gas_optics_sw requires a shortwave ckd model")
    del play, col_dry  # parity-only arguments (see gas_optics_lw)
    tau_gas = gas_optical_depth(model, plev, tlay, gas_concs,
                                logarithmic_interpolation)
    tau_ray = rayleigh_optical_depth(plev, model.rayleigh_coeff)
    tau = tau_gas + tau_ray
    # ssa = tau_ray / tau_total; g = 0 (gas_optics_ecckd.f90:457-464).
    ssa = tau_ray / tau
    g = jnp.zeros_like(tau)
    ncol = tlay.shape[0]
    toa_src = jnp.broadcast_to(model.solar_irradiance,
                               (ncol, model.ngpt)).astype(tau.dtype)
    return OpticalProps2str(tau=tau, ssa=ssa, g=g), toa_src


def gas_optics(model: CKDModel, plev: jax.Array, tlay: jax.Array,
               gas_concs: GasConcs, tsfc: jax.Array = None,
               tlev: jax.Array = None, **kwargs):
    """Generic dispatch mirroring the reference's ``ecckd%gas_optics(...)``
    binding (mo_gas_optics declares gas_optics_int/_ext behind one generic
    name; drivers call it with the LW or SW signature,
    ecckd_rfmip_lw.F90:120-127 / ecckd_rfmip_sw.F90:118-123).

    LW models (source_is_internal) require ``tsfc`` and ``tlev`` and
    return (OpticalProps1scl, SourceFuncLW); SW models return
    (OpticalProps2str, toa_src).  Extra kwargs pass through
    (play/col_dry parity args, logarithmic_interpolation).
    """
    if model.source_is_internal():
        if tsfc is None or tlev is None:
            raise ValueError("longwave gas_optics requires tsfc and tlev "
                             "(gas_optics_ecckd.f90:414-417)")
        return gas_optics_lw(model, plev, tlay, tsfc, gas_concs, tlev,
                             **kwargs)
    if tsfc is not None or tlev is not None:
        raise ValueError("shortwave gas_optics takes no tsfc/tlev "
                         "(gas_optics_ecckd.f90:431-473)")
    return gas_optics_sw(model, plev, tlay, gas_concs, **kwargs)
