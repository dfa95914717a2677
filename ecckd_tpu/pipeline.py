"""End-to-end RFMIP flux pipelines (jit units).

Each function is one jittable program: gas optics -> solver ->
broadband fluxes, in plain jax.numpy/lax left to XLA.  It replaces the
reference drivers' serial block loop (rte-ecckd/example/rfmip-rad-irf/
ecckd_rfmip_lw.F90:105-136): instead of 1800 blocks of one column, the whole
column batch is a single SPMD computation whose leading axis can be sharded
over a device mesh (see parallel/mesh.py).

Driver-level semantics reproduced here:
* spectrally-constant surface emissivity/albedo expanded per band -> g-point
  (ecckd_rfmip_lw.F90:112-116, ecckd_rfmip_sw.F90:135-140);
* SW: TOA flux renormalized to the requested TSI (ecckd_rfmip_sw.F90:125-133),
  night columns (sza >= 90 - 2*spacing(90)) run with mu0 = 1 and are zeroed
  afterwards (ecckd_rfmip_sw.F90:103-108,142-145,155-161);
* the reference's hard-coded 1700-block loop bound is a historical artifact
  (SURVEY.md section 2.4) — all columns are computed here.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from jax import lax

from ecckd_tpu.fluxes import FluxesBroadband
from ecckd_tpu.gases import GasConcs
from ecckd_tpu.models.ckd import CKDModel
from ecckd_tpu.models.gas_optics import gas_optics_lw, gas_optics_sw
from ecckd_tpu.solvers.lw import rte_lw
from ecckd_tpu.solvers.sw import rte_sw


def map_over_column_chunks(fn, args, ncol: int, chunk: int,
                           batch_leaf=None):
    """Evaluate ``fn(*args)`` in column chunks of size ``chunk`` via lax.map.

    Radiative transfer is embarrassingly parallel over columns but its
    intermediates (per-gas gathered coefficients, per-angle transmittances,
    two-stream R/T) are O(ncol * nlay * ngpt * n_intermediates), so one
    unchunked batch of ~10^6 columns needs tens of GB of device memory.
    Chunking bounds peak memory at O(chunk) while the sequential chunk loop
    keeps the device busy — the standard microbatching pattern.

    By default every pytree leaf of ``args`` whose leading axis equals
    ``ncol`` is mapped; everything else (scalars, tables) is closed over.
    Pass ``batch_leaf`` (leaf -> bool) to identify batch leaves explicitly
    when a non-batch leaf's leading extent could coincide with ``ncol``.
    ``ncol`` must be divisible by ``chunk`` (callers pad; see
    parallel.mesh.shard_batch).
    """
    if ncol <= chunk:
        return fn(*args)
    if ncol % chunk:
        raise ValueError(f"ncol={ncol} not divisible by chunk={chunk}")
    if batch_leaf is None:
        batch_leaf = (lambda x: hasattr(x, "ndim") and x.ndim >= 1
                      and x.shape[0] == ncol)
    n_chunks = ncol // chunk
    flat, treedef = jax.tree_util.tree_flatten(args)
    mapped_idx = [i for i, x in enumerate(flat) if batch_leaf(x)]
    mapped = [flat[i].reshape(n_chunks, chunk, *flat[i].shape[1:])
              for i in mapped_idx]

    def body(mapped_leaves):
        full = list(flat)
        for i, leaf in zip(mapped_idx, mapped_leaves):
            full[i] = leaf
        return fn(*jax.tree_util.tree_unflatten(treedef, full))

    out = lax.map(body, mapped)
    return jax.tree_util.tree_map(
        lambda x: x.reshape(ncol, *x.shape[2:]), out)


def _surface_to_gpt(model: CKDModel, sfc: jax.Array, ncol: int,
                    dtype) -> jax.Array:
    """Surface emissivity/albedo to per-g-point (ncol, ngpt): accepts a
    spectrally-constant (ncol,) value (the RFMIP drivers' case; expanded
    exactly like ecckd_rfmip_lw.F90:112-116 / _sw.F90:135-140) or a banded
    (ncol, nband) one (the reference solver API's sfc_emis(nband, ncol) /
    sfc_alb_dir(nband, ncol), SURVEY.md section 2.3)."""
    sfc = jnp.asarray(sfc, dtype)
    if sfc.ndim == 1:
        return jnp.broadcast_to(sfc[:, None], (ncol, model.ngpt))
    if sfc.shape[-1] != model.nband:
        raise ValueError(f"banded surface array has {sfc.shape[-1]} bands; "
                         f"model has {model.nband}")
    return model.gpt_weights_per_band(sfc)


def lw_fluxes(model: CKDModel, plev: jax.Array, tlay: jax.Array,
              tlev: jax.Array, tsfc: jax.Array, sfc_emis: jax.Array,
              gas_concs: GasConcs, n_gauss_angles: int = 1,
              top_at_1: bool = True,
              column_chunk: int | None = None,
              logarithmic_interpolation: bool = False) -> FluxesBroadband:
    """Longwave broadband fluxes for a column batch.

    Args:
      sfc_emis: surface emissivity — spectrally constant (ncol,) or banded
        (ncol, nband), matching the reference solver's sfc_emis(nband, ncol)
        argument (ecckd_rfmip_lw.F90:132; band -> g-point expansion as in
        rte-rrtmgp).
      column_chunk: optional microbatch size bounding peak device memory
        (see map_over_column_chunks).
      logarithmic_interpolation: the reference's alternate log-space table
        interpolation (live API, never selected by its drivers,
        gas_optics_ecckd.f90:368).
    """
    if column_chunk is not None and tlay.shape[0] > column_chunk:
        fn = lambda p, tl, tv, ts, e, c: lw_fluxes(
            model, p, tl, tv, ts, e, c, n_gauss_angles=n_gauss_angles,
            top_at_1=top_at_1,
            logarithmic_interpolation=logarithmic_interpolation)
        return map_over_column_chunks(
            fn, (plev, tlay, tlev, tsfc, sfc_emis, gas_concs),
            tlay.shape[0], column_chunk)
    props, sources = gas_optics_lw(
        model, plev, tlay, tsfc, gas_concs, tlev,
        logarithmic_interpolation=logarithmic_interpolation)
    emis_gpt = _surface_to_gpt(model, sfc_emis, tlay.shape[0],
                               props.tau.dtype)
    flux_up, flux_dn = rte_lw(props, sources, emis_gpt, top_at_1=top_at_1,
                              n_gauss_angles=n_gauss_angles)
    return FluxesBroadband(flux_up=flux_up, flux_dn=flux_dn)


def sw_fluxes(model: CKDModel, plev: jax.Array, tlay: jax.Array,
              gas_concs: GasConcs, sfc_alb: jax.Array, tsi: jax.Array,
              sza_deg: jax.Array, top_at_1: bool = True,
              column_chunk: int | None = None,
              logarithmic_interpolation: bool = False) -> FluxesBroadband:
    """Shortwave broadband fluxes for a column batch.

    Args:
      sfc_alb: surface albedo — spectrally constant (ncol,) or banded
        (ncol, nband); diffuse == direct, as in the reference driver
        (ecckd_rfmip_sw.F90:135-140).
      tsi: requested total solar irradiance [W m-2], (ncol,).
      sza_deg: solar zenith angle [degrees], (ncol,).
      column_chunk: optional microbatch size bounding peak device memory.
      logarithmic_interpolation: the reference's alternate interpolation
        (see lw_fluxes).
    """
    if column_chunk is not None and tlay.shape[0] > column_chunk:
        fn = lambda p, tl, c, a, t, s: sw_fluxes(
            model, p, tl, c, a, t, s, top_at_1=top_at_1,
            logarithmic_interpolation=logarithmic_interpolation)
        return map_over_column_chunks(
            fn, (plev, tlay, gas_concs, sfc_alb, tsi, sza_deg),
            tlay.shape[0], column_chunk)
    props, toa_src = gas_optics_sw(
        model, plev, tlay, gas_concs,
        logarithmic_interpolation=logarithmic_interpolation)
    dtype = props.tau.dtype

    # Renormalize the incoming solar flux to the requested TSI.
    def_tsi = jnp.sum(toa_src, axis=-1, keepdims=True)
    toa_flux = toa_src * (tsi[:, None].astype(dtype) / def_tsi)

    # Night mask: sza >= 90 - 2*spacing(90) in working precision.
    spacing90 = float(np.spacing(np.asarray(90.0, dtype=dtype)))
    usecol = sza_deg.astype(dtype) < (90.0 - 2.0 * spacing90)
    deg_to_rad = jnp.asarray(np.arccos(-1.0) / 180.0, dtype)
    mu0 = jnp.where(usecol, jnp.cos(sza_deg.astype(dtype) * deg_to_rad), 1.0)

    alb_gpt = _surface_to_gpt(model, sfc_alb, tlay.shape[0], dtype)
    flux_up, flux_dn, _ = rte_sw(props, mu0, toa_flux, alb_gpt, alb_gpt,
                                 top_at_1=top_at_1)
    mask = usecol[:, None].astype(dtype)
    return FluxesBroadband(flux_up=flux_up * mask, flux_dn=flux_dn * mask)


def lw_sw_fluxes(model_lw: CKDModel, model_sw: CKDModel, plev: jax.Array,
                 tlay: jax.Array, tlev: jax.Array, tsfc: jax.Array,
                 sfc_emis: jax.Array, gas_concs: GasConcs,
                 sfc_alb: jax.Array, tsi: jax.Array, sza_deg: jax.Array,
                 n_gauss_angles: int = 1, top_at_1: bool = True,
                 column_chunk: int | None = None
                 ) -> Tuple[FluxesBroadband, FluxesBroadband]:
    """Both bands' broadband fluxes over ONE atmosphere (the climate-model
    and RFMIP-benchmark shape of the workload).  Returns (lw_fluxes,
    sw_fluxes)."""
    return (lw_fluxes(model_lw, plev, tlay, tlev, tsfc, sfc_emis,
                      gas_concs, n_gauss_angles=n_gauss_angles,
                      top_at_1=top_at_1, column_chunk=column_chunk),
            sw_fluxes(model_sw, plev, tlay, gas_concs, sfc_alb, tsi,
                      sza_deg, top_at_1=top_at_1,
                      column_chunk=column_chunk))


def clamp_top_pressure(plev: np.ndarray, press_min: float,
                       top_at_1: bool = True) -> np.ndarray:
    """Driver-side input sanitizing: the model cannot run below its minimum
    table pressure, so the top level is set just above it
    (ecckd_rfmip_lw.F90:87-94)."""
    plev = np.array(plev, copy=True)
    eps = np.finfo(plev.dtype).eps if np.issubdtype(plev.dtype, np.floating) \
        else np.finfo(np.float64).eps
    if top_at_1:
        plev[:, 0] = press_min + eps
    else:
        plev[:, -1] = press_min + eps
    return plev
