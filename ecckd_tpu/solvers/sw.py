"""Shortwave two-stream + adding flux solver.

Replacement for the external ``rte_sw`` solver the reference links
against (call site: rte-ecckd/example/rfmip-rad-irf/
ecckd_rfmip_sw.F90:148-154; behavioral contract in SURVEY.md section 2.3):
per g-point, two-stream reflectance/transmittance of every layer (direct +
diffuse), combined into level fluxes by the Shonk & Hogan adding method, with
the direct beam attenuated by exp(-tau/mu0); broadband reduction over
g-points.

Recurrence structure (top-at-index-0 canonical form):
  * direct beam + downward diffuse sweeps are affine layer recurrences ->
    sequential lax.scan (solvers/scan.py; the associative form was
    benchmarked and rejected there);
  * the upward "albedo of the stack below" recurrence is a Mobius (linear
    fractional) map, evaluated with a 60-step lax.scan over the wide
    (ncol, ngpt) vector axes.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax

from ecckd_tpu.optics import OpticalProps2str
from ecckd_tpu.solvers.scan import affine_scan
from ecckd_tpu.solvers.two_stream import two_stream


def rte_sw(optical_props: OpticalProps2str, mu0: jax.Array,
           toa_flux: jax.Array, sfc_alb_dir_gpt: jax.Array,
           sfc_alb_dif_gpt: jax.Array, top_at_1: bool = True
           ) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Broadband shortwave fluxes.

    Args:
      optical_props: tau/ssa/g, each (ncol, nlay, ngpt).
      mu0: cosine of solar zenith angle, (ncol,).  Columns with
        mu0 <= 0 (sun below the horizon) return zero SW flux.
      toa_flux: TOA direct irradiance per g-point on a horizontal plane
        *per unit mu0* (ncol, ngpt); the solver multiplies by mu0.
      sfc_alb_dir_gpt / sfc_alb_dif_gpt: surface albedos per g-point,
        (ncol, ngpt).
      top_at_1: True if layer index 0 is the top of the atmosphere.

    Returns:
      (flux_up, flux_dn, flux_dn_dir) broadband [W m-2], each (ncol, nlay+1);
      flux_dn includes the direct beam.
    """
    tau, ssa, g = optical_props.tau, optical_props.ssa, optical_props.g
    if not top_at_1:
        flip = lambda x: jnp.flip(x, axis=1)
        tau, ssa, g = flip(tau), flip(ssa), flip(g)

    # Night / terminator columns (mu0 <= 0, a routine real-sky input):
    # zero SW flux, NOT NaN.  The tau/mu0 exponentials overflow for
    # mu0 <= 0, so compute those columns at a safe mu0 and zero their
    # fluxes on return (same masking the CLI pipeline applies,
    # ecckd_rfmip_sw.F90's cos(sza) handling; idempotent if the caller
    # masked already).
    night = mu0 <= 0.0
    mu0 = jnp.where(night, jnp.ones_like(mu0), mu0)

    ts = two_stream(tau, ssa, g, mu0)

    # Direct beam: flux_dir[0] = mu0 * toa_flux; attenuated by Tnoscat.
    flux_dir_top = mu0[:, None] * toa_flux
    flux_dir = affine_scan(ts.t_noscat, jnp.zeros_like(ts.t_noscat),
                           flux_dir_top, axis=1)  # (ncol, nlay+1, ngpt)
    dir_in = flux_dir[:, :-1, :]  # direct flux incident on each layer top

    # Diffuse sources from scattering of the direct beam.
    src_up = ts.r_dir * dir_in
    src_dn = ts.t_dir * dir_in
    src_sfc = sfc_alb_dir_gpt * flux_dir[:, -1, :]

    # Upward pass: albedo of (and upward emission from) the atmosphere below
    # each level.
    def up_step(carry, xs):
        albedo_below, src_below = carry
        r_dif, t_dif, s_up, s_dn = xs
        denom = 1.0 / (1.0 - r_dif * albedo_below)
        albedo = r_dif + t_dif * t_dif * albedo_below * denom
        src = s_up + t_dif * denom * (src_below + albedo_below * s_dn)
        return (albedo, src), (albedo, src, denom)

    # Scan from the bottom layer upward.
    xs = tuple(jnp.moveaxis(jnp.flip(x, axis=1), 1, 0)
               for x in (ts.r_dif, ts.t_dif, src_up, src_dn))
    (albedo_top, src_top), (albedo_rev, src_rev, denom_rev) = lax.scan(
        up_step, (sfc_alb_dif_gpt, src_sfc), xs)
    # Per-level albedo/src for levels 0..nlay (level nlay = surface).
    albedo = jnp.concatenate(
        [jnp.flip(jnp.moveaxis(albedo_rev, 0, 1), axis=1),
         sfc_alb_dif_gpt[:, None, :]], axis=1)
    src = jnp.concatenate(
        [jnp.flip(jnp.moveaxis(src_rev, 0, 1), axis=1),
         src_sfc[:, None, :]], axis=1)
    denom = jnp.flip(jnp.moveaxis(denom_rev, 0, 1), axis=1)  # (ncol,nlay,ngpt)

    # Downward diffuse: affine recurrence
    # F[j+1] = (Tdif_j F[j] + Rdif_j src[j+1] + src_dn_j) * denom_j,
    # with the broadband reduction fused into the sweep (per-level per-g-point
    # flux cubes are never materialized) and the upward flux
    # up[j] = F[j] * albedo[j] + src[j] emitted in the same pass.
    a = ts.t_dif * denom
    b = (ts.r_dif * src[:, 1:, :] + src_dn) * denom
    dn_top = jnp.zeros_like(flux_dir_top)  # no diffuse incidence at TOA

    def dn_step(dn, xs):
        ai, bi, albedo_next, src_next = xs
        dn_next = ai * dn + bi
        up_next = dn_next * albedo_next + src_next
        return dn_next, (jnp.sum(dn_next, -1), jnp.sum(up_next, -1))

    xs = tuple(jnp.moveaxis(x, 1, 0)
               for x in (a, b, albedo[:, 1:, :], src[:, 1:, :]))
    _, (dn_sums, up_sums) = lax.scan(dn_step, dn_top, xs)
    up_top = jnp.sum(dn_top * albedo[:, 0, :] + src[:, 0, :], -1)[:, None]
    dn0 = jnp.zeros_like(up_top)
    flux_dn_dif = jnp.concatenate([dn0, jnp.moveaxis(dn_sums, 0, 1)], axis=1)
    flux_up = jnp.concatenate([up_top, jnp.moveaxis(up_sums, 0, 1)], axis=1)
    flux_dn_direct = jnp.sum(flux_dir, axis=-1)
    flux_dn = flux_dn_dif + flux_dn_direct
    day = jnp.where(night, 0.0, 1.0).astype(flux_up.dtype)[:, None]
    flux_up = flux_up * day
    flux_dn = flux_dn * day
    flux_dn_direct = flux_dn_direct * day
    if not top_at_1:
        flux_up = jnp.flip(flux_up, axis=1)
        flux_dn = jnp.flip(flux_dn, axis=1)
        flux_dn_direct = jnp.flip(flux_dn_direct, axis=1)
    return flux_up, flux_dn, flux_dn_direct
