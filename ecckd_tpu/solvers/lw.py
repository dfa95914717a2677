"""Longwave no-scattering flux solver.

Replacement for the external ``rte_lw`` solver the reference links
against (rte-ecckd/example/rfmip-rad-irf/ecckd_rfmip_lw.F90:130-135;
behavioral contract documented in SURVEY.md section 2.3): per g-point,
integrate the Schwarzschild equation along 1..4 discrete zenith angles
(first-order Gaussian quadrature), with a linear-in-tau source inside each
layer (Clough et al. 1992 Eq. 13 form), surface emission ``emis * B_sfc`` and
isotropic-in-angle reflection ``(1 - emis)``, then quadrature-sum to fluxes
and sum over g-points to broadband.

Design: the up/down sweeps are affine layer recurrences evaluated by a
sequential ``lax.scan`` (solvers/scan.py — the associative-scan form was
benchmarked and REJECTED there: >10x compile-time inflation and a
non-sequential reduction order that breaks bit reproducibility); the
angle loop (1 or 3) is a static Python loop so XLA fuses everything
into one program.
"""
from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ecckd_tpu.optics import OpticalProps1scl, SourceFuncLW
from ecckd_tpu.solvers.quadrature import gauss_angles
from ecckd_tpu.solvers.scan import affine_sweep_broadband

from ecckd_tpu import constants

# Derived, not retyped: planck.py divides by constants.PI and the flux
# reconstruction here multiplies by 2*pi — the exact pi*B round-trip
# depends on the two staying consistent (doubling is exact in binary,
# so this is bit-identical to the old hand-typed 6.28318530718).
TWO_PI = 2.0 * constants.PI


def _linear_in_tau_sources(tau_slant: jax.Array, trans: jax.Array,
                           lay_source: jax.Array, lev_source_dn: jax.Array,
                           lev_source_up: jax.Array
                           ) -> Tuple[jax.Array, jax.Array]:
    """Per-layer emitted radiance for down/up propagation with a source that
    varies linearly in optical depth across the layer; 2nd-order series for
    optically thin layers (tau ~ sqrt(machine eps)) to avoid cancellation."""
    dtype = tau_slant.dtype
    tau_thresh = jnp.sqrt(jnp.asarray(jnp.finfo(dtype).eps, dtype))
    big = jnp.maximum(tau_slant, tau_thresh)
    # 1 - trans via expm1: avoids the 1 - exp(-tau) cancellation that would
    # otherwise amplify rounding error by ~1/tau for optically thin layers.
    one_m_trans = -jnp.expm1(-tau_slant)
    fact = jnp.where(tau_slant > tau_thresh,
                     one_m_trans / big - trans,
                     tau_slant * (0.5 - tau_slant / 3.0))
    source_dn = one_m_trans * lev_source_dn + \
        2.0 * fact * (lay_source - lev_source_dn)
    source_up = one_m_trans * lev_source_up + \
        2.0 * fact * (lay_source - lev_source_up)
    return source_dn, source_up


def rte_lw(optical_props: OpticalProps1scl, sources: SourceFuncLW,
           sfc_emis_gpt: jax.Array, top_at_1: bool = True,
           n_gauss_angles: int = 1,
           inc_flux_gpt: Optional[jax.Array] = None
           ) -> Tuple[jax.Array, jax.Array]:
    """Broadband longwave fluxes.

    Args:
      optical_props: tau (ncol, nlay, ngpt).
      sources: Planck intensities (see SourceFuncLW).
      sfc_emis_gpt: surface emissivity per g-point, (ncol, ngpt).
      top_at_1: True if layer index 0 is the top of the atmosphere.
      n_gauss_angles: quadrature order (the reference drivers use 1 or 3,
        ecckd_rfmip_lw.F90:40-44).
      inc_flux_gpt: optional ISOTROPIC incident flux at TOA per g-point
        (ncol, ngpt); default zero (no downwelling LW at TOA).  The flux
        is converted to the per-angle boundary radiance F/pi internally,
        so a transparent atmosphere returns exactly this flux at every
        level and quadrature order.

    Returns:
      (flux_up, flux_dn) broadband [W m-2], each (ncol, nlay+1), in the same
      level orientation as the inputs.
    """
    tau = optical_props.tau
    lay = sources.lay_source
    lev_inc = sources.lev_source_inc
    lev_dec = sources.lev_source_dec
    if not top_at_1:
        # Canonicalize to top-at-first-index; flip back at the end.
        flip = lambda x: jnp.flip(x, axis=1)
        tau, lay = flip(tau), flip(lay)
        # Edge roles swap with orientation: the increasing-index edge becomes
        # the decreasing-index edge of the flipped layer ordering.
        lev_inc, lev_dec = flip(sources.lev_source_dec), flip(
            sources.lev_source_inc)

    dtype = tau.dtype
    ncol, nlay, ngpt = tau.shape
    secants, weights = gauss_angles(n_gauss_angles)

    flux_up = jnp.zeros((ncol, nlay + 1), dtype)
    flux_dn = jnp.zeros((ncol, nlay + 1), dtype)
    zero_top = jnp.zeros((ncol, ngpt), dtype)
    if inc_flux_gpt is not None:
        # Isotropic incident FLUX -> per-angle boundary RADIANCE I = F/pi
        # (RTE convention): the quadrature then reconstructs the flux
        # exactly, sum_i 2*pi*w_i*I = 2*pi*0.5*(F/pi) = F at every order.
        # Feeding F directly would deliver pi*F at TOA (caught in round 5;
        # tests/test_solver_lw.py pins the transparent-atmosphere
        # round-trip).
        zero_top = (inc_flux_gpt / jnp.asarray(constants.PI, dtype)
                    ).astype(dtype)

    for secant, weight in zip(secants, weights):
        tau_slant = tau * jnp.asarray(secant, dtype)
        trans = jnp.exp(-tau_slant)
        # Downward propagation exits a layer at its increasing-index edge;
        # upward at its decreasing-index edge (top_at_1 canonical form).
        source_dn, source_up = _linear_in_tau_sources(
            tau_slant, trans, lay, lev_inc, lev_dec)

        # Downward sweep: I[0] = top incidence; I[j+1] = t_j I[j] + s_j.
        dn_levels, rad_dn_sfc = affine_sweep_broadband(
            trans, source_dn, zero_top)
        # Surface: emission + isotropic reflection of this angle's incidence.
        rad_sfc = (sfc_emis_gpt * sources.sfc_source
                   + (1.0 - sfc_emis_gpt) * rad_dn_sfc)
        # Upward sweep: I[nlay] = surface; I[j] = t_j I[j+1] + s_j.
        up_levels, _ = affine_sweep_broadband(
            trans, source_up, rad_sfc, reverse=True)

        w = jnp.asarray(TWO_PI * weight, dtype)
        flux_dn = flux_dn + w * dn_levels
        flux_up = flux_up + w * up_levels

    if not top_at_1:
        flux_up = jnp.flip(flux_up, axis=1)
        flux_dn = jnp.flip(flux_dn, axis=1)
    return flux_up, flux_dn
