"""Optical-property containers.

Functional counterparts of rte-rrtmgp's ``ty_optical_props_1scl`` /
``ty_optical_props_2str`` (use-sites: rte-ecckd/src/
gas_optics_ecckd.f90:5,346,370,457-464 and the drivers).  They are immutable
pytrees produced by the gas-optics functions and consumed by the solvers; the
band <-> g-point spectral mapping lives on the ``CKDModel``.

Array convention: (ncol, nlay, ngpt), layer index 0 at the *first* array row;
``top_at_1`` orientation is handled by the solvers.
"""
from __future__ import annotations

import dataclasses

import jax


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class OpticalProps1scl:
    """Absorption-only optical properties (longwave)."""
    tau: jax.Array  # (ncol, nlay, ngpt)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class OpticalProps2str:
    """Two-stream optical properties (shortwave)."""
    tau: jax.Array  # (ncol, nlay, ngpt) extinction optical depth
    ssa: jax.Array  # (ncol, nlay, ngpt) single-scattering albedo
    g: jax.Array    # (ncol, nlay, ngpt) asymmetry factor (0 for Rayleigh)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SourceFuncLW:
    """Planck source functions [W m-2 sr-1] (intensities; the /pi conversion
    happens inside the Planck interpolation, gas_optics_ecckd.f90:288)."""
    lay_source: jax.Array      # (ncol, nlay, ngpt) layer-mean source
    lev_source_inc: jax.Array  # (ncol, nlay, ngpt) source at layer's
    #                            increasing-index edge (level j+1)
    lev_source_dec: jax.Array  # (ncol, nlay, ngpt) source at layer's
    #                            decreasing-index edge (level j)
    sfc_source: jax.Array      # (ncol, ngpt) surface source
