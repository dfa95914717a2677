"""CKD gas-optics model container (a JAX pytree).

Plays the role of the reference's ``ty_gas_optics_ecckd`` + ``AbsorptionTable``
types (rte-ecckd/src/gas_optics_ecckd.f90:13-48), redesigned as an
immutable JAX pytree:

* All lookup tables are array leaves, so a ``CKDModel`` can be passed through
  ``jit`` / ``pjit`` and is replicated onto every device (the tables are
  <= ~3 MB; tensor-parallel sharding of them would be counter-productive).
* Everything that determines *program structure* (gas names, concentration-
  dependence codes, band maps) is static metadata, so gas-set resolution
  happens at trace time and the compiled kernel contains no data-dependent
  control flow.

Table axis conventions (C-order):
  dense coefficients   (table, pressure, temperature, gpoint)
  LUT coefficients     (mole_fraction, pressure, temperature, gpoint)
  temperature grid     (pressure, temperature)
  planck function      (planck_temperature, gpoint)
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ecckd_tpu import constants


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CKDModel:
    # --- array leaves -----------------------------------------------------
    log_pressure: jax.Array
    """ln(pressure grid [Pa]); uniform spacing (np,)."""
    temperature_grid: jax.Array
    """Temperature grid [K], (np, nT); the temperature-axis origin varies
    with pressure (gas_optics_ecckd.f90:131-132)."""
    coeff_dense: jax.Array
    """Stacked bi-linear absorption tables [m2 mol-1],
    (n_dense_tables, np, nT, ngpt).  Holds every gas whose concentration
    dependence is none/linear/relative-linear, plus the composite table."""
    coeff_lut: Tuple[jax.Array, ...]
    """Per-LUT-gas tri-linear tables, each (n_mf, np, nT, ngpt) (h2o)."""
    gpoint_fraction: jax.Array
    """(ngpt, n_wavenumber) spectral mapping; carried for API parity (only
    its first extent is used at runtime, mirroring the reference)."""
    planck_temperature: Optional[jax.Array]
    """LW only: Planck temperature axis [K], (n_planck_T,)."""
    planck_function: Optional[jax.Array]
    """LW only: Planck flux into a horizontal plane [W m-2],
    (n_planck_T, ngpt)."""
    solar_irradiance: Optional[jax.Array]
    """SW only: per-g-point solar irradiance [W m-2], (ngpt,)."""
    rayleigh_coeff: Optional[jax.Array]
    """SW only: Rayleigh molar scattering coefficient [m2 mol-1], (ngpt,)."""

    # --- static metadata --------------------------------------------------
    gas_names: Tuple[str, ...] = dataclasses.field(metadata=dict(static=True))
    gas_codes: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    gas_table_idx: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    """Per gas: row into coeff_dense, or index into coeff_lut for LUT gases."""
    gas_composite_only: Tuple[bool, ...] = dataclasses.field(metadata=dict(static=True))
    gas_reference_mf: Tuple[float, ...] = dataclasses.field(metadata=dict(static=True))
    """Reference mole fraction (relative-linear gases; else 0.0)."""
    lut_mf_grids: Tuple[Tuple[float, ...], ...] = dataclasses.field(metadata=dict(static=True))
    """Per-LUT-gas mole-fraction axis (log-uniform)."""
    shortwave: bool = dataclasses.field(metadata=dict(static=True))
    total_solar_irradiance: float = dataclasses.field(metadata=dict(static=True))
    band_limits: Tuple[Tuple[float, float], ...] = dataclasses.field(metadata=dict(static=True))
    """Per-band (wavenumber1, wavenumber2) [cm-1]."""
    band2gpt: Tuple[Tuple[int, int], ...] = dataclasses.field(metadata=dict(static=True))
    """Per-band inclusive 0-based (first_gpt, last_gpt)."""
    gpt2band: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    """0-based band index of each g-point."""
    num_composite_gases: int = dataclasses.field(metadata=dict(static=True))
    press_min: float = dataclasses.field(metadata=dict(static=True))
    press_max: float = dataclasses.field(metadata=dict(static=True))
    temp_min: float = dataclasses.field(metadata=dict(static=True))
    temp_max: float = dataclasses.field(metadata=dict(static=True))

    # --- API parity with ty_gas_optics_ecckd ------------------------------
    # (gas_optics_ecckd.f90:477-553)
    @property
    def ngpt(self) -> int:
        return self.gpoint_fraction.shape[0]

    @property
    def nband(self) -> int:
        return len(self.band_limits)

    def get_nband(self) -> int:
        """Reference accessor alias (ty_optical_props%get_nband)."""
        return self.nband

    def get_ngpt(self) -> int:
        """Reference accessor alias (ty_optical_props%get_ngpt)."""
        return self.ngpt

    def get_ngas(self) -> int:
        return len(self.gas_names)

    def get_gases(self) -> Tuple[str, ...]:
        return self.gas_names

    def source_is_internal(self) -> bool:
        """True if loaded from a longwave (Planck-source) file."""
        return self.planck_temperature is not None

    def source_is_external(self) -> bool:
        """True if loaded from a shortwave (solar-source) file."""
        return self.solar_irradiance is not None

    def get_press_min(self) -> float:
        return self.press_min

    def get_press_max(self) -> float:
        return self.press_max

    def get_temp_min(self) -> float:
        return self.temp_min

    def get_temp_max(self) -> float:
        return self.temp_max

    def gpt_weights_per_band(self, per_band: jax.Array) -> jax.Array:
        """Expand a per-band array (..., nband) to per-g-point (..., ngpt)."""
        idx = np.asarray(self.gpt2band, dtype=np.int32)
        return jnp.take(per_band, idx, axis=-1)

    def weight_scale_offset(self, gas_index: int) -> Tuple[float, float]:
        """(a, b) such that the mass-path weight of gas ``g`` is
        ``simple_weight * (a * vmr + b)``, folding the three non-LUT
        concentration-dependence codes (gas_optics_ecckd.f90:144-149,216) into
        one affine form:

          none             -> (0, 1)   (composite: dry-air moles only)
          linear           -> (1, 0)
          relative_linear  -> (1, -reference_mole_fraction)
        """
        code = self.gas_codes[gas_index]
        if code == constants.CONC_NONE:
            return 0.0, 1.0
        if code == constants.CONC_LINEAR:
            return 1.0, 0.0
        if code == constants.CONC_RELATIVE_LINEAR:
            return 1.0, -self.gas_reference_mf[gas_index]
        raise ValueError(f"gas {gas_index} is a LUT gas; no affine weight")

    def astype(self, dtype) -> "CKDModel":
        """Cast all floating-point table leaves to ``dtype``."""
        def cast(x):
            if x is None:
                return None
            return jnp.asarray(x, dtype=dtype)
        return dataclasses.replace(
            self,
            log_pressure=cast(self.log_pressure),
            temperature_grid=cast(self.temperature_grid),
            coeff_dense=cast(self.coeff_dense),
            coeff_lut=tuple(cast(x) for x in self.coeff_lut),
            gpoint_fraction=cast(self.gpoint_fraction),
            planck_temperature=cast(self.planck_temperature),
            planck_function=cast(self.planck_function),
            solar_irradiance=cast(self.solar_irradiance),
            rayleigh_coeff=cast(self.rayleigh_coeff),
        )
