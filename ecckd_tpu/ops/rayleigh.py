"""Rayleigh scattering optical depth (shortwave only).

Equivalent of the reference ``calculate_rayleigh_optical_depth``
(rte-ecckd/src/gas_optics_ecckd.f90:293-319):
tau_ray(col, lay, gpt) = dp/(g * 0.001 * M_air) * rayleigh_coeff(gpt).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ecckd_tpu import constants


def rayleigh_optical_depth(level_pressure: jax.Array,
                           rayleigh_coeff: jax.Array) -> jax.Array:
    """tau_ray, (ncol, nlay, ngpt), from (ncol, nlay+1) level pressures."""
    moles = (level_pressure[:, 1:] - level_pressure[:, :-1]) * jnp.asarray(
        constants.MOLES_PER_PA, level_pressure.dtype)
    return moles[..., None] * rayleigh_coeff
