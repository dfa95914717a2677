"""Planck source interpolation.

Vectorized equivalent of the reference ``calculate_planck_function``
(rte-ecckd/src/gas_optics_ecckd.f90:245-289):

* linear interpolation on the 1 K Planck-temperature axis;
* temperatures *above* the table extrapolate linearly from the last interval
  (the top index clamp leaves w1 > 1, gas_optics_ecckd.f90:278-279);
* temperatures *below* the first entry scale the first table row linearly
  toward zero: B = (T/T0) * planck[0] (gas_optics_ecckd.f90:283-285);
* the result is divided by pi, converting flux [W m-2] to intensity
  [W m-2 sr-1] (gas_optics_ecckd.f90:288).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ecckd_tpu import constants


def planck_source(temperature: jax.Array, planck_temperature: jax.Array,
                  planck_function: jax.Array) -> jax.Array:
    """Planck intensity at each (col, level, gpoint).

    Args:
      temperature: [K], any shape S (e.g. (ncol, nlev)).
      planck_temperature: (n_planck_T,) uniform axis.
      planck_function: (n_planck_T, ngpt) fluxes [W m-2].

    Returns:
      (*S, ngpt) intensities [W m-2 sr-1].
    """
    n = planck_function.shape[0]
    t0 = planck_temperature[0]
    dt = planck_temperature[1] - planck_temperature[0]
    idx = (temperature - t0) / dt
    i0 = jnp.clip(jnp.floor(idx).astype(jnp.int32), 0, n - 2)
    w1 = (idx - i0)[..., None]
    interp = ((1.0 - w1) * jnp.take(planck_function, i0, axis=0)
              + w1 * jnp.take(planck_function, i0 + 1, axis=0))
    below = (temperature / t0)[..., None] * planck_function[0]
    out = jnp.where((idx >= 0)[..., None], interp, below)
    return out / jnp.asarray(constants.PI, out.dtype)
