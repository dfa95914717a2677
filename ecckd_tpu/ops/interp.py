"""Fractional-index interpolation helpers.

Reproduces the exact index/clamp arithmetic of the reference hot kernel
(rte-ecckd/src/gas_optics_ecckd.f90:117-163) in 0-based form:

Fortran:  idx = 1 + max(0, min(raw, N - 1.0001));  i0 = int(idx); w1 = idx-i0
here:     idx = clip(raw, 0, N - 1.0001);          i0 = floor(idx); w1 = idx-i0

so i0 in [0, N-2] and w1 in [0, 1).  The vmr axis uses the looser clamp
constant ``N - 1.001`` (gas_optics_ecckd.f90:160).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp


class IndexWeight(NamedTuple):
    i0: jax.Array  # int32 lower grid index, in [0, N-2]
    w1: jax.Array  # fractional weight of index i0+1


def fractional_index(raw: jax.Array, n: int, clamp: float = 1.0001
                     ) -> IndexWeight:
    """Clamped fractional index on a uniform grid of ``n`` points."""
    idx = jnp.clip(raw, 0.0, n - clamp)
    i0 = jnp.floor(idx).astype(jnp.int32)
    return IndexWeight(i0, idx - i0)


def pressure_index(level_pressure: jax.Array, log_p0: jax.Array,
                   d_log_p: jax.Array, n_pressure: int) -> IndexWeight:
    """Pressure interpolation points from *level* pressures.

    Layer pressure is derived as the mean of the bounding level pressures
    (gas_optics_ecckd.f90:120); the ``play`` input of the public API is
    deliberately ignored, as in the reference.
    """
    log_p = jnp.log(0.5 * (level_pressure[..., 1:] + level_pressure[..., :-1]))
    return fractional_index((log_p - log_p0) / d_log_p, n_pressure)


def temperature_index(layer_temperature: jax.Array, p_iw: IndexWeight,
                      temperature_grid: jax.Array) -> IndexWeight:
    """Temperature interpolation points.

    The temperature-axis origin varies with pressure: it is the first grid
    column interpolated at the (clamped) pressure index
    (gas_optics_ecckd.f90:131-132).
    """
    t_first = temperature_grid[:, 0]
    dt = temperature_grid[0, 1] - temperature_grid[0, 0]
    t0 = ((1.0 - p_iw.w1) * jnp.take(t_first, p_iw.i0)
          + p_iw.w1 * jnp.take(t_first, p_iw.i0 + 1))
    n_t = temperature_grid.shape[1]
    return fractional_index((layer_temperature - t0) / dt, n_t)


def vmr_index(layer_vmr: jax.Array, mf_grid: Tuple[float, ...]) -> IndexWeight:
    """Mole-fraction interpolation points on the log-uniform LUT axis,
    with the vmr floored at the first grid entry
    (gas_optics_ecckd.f90:151-163)."""
    import math
    mf0 = mf_grid[0]
    d_log = math.log(mf_grid[1] / mf_grid[0])
    log_vmr = jnp.log(jnp.maximum(layer_vmr, mf0))
    raw = (log_vmr - math.log(mf0)) / d_log
    return fractional_index(raw, len(mf_grid), clamp=1.001)


def bilinear_gather(table_flat: jax.Array, n_t: int, p_iw: IndexWeight,
                    t_iw: IndexWeight, logarithmic: bool = False
                    ) -> jax.Array:
    """Bi-linear (pressure, temperature) interpolation of stacked tables.

    Args:
      table_flat: (..., np*nT, ngpt) tables flattened over the (p, T) grid.
      n_t: temperature-axis length.
      p_iw, t_iw: index/weight pairs of shape S (e.g. (ncol, nlay)).
      logarithmic: interpolate log(coefficient) and exponentiate — the
        reference's alternate branch (gas_optics_ecckd.f90:205-211,
        223-229), selectable but never selected by its callers.

    Returns:
      (..., *S, ngpt) interpolated coefficients.
    """
    idx = p_iw.i0 * n_t + t_iw.i0
    if logarithmic:
        take = lambda off: jnp.log(jnp.take(table_flat, idx + off, axis=-2))
    else:
        take = lambda off: jnp.take(table_flat, idx + off, axis=-2)
    pw1, tw1 = p_iw.w1[..., None], t_iw.w1[..., None]
    pw0, tw0 = 1.0 - pw1, 1.0 - tw1
    out = (tw0 * (pw0 * take(0) + pw1 * take(n_t))
           + tw1 * (pw0 * take(1) + pw1 * take(n_t + 1)))
    return jnp.exp(out) if logarithmic else out


def trilinear_gather(table_flat: jax.Array, n_p: int, n_t: int,
                     p_iw: IndexWeight, t_iw: IndexWeight,
                     v_iw: IndexWeight, logarithmic: bool = False
                     ) -> jax.Array:
    """Tri-linear (vmr, pressure, temperature) interpolation.

    Args:
      table_flat: (n_mf*np*nT, ngpt) LUT flattened over (mf, p, T).
      logarithmic: interpolate log(coefficient) then exponentiate (the
        reference's alternate branch, gas_optics_ecckd.f90:180-193).
    Returns:
      (*S, ngpt) interpolated coefficients.
    """
    idx = (v_iw.i0 * n_p + p_iw.i0) * n_t + t_iw.i0
    if logarithmic:
        take = lambda off: jnp.log(jnp.take(table_flat, idx + off, axis=-2))
    else:
        take = lambda off: jnp.take(table_flat, idx + off, axis=-2)
    pw1, tw1, vw1 = (p_iw.w1[..., None], t_iw.w1[..., None],
                     v_iw.w1[..., None])
    pw0, tw0, vw0 = 1.0 - pw1, 1.0 - tw1, 1.0 - vw1
    stride_v = n_p * n_t
    lo = (tw0 * (pw0 * take(0) + pw1 * take(n_t))
          + tw1 * (pw0 * take(1) + pw1 * take(n_t + 1)))
    hi = (tw0 * (pw0 * take(stride_v) + pw1 * take(stride_v + n_t))
          + tw1 * (pw0 * take(stride_v + 1) + pw1 * take(stride_v + n_t + 1)))
    out = vw0 * lo + vw1 * hi
    return jnp.exp(out) if logarithmic else out
