"""Gas optical-depth computation (the hot kernel).

Vectorized reimplementation of the reference's
``calculate_optical_depth`` / ``gas_optical_depth``
(rte-ecckd/src/gas_optics_ecckd.f90:64-241,323-376):

* The requested-gas set is resolved at *trace time* from the static gas-name
  tuples (unknown gases silently skipped, composite contributes exactly once —
  gas_optics_ecckd.f90:358-367).
* All bi-linear (dense) gases share one batched gather + one fused
  multiply-accumulate over a stacked table, instead of a per-gas Fortran loop;
  their three concentration-dependence codes collapse into one affine weight
  ``simple_weight * (a*vmr + b)``.
* Per-gas negative optical depths are clamped to zero *before* accumulation
  (gas_optics_ecckd.f90:233-238) — relevant for relative-linear gases whose
  vmr is below the reference value.
* ``logarithmic_interpolation`` selects the reference's alternate
  log-space interpolation branches (gas_optics_ecckd.f90:180-229) — live
  API there but never selected by its callers (:368), same default here.
"""
from __future__ import annotations

from typing import List, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ecckd_tpu import constants
from ecckd_tpu.gases import GasConcs
from ecckd_tpu.models.ckd import CKDModel
from ecckd_tpu.ops import interp


class GasContribution(NamedTuple):
    gas_index: int
    name: str


def resolve_contributions(model: CKDModel, names: Tuple[str, ...]
                          ) -> List[GasContribution]:
    """Trace-time gas-set resolution with reference semantics:
    requested order kept, unknown gases skipped, composite-only gases
    contribute once (the first one requested)."""
    out: List[GasContribution] = []
    used_composite = False
    for name in names:
        key = name.strip().lower()
        if key not in model.gas_names:
            continue  # silent skip, gas_optics_ecckd.f90:358-364
        gi = model.gas_names.index(key)
        if model.gas_composite_only[gi]:
            if used_composite:
                continue
            used_composite = True
        out.append(GasContribution(gi, key))
    return out


def gas_optical_depth(model: CKDModel, plev: jax.Array, tlay: jax.Array,
                      gas_concs: GasConcs,
                      logarithmic_interpolation: bool = False) -> jax.Array:
    """Total gas optical depth, (ncol, nlay, ngpt).

    Args:
      model: CKD model (tables).
      plev: level pressures [Pa], (ncol, nlay+1).
      tlay: layer temperatures [K], (ncol, nlay).
      gas_concs: requested gases (static names, vmr values).
      logarithmic_interpolation: interpolate log(coefficient) instead of
        the coefficient (the reference's never-selected alternate branch).
    """
    ncol, nlay = tlay.shape
    dtype = tlay.dtype
    contributions = resolve_contributions(model, gas_concs.names)

    # Shared (pressure, temperature) interpolation points.
    n_p = model.log_pressure.shape[0]
    n_t = model.temperature_grid.shape[1]
    p_iw = interp.pressure_index(
        plev, model.log_pressure[0],
        model.log_pressure[1] - model.log_pressure[0], n_p)
    t_iw = interp.temperature_index(tlay, p_iw, model.temperature_grid)

    # Moles of dry air per m^2 in each layer (gas_optics_ecckd.f90:107,143).
    simple_weight = (jnp.asarray(constants.MOLES_PER_PA, dtype)
                     * (plev[:, 1:] - plev[:, :-1]))

    ngpt = model.ngpt
    tau = jnp.zeros((ncol, nlay, ngpt), dtype)

    # --- dense (bi-linear) gases: one batched gather over stacked tables ---
    dense = [c for c in contributions
             if model.gas_codes[c.gas_index] != constants.CONC_LUT]
    if dense:
        rows = np.array([model.gas_table_idx[c.gas_index] for c in dense])
        scale_offset = [model.weight_scale_offset(c.gas_index) for c in dense]
        a = jnp.asarray([s for s, _ in scale_offset], dtype)
        b = jnp.asarray([o for _, o in scale_offset], dtype)
        vmrs = jnp.stack([gas_concs.get_vmr(c.name, ncol, nlay).astype(dtype)
                          for c in dense])                  # (G, ncol, nlay)
        weights = simple_weight * (a[:, None, None] * vmrs + b[:, None, None])
        tables = model.coeff_dense[rows].reshape(len(dense), n_p * n_t, ngpt)
        coeff = interp.bilinear_gather(tables, n_t, p_iw, t_iw,
                                       logarithmic_interpolation)
        #       (G, ncol, nlay, ngpt)
        tau_g = jnp.maximum(weights[..., None] * coeff, 0.0)
        tau = tau + jnp.sum(tau_g, axis=0)

    # --- look-up-table (tri-linear) gases (h2o) ---------------------------
    for c in contributions:
        gi = c.gas_index
        if model.gas_codes[gi] != constants.CONC_LUT:
            continue
        vmr = gas_concs.get_vmr(c.name, ncol, nlay).astype(dtype)
        mf_grid = model.lut_mf_grids[model.gas_table_idx[gi]]
        v_iw = interp.vmr_index(vmr, mf_grid)
        table = model.coeff_lut[model.gas_table_idx[gi]]
        table_flat = table.reshape(-1, ngpt)
        coeff = interp.trilinear_gather(table_flat, n_p, n_t, p_iw, t_iw,
                                        v_iw, logarithmic_interpolation)
        weight = simple_weight * vmr
        tau = tau + jnp.maximum(weight[..., None] * coeff, 0.0)

    return tau
