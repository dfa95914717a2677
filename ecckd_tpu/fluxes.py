"""Broadband flux containers and derived diagnostics.

Counterpart of rte-rrtmgp's ``ty_fluxes_broadband`` reducer (use-sites:
rte-ecckd/example/rfmip-rad-irf/ecckd_rfmip_lw.F90:108-109) plus the
heating-rate diagnostic called for by the accuracy contract of the ckd files
(the tolerance labels are heating-rate tolerances in K/day; SURVEY.md
section 6).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ecckd_tpu import constants


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class FluxesBroadband:
    flux_up: jax.Array  # (ncol, nlev) [W m-2]
    flux_dn: jax.Array  # (ncol, nlev) [W m-2]

    @property
    def flux_net(self) -> jax.Array:
        """Net downward flux."""
        return self.flux_dn - self.flux_up


def heating_rate(flux_up: jax.Array, flux_dn: jax.Array,
                 plev: jax.Array) -> jax.Array:
    """Layer heating rate [K/day] from broadband level fluxes.

    Energy balance of the layer between levels t (lower pressure) and b:
    cp * (dp/g) * dT/dt = F_net(t) - F_net(b) with F_net = F_dn - F_up, so

      dT/dt = -(g / cp) * dF_net / dp

    (written as a signed difference quotient, which is orientation-
    independent: flipping the level order flips both differences).
    """
    fnet = flux_dn - flux_up
    dfnet = fnet[:, 1:] - fnet[:, :-1]
    dp = plev[:, 1:] - plev[:, :-1]
    k_per_s = -(constants.GRAVITY / constants.CP_DRY_AIR) * dfnet / dp
    return k_per_s * constants.SECONDS_PER_DAY
