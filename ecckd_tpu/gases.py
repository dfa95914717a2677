"""Named gas volume-mixing-ratio store.

Counterpart of rte-rrtmgp's ``ty_gas_concs``
(use-sites: rte-ecckd/src/gas_optics_ecckd.f90:329,340-342,351 and
rte-ecckd/example/rfmip-rad-irf/mo_rfmip_io.F90:199-260).

Design notes (vs the Fortran original):
* Gas names are *static* pytree metadata, so the requested-gas set is resolved
  at trace time and the jitted program contains one fused kernel per distinct
  gas set, with no runtime name matching.
* Values may be scalars, (ncol,) or (ncol, nlay) arrays; ``get_vmr``
  broadcasts to (ncol, nlay) like the reference's scalar broadcast.
* Insertion order is preserved — the reference iterates the requested-gas
  list in order (gas_optics_ecckd.f90:348-374), and deterministic order
  is what makes the resolved contribution list (and composite-once
  semantics) a stable part of the traced program.  NOTE: tau
  ACCUMULATION order downstream is not bit-for-bit the reference's
  serial order — ops/optical_depth sums the stacked dense-gas
  contributions in one reduction and adds the LUT gas after — so
  parity with the Fortran chain is tolerance-level (the repo's
  documented contract), not addition-order-exact.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Mapping, Tuple, Union

import jax
import jax.numpy as jnp

Scalar = Union[float, jax.Array]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class GasConcs:
    values: Tuple[jax.Array, ...]
    names: Tuple[str, ...] = dataclasses.field(metadata=dict(static=True))

    @classmethod
    def create(cls, concs: Mapping[str, Scalar] | Iterable[Tuple[str, Scalar]]
               ) -> "GasConcs":
        items = concs.items() if isinstance(concs, Mapping) else list(concs)
        names, values = [], []
        for name, value in items:
            names.append(name.strip().lower())
            values.append(jnp.asarray(value))
        return cls(values=tuple(values), names=tuple(names))

    def set_vmr(self, name: str, value: Scalar) -> "GasConcs":
        """Functional update; replaces an existing entry or appends."""
        name = name.strip().lower()
        value = jnp.asarray(value)
        if name in self.names:
            i = self.names.index(name)
            vals = list(self.values)
            vals[i] = value
            return GasConcs(values=tuple(vals), names=self.names)
        return GasConcs(values=self.values + (value,),
                        names=self.names + (name,))

    def get_num_gases(self) -> int:
        return len(self.names)

    def get_gas_names(self) -> Tuple[str, ...]:
        return self.names

    def __contains__(self, name: str) -> bool:
        return name.strip().lower() in self.names

    def get_vmr(self, name: str, ncol: int, nlay: int) -> jax.Array:
        """VMR broadcast to (ncol, nlay), mirroring ty_gas_concs%get_vmr."""
        i = self.names.index(name.strip().lower())
        return jnp.broadcast_to(jnp.atleast_1d(self.values[i])[..., None]
                                if self.values[i].ndim == 1
                                else self.values[i], (ncol, nlay))
