"""ecckd_tpu: ecCKD gas optics + RTE flux solvers in JAX.

A from-scratch JAX/XLA reimplementation of the capabilities of
earth-system-radiation/rte-ecckd (plus the external rte-rrtmgp solvers it
depends on): functional pytrees, trace-time gas-set resolution, scanned
layer recurrences, column-axis SPMD sharding.
"""
from ecckd_tpu.fluxes import FluxesBroadband, heating_rate
from ecckd_tpu.gases import GasConcs
from ecckd_tpu.models.ckd import CKDModel
from ecckd_tpu.models.gas_optics import (gas_optics, gas_optics_lw,
                                         gas_optics_sw)
from ecckd_tpu.models.loader import load_ckd_model
from ecckd_tpu.optics import OpticalProps1scl, OpticalProps2str, SourceFuncLW
from ecckd_tpu.solvers.lw import rte_lw
from ecckd_tpu.solvers.sw import rte_sw

__version__ = "0.1.0"

__all__ = [
    "CKDModel", "GasConcs", "FluxesBroadband", "OpticalProps1scl",
    "OpticalProps2str", "SourceFuncLW", "gas_optics", "gas_optics_lw", "gas_optics_sw",
    "heating_rate", "load_ckd_model", "rte_lw", "rte_sw",
]
