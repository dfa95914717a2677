"""ckd-definition netCDF file loader.

Builds a :class:`~ecckd_tpu.models.ckd.CKDModel` from an ecCKD
"ckd-definition" file, implementing the same schema and gas-registration
semantics as the reference loader
(rte-ecckd/example/rfmip-rad-irf/mo_load_coefficients.F90:19-203):

* every non-"composite" token of the global attribute ``constituent_id``
  becomes a gas with its own absorption table;
* every token of ``composite_constituent_id`` not already registered becomes a
  gas pointing at the *composite* table with ``composite_only=True``
  (mo_load_coefficients.F90:127-143);
* a gas with a 1-D ``<gas>_mole_fraction`` variable is a look-up-table gas
  (code 2) with a 4-D table; otherwise the scalar
  ``<gas>_conc_dependence_code`` selects none/linear/relative-linear with a
  3-D table (mo_load_coefficients.F90:149-203).

The files are netCDF3-classic; they are parsed by the repo's native C++
engine when built (``make -C native``; the same runtime io/rfmip.py uses),
with a transparent ``scipy.io.netcdf_file`` fallback — either way with no
libnetcdf dependency and bit-identical loaded values (the native engine's
reads are converted back to the file dtype, io/nc3_native.read_exact).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from ecckd_tpu import constants
from ecckd_tpu.config import default_precision
from ecckd_tpu.models.ckd import CKDModel

COMPOSITE = "composite"


def _CkdFile(path: str):
    """ckd-file reader factory: io/rfmip._NcFile (native engine preferred,
    scipy fallback, file-dtype-exact reads).  One reader implementation
    serves both I/O surfaces."""
    from ecckd_tpu.io.rfmip import _NcFile
    return _NcFile(path)


def load_ckd_model(path: str, dtype=None) -> CKDModel:
    """Load a ckd-definition file into a CKDModel pytree.

    Args:
      path: ckd-definition netCDF file (netCDF3 classic).
      dtype: working dtype for the tables (default: precision policy).
    """
    if dtype is None:
        dtype = default_precision().dtype

    f = _CkdFile(path)
    try:
        return _build_model(f, dtype)
    finally:
        f.close()


def _build_model(f: "_CkdFile", dtype) -> CKDModel:
    pressure = f.read("pressure")  # (np,) [Pa]
    log_pressure = np.log(pressure)
    # File stores (temperature, pressure); we index (pressure, temperature).
    temperature_grid = f.read("temperature").T  # (np, nT)

    # Band structure: contiguous g-point runs per band
    # (mo_load_coefficients.F90:59-73).
    wn1 = f.read("wavenumber1_band")
    wn2 = f.read("wavenumber2_band")
    band_number = f.read("band_number").astype(np.int64)  # 0-based per gpt
    ngpt = band_number.shape[0]
    nband = wn1.shape[0]
    band2gpt: List[Tuple[int, int]] = []
    for b in range(nband):
        gpts = np.nonzero(band_number == b)[0]
        band2gpt.append((int(gpts[0]), int(gpts[-1])))
    band_limits = tuple((float(a), float(b)) for a, b in zip(wn1, wn2))

    gpoint_fraction = f.read("gpoint_fraction")  # (ngpt, n_wavenumber)

    shortwave = f.has("solar_irradiance")
    solar_irradiance = rayleigh_coeff = None
    planck_temperature = planck_function = None
    total_solar_irradiance = 0.0
    if shortwave:
        solar_irradiance = f.read("solar_irradiance")
        total_solar_irradiance = float(solar_irradiance.sum())
        rayleigh_coeff = f.read("rayleigh_molar_scattering_coeff")
    else:
        planck_temperature = f.read("temperature_planck")
        planck_function = f.read("planck_function")  # (n_planck_T, ngpt)

    # --- gas registration (mo_load_coefficients.F90:103-144) ---------------
    tokens = f.attr_tokens("constituent_id")
    uses_composite = COMPOSITE in tokens
    composite_tokens = (
        f.attr_tokens("composite_constituent_id") if uses_composite else []
    )

    gas_names: List[str] = []
    gas_codes: List[int] = []
    gas_table_idx: List[int] = []
    gas_composite_only: List[bool] = []
    gas_reference_mf: List[float] = []
    dense_tables: List[np.ndarray] = []
    lut_tables: List[np.ndarray] = []
    lut_mf_grids: List[Tuple[float, ...]] = []
    dense_row_of: Dict[str, int] = {}

    def read_gas(name: str, file_gas: str, composite_only: bool) -> None:
        """mo_load_coefficients.F90:149-203 equivalent."""
        mf_var = f"{file_gas}_mole_fraction"
        is_lut = f.has(mf_var) and f.ndims(mf_var) == 1
        if is_lut:
            mf = f.read(mf_var)
            coeff = f.read(f"{file_gas}_molar_absorption_coeff")
            # file (mf, T, p, gpt) -> (mf, p, T, gpt)
            coeff = np.ascontiguousarray(coeff.transpose(0, 2, 1, 3))
            gas_names.append(name)
            gas_codes.append(constants.CONC_LUT)
            gas_table_idx.append(len(lut_tables))
            gas_composite_only.append(composite_only)
            gas_reference_mf.append(0.0)
            lut_tables.append(coeff)
            lut_mf_grids.append(tuple(float(x) for x in mf))
            return
        code = int(f.read(f"{file_gas}_conc_dependence_code"))
        if code not in (constants.CONC_NONE, constants.CONC_LINEAR,
                        constants.CONC_RELATIVE_LINEAR):
            raise ValueError(
                f"bad concentration dependence code {code} for gas {file_gas}")
        ref_mf = 0.0
        if code == constants.CONC_RELATIVE_LINEAR:
            ref_mf = float(f.read(f"{file_gas}_reference_mole_fraction"))
        if file_gas in dense_row_of:
            row = dense_row_of[file_gas]
        else:
            coeff = f.read(f"{file_gas}_molar_absorption_coeff")
            if coeff.ndim != 3:
                raise ValueError(
                    f"absorption coefficient for {file_gas} is not 3-D")
            # file (T, p, gpt) -> (p, T, gpt)
            coeff = np.ascontiguousarray(coeff.transpose(1, 0, 2))
            row = len(dense_tables)
            dense_tables.append(coeff)
            dense_row_of[file_gas] = row
        gas_names.append(name)
        gas_codes.append(code)
        gas_table_idx.append(row)
        gas_composite_only.append(composite_only)
        gas_reference_mf.append(ref_mf)

    for tok in tokens:
        if tok != COMPOSITE:
            read_gas(tok, tok, composite_only=False)
    for tok in composite_tokens:
        if tok not in gas_names:
            read_gas(tok, COMPOSITE, composite_only=True)

    # Leaves stay on the host (numpy).  Callers running a hot loop
    # jax.device_put the model once and pass it as a jit *argument* (see
    # cli/common.py, bench.py) rather than closing over it as constants.
    arr = lambda x: np.asarray(x, dtype=dtype)
    opt = lambda x: None if x is None else arr(x)

    return CKDModel(
        log_pressure=arr(log_pressure),
        temperature_grid=arr(temperature_grid),
        coeff_dense=arr(np.stack(dense_tables, axis=0)),
        coeff_lut=tuple(arr(t) for t in lut_tables),
        gpoint_fraction=arr(gpoint_fraction),
        planck_temperature=opt(planck_temperature),
        planck_function=opt(planck_function),
        solar_irradiance=opt(solar_irradiance),
        rayleigh_coeff=opt(rayleigh_coeff),
        gas_names=tuple(gas_names),
        gas_codes=tuple(gas_codes),
        gas_table_idx=tuple(gas_table_idx),
        gas_composite_only=tuple(gas_composite_only),
        gas_reference_mf=tuple(gas_reference_mf),
        lut_mf_grids=tuple(lut_mf_grids),
        shortwave=shortwave,
        total_solar_irradiance=total_solar_irradiance,
        band_limits=band_limits,
        band2gpt=tuple(band2gpt),
        gpt2band=tuple(int(b) for b in band_number),
        num_composite_gases=len(composite_tokens),
        press_min=float(np.exp(log_pressure[0])),
        press_max=float(np.exp(log_pressure[-1])),
        temp_min=float(temperature_grid.min()),
        temp_max=float(temperature_grid.max()),
    )
