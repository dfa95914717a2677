"""Golden regression tests: committed f64 fluxes for all seeded ckd files.

The goldens (tests/goldens/*.npz, generated by tests/make_goldens.py) are
this framework's stand-in for the Fortran chain's RFMIP reference outputs
(SURVEY.md section 4): the f64 path must reproduce them near-bitwise, and
the f32 path must stay within single-precision flux tolerance.
Any drift means a numerics change — intentional changes regenerate the
goldens in the same commit.
"""
import os

import numpy as np
import pytest

from make_goldens import GOLDEN_DIR, LW_CASES, golden_inputs
from ecckd_tpu.models.loader import load_ckd_model
from ecckd_tpu.pipeline import lw_fluxes, sw_fluxes


def _golden(tag):
    path = os.path.join(GOLDEN_DIR, f"{tag}.npz")
    if not os.path.exists(path):
        pytest.fail(f"missing golden {path}; run tests/make_goldens.py")
    with np.load(path) as z:
        return z["flux_up"], z["flux_dn"]


@pytest.fixture(scope="module")
def inputs():
    return golden_inputs()


@pytest.mark.parametrize("tag,ckd,angles", LW_CASES)
def test_lw_golden_f64(inputs, ckd_paths, tag, ckd, angles):
    atm, concs, emis, _, _, _ = inputs
    model = load_ckd_model(ckd_paths[ckd], dtype=np.float64)
    f = lw_fluxes(model, atm["plev"], atm["tlay"], atm["tlev"], atm["tsfc"],
                  emis, concs, n_gauss_angles=angles)
    up, dn = _golden(tag)
    np.testing.assert_allclose(np.asarray(f.flux_up), up, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(f.flux_dn), dn, rtol=1e-12,
                               atol=1e-12)


def test_sw_golden_f64(inputs, ckd_paths):
    atm, concs, _, alb, tsi, sza = inputs
    model = load_ckd_model(ckd_paths["sw_wide"], dtype=np.float64)
    f = sw_fluxes(model, atm["plev"], atm["tlay"], concs, alb, tsi, sza)
    up, dn = _golden("sw_wide")
    np.testing.assert_allclose(np.asarray(f.flux_up), up, rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(np.asarray(f.flux_dn), dn, rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("tag,ckd,angles", LW_CASES)
def test_lw_golden_f32_path(inputs, ckd_paths, tag, ckd, angles):
    """The f32 fast path stays within single-precision flux error of the
    f64 goldens (relative to the flux scale, not elementwise — small dn
    values near TOA are absolutely tiny) for EVERY LW config: both ckd
    files, both quadrature orders."""
    atm, concs, emis, _, _, _ = inputs
    model = load_ckd_model(ckd_paths[ckd], dtype=np.float32)
    f32 = lambda x: np.asarray(x, np.float32)
    f = lw_fluxes(model, f32(atm["plev"]), f32(atm["tlay"]),
                  f32(atm["tlev"]), f32(atm["tsfc"]), f32(emis), concs,
                  n_gauss_angles=angles)
    up, dn = _golden(tag)
    scale = np.abs(up).max()
    assert np.abs(np.asarray(f.flux_up) - up).max() / scale < 5e-6
    assert np.abs(np.asarray(f.flux_dn) - dn).max() / scale < 5e-6


def test_sw_golden_f32_path(inputs, ckd_paths):
    """The SW f32 path (incl. the cancellation-free two-stream forms and
    night-column masking) stays within single-precision flux error of the
    f64 golden."""
    atm, concs, _, alb, tsi, sza = inputs
    model = load_ckd_model(ckd_paths["sw_wide"], dtype=np.float32)
    f32 = lambda x: np.asarray(x, np.float32)
    f = sw_fluxes(model, f32(atm["plev"]), f32(atm["tlay"]), concs,
                  f32(alb), f32(tsi), f32(sza))
    up, dn = _golden("sw_wide")
    scale = np.abs(dn).max()
    assert np.abs(np.asarray(f.flux_up) - up).max() / scale < 1e-5
    assert np.abs(np.asarray(f.flux_dn) - dn).max() / scale < 1e-5
