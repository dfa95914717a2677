"""utils/checks.py validation semantics + the pipelines' single path."""
import inspect

import numpy as np
import pytest

from ecckd_tpu.pipeline import clamp_top_pressure
from ecckd_tpu.utils.checks import InputValidationError, validate_inputs


def _cols(plev_row):
    plev = np.asarray(plev_row, np.float32)[None, :]
    tlay = np.full((1, plev.shape[1] - 1), 260.0, np.float32)
    return plev, tlay


@pytest.mark.parametrize("press_min", [4.1, 51.7, 400.3, 2.0])
def test_validate_accepts_clamped_top_at_f32(press_min):
    """clamp_top_pressure stores press_min + eps into an f32 array; in
    binades where the f32 ulp exceeds 2*eps the stored top level rounds
    up to half an ulp BELOW press_min.  validate_inputs must accept the
    clamp's own output (the old 1e-12 relative tolerance rejected it —
    round-5 fix: the tolerance is one f32 ulp)."""
    plev, tlay = _cols([press_min * 0.5, press_min * 2.0,
                        press_min * 10.0, press_min * 50.0])
    plev = clamp_top_pressure(plev, press_min).astype(np.float32)
    validate_inputs(plev, tlay, press_min=press_min)   # must not raise


def test_validate_rejects_genuinely_below_min():
    plev, tlay = _cols([1.0, 100.0, 1000.0])
    with pytest.raises(InputValidationError, match="below table minimum"):
        validate_inputs(plev, tlay, press_min=4.1)


def test_validate_rejects_non_monotonic():
    plev, tlay = _cols([100.0, 50.0, 1000.0])
    with pytest.raises(InputValidationError, match="monotonic"):
        validate_inputs(plev, tlay)


def test_unknown_backend_string_raises():
    """There is one compute path: the pipelines take no backend argument,
    so any backend string is refused instead of rerouting the compute."""
    from ecckd_tpu.pipeline import lw_fluxes, lw_sw_fluxes, sw_fluxes
    for fn in (lw_fluxes, sw_fluxes, lw_sw_fluxes):
        assert "backend" not in inspect.signature(fn).parameters
    tlay = np.zeros((1, 2), np.float32)
    with pytest.raises(TypeError, match="backend"):
        lw_fluxes(None, None, tlay, None, None, None, None,
                  **{"backend": "pallas"})
    with pytest.raises(TypeError, match="backend"):
        sw_fluxes(None, None, tlay, None, None, None, None,
                  **{"backend": "xla"})


def test_unknown_backend_with_log_interp_raises():
    """The logarithmic interpolation branch runs on the same single path:
    a backend string next to it is refused as well."""
    from ecckd_tpu.pipeline import lw_fluxes, sw_fluxes
    tlay = np.zeros((1, 2), np.float32)
    with pytest.raises(TypeError, match="backend"):
        lw_fluxes(None, None, tlay, None, None, None, None,
                  logarithmic_interpolation=True, **{"backend": "pallas"})
    with pytest.raises(TypeError, match="backend"):
        sw_fluxes(None, None, tlay, None, None, None, None,
                  logarithmic_interpolation=True, **{"backend": "Fused"})
