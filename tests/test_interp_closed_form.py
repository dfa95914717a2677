"""Transcription-independent anchors for the interpolation arithmetic.

Every other check of the gas-optics index/clamp arithmetic (oracle,
goldens, fuzz) compares two transcriptions of the same reading of
gas_optics_ecckd.f90:117-163 — a shared misreading would pass them all.  These tests anchor the interpolation itself to
ALGEBRA instead: a synthetic ckd model whose tables are exact affine
(or, for the logarithmic branch, exp-of-affine) functions of the grid
INDICES.  Bi/tri-linear interpolation reproduces an affine function of
the continuous (fractional) index exactly, so the expected coefficient
is a closed form in the clamped continuous coordinates — no floor,
weight, stride, gather or one-hot arithmetic appears in the expectation.
What the expectation does contain is exactly the documented index
mapping of the reference:

  ip = clip((ln p_lay - ln p0) / dlnp, 0, n_p - 1.0001)      [f90:117-128]
  t0(ip) = linear interp of the grid's first column               [:131-132]
  it = clip((T - t0(ip)) / dT,       0, n_t - 1.0001)            [:133-136]
  iv = clip((ln max(vmr, mf0) - ln mf0) / dlnv, 0, n_mf - 1.001) [:151-163]

with p_lay the mean of the bounding LEVEL pressures (:120).  The probe
batch places points exactly AT and BEYOND every clamp edge, so a
mis-transcribed clamp constant (1.001 vs 1.0001 on any axis), a wrong
temperature-axis origin, or a missing vmr floor shifts the expectation
by ~1e-4 relative — 10^8 times the f64 assertion tolerance.
"""
import math

import numpy as np
import pytest

import jax.numpy as jnp

from ecckd_tpu import constants
from ecckd_tpu.gases import GasConcs
from ecckd_tpu.models.ckd import CKDModel
from ecckd_tpu.ops.optical_depth import gas_optical_depth

F64 = np.float64

# --- synthetic grid geometry (deliberately non-round values) -----------
N_P, N_T, N_MF, NGPT = 20, 6, 9, 8
LNP0 = math.log(97.0)                    # ~ 1 hPa top
DLNP = (math.log(1.04e5) - LNP0) / (N_P - 1)
T00, T0_SLOPE, DT = 161.0, 1.7, 19.0     # t0(p) = T00 + T0_SLOPE * p_idx
MF0, DLNV = 2.1e-7, 0.48                 # log-uniform h2o axis
CH4_REF = 1.921e-6

G = np.arange(NGPT, dtype=F64)
# Per-g-point affine coefficients, chosen so every table entry is > 0
# over the full index ranges (absorption coefficients are non-negative).
COMP_C = (2.0 + 0.11 * G, 0.031 * (G - 3.5) / 3.5, -0.017 * (G - 2.0) / 5.0)
CO2_C = (1.5 + 0.07 * G, -0.024 * (G + 1.0) / 8.0, 0.021 * (G - 4.0) / 4.0)
CH4_C = (1.8 + 0.05 * G, 0.027 * (G - 1.0) / 7.0, 0.013 * (G - 6.0) / 6.0)
H2O_C = (2.2 + 0.09 * G, 0.041 * (G - 3.0) / 6.0, -0.019 * (G - 5.0) / 5.0,
         0.023 * (G - 2.5) / 5.5)
# The LINEAR variant scales the h2o LUT up so the vmr-axis clamp constant
# is discriminating at the h2o mole fractions the probe batch uses (h2o's
# small vmr weight would otherwise bury the 1.001-vs-1.0001 difference
# under the other gases' tau; see test_clamp_constants_are_load_bearing).
# The exponential variant stays unscaled: exp(0.15 * k) must not overflow.
H2O_SCALE = 1000.0


def _affine3(c, pi, ti):
    """c0[g] + c1[g]*pi + c2[g]*ti over broadcast index arrays."""
    return c[0] + c[1] * pi[..., None] + c[2] * ti[..., None]


def _affine4(c, vi, pi, ti):
    return (c[0] + c[1] * vi[..., None] + c[2] * pi[..., None]
            + c[3] * ti[..., None])


def synthetic_model(exponential: bool = False) -> CKDModel:
    """LW-shaped CKDModel whose tables are affine (or exp-of-affine) in
    the grid indices — see module docstring."""
    pi = np.arange(N_P, dtype=F64)[:, None]
    ti = np.arange(N_T, dtype=F64)[None, :]
    dense = np.stack([_affine3(c, pi, ti) for c in (COMP_C, CO2_C, CH4_C)])
    vi = np.arange(N_MF, dtype=F64)[:, None, None]
    lut = _affine4(H2O_C, vi, pi[None], ti[None])
    if exponential:
        # exp of an affine index function: the LOGARITHMIC interpolation
        # branch (log-space linear interp then exp) reproduces it exactly.
        dense, lut = np.exp(0.15 * (dense - 2.0)), np.exp(0.15 * (lut - 2.0))
    else:
        lut = lut * H2O_SCALE
    lnp = LNP0 + DLNP * np.arange(N_P, dtype=F64)
    tgrid = T00 + T0_SLOPE * pi + DT * ti + 0.0 * pi  # (N_P, N_T)
    mf_grid = tuple(float(MF0 * math.exp(DLNV * i)) for i in range(N_MF))
    planck_t = np.linspace(120.0, 350.0, 10)
    return CKDModel(
        log_pressure=jnp.asarray(lnp),
        temperature_grid=jnp.asarray(np.broadcast_to(tgrid, (N_P, N_T))),
        coeff_dense=jnp.asarray(dense),
        coeff_lut=(jnp.asarray(lut),),
        gpoint_fraction=jnp.ones((NGPT, 4), F64),
        planck_temperature=jnp.asarray(planck_t),
        planck_function=jnp.asarray(
            np.linspace(1.0, 50.0, 10)[:, None] * (1.0 + 0.1 * G)[None, :]),
        solar_irradiance=None,
        rayleigh_coeff=None,
        gas_names=("composite", "co2", "ch4", "h2o"),
        gas_codes=(constants.CONC_NONE, constants.CONC_LINEAR,
                   constants.CONC_RELATIVE_LINEAR, constants.CONC_LUT),
        gas_table_idx=(0, 1, 2, 0),
        gas_composite_only=(True, False, False, False),
        gas_reference_mf=(0.0, 0.0, CH4_REF, 0.0),
        lut_mf_grids=(mf_grid,),
        shortwave=False,
        total_solar_irradiance=0.0,
        band_limits=((0.0, 3260.0),),
        band2gpt=((0, NGPT - 1),),
        gpt2band=(0,) * NGPT,
        num_composite_gases=1,
        press_min=float(np.exp(lnp[0])), press_max=float(np.exp(lnp[-1])),
        temp_min=float(tgrid.min()), temp_max=float(tgrid.max()),
    )


def probe_batch():
    """(plev, tlay, vmrs) hitting every clamp edge AND generic interior
    points.  Columns (ncol=8, nlay=6):
      0: generic mid-grid, 1: pressures entirely ABOVE the table top
      (ip hits the 0 clamp), 2: pressures beyond the surface end (ip
      hits the N_P-1.0001 clamp), 3: temperatures below t0 (it = 0) and
      4: above the T grid (it = N_T-1.0001), 5: h2o below the vmr floor,
      6: h2o beyond the LUT top (iv = N_MF-1.001), 7: ch4 below its
      reference mole fraction (negative-weight per-gas clamp)."""
    ncol, nlay = 8, 6
    rng = np.random.default_rng(77)
    # Generic levels spanning the interior of the pressure grid.
    plev = np.exp(np.linspace(LNP0 + 0.7, LNP0 + DLNP * (N_P - 1) - 0.7,
                              nlay + 1))[None, :] * np.ones((ncol, 1))
    plev = plev * rng.uniform(0.97, 1.03, (ncol, nlay + 1))
    plev = np.sort(plev, axis=1)
    plev[1] = np.exp(np.linspace(LNP0 - 2.0, LNP0 - 0.1, nlay + 1))  # above
    plev[2] = np.exp(np.linspace(LNP0 + DLNP * (N_P - 1) - 0.05,
                                 LNP0 + DLNP * (N_P - 1) + 1.5, nlay + 1))
    tlay = rng.uniform(T00 + 15.0, T00 + T0_SLOPE * N_P + DT * (N_T - 2),
                       (ncol, nlay))
    tlay[3] = rng.uniform(80.0, T00 - 10.0, nlay)         # below t0
    tlay[4] = T00 + T0_SLOPE * N_P + DT * (N_T + 2)       # above grid
    h2o = 10.0 ** rng.uniform(math.log10(MF0 * 3),
                              math.log10(MF0 * math.exp(DLNV * (N_MF - 2))),
                              (ncol, nlay))
    h2o[5] = MF0 * 0.01                                   # below floor
    h2o[6] = MF0 * math.exp(DLNV * (N_MF + 3))            # beyond top
    ch4 = np.full(ncol, CH4_REF * 2.5)
    ch4[7] = CH4_REF * 0.3                                # negative weight
    co2 = np.full(ncol, 4.1e-4)
    return plev, tlay, {"co2": co2, "ch4": ch4, "h2o": h2o}


def expected_tau(plev, tlay, vmrs, exponential=False):
    """Closed-form expectation at f64 — clamped continuous indices into
    the affine (or exp-of-affine) forms; NO floor/weight/gather math."""
    lnp = np.log(0.5 * (plev[:, 1:] + plev[:, :-1]))
    ip = np.clip((lnp - LNP0) / DLNP, 0.0, N_P - 1.0001)
    t0 = T00 + T0_SLOPE * ip          # exact: first grid column is affine
    it = np.clip((tlay - t0) / DT, 0.0, N_T - 1.0001)
    iv = np.clip((np.log(np.maximum(vmrs["h2o"], MF0)) - math.log(MF0))
                 / DLNV, 0.0, N_MF - 1.001)
    sw = constants.MOLES_PER_PA * (plev[:, 1:] - plev[:, :-1])
    xf = ((lambda k: np.exp(0.15 * (k - 2.0))) if exponential
          else (lambda k: k))
    tau = sw[..., None] * xf(_affine3(COMP_C, ip, it))
    tau = tau + np.maximum(
        (sw * vmrs["co2"][:, None])[..., None] * xf(_affine3(CO2_C, ip, it)),
        0.0)
    tau = tau + np.maximum(
        (sw * (vmrs["ch4"] - CH4_REF)[:, None])[..., None]
        * xf(_affine3(CH4_C, ip, it)), 0.0)
    h2o_scale = 1.0 if exponential else H2O_SCALE
    tau = tau + np.maximum(
        (sw * vmrs["h2o"])[..., None]
        * h2o_scale * xf(_affine4(H2O_C, iv, ip, it)), 0.0)
    return tau


@pytest.mark.parametrize("exponential,logarithmic",
                         [(False, False), (True, True)])
def test_optical_depth_matches_closed_form(exponential, logarithmic):
    """XLA path at f64 vs pure algebra, <= 1e-12 relative, on a batch
    covering every clamp edge (see probe_batch).  The (True, True) leg
    anchors the logarithmic-interpolation branch the same way: log-space
    linear interpolation of exp-of-affine tables is exact."""
    model = synthetic_model(exponential=exponential)
    plev, tlay, vmrs = probe_batch()
    concs = GasConcs.create([
        ("co2", vmrs["co2"]), ("ch4", vmrs["ch4"]), ("h2o", vmrs["h2o"]),
        ("composite", np.zeros(plev.shape[0])),
        ("unknown_gas", np.full(plev.shape[0], 1e-9)),  # silent skip
    ])
    got = np.asarray(gas_optical_depth(
        model, jnp.asarray(plev), jnp.asarray(tlay), concs,
        logarithmic_interpolation=logarithmic))
    want = expected_tau(plev, tlay, vmrs, exponential=exponential)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-12 * scale, (
        f"max rel {np.abs(got - want).max() / scale:.3e}")


def test_clamp_constants_are_load_bearing():
    """The probe batch genuinely distinguishes the clamp constants: the
    expectation computed with the WRONG constant (1.001 on the p/T axes,
    1.0001 on the vmr axis) must differ by far more than the assertion
    tolerance — otherwise the test above could not catch a
    mis-transcription."""
    plev, tlay, vmrs = probe_batch()
    want = expected_tau(plev, tlay, vmrs)

    lnp = np.log(0.5 * (plev[:, 1:] + plev[:, :-1]))
    sw = constants.MOLES_PER_PA * (plev[:, 1:] - plev[:, :-1])
    for wrong_p, wrong_t, wrong_v in ((1.001, 1.0001, 1.001),
                                      (1.0001, 1.001, 1.001),
                                      (1.0001, 1.0001, 1.0001)):
        ip = np.clip((lnp - LNP0) / DLNP, 0.0, N_P - wrong_p)
        it = np.clip((tlay - (T00 + T0_SLOPE * ip)) / DT, 0.0,
                     N_T - wrong_t)
        iv = np.clip((np.log(np.maximum(vmrs["h2o"], MF0)) - math.log(MF0))
                     / DLNV, 0.0, N_MF - wrong_v)
        wrong = sw[..., None] * _affine3(COMP_C, ip, it)
        wrong = wrong + np.maximum(
            (sw * vmrs["co2"][:, None])[..., None]
            * _affine3(CO2_C, ip, it), 0.0)
        wrong = wrong + np.maximum(
            (sw * (vmrs["ch4"] - CH4_REF)[:, None])[..., None]
            * _affine3(CH4_C, ip, it), 0.0)
        wrong = wrong + np.maximum(
            (sw * vmrs["h2o"])[..., None]
            * H2O_SCALE * _affine4(H2O_C, iv, ip, it), 0.0)
        rel = np.abs(wrong - want).max() / np.abs(want).max()
        assert rel > 1e-7, f"clamp probe not load-bearing: {rel:.3e}"
