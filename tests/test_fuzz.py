"""Randomized end-to-end equivalence: full pipelines vs the NumPy oracle.

Each trial draws random shapes, a random requested-gas list (random order,
unknown names mixed in), and inputs that deliberately straddle the table
edges (temperatures below the Planck grid and above the (p,T) grid, very
thin and very thick layers, grazing/night sun angles), then checks the f64
XLA pipelines against a composition of the scalar oracle functions
(tests/oracle.py) that mirror the reference arithmetic statement by
statement.  This sweeps interaction effects the targeted unit tests can't
enumerate (clamp x extrapolation x gas-subset x solver).
"""
import numpy as np
import pytest

import oracle
from test_gas_optics import model_to_oracle
from ecckd_tpu.gases import GasConcs
from ecckd_tpu.models.loader import load_ckd_model
from ecckd_tpu.pipeline import lw_fluxes, sw_fluxes

GAS_POOL = ["co2", "ch4", "n2o", "o2", "cfc11", "cfc12", "h2o", "o3",
            "no2", "sf6", "unknown_gas"]


def random_atmosphere(rng, ncol, nlay):
    """Physically plausible but edge-hunting columns."""
    p_top = 10.0 ** rng.uniform(-0.5, 1.5)       # down to below-grid clamp
    p_sfc = 10.0 ** rng.uniform(4.8, 5.05)
    base = np.exp(np.linspace(np.log(p_top), np.log(p_sfc), nlay + 1))
    jitter = 1.0 + 0.1 * rng.standard_normal((ncol, nlay + 1))
    plev = np.sort(np.abs(base[None, :] * jitter) + 1e-3, axis=1)
    logp = np.log(0.5 * (plev[:, 1:] + plev[:, :-1]))
    # Temperatures spanning below the Planck grid (<120 K) to above the
    # (p,T) grid top — exercises every clamp/extrapolation branch.
    tmid = rng.uniform(110.0, 360.0)
    tlay = tmid + 20.0 * rng.standard_normal((ncol, nlay))
    tlev = tmid + 20.0 * rng.standard_normal((ncol, nlay + 1))
    tsfc = tmid + rng.uniform(-30, 30, ncol)
    return plev, np.abs(tlay) + 1.0, np.abs(tlev) + 1.0, np.abs(tsfc) + 1.0


def random_request(rng, ncol, nlay):
    names = list(rng.permutation(GAS_POOL))[:rng.integers(2, len(GAS_POOL))]
    items = []
    for n in names:
        kind = rng.integers(0, 3)
        if kind == 0:          # scalar
            v = 10.0 ** rng.uniform(-12, -3)
        elif kind == 1:        # per-column
            v = 10.0 ** rng.uniform(-12, -3, ncol)
        else:                  # per-(column, layer)
            v = 10.0 ** rng.uniform(-12, -2, (ncol, nlay))
        if n == "o2":
            v = np.asarray(v) * 1e6 * 0.2  # realistic magnitude for o2
        items.append((n, np.asarray(v, np.float64)))
    concs = GasConcs.create(items)

    def full(v):
        v = np.asarray(v, np.float64)
        if v.ndim == 1:          # per-column -> broadcast over layers
            v = v[:, None]
        return np.broadcast_to(v, (ncol, nlay)).copy()

    oracle_req = [(n, full(v)) for n, v in items]
    return concs, oracle_req


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_lw_pipeline_vs_oracle(ckd_paths, seed):
    rng = np.random.default_rng(1000 + seed)
    ncol = int(rng.integers(1, 6))
    nlay = int(rng.integers(2, 40))
    ckd = ckd_paths[("lw_fsck", "lw_rrtmgp")[seed % 2]]
    model = load_ckd_model(ckd, dtype=np.float64)
    plev, tlay, tlev, tsfc = random_atmosphere(rng, ncol, nlay)
    concs, oracle_req = random_request(rng, ncol, nlay)
    emis = rng.uniform(0.0, 1.0, ncol)
    n_ang = int(rng.choice([1, 2, 3]))

    f = lw_fluxes(model, plev, tlay, tlev, tsfc, emis, concs,
                  n_gauss_angles=n_ang)

    mnp = model_to_oracle(model)
    tau = oracle.total_optical_depth(mnp, oracle_req, plev, tlay)
    pt = np.asarray(model.planck_temperature, np.float64)
    pf = np.asarray(model.planck_function, np.float64)
    lay_src = oracle.planck(tlay, pt, pf)
    lev_src = oracle.planck(tlev, pt, pf)
    sfc_src = oracle.planck(tsfc[:, None], pt, pf)[:, 0, :]
    emis_gpt = np.broadcast_to(emis[:, None], (ncol, model.ngpt))
    up_ref, dn_ref = oracle.lw_fluxes(
        tau, lay_src, lev_src[:, 1:, :], lev_src[:, :-1, :], sfc_src,
        emis_gpt, n_ang)
    scale = max(np.abs(up_ref).max(), 1e-6)
    np.testing.assert_allclose(np.asarray(f.flux_up), up_ref,
                               atol=1e-9 * scale, rtol=1e-9)
    np.testing.assert_allclose(np.asarray(f.flux_dn), dn_ref,
                               atol=1e-9 * scale, rtol=1e-9)


def test_edge_pinned_columns_vs_oracle(ckd_paths):
    """Inputs pinned EXACTLY at every clamp boundary at once — the random
    fuzz straddles edges statistically; this hits them deterministically:
    layer pressures at/below the grid origin and at/above the grid top,
    temperatures exactly at the per-pressure grid origin and below the
    120 K Planck grid, h2o exactly at / a decade below / above the LUT
    mole-fraction axis ends, and near-zero-thickness layers (dp -> 1e-6 Pa).
    Reference clamps: gas_optics_ecckd.f90:121-128 (N-1.0001),
    :153-163 (vmr floor + N-1.001), :234-238 (neg-tau), :278-285 (Planck)."""
    model = load_ckd_model(ckd_paths["lw_fsck"], dtype=np.float64)
    logp = np.asarray(model.log_pressure, np.float64)
    tg = np.asarray(model.temperature_grid, np.float64)
    mf = np.asarray(model.lut_mf_grids[0], np.float64)
    p_lo, p_hi = np.exp(logp[0]), np.exp(logp[-1])

    nlay = 6
    # Column designs (each row: a target layer-pressure ladder).
    p_ladders = [
        # below-grid origin, exactly at origin, interior, exactly at top,
        # above top -- all in one column
        np.array([p_lo * 0.2, p_lo, np.exp(logp[10]), np.exp(logp[-2]),
                  p_hi, p_hi * 1.5]),
        # near-zero-thickness layers around an interior grid point
        np.full(nlay, np.exp(logp[25])),
        # exactly at successive grid points (weights 0/1 boundaries)
        np.exp(logp[5:5 + nlay]),
    ]
    ncol = len(p_ladders)
    plev = np.zeros((ncol, nlay + 1))
    for i, ladder in enumerate(p_ladders):
        # Build levels so that 0.5*(plev[j]+plev[j+1]) == ladder[j] with
        # near-zero dp for the middle ladder (dp = 1e-6 Pa).
        dp = 1e-6 if i == 1 else None
        levs = np.zeros(nlay + 1)
        levs[0] = ladder[0] - (dp or 0.05 * ladder[0])
        for j in range(nlay):
            levs[j + 1] = 2.0 * ladder[j] - levs[j]
            if levs[j + 1] <= levs[j]:  # keep strictly increasing
                levs[j + 1] = levs[j] * (1.0 + 1e-9) + (dp or 1e-6)
        plev[i] = levs
    # Temperatures: column 0 pinned at the per-pressure grid origin row,
    # column 1 below the Planck grid (100 K), column 2 above everything.
    t0_row = tg[:, 0]
    tlay = np.stack([
        np.interp(np.log(np.maximum(p_ladders[0], p_lo)), logp, t0_row),
        np.full(nlay, 100.0),
        np.full(nlay, 400.0)])
    tlev = np.concatenate([tlay[:, :1], 0.5 * (tlay[:, 1:] + tlay[:, :-1]),
                           tlay[:, -1:]], axis=1)
    tsfc = np.array([tg[0, 0], 100.0, 400.0])
    # h2o exactly at the LUT ends, a decade below, and far above.
    h2o = np.stack([
        np.array([mf[0] * 0.1, mf[0], mf[3], mf[-2], mf[-1], mf[-1] * 10]),
        np.full(nlay, mf[0]),
        np.full(nlay, mf[-1])])
    # ch4 at exactly its reference mole fraction (zero relative-linear
    # weight) in one column, below it (negative weight -> neg-tau clamp).
    ref_ch4 = model.gas_reference_mf[model.gas_names.index("ch4")]
    ch4 = np.array([ref_ch4, 0.2 * ref_ch4, 5.0 * ref_ch4])
    concs = GasConcs.create([("h2o", h2o), ("ch4", ch4), ("co2", 4e-4),
                             ("o2", 0.2095), ("o3", 1e-6)])
    emis = np.array([1.0, 0.5, 0.0])

    f = lw_fluxes(model, plev, tlay, tlev, tsfc, emis, concs,
                  n_gauss_angles=1)

    mnp = model_to_oracle(model)
    req = [("h2o", h2o), ("ch4", np.broadcast_to(ch4[:, None],
                                                 (ncol, nlay)).copy()),
           ("co2", np.full((ncol, nlay), 4e-4)),
           ("o2", np.full((ncol, nlay), 0.2095)),
           ("o3", np.full((ncol, nlay), 1e-6))]
    tau = oracle.total_optical_depth(mnp, req, plev, tlay)
    pt = np.asarray(model.planck_temperature, np.float64)
    pf = np.asarray(model.planck_function, np.float64)
    lay_src = oracle.planck(tlay, pt, pf)
    lev_src = oracle.planck(tlev, pt, pf)
    sfc_src = oracle.planck(tsfc[:, None], pt, pf)[:, 0, :]
    emis_gpt = np.broadcast_to(emis[:, None], (ncol, model.ngpt))
    up_ref, dn_ref = oracle.lw_fluxes(
        tau, lay_src, lev_src[:, 1:, :], lev_src[:, :-1, :], sfc_src,
        emis_gpt, 1)
    scale = np.abs(up_ref).max()
    np.testing.assert_allclose(np.asarray(f.flux_up), up_ref,
                               atol=1e-9 * scale, rtol=1e-9)
    np.testing.assert_allclose(np.asarray(f.flux_dn), dn_ref,
                               atol=1e-9 * scale, rtol=1e-9)


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_sw_pipeline_vs_oracle(ckd_paths, seed):
    rng = np.random.default_rng(2000 + seed)
    ncol = int(rng.integers(1, 6))
    nlay = int(rng.integers(2, 40))
    model = load_ckd_model(ckd_paths["sw_wide"], dtype=np.float64)
    plev, tlay, _, _ = random_atmosphere(rng, ncol, nlay)
    concs, oracle_req = random_request(rng, ncol, nlay)
    alb = rng.uniform(0.0, 1.0, ncol)
    tsi = rng.uniform(1300.0, 1400.0, ncol)
    sza = rng.uniform(0.0, 130.0, ncol)          # includes night columns

    f = sw_fluxes(model, plev, tlay, concs, alb, tsi, sza)

    mnp = model_to_oracle(model)
    tau_gas = oracle.total_optical_depth(mnp, oracle_req, plev, tlay)
    tau_ray = oracle.rayleigh_tau(
        plev, np.asarray(model.rayleigh_coeff, np.float64))
    tau = tau_gas + tau_ray
    ssa = tau_ray / tau
    g = np.zeros_like(tau)
    solar = np.asarray(model.solar_irradiance, np.float64)
    toa = np.broadcast_to(solar, (ncol, model.ngpt))
    toa = toa * (tsi[:, None] / toa.sum(-1, keepdims=True))
    spacing90 = np.spacing(90.0)
    usecol = sza < 90.0 - 2.0 * spacing90
    mu0 = np.where(usecol, np.cos(np.deg2rad(sza)), 1.0)
    alb_gpt = np.broadcast_to(alb[:, None], (ncol, model.ngpt))
    up_ref, dn_ref, _ = oracle.sw_fluxes(tau, ssa, g, mu0, toa,
                                         alb_gpt, alb_gpt)
    up_ref = up_ref * usecol[:, None]
    dn_ref = dn_ref * usecol[:, None]
    scale = max(np.abs(dn_ref).max(), 1e-6)
    np.testing.assert_allclose(np.asarray(f.flux_up), up_ref,
                               atol=2e-9 * scale, rtol=1e-8)
    np.testing.assert_allclose(np.asarray(f.flux_dn), dn_ref,
                               atol=2e-9 * scale, rtol=1e-8)
