"""Seeded inputs: ckd-definition files, RFMIP atmospheres, column batches.

Usage:
  python -m ecckd_tpu.io.synthetic rfmip out.nc [--nsite N] [--nlay N]
         [--nexp N] [--seed S]
  python -m ecckd_tpu.io.synthetic ckd out.nc --kind lw_fsck|lw_rrtmgp|sw_wide
         [--seed S]

The published ecCKD-1.2 ckd-definition files and the 100-site RFMIP file
are not part of this repository.  The generators below write files with the
published dimensions and schema (SURVEY.md sections 2.6-2.7), so the loader,
the readers and every driver run unchanged; their physical content is
invented, as listed in ``write_synthetic_ckd``'s ASSUMED block.
"""
from __future__ import annotations

import argparse
import os
from typing import Dict

import numpy as np
from scipy.io import netcdf_file

from ecckd_tpu import constants
from ecckd_tpu.config import REPO_ROOT
from ecckd_tpu.io.rfmip import write_synthetic_rfmip

CKD_KINDS = ("lw_fsck", "lw_rrtmgp", "sw_wide")

DEFAULT_CKD_DIR = os.path.join(REPO_ROOT, ".ckd_data")
"""Where drivers keep the seeded ckd files when no path is given."""

# Published per-file dimensions (SURVEY.md section 2.6).
_NGPT = {"lw_fsck": 32, "lw_rrtmgp": 36, "sw_wide": 27}
_N_WAVENUMBER = {"lw_fsck": 326, "lw_rrtmgp": 326, "sw_wide": 995}
_BAND_EDGES = {
    "lw_fsck": (0.0, 3260.0),
    "lw_rrtmgp": (10.0, 250.0, 500.0, 630.0, 700.0, 820.0, 980.0, 1080.0,
                  1180.0, 1390.0, 1480.0, 1800.0, 2080.0, 2250.0, 2390.0,
                  2680.0, 3250.0),
    "sw_wide": (250.0, 2500.0, 4000.0, 8000.0, 16000.0, 50000.0),
}
_GPT_PER_BAND = {
    "lw_fsck": (32,),
    "lw_rrtmgp": (2, 2, 3, 2, 2, 3, 2, 2, 2, 2, 3, 2, 2, 2, 3, 2),
    "sw_wide": (6, 5, 5, 5, 6),
}
N_PRESSURE, N_TEMPERATURE, N_H2O_MF, N_PLANCK = 53, 6, 12, 231
_P_MIN, _P_MAX = 0.694, 1.1e5
_MF_MIN, _MF_MAX = 1.61e-7, 5.08e-2
_COMPOSITE = "o2 n2 n2o ch4"
_COMPOSITE_MF = (0.2095, 0.7808, 3.32e-7, 1.921e-6)
_REFERENCE_MF = {"ch4": 1.921e-6, "n2o": 3.32e-7}
TOTAL_SOLAR_IRRADIANCE = 1361.0

# Column amount [mol m-2] at which each table's column optical depths take
# their seeded values, and the decades those optical depths span over the
# g-points (LW, SW).  See ASSUMED in write_synthetic_ckd.
_COLUMN_MOLES = {"composite": 3.5e5, "h2o": 1.0e3, "o3": 0.134,
                 "co2": 140.0, "ch4": 0.68, "n2o": 0.12, "cfc11": 8.2e-5,
                 "cfc12": 1.9e-4}
_TAU_RANGE = {
    "lw": {"composite": (1e-4, 1e2), "h2o": (0.1, 1e5), "o3": (1e-4, 1e2),
           "co2": (1e-3, 1e3), "ch4": (1e-5, 10.0), "n2o": (1e-5, 10.0),
           "cfc11": (1e-6, 1.0), "cfc12": (1e-6, 1.0)},
    "sw": {"composite": (1e-6, 1.0), "h2o": (1e-5, 30.0), "o3": (1e-5, 10.0),
           "co2": (1e-6, 1.0), "ch4": (1e-7, 0.1), "n2o": (1e-7, 0.1)},
}
_H2O_SELF_MF = 1.0e-2

# Planck's radiation constants: 2hc^2 [W m2 sr-1] and hc/k [m K].
_C1, _C2 = 1.191042972e-16, 1.438776877e-2


def _reference_temperature(log_p: np.ndarray) -> np.ndarray:
    """Middle of the temperature grid at each pressure: a standard-
    atmosphere-like profile, 188.46 K at the top of the grid."""
    knots_p = np.log([_P_MIN, 1.0e2, 2.0e4, _P_MAX])
    knots_t = np.array([188.46, 270.0, 217.0, 290.0])
    return np.interp(log_p, knots_p, knots_t)


def _planck_flux(nu_cm: np.ndarray, temperature: np.ndarray) -> np.ndarray:
    """pi * B_nu [W m-2 (m-1)-1] at wavenumbers ``nu_cm`` [cm-1],
    (n_temperature, n_nu)."""
    nu = 100.0 * nu_cm[None, :]
    x = _C2 * nu / temperature[:, None]
    return np.pi * _C1 * nu ** 3 / np.expm1(np.maximum(x, 1e-12))


def _band_integrated_planck(edges, temperature: np.ndarray) -> np.ndarray:
    """pi * integral of B over each band [W m-2], (n_temperature, nband);
    trapezoid rule on a 0.25 cm-1 grid."""
    out = np.empty((temperature.size, len(edges) - 1))
    for b, (lo, hi) in enumerate(zip(edges[:-1], edges[1:])):
        nu = np.linspace(lo, hi, int(round((hi - lo) / 0.25)) + 1)
        f = _planck_flux(nu, temperature)
        out[:, b] = np.sum(0.5 * (f[:, 1:] + f[:, :-1]), axis=1) * (
            100.0 * (nu[1] - nu[0]))
    return out


def write_synthetic_ckd(path: str, kind: str, seed: int = 0) -> None:
    """Write a seeded ckd-definition file with the published ecCKD-1.2
    dimensions and schema (netCDF3 classic, SURVEY.md section 2.6).

    ``kind`` is one of ``CKD_KINDS``: ``lw_fsck`` (32 g-points, 1 band),
    ``lw_rrtmgp`` (36 g-points, 16 bands) or ``sw_wide`` (27 g-points,
    5 bands).  The same ``(kind, seed)`` writes the same bytes.

    ASSUMED (invented; none of it comes from the published files):
      * band limits: fsck 0-3260 cm-1; rrtmgp the 16 RRTMGP longwave bands
        10-3250 cm-1; wide 250/2500/4000/8000/16000/50000 cm-1.  g-points
        per band as in ``_GPT_PER_BAND``.
      * wavenumber bins: 10 cm-1 bins over 0-3260 cm-1 (LW), log-spaced
        bins over 250-50000 cm-1 (SW); each bin maps wholly to one g-point
        of its band, the first ``ngpt`` bins of a band one to each g-point
        and the rest at random.
      * temperature grid: 6 points 20 K apart centred on a piecewise
        log-pressure-linear profile through 188.46 K (0.694 Pa), 270 K
        (100 Pa), 217 K (2e4 Pa) and 290 K (1.1e5 Pa).
      * absorption: each table is tau(g) * (1 + a) / N * (p / 1.1e5)^a
        * exp(b (T - T_mid(p)) / 100 K) [m2 mol-1], with column optical
        depths tau(g) log-uniform over ``_TAU_RANGE`` (six or more decades)
        and sorted to rise with g within each band, column amounts N from
        ``_COLUMN_MOLES``, pressure exponents a ~ U(0.5, 1) and
        temperature exponents b ~ U(-1, 1) per (gas, g-point).  The h2o
        table also scales by (1 + x / 1e-2) in its mole fraction x (a
        self-continuum).  All entries are non-negative; stored as float32.
      * Planck function: pi * B integrated over each band at 120-350 K in
        1 K steps, split over the band's g-points by fixed fractions drawn
        from Dirichlet(2).
      * solar irradiance: a 5778 K blackbody over each band, split over its
        g-points by Dirichlet(2) fractions, scaled to sum to 1361 W m-2.
      * Rayleigh: 2.7e-7 m2 mol-1 at 18182 cm-1 (550 nm), scaled as nu^4
        (the lambda^-4 law), averaged over each g-point's bins with the
        solar spectrum as weight.
      * codes and reference mole fractions: composite 0, h2o LUT
        (1.61e-7..5.08e-2, 12 points), o3/co2/cfc11/cfc12 1, ch4 3
        (1.921e-6), n2o 3 (3.32e-7); the composite's mole fractions
        (o2 0.2095, n2 0.7808, n2o 3.32e-7, ch4 1.921e-6) are written but
        never read.
    """
    if kind not in CKD_KINDS:
        raise ValueError(f"unknown ckd kind {kind!r}; expected one of "
                         f"{CKD_KINDS}")
    rng = np.random.default_rng([seed, CKD_KINDS.index(kind)])
    shortwave = kind.startswith("sw")
    ngpt = _NGPT[kind]
    edges = np.asarray(_BAND_EDGES[kind])
    gpt_per_band = _GPT_PER_BAND[kind]
    nband = len(gpt_per_band)
    band_number = np.repeat(np.arange(nband), gpt_per_band)
    gpt_start = np.concatenate([[0], np.cumsum(gpt_per_band)])

    # --- grids ------------------------------------------------------------
    log_p = np.linspace(np.log(_P_MIN), np.log(_P_MAX), N_PRESSURE)
    pressure = np.exp(log_p)
    t_mid = _reference_temperature(log_p)
    temperature = (t_mid[None, :]
                   + 20.0 * (np.arange(N_TEMPERATURE) - 2.5)[:, None])
    mole_fraction = np.exp(np.linspace(np.log(_MF_MIN), np.log(_MF_MAX),
                                       N_H2O_MF))

    # --- spectral mapping -------------------------------------------------
    nwn = _N_WAVENUMBER[kind]
    if shortwave:
        wn = np.exp(np.linspace(np.log(edges[0]), np.log(edges[-1]),
                                nwn + 1))
    else:
        wn = np.linspace(0.0, 3260.0, nwn + 1)
    wn_mid = 0.5 * (wn[1:] + wn[:-1])
    bin_gpt = np.full(nwn, -1)
    for b in range(nband):
        bins = np.nonzero((wn_mid >= edges[b]) & (wn_mid < edges[b + 1]))[0]
        gpts = np.arange(gpt_start[b], gpt_start[b + 1])
        bin_gpt[bins] = rng.choice(gpts, bins.size)
        bin_gpt[bins[:gpts.size]] = gpts
    gpoint_fraction = np.zeros((ngpt, nwn))
    gpoint_fraction[bin_gpt[bin_gpt >= 0], np.nonzero(bin_gpt >= 0)[0]] = 1.0

    split = np.concatenate([rng.dirichlet(np.full(n, 2.0))
                            for n in gpt_per_band])

    gases = (("composite", "h2o", "o3", "co2", "ch4", "n2o")
             + (() if shortwave else ("cfc11", "cfc12")))
    tau_range = _TAU_RANGE["sw" if shortwave else "lw"]

    def table(gas):
        """(T, p, g) molar absorption coefficients [m2 mol-1]."""
        lo, hi = np.log10(tau_range[gas])
        tau = 10.0 ** rng.uniform(lo, hi, ngpt)
        for b in range(nband):
            s = slice(gpt_start[b], gpt_start[b + 1])
            tau[s] = np.sort(tau[s])
        a = rng.uniform(0.5, 1.0, ngpt)
        b = rng.uniform(-1.0, 1.0, ngpt)
        k_ref = tau * (1.0 + a) / _COLUMN_MOLES[gas]
        p_fac = (pressure[:, None] / _P_MAX) ** a[None, :]           # (p, g)
        t_fac = np.exp(b[None, None, :] * (temperature - t_mid[None, :])
                       [:, :, None] / 100.0)                        # (T, p, g)
        return k_ref * p_fac[None] * t_fac

    f = netcdf_file(path, "w", version=1)
    try:
        f.createDimension("g_point", ngpt)
        f.createDimension("band", nband)
        f.createDimension("pressure", N_PRESSURE)
        f.createDimension("temperature", N_TEMPERATURE)
        f.createDimension("wavenumber", nwn)
        f.createDimension("composite_gas", len(_COMPOSITE_MF))

        def var(name, dims, data, typecode="d", units=None):
            v = f.createVariable(name, typecode, dims)
            v[...] = data
            if units is not None:
                v.units = units

        var("pressure", ("pressure",), pressure, units="Pa")
        var("temperature", ("temperature", "pressure"), temperature,
            units="K")
        var("wavenumber1_band", ("band",), edges[:-1], units="cm-1")
        var("wavenumber2_band", ("band",), edges[1:], units="cm-1")
        var("band_number", ("g_point",), band_number, typecode="h")
        var("gpoint_fraction", ("g_point", "wavenumber"), gpoint_fraction,
            typecode="f")
        var("n_gases", (), len(gases) - 1, typecode="h")
        var("composite_mole_fraction", ("composite_gas", "pressure"),
            np.repeat(np.asarray(_COMPOSITE_MF)[:, None], N_PRESSURE, 1))

        for gas in gases:
            if gas == "h2o":
                f.createDimension("h2o_mole_fraction", N_H2O_MF)
                var("h2o_mole_fraction", ("h2o_mole_fraction",),
                    mole_fraction, units="1")
                self_cont = 1.0 + mole_fraction / _H2O_SELF_MF
                coeff = self_cont[:, None, None, None] * table(gas)[None]
                var("h2o_molar_absorption_coeff",
                    ("h2o_mole_fraction", "temperature", "pressure",
                     "g_point"), coeff, typecode="f", units="m2 mol-1")
                continue
            code = (constants.CONC_NONE if gas == "composite" else
                    constants.CONC_RELATIVE_LINEAR if gas in _REFERENCE_MF
                    else constants.CONC_LINEAR)
            var(f"{gas}_conc_dependence_code", (), code, typecode="h")
            if gas in _REFERENCE_MF:
                var(f"{gas}_reference_mole_fraction", (),
                    _REFERENCE_MF[gas], units="1")
            var(f"{gas}_molar_absorption_coeff",
                ("temperature", "pressure", "g_point"), table(gas),
                typecode="f", units="m2 mol-1")

        if shortwave:
            sun = _band_integrated_planck(edges, np.array([5778.0]))[0]
            solar = sun[band_number] * split
            solar *= TOTAL_SOLAR_IRRADIANCE / solar.sum()
            var("solar_irradiance", ("g_point",), solar, units="W m-2")
            bin_sun = _planck_flux(wn_mid, np.array([5778.0]))[0] * np.diff(wn)
            k_ray = 2.7e-7 * (wn_mid / 18182.0) ** 4
            w = gpoint_fraction * bin_sun[None, :]
            var("rayleigh_molar_scattering_coeff", ("g_point",),
                (w @ k_ray) / w.sum(1), units="m2 mol-1")
        else:
            f.createDimension("temperature_planck", N_PLANCK)
            t_planck = np.linspace(120.0, 350.0, N_PLANCK)
            var("temperature_planck", ("temperature_planck",), t_planck,
                units="K")
            planck = _band_integrated_planck(edges, t_planck)
            var("planck_function", ("temperature_planck", "g_point"),
                planck[:, band_number] * split[None, :], typecode="f",
                units="W m-2")

        f.constituent_id = " ".join(gases)
        f.composite_constituent_id = _COMPOSITE
        f.title = f"Synthetic ecCKD-1.2-shaped ckd definition ({kind})"
        f.history = (f"written by ecckd_tpu.io.synthetic.write_synthetic_ckd"
                     f"(kind={kind!r}, seed={seed}); invented tables")
    finally:
        f.close()


def synthetic_ckd_files(directory: str = DEFAULT_CKD_DIR,
                        seed: int = 0) -> Dict[str, str]:
    """Paths of the three seeded ckd files in ``directory``, keyed by kind;
    files that do not exist yet are written (atomically, so concurrent
    callers never read a partial file)."""
    os.makedirs(directory, exist_ok=True)
    paths = {}
    for kind in CKD_KINDS:
        path = os.path.join(directory, f"synthetic_{kind}_seed{seed}.nc")
        if not os.path.exists(path):
            tmp = f"{path}.{os.getpid()}.tmp"
            write_synthetic_ckd(tmp, kind, seed)
            os.replace(tmp, path)
        paths[kind] = path
    return paths


def example_flux_batch(ncol: int, nlay: int, dtype):
    """RFMIP-shaped in-memory column batch for benchmarks and dry runs.

    Deterministic per-column jitter keeps columns heterogeneous, so a
    batch never hides a per-column indexing bug behind identical columns.
    """
    from ecckd_tpu.gases import GasConcs
    base = np.exp(np.linspace(np.log(2.0), np.log(101300.0), nlay + 1))
    rng = np.random.default_rng(0)
    jitter = 1.0 + 0.03 * rng.standard_normal((ncol, 1))
    plev = (base[None, :] * jitter).astype(dtype)
    logp = np.log(0.5 * (plev[:, 1:] + plev[:, :-1]))
    tlay = (288.0 - 55.0 * np.exp(-((logp - np.log(1.5e4)) ** 2) / 4.0)
            ).astype(dtype)
    tlev = (288.0 - 55.0 * np.exp(-((np.log(plev) - np.log(1.5e4)) ** 2)
                                  / 4.0)).astype(dtype)
    tsfc = np.full(ncol, 294.0, dtype)
    emis = np.full(ncol, 0.98, dtype)
    alb = np.full(ncol, 0.1, dtype)
    tsi = np.full(ncol, 1361.0, dtype)
    sza = np.linspace(10.0, 120.0, ncol).astype(dtype)
    h2o = (0.02 * np.exp(-(np.log(1.05e5 / np.maximum(plev[:, 1:], 1e-3))
                           / 1.1)) + 2e-6).astype(dtype)
    o3 = np.full((ncol, nlay), 3e-7, dtype)
    concs = GasConcs.create([
        ("co2", np.full(ncol, 397.5e-6, dtype)),
        ("ch4", np.full(ncol, 1831e-9, dtype)),
        ("n2o", np.full(ncol, 327e-9, dtype)),
        ("o2", np.full(ncol, 0.2095, dtype)),
        ("cfc11", np.full(ncol, 233e-12, dtype)),
        ("cfc12", np.full(ncol, 520e-12, dtype)),
        ("h2o", h2o), ("o3", o3)])
    return dict(plev=plev, tlay=tlay, tlev=tlev, tsfc=tsfc, emis=emis,
                alb=alb, tsi=tsi, sza=sza, concs=concs)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ecckd_tpu.io.synthetic")
    sub = p.add_subparsers(dest="command", required=True)
    r = sub.add_parser("rfmip", help="RFMIP-format atmosphere file")
    r.add_argument("output")
    r.add_argument("--nsite", type=int, default=100)
    r.add_argument("--nlay", type=int, default=60)
    r.add_argument("--nexp", type=int, default=18)
    r.add_argument("--seed", type=int, default=0)
    c = sub.add_parser("ckd", help="ckd-definition file")
    c.add_argument("output")
    c.add_argument("--kind", required=True, choices=CKD_KINDS)
    c.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if args.command == "rfmip":
        write_synthetic_rfmip(args.output, nsite=args.nsite, nlay=args.nlay,
                              nexp=args.nexp, seed=args.seed)
        print(f"wrote {args.output}: {args.nsite} sites x {args.nlay} "
              f"layers x {args.nexp} experiments")
    else:
        write_synthetic_ckd(args.output, args.kind, args.seed)
        print(f"wrote {args.output}: {args.kind} ckd definition, "
              f"seed {args.seed}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
