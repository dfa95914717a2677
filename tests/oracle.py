"""Pure-NumPy float64 oracle of the ecCKD numerics.

An independent, deliberately *scalar-loop* transcription of the equations
documented in SURVEY.md section 2.2 (from rte-ecckd/src/
gas_optics_ecckd.f90) and of the RTE solver physics (SURVEY.md section 2.3).
Written in plain per-point style so that vectorization/gather/scan bugs in the
JAX implementation cannot be mirrored here.
"""
from __future__ import annotations

import numpy as np

GRAVITY = 9.80665
DRY_AIR_MOLAR_MASS = 28.970
PI = 3.14159265359
MOLES_PER_PA = 1.0 / (GRAVITY * 0.001 * DRY_AIR_MOLAR_MASS)


# --------------------------------------------------------------------------
# Gas optics
# --------------------------------------------------------------------------
def optical_depth_one_gas(log_pressure, temperature_grid, coeff, code,
                          plev, tlay, vmr, reference_mf=0.0, mf_grid=None,
                          logarithmic=False):
    """Optical depth of a single gas, (ncol, nlay, ngpt).

    coeff: (n_mf_or_1, np, nT, ngpt); code: 0 none / 1 linear /
    2 look-up-table / 3 relative-linear.  ``logarithmic``: the reference's
    alternate branch — interpolate log(coeff), exponentiate
    (gas_optics_ecckd.f90:180-229).
    """
    if logarithmic:
        # log(0) -> -inf -> exp -> 0 is the reference's own behavior for
        # zero table entries; silence the benign numpy warning.
        with np.errstate(divide="ignore"):
            coeff = np.log(coeff)
    ncol, nlay = tlay.shape
    ngpt = coeff.shape[-1]
    n_p = log_pressure.shape[0]
    n_t = temperature_grid.shape[1]
    d_log_p = log_pressure[1] - log_pressure[0]
    dt = temperature_grid[0, 1] - temperature_grid[0, 0]
    tau = np.zeros((ncol, nlay, ngpt))
    for i in range(ncol):
        for j in range(nlay):
            log_p = np.log(0.5 * (plev[i, j + 1] + plev[i, j]))
            pidx = (log_p - log_pressure[0]) / d_log_p
            pidx = max(0.0, min(pidx, n_p - 1.0001))
            ip0 = int(np.floor(pidx))
            pw1 = pidx - ip0
            pw0 = 1.0 - pw1

            t0 = pw0 * temperature_grid[ip0, 0] + \
                pw1 * temperature_grid[ip0 + 1, 0]
            tidx = (tlay[i, j] - t0) / dt
            tidx = max(0.0, min(tidx, n_t - 1.0001))
            it0 = int(np.floor(tidx))
            tw1 = tidx - it0
            tw0 = 1.0 - tw1

            simple_weight = MOLES_PER_PA * (plev[i, j + 1] - plev[i, j])
            if code == 3:
                weight = simple_weight * (vmr[i, j] - reference_mf)
            else:
                weight = simple_weight * vmr[i, j]

            if code == 2:
                log_vmr = np.log(max(vmr[i, j], mf_grid[0]))
                d_log_vmr = np.log(mf_grid[1] / mf_grid[0])
                vidx = (log_vmr - np.log(mf_grid[0])) / d_log_vmr
                vidx = max(0.0, min(vidx, len(mf_grid) - 1.001))
                iv0 = int(np.floor(vidx))
                vw1 = vidx - iv0
                vw0 = 1.0 - vw1
                val = vw0 * (tw0 * (pw0 * coeff[iv0, ip0, it0, :]
                                    + pw1 * coeff[iv0, ip0 + 1, it0, :])
                             + tw1 * (pw0 * coeff[iv0, ip0, it0 + 1, :]
                                      + pw1 * coeff[iv0, ip0 + 1, it0 + 1, :])) \
                    + vw1 * (tw0 * (pw0 * coeff[iv0 + 1, ip0, it0, :]
                                    + pw1 * coeff[iv0 + 1, ip0 + 1, it0, :])
                             + tw1 * (pw0 * coeff[iv0 + 1, ip0, it0 + 1, :]
                                      + pw1 * coeff[iv0 + 1, ip0 + 1, it0 + 1, :]))
                if logarithmic:
                    val = np.exp(val)
                tau[i, j, :] = weight * val
            else:
                val = (tw0 * (pw0 * coeff[0, ip0, it0, :]
                              + pw1 * coeff[0, ip0 + 1, it0, :])
                       + tw1 * (pw0 * coeff[0, ip0, it0 + 1, :]
                                + pw1 * coeff[0, ip0 + 1, it0 + 1, :]))
                if logarithmic:
                    val = np.exp(val)
                if code == 0:
                    tau[i, j, :] = simple_weight * val
                else:
                    tau[i, j, :] = weight * val
            tau[i, j, :] = np.maximum(tau[i, j, :], 0.0)
    return tau


def planck(level_temperature, planck_temperature, planck_function):
    ncol, nlev = level_temperature.shape
    n = planck_temperature.shape[0]
    ngpt = planck_function.shape[1]
    dt = planck_temperature[1] - planck_temperature[0]
    t0 = planck_temperature[0]
    out = np.zeros((ncol, nlev, ngpt))
    for i in range(ncol):
        for j in range(nlev):
            idx = (level_temperature[i, j] - t0) / dt
            if idx >= 0:
                it0 = min(int(np.floor(idx)), n - 2)
                w1 = idx - it0
                out[i, j, :] = (1.0 - w1) * planck_function[it0, :] \
                    + w1 * planck_function[it0 + 1, :]
            else:
                out[i, j, :] = (level_temperature[i, j] / t0) \
                    * planck_function[0, :]
    return out / PI


def rayleigh_tau(plev, rayleigh_coeff):
    moles = (plev[:, 1:] - plev[:, :-1]) * MOLES_PER_PA
    return moles[..., None] * rayleigh_coeff


def total_optical_depth(model_np, requested, plev, tlay):
    """Accumulate gas optical depths with reference semantics.

    model_np: dict with keys 'log_pressure', 'temperature_grid' and per-gas
      dicts under 'gases' (ordered): name -> dict(code, coeff (nmf,np,nT,ngpt),
      composite_only, reference_mf, mf_grid).
    requested: ordered list of (name, vmr (ncol, nlay)).
    """
    ncol, nlay = tlay.shape
    first = next(iter(model_np["gases"].values()))
    ngpt = first["coeff"].shape[-1]
    tau = np.zeros((ncol, nlay, ngpt))
    first_calc = True
    for name, vmr in requested:
        if name not in model_np["gases"]:
            continue
        gasd = model_np["gases"][name]
        if gasd["composite_only"] and not first_calc:
            continue
        tau += optical_depth_one_gas(
            model_np["log_pressure"], model_np["temperature_grid"],
            gasd["coeff"], gasd["code"], plev, tlay, vmr,
            reference_mf=gasd.get("reference_mf", 0.0),
            mf_grid=gasd.get("mf_grid"))
        if gasd["composite_only"]:
            first_calc = False
    return tau


# --------------------------------------------------------------------------
# Longwave solver (per-gpt scalar loops)
# --------------------------------------------------------------------------
GAUSS_SECANTS = {1: [1.66], 2: [1.18350343, 2.81649655],
                 3: [1.09719858, 1.69338507, 4.70941630]}
GAUSS_WEIGHTS = {1: [0.5], 2: [0.3180413817, 0.1819586183],
                 3: [0.2009319137, 0.2292411064, 0.0698269799]}


def lw_fluxes(tau, lay_source, lev_source_inc, lev_source_dec, sfc_source,
              sfc_emis_gpt, n_angles=1):
    """Broadband LW fluxes, top at index 0. All inputs per-gpt."""
    ncol, nlay, ngpt = tau.shape
    flux_up = np.zeros((ncol, nlay + 1))
    flux_dn = np.zeros((ncol, nlay + 1))
    eps = np.finfo(np.float64).eps
    for d, w in zip(GAUSS_SECANTS[n_angles], GAUSS_WEIGHTS[n_angles]):
        for i in range(ncol):
            for k in range(ngpt):
                ts = tau[i, :, k] * d
                trans = np.exp(-ts)
                rad_dn = np.zeros(nlay + 1)
                rad_up = np.zeros(nlay + 1)
                for j in range(nlay):
                    omt = -np.expm1(-ts[j])
                    if ts[j] > np.sqrt(eps):
                        fact = omt / ts[j] - trans[j]
                    else:
                        fact = ts[j] * (0.5 - ts[j] / 3.0)
                    s_dn = omt * lev_source_inc[i, j, k] + \
                        2.0 * fact * (lay_source[i, j, k]
                                      - lev_source_inc[i, j, k])
                    rad_dn[j + 1] = trans[j] * rad_dn[j] + s_dn
                rad_up[nlay] = sfc_emis_gpt[i, k] * sfc_source[i, k] + \
                    (1.0 - sfc_emis_gpt[i, k]) * rad_dn[nlay]
                for j in range(nlay - 1, -1, -1):
                    omt = -np.expm1(-ts[j])
                    if ts[j] > np.sqrt(eps):
                        fact = omt / ts[j] - trans[j]
                    else:
                        fact = ts[j] * (0.5 - ts[j] / 3.0)
                    s_up = omt * lev_source_dec[i, j, k] + \
                        2.0 * fact * (lay_source[i, j, k]
                                      - lev_source_dec[i, j, k])
                    rad_up[j] = trans[j] * rad_up[j + 1] + s_up
                flux_dn[i, :] += 2.0 * np.pi * w * rad_dn
                flux_up[i, :] += 2.0 * np.pi * w * rad_up
    return flux_up, flux_dn


# --------------------------------------------------------------------------
# Shortwave solver (per-gpt scalar loops)
# --------------------------------------------------------------------------
def sw_two_stream_scalar(tau, ssa, g, mu0):
    eps = np.finfo(np.float64).eps
    gamma1 = (8.0 - ssa * (5.0 + 3.0 * g)) * 0.25
    gamma2 = 3.0 * (ssa * (1.0 - g)) * 0.25
    gamma3 = (2.0 - 3.0 * mu0 * g) * 0.25
    gamma4 = 1.0 - gamma3
    alpha1 = gamma1 * gamma4 + gamma2 * gamma3
    alpha2 = gamma1 * gamma3 + gamma2 * gamma4
    k = np.sqrt(max((gamma1 - gamma2) * (gamma1 + gamma2), 1e-12))
    e1 = np.exp(-k * tau)
    e2 = e1 * e1
    rt = 1.0 / (k * (1.0 + e2) + gamma1 * (1.0 - e2))
    r_dif = rt * gamma2 * (1.0 - e2)
    t_dif = rt * 2.0 * k * e1
    t_noscat = np.exp(-tau / mu0)
    k_mu = k * mu0
    denom = 1.0 - k_mu * k_mu
    if abs(denom) < eps:
        denom = eps
    rt2 = ssa * rt / denom
    r_dir = rt2 * ((1.0 - k_mu) * (alpha2 + k * gamma3)
                   - (1.0 + k_mu) * (alpha2 - k * gamma3) * e2
                   - 2.0 * (k * gamma3 - alpha2 * k_mu) * e1 * t_noscat)
    t_dir = -rt2 * ((1.0 + k_mu) * (alpha1 + k * gamma4) * t_noscat
                    - (1.0 - k_mu) * (alpha1 - k * gamma4) * e2 * t_noscat
                    - 2.0 * (k * gamma4 + alpha1 * k_mu) * e1)
    r_dir = min(max(r_dir, 0.0), 1.0 - t_noscat)
    t_dir = min(max(t_dir, 0.0), 1.0 - t_noscat - r_dir)
    return r_dif, t_dif, r_dir, t_dir, t_noscat


def sw_fluxes(tau, ssa, g, mu0, toa_flux, alb_dir_gpt, alb_dif_gpt):
    """Broadband SW fluxes via per-gpt adding, top at index 0."""
    ncol, nlay, ngpt = tau.shape
    flux_up = np.zeros((ncol, nlay + 1))
    flux_dn = np.zeros((ncol, nlay + 1))
    flux_dir_bb = np.zeros((ncol, nlay + 1))
    for i in range(ncol):
        for kk in range(ngpt):
            rdif = np.zeros(nlay)
            tdif = np.zeros(nlay)
            rdir = np.zeros(nlay)
            tdir = np.zeros(nlay)
            tnos = np.zeros(nlay)
            for j in range(nlay):
                rdif[j], tdif[j], rdir[j], tdir[j], tnos[j] = \
                    sw_two_stream_scalar(tau[i, j, kk], ssa[i, j, kk],
                                         g[i, j, kk], mu0[i])
            flux_dir = np.zeros(nlay + 1)
            flux_dir[0] = mu0[i] * toa_flux[i, kk]
            for j in range(nlay):
                flux_dir[j + 1] = tnos[j] * flux_dir[j]
            src_up = rdir * flux_dir[:-1]
            src_dn = tdir * flux_dir[:-1]
            src_sfc = alb_dir_gpt[i, kk] * flux_dir[nlay]

            albedo = np.zeros(nlay + 1)
            src = np.zeros(nlay + 1)
            albedo[nlay] = alb_dif_gpt[i, kk]
            src[nlay] = src_sfc
            denom = np.zeros(nlay)
            for j in range(nlay - 1, -1, -1):
                denom[j] = 1.0 / (1.0 - rdif[j] * albedo[j + 1])
                albedo[j] = rdif[j] + tdif[j] ** 2 * albedo[j + 1] * denom[j]
                src[j] = src_up[j] + tdif[j] * denom[j] * \
                    (src[j + 1] + albedo[j + 1] * src_dn[j])
            fdn = np.zeros(nlay + 1)  # diffuse
            fup = np.zeros(nlay + 1)
            fup[0] = fdn[0] * albedo[0] + src[0]
            for j in range(1, nlay + 1):
                fdn[j] = (tdif[j - 1] * fdn[j - 1]
                          + rdif[j - 1] * src[j]
                          + src_dn[j - 1]) * denom[j - 1]
                fup[j] = fdn[j] * albedo[j] + src[j]
            flux_up[i, :] += fup
            flux_dn[i, :] += fdn + flux_dir
            flux_dir_bb[i, :] += flux_dir
    return flux_up, flux_dn, flux_dir_bb
