"""Analytic correctness anchors — external triangulation of the numerics.

The goldens (test_golden.py) freeze the framework against itself and the
oracle (tests/oracle.py) is a transcription of the same reference reading,
so neither is fully independent.  These tests anchor the chain to physics
that is true regardless of implementation:

* the ckd files' Planck tables integrate over g-points to the
  Stefan-Boltzmann law sigma*T^4 (the seeded files split band-integrated
  Planck functions over their g-points, so pi * sum_g B_g(T) tracks
  sigma*T^4 up to the spectral truncation above 3250-3260 cm-1: <= 7.4e-4
  relative over the whole 120-350 K grid, <= 8e-5 at 288 K);
* an optically thick isothermal atmosphere is a blackbody cavity:
  flux_up == flux_dn == pi*B(T) at every interior level, for EVERY
  quadrature order (1-4 angles) — pins the Gauss secants/weights
  (solvers/quadrature.py) including the 2- and 4-angle sets no other
  test exercises;
* with scattering off, the SW direct beam obeys Beer's law exactly:
  flux_dn(level) = mu0 * F_toa * exp(-cumsum(tau)/mu0) at f64.

Reference spec: gas_optics_ecckd.f90:245-289 (Planck), SURVEY.md
section 2.3 (rte_lw / rte_sw behavioral contracts).
"""
import numpy as np
import pytest

from ecckd_tpu.models.loader import load_ckd_model
from ecckd_tpu.ops.planck import planck_source
from ecckd_tpu.optics import OpticalProps1scl, OpticalProps2str, SourceFuncLW
from ecckd_tpu.solvers.lw import rte_lw
from ecckd_tpu.solvers.sw import rte_sw

STEFAN_BOLTZMANN = 5.670374419e-8  # W m-2 K-4 (CODATA exact-sigma value)


@pytest.mark.parametrize("ckd", ["lw_fsck", "lw_rrtmgp"])
def test_planck_table_integrates_to_sigma_t4(ckd_paths, ckd):
    model = load_ckd_model(ckd_paths[ckd], dtype=np.float64)
    # Whole table range, incl. both endpoints and the 288 K climate anchor.
    T = np.concatenate([np.arange(120.0, 351.0, 5.0), [288.0, 350.0]])
    src = planck_source(T[None, :], model.planck_temperature,
                        model.planck_function)      # intensity B/pi per gpt
    total = np.pi * np.asarray(src).sum(-1)[0]      # flux pi*B [W m-2]
    rel = (total - STEFAN_BOLTZMANN * T ** 4) / (STEFAN_BOLTZMANN * T ** 4)
    assert np.abs(rel).max() < 1e-3, (
        f"worst {np.abs(rel).max():.2e} at T={T[np.abs(rel).argmax()]}")
    assert abs(rel[T == 288.0][0]) < 2e-4


def test_quadrature_tables_closed_form():
    """Transcription-independent anchor for EVERY secant and weight in
    solvers/quadrature.py.  In the saturated-cavity test below the
    radiance is isotropic, so only sum(w) is pinned there; this test
    pins the nodes themselves:

    * Orders 2-4 are Gauss quadratures for the first-moment measure
      int_0^1 f(mu) mu dmu (the flux integral 2*pi*int B(mu) mu dmu):
      sum_i w_i * mu_i**k == 1/(k+2) EXACTLY for k = 0..2n-1 — moment
      exactness through degree 2n-1 pins all n secants and n weights
      against closed-form truth (measured table precision ~3e-9).
    * Order 1 is NOT a Gauss node: it is the Elsasser diffusivity
      approximation, secant 1.66 and weight 0.5 exactly
      (ecckd_rfmip_lw.F90:40-44's single-angle physics index).
    """
    from ecckd_tpu.solvers.quadrature import GAUSS_SECANTS, GAUSS_WEIGHTS

    assert GAUSS_SECANTS[0] == (1.66,)
    assert GAUSS_WEIGHTS[0] == (0.5,)
    for n in (1, 2, 3):   # 2-, 3-, 4-angle sets
        secs = np.asarray(GAUSS_SECANTS[n], np.float64)
        ws = np.asarray(GAUSS_WEIGHTS[n], np.float64)
        mus = 1.0 / secs
        for k in range(2 * (n + 1)):
            moment = float((ws * mus ** k).sum())
            assert abs(moment - 1.0 / (k + 2)) < 1e-8, (
                f"{n + 1}-angle set violates moment {k}: {moment}")


@pytest.mark.parametrize("n_angles", [1, 2, 3, 4])
def test_lw_isothermal_blackbody_all_quadratures(ckd_paths, n_angles):
    """Optically thick isothermal cavity: up == dn == pi*B(T) at every
    interior level for every quadrature order.  The radiance here is
    isotropic, so this pins sum(w) = 0.5 per order (the node positions
    are pinned by test_quadrature_tables_closed_form above)."""
    model = load_ckd_model(ckd_paths["lw_fsck"], dtype=np.float64)
    ncol, nlay, T = 3, 24, 288.0
    ngpt = model.ngpt
    src = np.asarray(planck_source(
        np.full((ncol, nlay), T), model.planck_temperature,
        model.planck_function))
    lev_src = np.asarray(planck_source(
        np.full((ncol, nlay + 1), T), model.planck_temperature,
        model.planck_function))
    tau = np.full((ncol, nlay, ngpt), 12.0)  # each layer optically thick
    sources = SourceFuncLW(lay_source=src, lev_source_inc=lev_src[:, 1:],
                           lev_source_dec=lev_src[:, :-1],
                           sfc_source=lev_src[:, -1])
    emis = np.ones((ncol, ngpt))
    up, dn = rte_lw(OpticalProps1scl(tau=tau), sources, emis,
                    n_gauss_angles=n_angles)
    pi_b = np.pi * src[0, 0].sum()
    # Interior levels see a closed cavity from both sides; dn saturates
    # after ~2 thick layers (min secant 1.06 in the 4-angle set:
    # exp(-2*1.06*12) ~ 1e-11), up is saturated everywhere (emis = 1).
    up_i = np.asarray(up)[:, 1:-1]
    dn_i = np.asarray(dn)[:, 2:-1]
    np.testing.assert_allclose(up_i, pi_b, rtol=5e-9)
    np.testing.assert_allclose(dn_i, pi_b, rtol=5e-9)
    # Surface-up is exactly pi*B at every quadrature (emis = 1).
    np.testing.assert_allclose(np.asarray(up)[:, -1], pi_b, rtol=5e-9)


def test_sw_direct_beam_beer_lambert():
    """No scattering (ssa = 0), black surface: the downward flux IS the
    direct beam, mu0 * F * exp(-cumtau/mu0), exactly at f64; no upward
    flux anywhere."""
    rng = np.random.default_rng(7)
    ncol, nlay, ngpt = 4, 30, 5
    tau = 10.0 ** rng.uniform(-4, 0.5, (ncol, nlay, ngpt))
    mu0 = np.array([1.0, 0.8, 0.5, 0.05])
    toa = rng.uniform(5.0, 50.0, (ncol, ngpt))
    props = OpticalProps2str(tau=tau, ssa=np.zeros_like(tau),
                             g=np.zeros_like(tau))
    alb = np.zeros((ncol, ngpt))
    up, dn, dn_dir = rte_sw(props, mu0, toa, alb, alb)
    cum = np.concatenate([np.zeros((ncol, 1, ngpt)),
                          np.cumsum(tau, axis=1)], axis=1)
    expect = (mu0[:, None] * toa)[:, None, :] * np.exp(
        -cum / mu0[:, None, None])
    es = expect.sum(-1)
    # Exact wherever the beam is not astronomically attenuated (the scan's
    # product-of-exps vs exp-of-sum drift only matters below ~1e-9 of the
    # incident flux; measured 2.6e-15 above that).
    sig = es > 1e-9 * es.max()
    rel = np.abs(np.asarray(dn) - es) / es.max()
    rel_dir = np.abs(np.asarray(dn_dir) - es) / es.max()
    assert rel[sig].max() < 1e-12 and rel_dir[sig].max() < 1e-12
    np.testing.assert_allclose(np.asarray(up), 0.0, atol=1e-12)
