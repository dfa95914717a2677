"""Differentiability of the flux pipelines (framework capability test).

The XLA path is pure jnp, so the whole chain — ckd table interpolation,
Planck sources, solver recurrences (lax.scan), band expansion — is
differentiable with jax.grad/jacrev/jacfwd.  This is a framework
capability with no counterpart in the Fortran reference
(adjoints for retrievals, data assimilation, and ML coupling), so it
gets its own contract tests: every adjoint is validated against central
finite differences at f64.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from conftest import RFMIP_VMRS, make_atmosphere

from ecckd_tpu.gases import GasConcs
from ecckd_tpu.models.loader import load_ckd_model
from ecckd_tpu.pipeline import lw_fluxes, sw_fluxes

NCOL, NLAY = 2, 20


@pytest.fixture(scope="module")
def setup(ckd_paths):
    lw = load_ckd_model(ckd_paths["lw_fsck"])
    sw = load_ckd_model(ckd_paths["sw_wide"])
    atm = make_atmosphere(ncol=NCOL, nlay=NLAY, seed=1)
    return lw, sw, atm


def _concs(atm, h2o=None):
    return GasConcs.create(dict(
        h2o=atm["h2o"] if h2o is None else h2o, o3=atm["o3"],
        co2=RFMIP_VMRS["co2"], ch4=RFMIP_VMRS["ch4"],
        n2o=RFMIP_VMRS["n2o"], o2=RFMIP_VMRS["o2"]))


def _check_fd(f, x, eps, rtol, spots=((0, 10), (1, 3))):
    """Central-difference check of jax.grad(f) at a few entries."""
    g = jax.grad(f)(jnp.asarray(x))
    assert bool(jnp.isfinite(g).all()), "non-finite adjoint"
    for idx in spots:
        fd = (f(jnp.asarray(x).at[idx].add(eps))
              - f(jnp.asarray(x).at[idx].add(-eps))) / (2 * eps)
        assert abs(g[idx] - fd) <= rtol * max(abs(fd), 1e-12), (
            f"adjoint {g[idx]:.6e} vs fd {fd:.6e} at {idx}")
    return g


def test_lw_olr_adjoint_wrt_h2o(setup):
    lw, _, atm = setup

    def olr(h2o):
        f = lw_fluxes(lw, atm["plev"], atm["tlay"], atm["tlev"],
                      atm["tsfc"], np.full(NCOL, 0.98), _concs(atm, h2o))
        return jnp.sum(f.flux_up[:, 0])

    _check_fd(olr, atm["h2o"], eps=1e-9, rtol=1e-4)


def test_lw_flux_adjoint_wrt_temperature(setup):
    """Temperature feeds BOTH the table interpolation (pressure-origin
    temperature index) and the Planck sources; the adjoint must combine
    them correctly."""
    lw, _, atm = setup

    def sfc_dn(tlay):
        f = lw_fluxes(lw, atm["plev"], tlay, atm["tlev"], atm["tsfc"],
                      np.full(NCOL, 0.98), _concs(atm))
        return jnp.sum(f.flux_dn[:, -1])

    g = _check_fd(sfc_dn, atm["tlay"], eps=1e-4, rtol=1e-4)
    # Physics sign: warming a layer increases downward emission.
    assert float(g.sum()) > 0.0


def test_lw_surface_emissivity_adjoint(setup):
    lw, _, atm = setup

    def olr(emis):
        f = lw_fluxes(lw, atm["plev"], atm["tlay"], atm["tlev"],
                      atm["tsfc"], emis, _concs(atm))
        return jnp.sum(f.flux_up[:, 0])

    g = jax.grad(olr)(jnp.full(NCOL, 0.95))
    fd_f = lambda e: olr(jnp.full(NCOL, e))
    fd = (fd_f(0.95 + 1e-6) - fd_f(0.95 - 1e-6)) / 2e-6
    assert abs(float(g.sum()) - float(fd)) <= 1e-4 * abs(float(fd))


def test_sw_adjoints(setup):
    _, sw, atm = setup
    alb = np.full(NCOL, 0.2)
    tsi = np.full(NCOL, 1361.0)
    sza = np.array([30.0, 70.0])

    def up_toa(h2o):
        f = sw_fluxes(sw, atm["plev"], atm["tlay"], _concs(atm, h2o),
                      alb, tsi, sza)
        return jnp.sum(f.flux_up[:, 0])

    _check_fd(up_toa, atm["h2o"], eps=1e-9, rtol=1e-3)

    def up_toa_alb(a):
        f = sw_fluxes(sw, atm["plev"], atm["tlay"], _concs(atm), a, tsi,
                      sza)
        return jnp.sum(f.flux_up[:, 0])

    g = jax.grad(up_toa_alb)(jnp.asarray(alb))
    assert bool((g > 0).all()), "brighter surface must reflect more"


def test_jacobian_row_shape_and_jit(setup):
    """jacrev over the per-level flux profile (the retrieval-operator
    shape), under jit, on the sharded-capable pipeline."""
    lw, _, atm = setup

    @jax.jit
    def profile(h2o):
        f = lw_fluxes(lw, atm["plev"], atm["tlay"], atm["tlev"],
                      atm["tsfc"], np.full(NCOL, 0.98), _concs(atm, h2o))
        return f.flux_up[0]          # (nlev,) one column's profile

    J = jax.jacrev(profile)(jnp.asarray(atm["h2o"]))
    assert J.shape == (NLAY + 1, NCOL, NLAY)
    assert bool(jnp.isfinite(J).all())
    # Column 0's fluxes depend only on column 0's water vapor.
    assert float(jnp.abs(J[:, 1, :]).max()) == 0.0
