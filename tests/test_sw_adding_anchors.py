"""SW adding-chain analytic anchors (beyond Beer's law).

The goldens and the oracle both transcribe the same reading of the solver
spec, so they cannot catch a shared misreading.  These tests pin the
Mobius/adding recurrences in solvers/sw.py (up_step/dn_step, sw.py:70-113)
against mathematics that is independent of any transcription:

* the full interface-flux system solved by DENSE LINEAR ALGEBRA — the
  adding method is, by construction, an O(nlay) elimination of the block
  bidiagonal system relating interface diffuse fluxes via each layer's
  (Rdif, Tdif) and direct-beam sources; building that system explicitly
  from the same two_stream outputs and solving it with numpy must agree
  to f64 roundoff for arbitrary heterogeneous layers;
* the SEMIGROUP property of the two-stream solution operator — a
  homogeneous slab split into N sublayers must produce identical boundary
  fluxes (layer R/T are exact solutions of the constant-coefficient
  two-stream ODE, and adding composes solution operators exactly);
* the CONSERVATIVE closed forms — at ssa = 1 the diffuse reflectance and
  transmittance collapse to R = g1*tau / (1 + g1*tau), T = 1 / (1 + g1*tau)
  (Meador & Weaver 1980 eq. 24 with the PIFM gamma1 = gamma2); the code's
  k-floor (two_stream.py:47) perturbs these only at O((k*tau)^2) ~ 1e-12;
* a conservative slab over a perfectly reflecting surface is a closed,
  lossless cavity: the net flux vanishes at EVERY level (up == dn level by
  level, and both equal mu0*S0 at TOA).

Reference behavioral contract: SURVEY.md section 2.3 (external rte_sw,
call site rte-ecckd/example/rfmip-rad-irf/ecckd_rfmip_sw.F90:148-154).
"""
import numpy as np
import pytest

from ecckd_tpu.optics import OpticalProps2str
from ecckd_tpu.solvers.sw import rte_sw
from ecckd_tpu.solvers.two_stream import two_stream


def _dense_reference(tau, ssa, g, mu0, toa, alb_dir, alb_dif):
    """Solve the interface diffuse-flux system exactly with numpy.

    Unknowns per (col, gpt): D_j, U_j for levels j = 0..nlay, coupled by
      D_0 = 0
      D_{j+1} = Tdif_j D_j + Rdif_j U_{j+1} + Sdn_j          (layer j)
      U_j     = Rdif_j D_j + Tdif_j U_{j+1} + Sup_j          (layer j)
      U_nlay  = alb_dif D_nlay + alb_dir * Fdir(sfc)
    with Sup_j = Rdir_j * Fdir(top of j), Sdn_j = Tdir_j * Fdir(top of j).
    """
    ncol, nlay, ngpt = tau.shape
    ts = two_stream(tau, ssa, g, mu0)
    r_dif, t_dif = np.asarray(ts.r_dif), np.asarray(ts.t_dif)
    r_dir, t_dir = np.asarray(ts.r_dir), np.asarray(ts.t_dir)
    t_noscat = np.asarray(ts.t_noscat)

    # Direct beam levels 0..nlay.
    fdir = np.empty((ncol, nlay + 1, ngpt))
    fdir[:, 0] = mu0[:, None] * toa
    for i in range(nlay):
        fdir[:, i + 1] = fdir[:, i] * t_noscat[:, i]

    nlev = nlay + 1
    n = 2 * nlev  # unknowns [D_0..D_nlay, U_0..U_nlay]
    D = np.zeros((ncol, nlev, ngpt))
    U = np.zeros((ncol, nlev, ngpt))
    for c in range(ncol):
        for q in range(ngpt):
            A = np.zeros((n, n))
            b = np.zeros(n)
            A[0, 0] = 1.0                       # D_0 = 0
            for j in range(nlay):
                r, t = r_dif[c, j, q], t_dif[c, j, q]
                sup = r_dir[c, j, q] * fdir[c, j, q]
                sdn = t_dir[c, j, q] * fdir[c, j, q]
                row = 1 + j                      # D_{j+1} equation
                A[row, j + 1] = 1.0
                A[row, j] = -t
                A[row, nlev + j + 1] = -r
                b[row] = sdn
                row = nlev + j                   # U_j equation
                A[row, nlev + j] = 1.0
                A[row, j] = -r
                A[row, nlev + j + 1] = -t
                b[row] = sup
            row = 2 * nlev - 1                   # surface closure
            A[row, nlev + nlay] = 1.0
            A[row, nlay] = -alb_dif[c, q]
            b[row] = alb_dir[c, q] * fdir[c, nlay, q]
            x = np.linalg.solve(A, b)
            D[c, :, q] = x[:nlev]
            U[c, :, q] = x[nlev:]
    return U.sum(-1), D.sum(-1) + fdir.sum(-1)


def test_adding_vs_dense_linear_solve():
    """Arbitrary heterogeneous layers: the scan-based adding chain must
    reproduce the dense solve of the interface-flux system to f64
    roundoff."""
    rng = np.random.default_rng(11)
    ncol, nlay, ngpt = 3, 22, 4
    tau = 10.0 ** rng.uniform(-3, 0.7, (ncol, nlay, ngpt))
    ssa = rng.uniform(0.05, 0.999999, (ncol, nlay, ngpt))
    g = rng.uniform(0.0, 0.85, (ncol, nlay, ngpt))
    mu0 = np.array([1.0, 0.6, 0.2])
    toa = rng.uniform(5.0, 40.0, (ncol, ngpt))
    alb_dir = rng.uniform(0.0, 0.9, (ncol, ngpt))
    alb_dif = rng.uniform(0.0, 0.9, (ncol, ngpt))

    up, dn, _ = rte_sw(OpticalProps2str(tau=tau, ssa=ssa, g=g), mu0, toa,
                       alb_dir, alb_dif)
    up_ref, dn_ref = _dense_reference(tau, ssa, g, mu0, toa, alb_dir,
                                      alb_dif)
    scale = dn_ref.max()
    assert np.abs(np.asarray(up) - up_ref).max() / scale < 1e-12
    assert np.abs(np.asarray(dn) - dn_ref).max() / scale < 1e-12


@pytest.mark.parametrize("nsub", [2, 8])
def test_homogeneous_sublayer_splitting(nsub):
    """Semigroup identity: a homogeneous slab solved as one layer equals
    the same slab split into nsub sublayers, at the shared boundary
    levels, to f64 roundoff (the two-layer adding identity is nsub=2)."""
    tau_tot, ssa_v, g_v = 2.4, 0.93, 0.55
    ncol, ngpt = 2, 3
    mu0 = np.array([0.82, 0.37])
    toa = np.array([[20.0, 31.0, 9.0], [17.0, 24.0, 13.0]])
    alb = np.full((ncol, ngpt), 0.3)

    def solve(nlay):
        shp = (ncol, nlay, ngpt)
        props = OpticalProps2str(tau=np.full(shp, tau_tot / nlay),
                                 ssa=np.full(shp, ssa_v),
                                 g=np.full(shp, g_v))
        return [np.asarray(x) for x in rte_sw(props, mu0, toa, alb, alb)]

    up1, dn1, dir1 = solve(1)
    upn, dnn, dirn = solve(nsub)
    scale = dn1.max()
    for a, b in ((up1[:, 0], upn[:, 0]), (up1[:, -1], upn[:, -1]),
                 (dn1[:, -1], dnn[:, -1]), (dir1[:, -1], dirn[:, -1])):
        assert np.abs(a - b).max() / scale < 1e-12


def test_conservative_slab_diffuse_closed_form():
    """ssa = 1: Rdif = g1*tau/(1 + g1*tau), Tdif = 1/(1 + g1*tau) in
    closed form (PIFM gamma1 == gamma2 at ssa = 1, so k -> 0 and the
    general solution collapses).  The code's k-floor of 1e-6 enters only
    at O((k*tau)^2); tolerance 1e-9 leaves two orders of margin."""
    tau = np.linspace(0.05, 4.0, 12).reshape(1, 12, 1)
    for g_v in (0.0, 0.4, 0.85):
        g = np.full_like(tau, g_v)
        ts = two_stream(tau, np.ones_like(tau), g, np.array([0.5]))
        gamma1 = (8.0 - (5.0 + 3.0 * g_v)) * 0.25
        r_exp = gamma1 * tau / (1.0 + gamma1 * tau)
        t_exp = 1.0 / (1.0 + gamma1 * tau)
        assert np.abs(np.asarray(ts.r_dif) - r_exp).max() < 1e-9
        assert np.abs(np.asarray(ts.t_dif) - t_exp).max() < 1e-9


def test_conservative_slab_over_reflector_closed_cavity():
    """Conservative scattering over a perfectly reflecting surface: no
    energy is absorbed anywhere, so the net flux vanishes at EVERY level
    (up == dn level by level) and both equal the incident mu0*S0 at TOA.
    Pins the whole direct+diffuse adding chain, including the surface
    closure, against exact energy conservation."""
    rng = np.random.default_rng(23)
    ncol, nlay, ngpt = 3, 25, 4
    tau = 10.0 ** rng.uniform(-2, 0.5, (ncol, nlay, ngpt))
    g = rng.uniform(0.0, 0.8, (ncol, nlay, ngpt))
    mu0 = np.array([0.95, 0.55, 0.15])
    toa = rng.uniform(10.0, 30.0, (ncol, ngpt))
    alb = np.ones((ncol, ngpt))
    up, dn, _ = rte_sw(OpticalProps2str(tau=tau, ssa=np.ones_like(tau),
                                        g=g), mu0, toa, alb, alb)
    up, dn = np.asarray(up), np.asarray(dn)
    incident = (mu0[:, None] * toa).sum(-1)
    scale = incident.max()
    # Tolerance 1e-10: the k-floor's O((k*tau)^2) pseudo-absorption
    # accumulates over 25 layers (measured 1.4e-11 worst).
    assert np.abs(up - dn).max() / scale < 1e-10
    assert np.abs(up[:, 0] - incident).max() / scale < 1e-10
