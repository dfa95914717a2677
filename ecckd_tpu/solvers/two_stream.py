"""Two-stream layer reflectance/transmittance (shortwave).

Meador & Weaver (1980) two-stream solutions with Zdunkowski PIFM coupling
coefficients — the standard formulation used by the external ``rte_sw``
solver whose behavior the reference depends on (SURVEY.md section 2.3).
Computes, per (column, layer, g-point):

  Rdif, Tdif   : reflectance/transmittance for diffuse incidence
  Rdir, Tdir   : reflectance / *diffuse* transmittance for direct incidence
  Tnoscat      : direct-beam transmittance exp(-tau/mu0)

All expressions are elementwise; the layer-coupling recurrences
live in solvers/sw.py.  Energy-safety clamps keep Rdir + Tdir + Tnoscat <= 1
so single-precision rounding cannot create energy.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class TwoStream(NamedTuple):
    r_dif: jax.Array
    t_dif: jax.Array
    r_dir: jax.Array
    t_dir: jax.Array
    t_noscat: jax.Array


def two_stream(tau: jax.Array, ssa: jax.Array, g: jax.Array,
               mu0: jax.Array) -> TwoStream:
    """Args: tau/ssa/g (ncol, nlay, ngpt); mu0 (ncol,) cosine zenith angle."""
    dtype = tau.dtype
    eps = jnp.asarray(jnp.finfo(dtype).eps, dtype)
    mu0b = mu0[:, None, None]

    # Zdunkowski practical-improved-flux-method coupling coefficients.
    gamma1 = (8.0 - ssa * (5.0 + 3.0 * g)) * 0.25
    gamma2 = 3.0 * (ssa * (1.0 - g)) * 0.25
    gamma3 = (2.0 - 3.0 * mu0b * g) * 0.25
    gamma4 = 1.0 - gamma3
    alpha1 = gamma1 * gamma4 + gamma2 * gamma3
    alpha2 = gamma1 * gamma3 + gamma2 * gamma4

    k = jnp.sqrt(jnp.maximum((gamma1 - gamma2) * (gamma1 + gamma2), 1e-12))
    # In the conservative limit (ssa -> 1, k*tau -> 0) the classical forms
    # difference O(1) exponentials, losing ~eps/(k*tau) relative accuracy —
    # a >1% broadband energy error at f32.  Everything below is therefore
    # built from the *complements* (computed cancellation-free via expm1):
    #   em1 = 1 - e,  m1 = 1 - e^2,  tm1 = 1 - t,
    #   q = 1 + e^2 - 2 e t = (1-e)^2 + 2 e (1-t)
    #   s = t (1 + e^2) - 2 e = (1-e)^2 - (1-t)(1 + e^2)
    # with e = exp(-k tau), t = exp(-tau/mu0).
    em1 = -jnp.expm1(-k * tau)
    m1 = em1 * (2.0 - em1)
    exp_mktau = 1.0 - em1
    exp_m2ktau = 1.0 - m1

    rt_term = 1.0 / (k * (1.0 + exp_m2ktau) + gamma1 * m1)
    r_dif = rt_term * gamma2 * m1
    t_dif = rt_term * 2.0 * k * exp_mktau

    tm1 = -jnp.expm1(-tau / mu0b)
    t_noscat = 1.0 - tm1

    # Direct-beam R / diffuse-T: exact regrouping of Meador-Weaver eqs
    # 14-15 (expand to verify):
    #   R = rt2 [alpha2 (m1 - k mu q) + k g3 (q - k mu m1)]
    #   T = -rt2 [alpha1 (t m1 + k mu s) + k g4 (s + k mu t m1)]
    # where every factor is O(of its own size) rather than a difference of
    # O(1) terms.  Resonance denominator 1 - (k mu0)^2 guarded against ~0.
    k_mu = k * mu0b
    k_g3 = k * gamma3
    k_g4 = k * gamma4
    denom = 1.0 - k_mu * k_mu
    denom = jnp.where(jnp.abs(denom) >= eps, denom, eps)
    rt2 = ssa * rt_term / denom
    q = em1 * em1 + 2.0 * exp_mktau * tm1
    s = em1 * em1 - tm1 * (1.0 + exp_m2ktau)
    r_dir = rt2 * (alpha2 * (m1 - k_mu * q) + k_g3 * (q - k_mu * m1))
    t_dir = -rt2 * (alpha1 * (t_noscat * m1 + k_mu * s)
                    + k_g4 * (s + k_mu * t_noscat * m1))

    # Energy safety: the direct beam is either reflected, transmitted
    # unscattered, or transmitted diffusely; the rest is absorbed.
    r_dir = jnp.clip(r_dir, 0.0, 1.0 - t_noscat)
    t_dir = jnp.clip(t_dir, 0.0, 1.0 - t_noscat - r_dir)

    return TwoStream(r_dif=r_dif, t_dif=t_dif, r_dir=r_dir, t_dir=t_dir,
                     t_noscat=t_noscat)
