"""Two-stream layer properties at g = 0 (the only asymmetry the ecCKD
pipeline produces, gas_optics_ecckd.f90:461) at single precision, on the
edge cases the cancellation-free forms of solvers/two_stream.py must not
break: zero-thickness padded layers (tau == 0) and the conservative limit
(ssa -> 1).
"""
import numpy as np

import jax.numpy as jnp

from ecckd_tpu.solvers.two_stream import two_stream


def _g0(tau, ssa, mu0):
    """two_stream on (n, 1, 1) layers with g = 0 and one mu0 per layer."""
    col = lambda x: jnp.asarray(x, jnp.float32)[:, None, None]
    ts = two_stream(col(tau), col(ssa), jnp.zeros_like(col(tau)),
                    jnp.asarray(mu0, jnp.float32))
    return tuple(np.asarray(x).ravel() for x in ts)


def test_two_stream_g0_zero_thickness_exact():
    """Padded rows (dp == 0 => tau == 0) must give the exact transparent
    layer: T_dif ~ 1, everything else ~ 0, T_noscat == 1."""
    mu0 = np.asarray([0.1, 0.5, 0.9, 1.0], np.float32)
    z = np.zeros(4, np.float32)
    r_dif, t_dif, r_dir, t_dir, t = _g0(z, z, mu0)
    np.testing.assert_array_equal(t, 1.0)
    np.testing.assert_allclose(t_dif, 1.0, atol=1e-6)
    np.testing.assert_allclose(r_dif, 0.0, atol=1e-7)
    np.testing.assert_array_equal(r_dir, 0.0)
    np.testing.assert_array_equal(t_dir, 0.0)


def test_two_stream_g0_conservative_closure():
    """Pure scattering (ssa = 1): no absorption, so R_dif + T_dif = 1 to
    f32 roundoff — the cancellation-free property the complement forms
    exist for (docs/DESIGN.md)."""
    tau = np.logspace(-6, 1.2, 64).astype(np.float32)
    r_dif, t_dif, r_dir, t_dir, t = _g0(tau, np.ones_like(tau),
                                        np.full_like(tau, 0.7))
    np.testing.assert_allclose(r_dif + t_dif, 1.0, atol=5e-6)
    # Direct beam: everything not transmitted unscattered is reflected or
    # transmitted diffusely (energy conservation at ssa = 1).
    np.testing.assert_allclose(r_dir + t_dir + t, 1.0, atol=5e-6)
