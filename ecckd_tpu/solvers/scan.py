"""Layer-recurrence primitives for the flux solvers.

The radiative-transfer sweeps are first-order linear recurrences over the
layer axis: x[k+1] = a[k] * x[k] + b[k].  They are evaluated with a
``lax.scan`` over the (tiny, static) layer axis — nlay ~ 60 steps — while the
column x g-point axes stay fully vectorized, so each step is one wide fused
elementwise op and the whole sweep compiles to a single XLA while-loop.

(An associative-scan formulation — composing affine maps (a2,b2) o (a1,b1) =
(a1*a2, a2*b1 + b2) over log2(nlay) doubling levels — was benchmarked first:
its unrolled slice/concat graphs inflated XLA compile time by >10x for no
runtime win at nlay=60, and its non-sequential reduction order costs
bit-reproducibility against the reference sweep.  lax.scan wins on both.)
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def _swap_to_front(x: jax.Array, axis: int) -> jax.Array:
    return jnp.moveaxis(x, axis, 0)


def affine_scan(a: jax.Array, b: jax.Array, init: jax.Array,
                axis: int) -> jax.Array:
    """All n+1 states of x[k+1] = a[k] * x[k] + b[k] with x[0] = init.

    Args:
      a, b: per-step coefficients with n entries along ``axis``.
      init: initial state (shape of a with ``axis`` removed).
    Returns:
      states with n+1 entries along ``axis`` (x[0] == init first).
    """
    a_s = _swap_to_front(a, axis)
    b_s = _swap_to_front(b, axis)

    def step(x, ab):
        ai, bi = ab
        x_next = ai * x + bi
        return x_next, x_next

    _, states = lax.scan(step, init, (a_s, b_s))
    out = jnp.concatenate([init[None], states], axis=0)
    return jnp.moveaxis(out, 0, axis)


def affine_scan_reverse(a: jax.Array, b: jax.Array, init: jax.Array,
                        axis: int) -> jax.Array:
    """All n+1 states of x[k] = a[k] * x[k+1] + b[k] with x[n] = init."""
    flip = lambda x: jnp.flip(x, axis=axis)
    return flip(affine_scan(flip(a), flip(b), init, axis))


def affine_sweep_broadband(a: jax.Array, b: jax.Array, init: jax.Array,
                           reverse: bool = False):
    """Affine layer sweep that emits only the *g-point-summed* per-level
    fluxes, keeping the per-g-point state as the scan carry.

    Memory matters: materializing the per-g-point radiance at every level is
    an (ncol, nlay+1, ngpt) cube per sweep per angle; the broadband reduction
    commutes with the sweep, so emitting (ncol, nlay+1) directly cuts HBM
    traffic and peak footprint by ~ngpt.

    Args:
      a, b: (ncol, nlay, ngpt) per-layer coefficients of
        x[k+1] = a[k] x[k] + b[k] (forward) or x[k] = a[k] x[k+1] + b[k]
        (reverse).
      init: (ncol, ngpt) boundary state (top for forward, surface for
        reverse).
    Returns:
      (levels, final): levels (ncol, nlay+1) broadband sums at every level
      (orientation matches the input layer order), final (ncol, ngpt) state
      at the far boundary.
    """
    a_s = jnp.moveaxis(a, 1, 0)
    b_s = jnp.moveaxis(b, 1, 0)

    def step(x, ab):
        ai, bi = ab
        x_next = ai * x + bi
        return x_next, jnp.sum(x_next, axis=-1)

    final, sums = lax.scan(step, init, (a_s, b_s), reverse=reverse)
    init_sum = jnp.sum(init, axis=-1)[:, None]
    if reverse:
        levels = jnp.concatenate([jnp.moveaxis(sums, 0, 1), init_sum], axis=1)
    else:
        levels = jnp.concatenate([init_sum, jnp.moveaxis(sums, 0, 1)], axis=1)
    return levels, final
