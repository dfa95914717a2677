"""Precision policy and global configuration.

The reference chain computes in Fortran double precision (rte-rrtmgp's default
``wp``).  The fast path here is float32; float64 is available for validation
by enabling JAX x64 mode *before* importing anything that builds arrays.
"""
from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")
"""Persistent compilation cache when JAX_COMPILATION_CACHE_DIR is unset."""


@dataclasses.dataclass(frozen=True)
class Precision:
    """Working precision for the compute path."""

    dtype: jnp.dtype

    @property
    def eps(self) -> float:
        return float(jnp.finfo(self.dtype).eps)


F32 = Precision(jnp.dtype(jnp.float32))


def default_precision() -> Precision:
    """float64 when x64 mode is enabled, else float32."""
    if jax.config.read("jax_enable_x64"):
        return Precision(jnp.dtype(jnp.float64))
    return F32


def enable_f64_validation_mode() -> None:
    """Switch JAX to x64 so results can be compared against the Fortran
    double-precision chain.  Call before constructing models."""
    jax.config.update("jax_enable_x64", True)


def setup_compilation_cache() -> None:
    """Persistent XLA compilation cache.  Where JAX_COMPILATION_CACHE_DIR is
    set, JAX reads it itself and nothing is set here; otherwise the cache
    lives at the fixed path ``<checkout>/.jax_cache`` (the path is part of
    the cache key, so it must not move between runs)."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
