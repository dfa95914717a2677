"""The compilation-cache rule and the absence of per-machine switches: one
compute path, no backend or precision-mode options."""
import importlib.util
import os

import jax
import pytest

from ecckd_tpu import config
from ecckd_tpu.cli.common import make_parser


@pytest.fixture
def restore_cache_config():
    saved = (jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs)
    yield
    jax.config.update("jax_compilation_cache_dir", saved[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      saved[1])


def test_cache_dir_from_environment_sets_nothing(monkeypatch,
                                                 restore_cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    jax.config.update("jax_compilation_cache_dir", "sentinel")
    config.setup_compilation_cache()
    assert jax.config.jax_compilation_cache_dir == "sentinel"


def test_cache_dir_defaults_to_checkout(monkeypatch, restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    jax.config.update("jax_compilation_cache_dir", None)
    config.setup_compilation_cache()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert jax.config.jax_compilation_cache_dir == os.path.join(
        repo, ".jax_cache")


@pytest.mark.parametrize("flag", [["--fast"], ["--backend", "xla"],
                                  ["--backend", "fused"]])
def test_cli_has_no_backend_or_fast_option(flag, capsys):
    p = make_parser("ecckd_rfmip_lw")
    assert p.parse_args(["rfmip.nc", "ckd.nc"]).physics_index == 1
    with pytest.raises(SystemExit):
        p.parse_args(["rfmip.nc", "ckd.nc"] + flag)
    assert "unrecognized arguments" in capsys.readouterr().err


def test_no_precision_mode_knob_or_kernel_package():
    """config exposes no setters (the old precision-mode knob was one) and
    no kernel package sits beside the XLA path."""
    assert [n for n in dir(config) if n.startswith("set_")] == []
    assert importlib.util.find_spec("ecckd_tpu.ops.pallas") is None
