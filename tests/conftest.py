"""Test configuration: run on a virtual 8-device CPU mesh.

Sharding-equivalence tests need multiple devices, so the host platform is
forced with 8 virtual devices (SURVEY.md section 4).  This must happen
before the first JAX backend is initialized.  Tests that need the GPU carry
the ``gpu`` marker and decide inside a fixture whether a card exists.
"""
import os
import shutil
import subprocess

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")

import jax  # noqa: E402

# A plugin imported before this conftest may already have imported jax, so
# the environment variable alone can be too late; the config update holds
# as long as no backend has been initialized yet.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)  # match Fortran double precision

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from ecckd_tpu.config import setup_compilation_cache  # noqa: E402

setup_compilation_cache()


@pytest.fixture(scope="session")
def ckd_paths(tmp_path_factory):
    """The three seeded ckd-definition files, written once per session:
    {"lw_fsck": path, "lw_rrtmgp": path, "sw_wide": path}."""
    from ecckd_tpu.io.synthetic import synthetic_ckd_files
    return synthetic_ckd_files(str(tmp_path_factory.mktemp("ckd")))


@pytest.fixture(scope="session")
def lw_model(ckd_paths):
    from ecckd_tpu.models.loader import load_ckd_model
    return load_ckd_model(ckd_paths["lw_fsck"])


@pytest.fixture(scope="session")
def lw_rrtmgp_model(ckd_paths):
    from ecckd_tpu.models.loader import load_ckd_model
    return load_ckd_model(ckd_paths["lw_rrtmgp"])


@pytest.fixture(scope="session")
def sw_model(ckd_paths):
    from ecckd_tpu.models.loader import load_ckd_model
    return load_ckd_model(ckd_paths["sw_wide"])


@pytest.fixture
def gpu_card():
    """Skip unless an NVIDIA card answers nvidia-smi.  Decided here, at run
    time, so every worker collects the same tests."""
    smi = shutil.which("nvidia-smi")
    if smi is None or subprocess.run([smi, "-L"], capture_output=True
                                     ).returncode != 0:
        pytest.skip("needs an NVIDIA GPU (nvidia-smi finds none)")
    return smi


def make_atmosphere(ncol=4, nlay=20, seed=0, p_top=1.0, p_sfc=101300.0):
    """Synthetic but physically plausible atmospheric columns."""
    rng = np.random.default_rng(seed)
    # Log-spaced level pressures with mild per-column jitter.
    base = np.exp(np.linspace(np.log(p_top), np.log(p_sfc), nlay + 1))
    jitter = 1.0 + 0.05 * rng.standard_normal((ncol, nlay + 1))
    plev = np.sort(base[None, :] * jitter, axis=1)
    play = 0.5 * (plev[:, 1:] + plev[:, :-1])
    # Temperature: warm surface, cold tropopause, warm stratopause.
    logp = np.log(play)
    tlay = (288.0 - 55.0 * np.exp(-((logp - np.log(1.5e4)) ** 2) / 4.0)
            + 2.0 * rng.standard_normal((ncol, nlay)))
    loglev = np.log(plev)
    tlev = (288.0 - 55.0 * np.exp(-((loglev - np.log(1.5e4)) ** 2) / 4.0)
            + 2.0 * rng.standard_normal((ncol, nlay + 1)))
    tsfc = tlev[:, -1] + rng.uniform(-2, 4, ncol)
    h2o = 10.0 ** rng.uniform(-6, -2, (ncol, nlay))
    o3 = 10.0 ** rng.uniform(-8, -5.2, (ncol, nlay))
    return dict(plev=plev, play=play, tlay=tlay, tlev=tlev, tsfc=tsfc,
                h2o=h2o, o3=o3)


RFMIP_VMRS = dict(co2=397.547e-6, ch4=1831.47e-9, n2o=326.99e-9, o2=0.2095,
                  cfc11=233.042e-12, cfc12=520.581e-12, n2=0.7808)
