"""Generate the committed golden flux files under tests/goldens/.

Run once (and re-run only on a *deliberate* numerics change):

    python tests/make_goldens.py

Goldens freeze the f64 fluxes for a fixed synthetic atmosphere on every
seeded ckd file (io/synthetic.write_synthetic_ckd, seed 0), playing the role of the Fortran chain's RFMIP
reference outputs (SURVEY.md section 4: golden-file integration tests).
``tests/test_golden.py`` recomputes them and compares at near-bitwise
tolerance, guarding the numerics (clamp constants, accumulation order,
Planck extrapolation, two-stream algebra) across kernel refactors.
"""
import os
import sys
import tempfile

os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

from conftest import RFMIP_VMRS, make_atmosphere  # noqa: E402
from ecckd_tpu.gases import GasConcs  # noqa: E402
from ecckd_tpu.io.synthetic import synthetic_ckd_files  # noqa: E402
from ecckd_tpu.models.loader import load_ckd_model  # noqa: E402
from ecckd_tpu.pipeline import lw_fluxes, sw_fluxes  # noqa: E402

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")

NCOL, NLAY, SEED = 8, 40, 123
LW_CASES = [("lw_fsck_1ang", "lw_fsck", 1), ("lw_fsck_3ang", "lw_fsck", 3),
            ("lw_rrtmgp_1ang", "lw_rrtmgp", 1),
            ("lw_rrtmgp_3ang", "lw_rrtmgp", 3)]


def golden_inputs():
    atm = make_atmosphere(ncol=NCOL, nlay=NLAY, seed=SEED)
    concs = GasConcs.create({"h2o": atm["h2o"], "o3": atm["o3"],
                             **RFMIP_VMRS})
    rng = np.random.default_rng(SEED + 1)
    emis = rng.uniform(0.9, 1.0, NCOL)
    alb = rng.uniform(0.05, 0.5, NCOL)
    tsi = np.full(NCOL, 1361.0)
    # Includes grazing (89.9) and night (95, 120) columns.
    sza = np.array([0.0, 30.0, 52.5, 66.0, 78.0, 89.9, 95.0, 120.0])[:NCOL]
    return atm, concs, emis, alb, tsi, sza


def main():
    os.makedirs(GOLDEN_DIR, exist_ok=True)
    atm, concs, emis, alb, tsi, sza = golden_inputs()
    with tempfile.TemporaryDirectory() as tmp:
        paths = synthetic_ckd_files(tmp)
        models = {kind: load_ckd_model(path, dtype=np.float64)
                  for kind, path in paths.items()}

    for tag, kind, angles in LW_CASES:
        f = lw_fluxes(models[kind], atm["plev"], atm["tlay"], atm["tlev"],
                      atm["tsfc"], emis, concs, n_gauss_angles=angles)
        out = os.path.join(GOLDEN_DIR, f"{tag}.npz")
        np.savez_compressed(out, flux_up=np.asarray(f.flux_up),
                            flux_dn=np.asarray(f.flux_dn))
        print(f"{out}: up[0,0]={float(f.flux_up[0, 0]):.9f} "
              f"dn[0,-1]={float(f.flux_dn[0, -1]):.9f}")

    f = sw_fluxes(models["sw_wide"], atm["plev"], atm["tlay"], concs, alb,
                  tsi, sza)
    out = os.path.join(GOLDEN_DIR, "sw_wide.npz")
    np.savez_compressed(out, flux_up=np.asarray(f.flux_up),
                        flux_dn=np.asarray(f.flux_dn))
    print(f"{out}: up[0,0]={float(f.flux_up[0, 0]):.9f} "
          f"dn[0,-1]={float(f.flux_dn[0, -1]):.9f}")


if __name__ == "__main__":
    main()
