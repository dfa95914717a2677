"""End-to-end driver tests: synthetic RFMIP file -> CLI -> CMIP flux files.

Mirrors the reference's (manual) integration pathway — build drivers, run on
an RFMIP file, inspect rlu/rld/rsu/rsd — but automated (SURVEY.md section 4).
"""
import os

import numpy as np
import pytest

from ecckd_tpu.cli import ecckd_rfmip_lw, ecckd_rfmip_sw
from ecckd_tpu.io.rfmip import (read_fluxes, read_rfmip,
                                write_synthetic_rfmip)


@pytest.fixture(scope="module")
def rfmip_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("rfmip") / "rfmip_synth.nc")
    write_synthetic_rfmip(path, nsite=8, nlay=24, nexp=2, seed=7)
    return path


def test_rfmip_reader_units_scaling(rfmip_file):
    data = read_rfmip(rfmip_file)
    assert data.nsite == 8 and data.nlay == 24 and data.nexp == 2
    # units="1e-03" scaling applied: physical h2o vmr is O(1e-2), not O(10).
    assert 1e-7 < data.gases_3d["h2o"].max() < 0.1
    assert 1e-10 < data.gases_3d["o3"].max() < 1e-4
    # co2 scaled from ppm; experiment 2 = 2x experiment 1 in the generator.
    co2 = data.gases_scalar["co2"]
    assert 3e-4 < co2[0] < 5e-4
    np.testing.assert_allclose(co2[data.nsite], 2.0 * co2[0], rtol=1e-12)
    # column flattening: site fastest.
    assert co2[0] == co2[1]
    assert data.top_at_1


def test_lw_driver_end_to_end(ckd_paths, rfmip_file, tmp_path):
    rc = ecckd_rfmip_lw.main([rfmip_file, ckd_paths["lw_fsck"], "-p", "1",
                              "--output-dir", str(tmp_path),
                              "--precision", "f64"])
    assert rc == 0
    up = read_fluxes(str(tmp_path / "rlu_Efx_RTE-ecckd_rad-irf_r1i1p1f1_gn.nc"),
                     "rlu")
    dn = read_fluxes(str(tmp_path / "rld_Efx_RTE-ecckd_rad-irf_r1i1p1f1_gn.nc"),
                     "rld")
    assert up.shape == (16, 25) and dn.shape == (16, 25)
    assert np.isfinite(up).all() and np.isfinite(dn).all()
    # Physical checks: no downwelling at TOA; sane OLR; positive fluxes.
    np.testing.assert_allclose(dn[:, 0], 0.0, atol=1e-9)
    assert (up[:, 0] > 80.0).all() and (up[:, 0] < 500.0).all()
    assert (up >= 0).all() and (dn >= 0).all()
    # Surface closure: up_sfc = emis*pi*B(tsfc) + (1-emis)*dn_sfc > dn_sfc*(1-emis)
    data = read_rfmip(rfmip_file)
    sigma = 5.670374419e-8
    approx_planck = sigma * data.sfc_t ** 4
    assert (np.abs(up[:, -1] - (data.sfc_emis * approx_planck
                                + (1 - data.sfc_emis) * dn[:, -1]))
            / approx_planck < 0.02).all()


def test_lw_driver_physics_index_2(ckd_paths, rfmip_file, tmp_path):
    rc = ecckd_rfmip_lw.main([rfmip_file, ckd_paths["lw_fsck"], "-p", "2",
                              "--output-dir", str(tmp_path),
                              "--precision", "f64"])
    assert rc == 0
    up3 = read_fluxes(
        str(tmp_path / "rlu_Efx_RTE-ecckd_rad-irf_r1i1p2f1_gn.nc"), "rlu")
    # 3-angle quadrature differs from 1-angle but not wildly.
    rc = ecckd_rfmip_lw.main([rfmip_file, ckd_paths["lw_fsck"], "-p", "1",
                              "--output-dir", str(tmp_path),
                              "--precision", "f64"])
    up1 = read_fluxes(
        str(tmp_path / "rlu_Efx_RTE-ecckd_rad-irf_r1i1p1f1_gn.nc"), "rlu")
    assert not np.allclose(up1, up3, rtol=1e-6)
    np.testing.assert_allclose(up1, up3, rtol=0.05)


def test_sw_driver_end_to_end(ckd_paths, rfmip_file, tmp_path):
    rc = ecckd_rfmip_sw.main([rfmip_file, ckd_paths["sw_wide"],
                              "--output-dir", str(tmp_path),
                              "--precision", "f64"])
    assert rc == 0
    up = read_fluxes(str(tmp_path / "rsu_Efx_RTE-ecckd_rad-irf_r1i1p1f1_gn.nc"),
                     "rsu")
    dn = read_fluxes(str(tmp_path / "rsd_Efx_RTE-ecckd_rad-irf_r1i1p1f1_gn.nc"),
                     "rsd")
    data = read_rfmip(rfmip_file)
    night = data.sza >= 90.0
    assert night.any() and (~night).any()  # generator makes both
    # Night columns exactly zero (ecckd_rfmip_sw.F90:155-161).
    np.testing.assert_array_equal(up[night], 0.0)
    np.testing.assert_array_equal(dn[night], 0.0)
    # Day columns: TOA dn = mu0 * TSI after renormalization.
    mu0 = np.cos(np.deg2rad(data.sza[~night]))
    np.testing.assert_allclose(dn[~night, 0], mu0 * data.tsi[~night],
                               rtol=1e-9)
    assert (up[~night] >= 0).all()
    # Energy: up at TOA < dn at TOA (planet absorbs).
    assert (up[~night, 0] < dn[~night, 0]).all()


def test_combined_driver_matches_separate(ckd_paths, rfmip_file, tmp_path):
    """The combined lw+sw driver's four flux files must equal the two
    separate drivers' outputs on the same inputs."""
    from ecckd_tpu.cli import ecckd_rfmip
    sep = tmp_path / "sep"
    both = tmp_path / "both"
    lw, sw = ckd_paths["lw_fsck"], ckd_paths["sw_wide"]
    assert ecckd_rfmip_lw.main([rfmip_file, lw, "--output-dir", str(sep),
                                "--precision", "f64"]) == 0
    assert ecckd_rfmip_sw.main([rfmip_file, sw, "--output-dir", str(sep),
                                "--precision", "f64"]) == 0
    assert ecckd_rfmip.main([rfmip_file, lw, sw, "--output-dir", str(both),
                             "--precision", "f64",
                             "--heating-rates"]) == 0
    for name, var in (("rlu", "rlu"), ("rld", "rld"), ("rsu", "rsu"),
                      ("rsd", "rsd")):
        fn = f"{name}_Efx_RTE-ecckd_rad-irf_r1i1p1f1_gn.nc"
        a = read_fluxes(str(sep / fn), var)
        b = read_fluxes(str(both / fn), var)
        np.testing.assert_allclose(b, a, rtol=1e-12, atol=1e-12)
    assert (both / "hrl_Efx_RTE-ecckd_rad-irf_r1i1p1f1_gn.nc").exists()
    assert (both / "hrs_Efx_RTE-ecckd_rad-irf_r1i1p1f1_gn.nc").exists()


def test_forcing_index_2_uses_cfc11eq(ckd_paths, rfmip_file, tmp_path):
    rc = ecckd_rfmip_lw.main([rfmip_file, ckd_paths["lw_fsck"], "-f", "2",
                              "--output-dir", str(tmp_path),
                              "--precision", "f64"])
    assert rc == 0
    up_f2 = read_fluxes(
        str(tmp_path / "rlu_Efx_RTE-ecckd_rad-irf_r1i1p1f2_gn.nc"), "rlu")
    rc = ecckd_rfmip_lw.main([rfmip_file, ckd_paths["lw_fsck"], "-f", "1",
                              "--output-dir", str(tmp_path),
                              "--precision", "f64"])
    up_f1 = read_fluxes(
        str(tmp_path / "rlu_Efx_RTE-ecckd_rad-irf_r1i1p1f1_gn.nc"), "rlu")
    # cfc11eq (higher equivalent loading) must change the fluxes slightly.
    assert not np.array_equal(up_f1, up_f2)


def test_write_into_existing_template(tmp_path):
    """write_fluxes must fill an existing variable like unblock_and_write."""
    from scipy.io import netcdf_file
    from ecckd_tpu.io.rfmip import write_fluxes
    path = str(tmp_path / "template.nc")
    f = netcdf_file(path, "w")
    f.createDimension("expt", 2)
    f.createDimension("site", 3)
    f.createDimension("level", 4)
    v = f.createVariable("rlu", "f8", ("expt", "site", "level"))
    v[:] = 0.0
    f.close()
    flux = np.arange(24, dtype=np.float64).reshape(6, 4)
    write_fluxes(path, "rlu", flux, nsite=3, nexp=2)
    got = read_fluxes(path, "rlu")
    np.testing.assert_array_equal(got, flux)


def test_pipeline_banded_surfaces(ckd_paths):
    """Banded (ncol, nband) emissivity/albedo through the pipelines matches
    manual band->g-point expansion through the solvers (the reference
    solver API's sfc_emis(nband, ncol) / sfc_alb_dir(nband, ncol) shape,
    SURVEY.md section 2.3)."""
    from conftest import RFMIP_VMRS, make_atmosphere
    from ecckd_tpu.gases import GasConcs
    from ecckd_tpu.models.gas_optics import gas_optics_lw, gas_optics_sw
    from ecckd_tpu.models.loader import load_ckd_model
    from ecckd_tpu.pipeline import lw_fluxes, sw_fluxes
    from ecckd_tpu.solvers.lw import rte_lw

    atm = make_atmosphere(ncol=3, nlay=15, seed=21)
    concs = GasConcs.create({"h2o": atm["h2o"], "o3": atm["o3"],
                             **RFMIP_VMRS})
    rng = np.random.default_rng(2)

    model = load_ckd_model(ckd_paths["lw_rrtmgp"],
                           dtype=np.float64)  # 16 bands
    emis_band = rng.uniform(0.7, 1.0, (3, model.nband))
    f = lw_fluxes(model, atm["plev"], atm["tlay"], atm["tlev"], atm["tsfc"],
                  emis_band, concs)
    props, sources = gas_optics_lw(model, atm["plev"], atm["tlay"],
                                   atm["tsfc"], concs, atm["tlev"])
    emis_gpt = np.asarray(model.gpt_weights_per_band(emis_band))
    up_ref, dn_ref = rte_lw(props, sources, emis_gpt)
    np.testing.assert_allclose(np.asarray(f.flux_up), np.asarray(up_ref),
                               rtol=1e-12)

    swm = load_ckd_model(ckd_paths["sw_wide"], dtype=np.float64)  # 5 bands
    alb_band = rng.uniform(0.05, 0.6, (3, swm.nband))
    fs = sw_fluxes(swm, atm["plev"], atm["tlay"], concs, alb_band,
                   np.full(3, 1361.0), np.array([20.0, 60.0, 80.0]))
    fs_const = sw_fluxes(swm, atm["plev"], atm["tlay"], concs,
                         np.full(3, 0.3), np.full(3, 1361.0),
                         np.array([20.0, 60.0, 80.0]))
    # Banded run is finite, differs from constant-albedo run, and matches
    # the constant run when all bands carry the same value.
    assert np.isfinite(np.asarray(fs.flux_up)).all()
    assert not np.allclose(np.asarray(fs.flux_up),
                           np.asarray(fs_const.flux_up))
    fs_same = sw_fluxes(swm, atm["plev"], atm["tlay"], concs,
                        np.full((3, swm.nband), 0.3), np.full(3, 1361.0),
                        np.array([20.0, 60.0, 80.0]))
    np.testing.assert_allclose(np.asarray(fs_same.flux_up),
                               np.asarray(fs_const.flux_up), rtol=1e-12)


def test_heating_rate_output(ckd_paths, rfmip_file, tmp_path):
    """--heating-rates writes an hrl file with plausible K/day values."""
    from ecckd_tpu.io.rfmip import netcdf_file
    rc = ecckd_rfmip_lw.main([rfmip_file, ckd_paths["lw_fsck"], "--output-dir",
                              str(tmp_path), "--heating-rates"])
    assert rc == 0
    path = tmp_path / "hrl_Efx_RTE-ecckd_rad-irf_r1i1p1f1_gn.nc"
    f = netcdf_file(str(path), mmap=False)
    hr = f.variables["hrl"][:].copy()
    f.close()
    assert hr.shape == (2, 8, 24)
    assert np.isfinite(hr).all()
    # Longwave COOLING on average (the synthetic profile's thin top layers
    # cool hard, O(100) K/day; the troposphere at O(1)).
    assert hr.mean() < 0.0 and hr.min() > -200.0 and abs(hr).max() > 0.1
