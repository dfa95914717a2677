"""The seeded ckd-definition generator (io/synthetic.write_synthetic_ckd):
published dimensions and schema (SURVEY.md section 2.6), a loader round
trip, and determinism from the seed."""
import os

import numpy as np
import pytest
from scipy.io import netcdf_file

from ecckd_tpu import constants
from ecckd_tpu.io import synthetic
from ecckd_tpu.models.loader import load_ckd_model

NGPT = {"lw_fsck": 32, "lw_rrtmgp": 36, "sw_wide": 27}
NBAND = {"lw_fsck": 1, "lw_rrtmgp": 16, "sw_wide": 5}
NWAVENUMBER = {"lw_fsck": 326, "lw_rrtmgp": 326, "sw_wide": 995}
KINDS = list(NGPT)


def _open(path):
    return netcdf_file(path, mmap=False)


def _text(f, name):
    v = getattr(f, name)
    return v.decode() if isinstance(v, bytes) else v


@pytest.mark.parametrize("kind", KINDS)
def test_dimensions(ckd_paths, kind):
    f = _open(ckd_paths[kind])
    dims = dict(f.dimensions)
    f.close()
    want = {"g_point": NGPT[kind], "band": NBAND[kind], "pressure": 53,
            "temperature": 6, "wavenumber": NWAVENUMBER[kind],
            "h2o_mole_fraction": 12, "composite_gas": 4}
    if kind.startswith("lw"):
        want["temperature_planck"] = 231
    assert dims == want


@pytest.mark.parametrize("kind", KINDS)
def test_grids_and_attributes(ckd_paths, kind):
    f = _open(ckd_paths[kind])
    v = {k: np.asarray(x.data).copy() for k, x in f.variables.items()}
    gases = _text(f, "constituent_id").split()
    composite = _text(f, "composite_constituent_id")
    f.close()
    p = v["pressure"]
    assert np.isclose(p[0], 0.694) and np.isclose(p[-1], 1.1e5)
    assert np.allclose(np.diff(np.log(p)), np.log(p[1] / p[0]))
    np.testing.assert_allclose(np.diff(v["temperature"], axis=0), 20.0)
    np.testing.assert_allclose(v["temperature"][:, 0],
                               138.46 + 20.0 * np.arange(6))
    mf = v["h2o_mole_fraction"]
    assert np.isclose(mf[0], 1.61e-7) and np.isclose(mf[-1], 5.08e-2)
    assert np.allclose(np.diff(np.log(mf)), np.log(mf[1] / mf[0]))
    assert composite == "o2 n2 n2o ch4"
    lw_only = ["cfc11", "cfc12"] if kind.startswith("lw") else []
    assert gases == ["composite", "h2o", "o3", "co2", "ch4", "n2o"] + lw_only
    codes = {g: int(v[f"{g}_conc_dependence_code"]) for g in gases
             if g != "h2o"}
    assert codes.pop("composite") == constants.CONC_NONE
    assert codes.pop("ch4") == codes.pop("n2o") == \
        constants.CONC_RELATIVE_LINEAR
    assert set(codes.values()) == {constants.CONC_LINEAR}
    assert np.isclose(v["ch4_reference_mole_fraction"], 1.921e-6)
    assert np.isclose(v["n2o_reference_mole_fraction"], 3.32e-7)
    # Every wavenumber bin maps to at most one g-point, every g-point to
    # at least one bin, and the bands cover contiguous g-point runs.
    frac = v["gpoint_fraction"]
    assert frac.sum(0).max() == 1.0 and (frac.sum(1) >= 1).all()
    assert (np.diff(v["band_number"]) >= 0).all()
    assert v["band_number"][-1] == NBAND[kind] - 1


@pytest.mark.parametrize("kind", KINDS)
def test_absorption_tables(ckd_paths, kind):
    """Non-negative, spread over at least six decades across g-points, and
    rising with pressure for every g-point."""
    f = _open(ckd_paths[kind])
    tables = {k: np.asarray(x.data).copy() for k, x in f.variables.items()
              if k.endswith("_molar_absorption_coeff")}
    f.close()
    for name, k in tables.items():
        assert (k >= 0).all(), name
        k3 = k[-1] if k.ndim == 4 else k        # (T, p, g)
        at_ref = k3[2, -1, :]
        assert at_ref.max() / at_ref.min() >= 1e5, name
        assert (np.diff(k3, axis=1) > 0).all(), name


def test_lw_planck_and_sw_sources(ckd_paths):
    f = _open(ckd_paths["lw_rrtmgp"])
    t = np.asarray(f.variables["temperature_planck"].data).copy()
    planck = np.asarray(f.variables["planck_function"].data).copy()
    f.close()
    np.testing.assert_allclose(t, np.arange(120.0, 351.0))
    assert (planck > 0).all() and (np.diff(planck.sum(1)) > 0).all()
    f = _open(ckd_paths["sw_wide"])
    solar = np.asarray(f.variables["solar_irradiance"].data).copy()
    ray = np.asarray(f.variables["rayleigh_molar_scattering_coeff"].data
                     ).copy()
    bands = np.asarray(f.variables["band_number"].data).copy()
    f.close()
    assert np.isclose(solar.sum(), 1361.0)
    # Rayleigh scattering rises steeply with wavenumber (nu^4): each band's
    # mean exceeds the previous band's.
    means = [ray[bands == b].mean() for b in range(5)]
    assert (np.diff(means) > 0).all()


@pytest.mark.parametrize("kind", KINDS)
def test_loader_round_trip(ckd_paths, kind):
    m = load_ckd_model(ckd_paths[kind])
    assert m.ngpt == NGPT[kind] and m.nband == NBAND[kind]
    assert m.shortwave == (kind == "sw_wide")
    lw = kind.startswith("lw")
    assert m.get_ngas() == (9 if lw else 7)
    assert m.gas_names[-2:] == ("o2", "n2")
    assert m.coeff_dense.shape == ((7 if lw else 5), 53, 6, NGPT[kind])
    assert m.coeff_lut[0].shape == (12, 53, 6, NGPT[kind])


def test_same_seed_same_bytes_other_seed_other_tables(tmp_path):
    a, b, c = (str(tmp_path / n) for n in ("a.nc", "b.nc", "c.nc"))
    synthetic.write_synthetic_ckd(a, "lw_fsck", seed=3)
    synthetic.write_synthetic_ckd(b, "lw_fsck", seed=3)
    synthetic.write_synthetic_ckd(c, "lw_fsck", seed=4)
    with open(a, "rb") as fa, open(b, "rb") as fb, open(c, "rb") as fc:
        ra, rb, rc = fa.read(), fb.read(), fc.read()
    assert ra == rb and ra != rc


def test_synthetic_ckd_files_writes_once(tmp_path):
    paths = synthetic.synthetic_ckd_files(str(tmp_path), seed=1)
    assert sorted(paths) == sorted(synthetic.CKD_KINDS)
    stamps = {k: os.stat(p).st_mtime_ns for k, p in paths.items()}
    again = synthetic.synthetic_ckd_files(str(tmp_path), seed=1)
    assert again == paths
    assert {k: os.stat(p).st_mtime_ns for k, p in again.items()} == stamps
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]


def test_cli_subcommands(tmp_path):
    ckd = str(tmp_path / "sw.nc")
    assert synthetic.main(["ckd", ckd, "--kind", "sw_wide", "--seed",
                           "2"]) == 0
    assert load_ckd_model(ckd).ngpt == 27
    rfmip = str(tmp_path / "rfmip.nc")
    assert synthetic.main(["rfmip", rfmip, "--nsite", "3", "--nlay", "5",
                           "--nexp", "2"]) == 0
    assert os.path.getsize(rfmip) > 0
    with pytest.raises(ValueError, match="unknown ckd kind"):
        synthetic.write_synthetic_ckd(str(tmp_path / "x.nc"), "lw_other")
