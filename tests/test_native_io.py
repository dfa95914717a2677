"""Native C++ netCDF3 engine vs scipy.io.netcdf parity."""
import os
import subprocess

import jax
import numpy as np
import pytest
from scipy.io import netcdf_file

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="session", autouse=True)
def build_native():
    subprocess.run(["make", "-C", os.path.join(REPO, "native")], check=True,
                   capture_output=True)


def _native():
    from ecckd_tpu.io import nc3_native
    assert nc3_native.load_library() is not None
    return nc3_native


@pytest.mark.parametrize("kind", ["lw_fsck", "lw_rrtmgp", "sw_wide"])
def test_reader_matches_scipy(ckd_paths, kind):
    path = ckd_paths[kind]
    nc3 = _native()
    ref = netcdf_file(path, mmap=False)
    with nc3.NativeReader(path) as r:
        assert r.dimensions == dict(ref.dimensions)
        assert set(r.var_names) == set(ref.variables)
        for name, var in ref.variables.items():
            got = r.read(name)
            want = np.asarray(var.data).astype(np.float64)
            assert got.shape == want.shape, name
            np.testing.assert_array_equal(got, want, err_msg=name)
        # global attribute text parity (the loader's gas-list contract)
        for att in ("constituent_id", "composite_constituent_id"):
            want_att = getattr(ref, att)
            if isinstance(want_att, bytes):
                want_att = want_att.decode()
            assert r.att_text(None, att) == want_att
    ref.close()


def test_reader_var_units_attribute(tmp_path):
    nc3 = _native()
    from ecckd_tpu.io.rfmip import write_synthetic_rfmip
    p = str(tmp_path / "rfmip.nc")
    write_synthetic_rfmip(p, nsite=7, nlay=13, nexp=2)
    ref = netcdf_file(p, mmap=False)
    with nc3.NativeReader(p) as r:
        for name, var in ref.variables.items():
            np.testing.assert_array_equal(
                r.read(name), np.asarray(var.data).astype(np.float64),
                err_msg=name)
            units = getattr(var, "units", None)
            if units is not None:
                if isinstance(units, bytes):
                    units = units.decode()
                assert r.att_text(name, "units") == units
    ref.close()


def test_writer_roundtrip(tmp_path):
    nc3 = _native()
    p = str(tmp_path / "out.nc")
    rng = np.random.default_rng(0)
    a = rng.standard_normal((3, 5, 4))
    b = rng.standard_normal((5,)).astype(np.float32)
    w = nc3.NativeWriter(p)
    w.def_dim("x", 3)
    w.def_dim("y", 5)
    w.def_dim("z", 4)
    w.def_var("a", "d", ("x", "y", "z"))
    w.def_var("b", "f", ("y",))
    w.put_att("a", "units", "W m-2")
    w.put_att(None, "title", "roundtrip")
    w.put_var("a", a)
    w.put_var("b", b)
    w.finish()

    # scipy must read back what the native writer produced.
    f = netcdf_file(p, mmap=False)
    np.testing.assert_array_equal(np.asarray(f.variables["a"].data), a)
    np.testing.assert_allclose(np.asarray(f.variables["b"].data), b,
                               rtol=1e-7)
    units = f.variables["a"].units
    assert (units.decode() if isinstance(units, bytes) else units) == "W m-2"
    f.close()
    # ... and so must the native reader.
    with nc3.NativeReader(p) as r:
        np.testing.assert_array_equal(r.read("a"), a)
        assert r.att_text(None, "title") == "roundtrip"


def test_update_var_template_fill(tmp_path):
    """In-place variable overwrite, the reference's CMIP-template fill
    pattern (mo_rfmip_io.F90:288-317)."""
    nc3 = _native()
    p = str(tmp_path / "tmpl.nc")
    w = nc3.NativeWriter(p)
    w.def_dim("expt", 2)
    w.def_dim("site", 3)
    w.def_dim("level", 4)
    w.def_var("rlu", "f", ("expt", "site", "level"))
    w.put_var("rlu", np.zeros((2, 3, 4)))
    w.finish()
    data = np.arange(24, dtype=np.float64).reshape(2, 3, 4)
    nc3.update_var(p, "rlu", data)
    f = netcdf_file(p, mmap=False)
    np.testing.assert_allclose(np.asarray(f.variables["rlu"].data), data,
                               rtol=1e-6)
    f.close()


def test_ckd_loader_native_matches_scipy(ckd_paths, monkeypatch):
    """load_ckd_model must produce a bit-identical model whichever I/O
    engine parses the file (the native engine decodes to f64; read_exact
    converts back to the file dtype so load-time numerics like
    np.log(pressure) cannot diverge)."""
    from ecckd_tpu.io import nc3_native
    from ecckd_tpu.models import loader

    path = ckd_paths["lw_fsck"]
    assert nc3_native.load_library() is not None
    m_native = loader.load_ckd_model(path, dtype=np.dtype(np.float32))
    monkeypatch.setattr(nc3_native, "load_library", lambda: None)
    m_scipy = loader.load_ckd_model(path, dtype=np.dtype(np.float32))

    leaves_n, treedef_n = jax.tree_util.tree_flatten(m_native)
    leaves_s, treedef_s = jax.tree_util.tree_flatten(m_scipy)
    assert treedef_n == treedef_s  # static metadata equal
    for a, b in zip(leaves_n, leaves_s):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_writer_rejects_unwritten_variable(tmp_path):
    """finish() must REFUSE a defined-but-never-written variable: its
    empty buffer would otherwise give it the same begin offset as the
    next variable (header vsize still claims the full padded size), so
    a reader silently returns the next variable's bytes for it."""
    nc3 = _native()
    p = str(tmp_path / "alias.nc")
    w = nc3.NativeWriter(p)
    w.def_dim("x", 4)
    w.def_var("a", "d", ("x",))
    w.def_var("b", "d", ("x",))
    w.put_var("b", np.arange(4.0))
    with pytest.raises(OSError, match="never written"):
        w.finish()


def test_reader_rejects_truncated_header(tmp_path):
    """A file cut mid-header must fail with a clean error (the grow-retry
    stops at the file size), never an out-of-bounds read or a garbage
    parse."""
    nc3 = _native()
    good = str(tmp_path / "good.nc")
    w = nc3.NativeWriter(good)
    w.def_dim("x", 8)
    w.def_var("long_variable_name_to_cut_through", "d", ("x",))
    w.put_var("long_variable_name_to_cut_through", np.arange(8.0))
    w.put_att(None, "title", "truncate me")
    w.finish()
    blob = open(good, "rb").read()
    # Cut inside the header (before any variable data): every prefix
    # must be rejected cleanly.  Step through a range of cuts including
    # mid-name and mid-length positions.
    for cut in range(5, min(len(blob) - 65, 200), 7):
        bad = str(tmp_path / f"cut{cut}.nc")
        with open(bad, "wb") as f:
            f.write(blob[:cut])
        with pytest.raises(OSError):
            nc3.NativeReader(bad)


def test_reader_streaming_numrecs_sentinel(tmp_path):
    """numrecs == 0xFFFFFFFF (the CDF STREAMING convention) must be
    derived from the file size per spec — not reported as ~4.3e9
    records (which would OOM any consumer)."""
    nc3 = _native()
    p = str(tmp_path / "rec.nc")
    f = netcdf_file(p, "w")
    f.createDimension("t", None)
    f.createDimension("x", 3)
    v = f.createVariable("v", "f8", ("t", "x"))
    v[0] = [1.0, 2.0, 3.0]
    v[1] = [4.0, 5.0, 6.0]
    f.flush(); f.close()
    blob = bytearray(open(p, "rb").read())
    blob[4:8] = b"\xff\xff\xff\xff"
    p2 = str(tmp_path / "stream.nc")
    open(p2, "wb").write(bytes(blob))
    with nc3.NativeReader(p2) as r:
        assert tuple(r.var_shape("v")) == (2, 3)
        np.testing.assert_array_equal(
            r.read("v"), [[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]])


def test_reader_unknown_type_is_loud(tmp_path):
    """An unrecognized variable type code must raise, not return zeros
    (type_size(unknown)==0 made the pread a 0-byte 'success' before the
    round-5 fix)."""
    import struct
    nc3 = _native()
    u32 = lambda v: struct.pack(">I", v)
    hdr = b"CDF\x01" + u32(0)
    hdr += u32(0x0A) + u32(1) + u32(1) + b"x\x00\x00\x00" + u32(2)
    hdr += u32(0) + u32(0)
    hdr += u32(0x0B) + u32(1) + u32(1) + b"v\x00\x00\x00"
    hdr += u32(1) + u32(0) + u32(0) + u32(0)
    hdr += u32(99) + u32(16) + u32(len(hdr) + 8)
    p = str(tmp_path / "badtype.nc")
    open(p, "wb").write(hdr + struct.pack(">2d", 1.5, 2.5))
    with nc3.NativeReader(p) as r:
        with pytest.raises(OSError, match="unknown type"):
            r.read("v")
