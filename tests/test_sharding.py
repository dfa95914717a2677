"""Sharding-equivalence tests on a virtual 8-device CPU mesh.

The column axis is the framework's only parallel dimension (SURVEY.md
section 2.5); sharded and single-device execution must agree bitwise.
"""
import jax
import numpy as np
import pytest

from conftest import RFMIP_VMRS, make_atmosphere
from ecckd_tpu.gases import GasConcs
from ecckd_tpu.parallel import mesh as pmesh
from ecckd_tpu.pipeline import lw_fluxes, sw_fluxes


@pytest.fixture(scope="module")
def batch():
    ncol, nlay = 16, 20
    atm = make_atmosphere(ncol=ncol, nlay=nlay, seed=42)
    items = [(g, np.full(ncol, RFMIP_VMRS[g])) for g in
             ("co2", "ch4", "n2o", "o2", "cfc11", "cfc12")]
    items += [("h2o", atm["h2o"]), ("o3", atm["o3"])]
    concs = GasConcs.create(items)
    return atm, concs


def test_eight_devices_available():
    assert len(jax.devices()) == 8


def test_lw_sharded_equals_single_device(lw_model, batch):
    atm, concs = batch
    emis = np.full(atm["tlay"].shape[0], 0.98)
    args = (atm["plev"], atm["tlay"], atm["tlev"], atm["tsfc"], emis)

    single = jax.jit(lambda *a: lw_fluxes(lw_model, *a))(*args, concs)

    mesh = pmesh.make_column_mesh()
    placed, ncol = pmesh.shard_batch(list(args), mesh)
    concs_sharded = GasConcs(
        values=tuple(
            jax.device_put(v, pmesh.column_sharding(mesh)
                           if np.ndim(v) >= 1 else pmesh.replicated(mesh))
            for v in concs.values),
        names=concs.names)
    jfn = jax.jit(lambda p, tl, tv, ts, e, c: lw_fluxes(
        lw_model, p, tl, tv, ts, e, c))
    sharded = jfn(*placed, concs_sharded)

    np.testing.assert_array_equal(np.asarray(sharded.flux_up)[:ncol],
                                  np.asarray(single.flux_up))
    np.testing.assert_array_equal(np.asarray(sharded.flux_dn)[:ncol],
                                  np.asarray(single.flux_dn))
    # Output really is sharded over the mesh.
    assert len(sharded.flux_up.sharding.device_set) == 8


def test_sw_sharded_equals_single_device(sw_model, batch):
    atm, concs = batch
    ncol = atm["tlay"].shape[0]
    alb = np.full(ncol, 0.1)
    tsi = np.full(ncol, 1361.0)
    sza = np.linspace(10.0, 120.0, ncol)  # mix of day and night

    single = jax.jit(lambda *a: sw_fluxes(sw_model, *a))(
        atm["plev"], atm["tlay"], concs, alb, tsi, sza)

    mesh = pmesh.make_column_mesh()
    placed, n = pmesh.shard_batch(
        [atm["plev"], atm["tlay"], alb, tsi, sza], mesh)
    concs_sharded = GasConcs(
        values=tuple(
            jax.device_put(v, pmesh.column_sharding(mesh)
                           if np.ndim(v) >= 1 else pmesh.replicated(mesh))
            for v in concs.values),
        names=concs.names)
    jfn = jax.jit(lambda p, tl, c, a, t, s: sw_fluxes(
        sw_model, p, tl, c, a, t, s))
    sharded = jfn(placed[0], placed[1], concs_sharded, placed[2], placed[3],
                  placed[4])

    np.testing.assert_array_equal(np.asarray(sharded.flux_up)[:n],
                                  np.asarray(single.flux_up))
    np.testing.assert_array_equal(np.asarray(sharded.flux_dn)[:n],
                                  np.asarray(single.flux_dn))


def test_uneven_columns_padded(lw_model, batch):
    """A column count not divisible by the mesh still works via padding."""
    atm, concs = batch
    ncol = 11  # not divisible by 8
    sub = {k: v[:ncol] for k, v in atm.items()}
    sub_concs = GasConcs(
        values=tuple(v[:ncol] if np.ndim(v) >= 1 else v
                     for v in concs.values),
        names=concs.names)
    emis = np.full(ncol, 0.98)
    single = jax.jit(lambda *a: lw_fluxes(lw_model, *a))(
        sub["plev"], sub["tlay"], sub["tlev"], sub["tsfc"], emis, sub_concs)
    mesh = pmesh.make_column_mesh()
    placed, n = pmesh.shard_batch(
        [sub["plev"], sub["tlay"], sub["tlev"], sub["tsfc"], emis], mesh)
    assert n == ncol and placed[0].shape[0] == 16
    padded_concs = GasConcs(
        values=tuple(
            np.pad(np.asarray(v), [(0, 16 - ncol)] + [(0, 0)] * (v.ndim - 1),
                   mode="edge") if np.ndim(v) >= 1 else v
            for v in sub_concs.values),
        names=sub_concs.names)
    sharded = jax.jit(lambda p, tl, tv, ts, e, c: lw_fluxes(
        lw_model, p, tl, tv, ts, e, c))(*placed, padded_concs)
    np.testing.assert_array_equal(np.asarray(sharded.flux_up)[:ncol],
                                  np.asarray(single.flux_up))


def test_shard_map_columns_call(lw_model, batch):
    """shard_columns_call (the per-device-program bridge) matches unsharded
    execution; each device sees only its column shard."""
    atm, concs = batch
    ncol = atm["tlay"].shape[0]
    emis = np.full(ncol, 0.98)
    args = (atm["plev"], atm["tlay"], atm["tlev"], atm["tsfc"], emis, concs)
    single = jax.jit(lambda *a: lw_fluxes(lw_model, *a))(*args)

    mesh = pmesh.make_column_mesh()

    def fn(plev, tlay, tlev, tsfc, e, c):
        out = lw_fluxes(lw_model, plev, tlay, tlev, tsfc, e, c)
        return out.flux_up, out.flux_dn

    up, dn = jax.jit(lambda *a: pmesh.shard_columns_call(
        fn, mesh, a, ncol))(*args)
    np.testing.assert_array_equal(np.asarray(up), np.asarray(single.flux_up))
    np.testing.assert_array_equal(np.asarray(dn), np.asarray(single.flux_dn))


def test_shard_columns_call_replicated_argnums_collision():
    """A replicated table whose leading extent EQUALS ncol must not be
    sharded over columns when pinned via replicated_argnums (the shape
    heuristic alone cannot tell it apart from a batch array — e.g. the
    12-point h2o mole-fraction axis vs ncol == 12)."""
    import jax
    import jax.numpy as jnp
    from ecckd_tpu.parallel import mesh as pmesh

    devs = jax.devices()
    n_dev = min(4, len(devs))
    mesh = pmesh.make_column_mesh(devs[:n_dev])
    ncol = 2 * n_dev
    table = jnp.arange(ncol * 3, dtype=jnp.float32).reshape(ncol, 3)
    cols = jnp.linspace(0.0, 1.0, ncol)

    def fn(table, cols):
        # every column reads the FULL table: wrong if the table was split
        return cols[:, None] + jnp.sum(table) + jnp.zeros((cols.shape[0], 1))

    expect = np.asarray(fn(table, cols))
    got = pmesh.shard_columns_call(fn, mesh, (table, cols), ncol,
                                   replicated_argnums=(0,))
    np.testing.assert_array_equal(np.asarray(got), expect)
    # and the heuristic alone WOULD have split it (documented hazard):
    split = pmesh.shard_columns_call(fn, mesh, (table, cols), ncol)
    assert not np.allclose(np.asarray(split), expect), (
        "collision no longer reproduces; revisit the replicated_argnums "
        "rationale")
