"""Weak-scaling harness tests on the 8-virtual-device CPU mesh.

Checks the chunked, overlapped streaming path (parallel/scale.py) is
numerically identical to the single-shot pipeline and that every chunk's
output reaches the host sink exactly once, in order (SURVEY.md section 5.8).
"""
import numpy as np
import jax

from conftest import RFMIP_VMRS, make_atmosphere
from ecckd_tpu.gases import GasConcs
from ecckd_tpu.models.loader import load_ckd_model
from ecckd_tpu.parallel import mesh as pmesh
from ecckd_tpu.parallel.scale import place_pytree, run_weak_scaling
from ecckd_tpu.pipeline import lw_fluxes


def _batch(ncol, nlay, seed):
    atm = make_atmosphere(ncol=ncol, nlay=nlay, seed=seed)
    concs = GasConcs.create({"h2o": atm["h2o"], "o3": atm["o3"],
                             **RFMIP_VMRS})
    emis = np.full(ncol, 0.97)
    return (atm["plev"], atm["tlay"], atm["tlev"], atm["tsfc"], emis, concs)


def test_chunked_stream_matches_single_shot(ckd_paths):
    model = load_ckd_model(ckd_paths["lw_fsck"], dtype=np.float64)
    mesh = pmesh.make_column_mesh()
    assert mesh.devices.size == 8
    nlay, chunk, n_chunks = 12, 16, 4
    chunks = [_batch(chunk, nlay, seed=100 + i) for i in range(n_chunks)]

    model_dev = place_pytree(model, mesh, -1)

    @jax.jit
    def step(m, plev, tlay, tlev, tsfc, emis, concs):
        f = lw_fluxes(m, plev, tlay, tlev, tsfc, emis, concs,
                      n_gauss_angles=1)
        return (f.flux_up, f.flux_dn)

    seen = []

    def consume(host_outs, i):
        seen.append((i, host_outs))

    metrics = run_weak_scaling(
        step, lambda i: (model_dev,) + chunks[i], n_chunks, chunk,
        mesh=mesh, consume=consume, warmup=1)

    assert metrics["n_chunks"] == n_chunks
    assert metrics["n_devices"] == 8
    assert metrics["total_columns"] == chunk * n_chunks
    assert [i for i, _ in seen] == list(range(n_chunks))

    # Bitwise match per chunk against the same jitted step, unsharded and
    # unstreamed (sharded-vs-single-device equivalence of the *program* is
    # covered separately in test_sharding.py).
    for i, (up, dn) in seen:
        ref_up, ref_dn = step(model, *chunks[i])
        np.testing.assert_array_equal(up, np.asarray(ref_up))
        np.testing.assert_array_equal(dn, np.asarray(ref_dn))


def test_scale_bench_cli(tmp_path):
    """The scale_bench driver runs end-to-end (tiny sizes) and its memmap
    outputs are finite with every chunk slot filled."""
    from ecckd_tpu.cli import scale_bench
    rc = scale_bench.main(["--columns", "64", "--chunk", "16",
                           "--nlay", "8", "--out-dir", str(tmp_path)])
    assert rc == 0
    for name in ("rlu", "rld", "rsu", "rsd"):
        arr = np.load(tmp_path / f"{name}.npy")
        assert arr.shape == (64, 9)
        assert np.isfinite(arr).all()
    # Downwelling LW at TOA is zero; upwelling LW at TOA is positive.
    rld = np.load(tmp_path / "rld.npy")
    rlu = np.load(tmp_path / "rlu.npy")
    np.testing.assert_allclose(rld[:, 0], 0.0, atol=1e-6)
    assert (rlu[:, 0] > 50.0).all()


def test_scale_bench_resume(tmp_path):
    """Restart-at-chunk (SURVEY section 5.4): a partially completed run's
    progress journal makes --resume skip finished chunks and fill only the
    remainder."""
    import json
    from ecckd_tpu.cli import scale_bench
    out = tmp_path / "flx"
    rc = scale_bench.main(["--columns", "64", "--chunk", "16",
                           "--nlay", "8", "--out-dir", str(out)])
    assert rc == 0
    prog = json.loads((out / "progress.json").read_text())
    assert prog["done"] == [0, 1, 2, 3]
    full = np.load(out / "rlu.npy").copy()

    # Simulate an interrupted run: pretend chunks 2,3 never completed and
    # zero their output rows.
    (out / "progress.json").write_text(json.dumps({"done": [0, 1]}))
    arr = np.lib.format.open_memmap(out / "rlu.npy", mode="r+")
    arr[32:] = 0.0
    arr.flush()
    del arr

    rc = scale_bench.main(["--columns", "64", "--chunk", "16",
                           "--nlay", "8", "--out-dir", str(out),
                           "--resume"])
    assert rc == 0
    prog = json.loads((out / "progress.json").read_text())
    assert prog["done"] == [0, 1, 2, 3]
    resumed = np.load(out / "rlu.npy")
    np.testing.assert_array_equal(resumed, full)


def test_driver_metrics_and_validate(ckd_paths, tmp_path):
    """--metrics-json writes a throughput/sanity record; --validate accepts
    physical inputs and rejects unphysical ones."""
    import json
    from ecckd_tpu.cli import ecckd_rfmip_lw
    from ecckd_tpu.io.rfmip import write_synthetic_rfmip
    rf = str(tmp_path / "rfmip.nc")
    write_synthetic_rfmip(rf, nsite=4, nlay=12, nexp=1, seed=3)
    mpath = str(tmp_path / "metrics.json")
    rc = ecckd_rfmip_lw.main([rf, ckd_paths["lw_fsck"], "--output-dir",
                              str(tmp_path),
                              "--metrics-json", mpath, "--validate"])
    assert rc == 0
    m = json.loads(open(mpath).read())
    assert m["columns"] == 4 and m["all_finite"]
    assert m["columns_per_sec"] > 0
    assert m["driver"] == "lw" and m["n_quad_angles"] == 1


def test_stream_chunks_depth_semantics():
    """stream_chunks must drain every chunk exactly once, in order, at
    every pipeline depth, hold at most ``depth`` chunks in flight behind
    the drain point, and report the per-phase latency budget keys."""
    from ecckd_tpu.parallel.scale import stream_chunks

    for depth in (1, 2, 3, 7):
        inflight = {"now": 0, "max": 0}
        drained = []

        def step(i):
            inflight["now"] += 1
            inflight["max"] = max(inflight["max"], inflight["now"])
            return {"val": np.full((4,), float(i)), "id": np.int32(i)}

        def consume(host, meta):
            inflight["now"] -= 1
            assert float(host["val"][0]) == float(meta)
            drained.append(int(meta))

        n = 5
        m = stream_chunks(step, (((i,), i) for i in range(n)),
                          consume=consume, depth=depth)
        assert drained == list(range(n)), (depth, drained)
        assert m["n_chunks"] == n
        # At most depth+1 chunks can be live at once (the one being
        # dispatched plus depth waiting behind the drain point).
        assert inflight["max"] <= depth + 1, (depth, inflight["max"])
        for key in ("dispatch_s", "d2h_issue_s", "drain_wait_s",
                    "consume_s", "wall_s"):
            assert key in m


def test_place_pytree_batch_leaf_hatch():
    """A replicated leaf whose leading extent collides with the chunk size
    must stay replicated when the caller marks batch leaves explicitly —
    the scale_bench hazard: its chunk args bundle the model pytrees, whose
    log_pressure/temperature leaves have leading extent n_p=53 and would
    match the default shape[0]==ncol heuristic at --chunk 53 (round-5
    review fix: scale_bench now passes an id-based batch_leaf)."""
    mesh = pmesh.make_column_mesh()
    ncol = 16
    model_like = {"log_pressure": np.arange(ncol, dtype=np.float32),
                  "table": np.ones((ncol, 4), np.float32)}
    batch = {"tlay": np.ones((ncol, 8), np.float32)}
    model_ids = {id(v) for v in model_like.values()}

    def batch_leaf(x):
        return (id(x) not in model_ids
                and getattr(x, "ndim", 0) >= 1 and x.shape[0] == ncol)

    m, b = place_pytree((model_like, batch), mesh, ncol,
                        batch_leaf=batch_leaf)
    col = pmesh.column_sharding(mesh)
    rep = pmesh.replicated(mesh)
    assert b["tlay"].sharding.is_equivalent_to(col, b["tlay"].ndim)
    for v in m.values():
        assert v.sharding.is_equivalent_to(rep, v.ndim)
    # The default heuristic DOES column-shard the colliding model leaf —
    # the escape hatch is load-bearing, not redundant.
    m_def, _ = place_pytree((model_like, batch), mesh, ncol)
    assert m_def["table"].sharding.is_equivalent_to(col, 2)
