"""Weak-scaling harness: chunked million-column runs with output overlap.

BASELINE config 5 / SURVEY.md section 5.8: scale the RFMIP workload to
~1M replicated columns sharded over a device mesh, streaming the broadband
flux outputs back to the host *overlapped* with the next chunk's compute.
The reference has no counterpart (serial Fortran, single address space);
this is the design for the gather/compute-overlap requirement.

How the overlap works (all JAX dispatch is asynchronous):

  for each chunk i:
    1. device_put chunk i inputs        (H2D copy, async)
    2. dispatch the jitted flux step    (compute, async)
    3. copy_to_host_async on outputs    (D2H enqueued behind compute)
    4. drain chunk i-depth on the host  (np.asarray blocks only until
       that chunk's D2H finished — host writing proceeds while the
       device computes chunks i-depth+1 .. i)

With the default depth=2 the device pipeline holds dispatch(i),
compute(i-1) and D2H(i-2) concurrently, so neither a host-side write
nor one D2H round-trip stalls the device (a single-deep pipeline loses
one D2H latency per chunk).  The host never blocks on in-flight
compute.
"""
from __future__ import annotations

import time
from typing import Callable, Iterable, Optional, Sequence, Tuple

import jax
import numpy as np

from jax.sharding import Mesh

from ecckd_tpu.parallel import mesh as pmesh


def place_pytree(tree, mesh: Optional[Mesh], ncol: int, batch_leaf=None):
    """Device-place a pytree: leaves with a leading ``ncol`` axis get column
    sharding over ``mesh`` (replicated otherwise); no mesh = default device.
    Pass ``batch_leaf`` (leaf -> bool) to mark batch leaves explicitly when
    a replicated leaf's leading extent could coincide with ``ncol``."""
    if mesh is None or mesh.devices.size == 1:
        return jax.tree_util.tree_map(jax.device_put, tree)
    col = pmesh.column_sharding(mesh)
    rep = pmesh.replicated(mesh)
    if batch_leaf is None:
        batch_leaf = (lambda x: getattr(x, "ndim", 0) >= 1
                      and x.shape[0] == ncol)

    def put(x):
        x = np.asarray(x) if not hasattr(x, "dtype") else x
        return jax.device_put(x, col if batch_leaf(x) else rep)

    return jax.tree_util.tree_map(put, tree)


def stream_chunks(step: Callable, chunks: Iterable[Tuple[tuple, object]],
                  consume: Optional[Callable] = None,
                  depth: int = 2) -> dict:
    """Run ``step(*args)`` over a stream of pre-placed input chunks with
    device compute overlapped against host-side output consumption.

    Args:
      step: jitted function; returns a pytree of device arrays.
      chunks: iterable of ``(args, meta)``; ``args`` already device-placed
        (see place_pytree) so H2D for chunk i+1 can also overlap.
      consume: ``consume(host_outputs, meta)`` called for every chunk,
        ``depth`` chunks behind the device (the overlap window); order is
        preserved.  None = outputs are fetched (completion-barrier) and
        dropped.
      depth: in-flight chunks behind the drain point.  depth=2 keeps the
        device pipeline (dispatch i, compute i-1, D2H i-2 in transit)
        full while the host waits on chunk i-2's D2H — a single-deep
        pipeline stalls the device for one D2H round-trip per chunk.

    Returns timing metrics: total wall seconds plus a per-phase host
    latency budget — dispatch_s (time inside the async ``step`` calls:
    tracing/arg handling + command issue), d2h_issue_s
    (``copy_to_host_async`` enqueueing), drain_wait_s (blocked waiting
    for D2H bytes) and consume_s (host-side writes) — so a below-compute
    streaming rate can be attributed to a specific pipeline phase.
    """
    t0 = time.perf_counter()
    dispatch_s = d2h_issue_s = drain_wait_s = consume_s = 0.0
    n_chunks = 0
    inflight: list = []  # (outputs, meta), oldest first

    def drain(outs, meta):
        nonlocal drain_wait_s, consume_s
        tw = time.perf_counter()
        host = jax.tree_util.tree_map(np.asarray, outs)  # waits on D2H only
        tc = time.perf_counter()
        drain_wait_s += tc - tw
        if consume is not None:
            consume(host, meta)
        consume_s += time.perf_counter() - tc

    for args, meta in chunks:
        td = time.perf_counter()
        outs = step(*args)
        te = time.perf_counter()
        dispatch_s += te - td
        # Enqueue D2H behind this chunk's compute; does not block.
        jax.tree_util.tree_map(
            lambda x: x.copy_to_host_async() if hasattr(
                x, "copy_to_host_async") else None, outs)
        d2h_issue_s += time.perf_counter() - te
        inflight.append((outs, meta))
        if len(inflight) > max(depth, 0):
            drain(*inflight.pop(0))
        n_chunks += 1
    while inflight:
        drain(*inflight.pop(0))
    return {"wall_s": time.perf_counter() - t0,
            "dispatch_s": dispatch_s, "d2h_issue_s": d2h_issue_s,
            "drain_wait_s": drain_wait_s,
            "consume_s": consume_s, "n_chunks": n_chunks}


def run_weak_scaling(step: Callable, chunk_builder: Callable[[int], tuple],
                     n_chunks: int, chunk_cols: int,
                     mesh: Optional[Mesh] = None,
                     consume: Optional[Callable] = None,
                     warmup: int = 1,
                     chunk_ids: Optional[Sequence] = None,
                     depth: int = 2, batch_leaf=None) -> dict:
    """Chunked weak-scaling run.  Every chunk's output reaches the
    ``consume`` sink exactly once, in order (the invariant the restart
    journal depends on); best-of-N measurement passes belong in the
    caller (cli/scale_bench.py interleaves them with its compute
    reference).

    Args:
      step: jitted flux step taking the chunk args.
      chunk_builder: ``i -> host args tuple`` for chunk i (leading column
        axis = chunk_cols on the batch leaves).
      n_chunks: chunks to stream (total columns = n_chunks * chunk_cols).
      mesh: optional column mesh to shard each chunk over.
      consume: optional host output sink (overlapped; see stream_chunks).
      warmup: untimed pre-run chunks (compile + cache warm).
      chunk_ids: explicit chunk ids to process (restart-at-chunk: pass the
        not-yet-completed subset; defaults to range(n_chunks)).
      depth: in-flight chunks behind the drain point (see stream_chunks).
      batch_leaf: optional leaf -> bool forwarded to place_pytree, for
        chunk args containing replicated leaves whose leading extent
        could coincide with chunk_cols (e.g. model tables).

    Returns metrics incl. columns/s and columns/s/device.
    """
    n_dev = mesh.devices.size if mesh is not None else 1
    ids = list(range(n_chunks)) if chunk_ids is None else list(chunk_ids)

    def placed(i):
        # batch_leaf forwards to place_pytree's escape hatch: without it
        # a replicated leaf (e.g. a model table) whose leading extent
        # happens to equal chunk_cols would be silently column-sharded.
        return place_pytree(chunk_builder(i), mesh, chunk_cols,
                            batch_leaf=batch_leaf)

    if warmup and ids:
        stream_chunks(step, ((placed(ids[i % len(ids)]), None)
                             for i in range(warmup)), depth=depth)
    m = stream_chunks(step, ((placed(i), i) for i in ids),
                      consume=consume, depth=depth)
    total_cols = len(ids) * chunk_cols
    cols_per_sec = total_cols / m["wall_s"]
    return {**m, "total_columns": total_cols, "n_devices": n_dev,
            "columns_per_sec": cols_per_sec,
            "columns_per_sec_per_device": cols_per_sec / n_dev,
            "host_consume_fraction": m["consume_s"] / m["wall_s"]}
