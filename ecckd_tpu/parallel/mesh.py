"""Device mesh and column sharding.

The physics is column-independent (no cross-column term anywhere in the
reference, rte-ecckd/src/gas_optics_ecckd.f90:117-240), so the single
parallel strategy is *data parallelism over the column axis*: a 1-D named
mesh ``("columns",)``, every (ncol, ...) array sharded on axis 0, lookup
tables replicated (they are <= ~3 MB).  XLA
inserts no collectives in the flux computation itself; only diagnostics
(max-error, throughput counters) reduce across devices.

Multi-host: ``jax.distributed.initialize`` + the same NamedSharding spans
hosts transparently; each host feeds its local shard of columns
(make_array_from_process_local_data).
"""
from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

COLUMNS = "columns"


def make_column_mesh(devices: Optional[list] = None) -> Mesh:
    """1-D mesh over all (or the given) devices."""
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (COLUMNS,))


def column_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for arrays with a leading column axis."""
    return NamedSharding(mesh, P(COLUMNS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def pad_columns(n: int, n_shards: int) -> int:
    """Columns must divide evenly over shards; pad with replicated work
    (cheaper than ragged shards; padded outputs are dropped)."""
    return (n + n_shards - 1) // n_shards * n_shards


def pad_to_mesh(a: np.ndarray, n_dev: int) -> np.ndarray:
    """Edge-replicate the leading (column) axis up to the mesh multiple —
    THE single definition of the batch padding rule.  Every per-column
    input of one jitted call must go through this same rule (a second
    hand-written copy that diverges produces mismatched batch extents
    and a shape error at trace time)."""
    target = pad_columns(a.shape[0], n_dev)
    if target != a.shape[0]:
        pad = [(0, target - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
        a = np.pad(a, pad, mode="edge")
    return a


def shard_batch(arrays, mesh: Mesh):
    """Place every array (leading axis = columns) with column sharding.

    Pads the column axis by edge-replication if it does not divide the mesh.
    Returns (placed_arrays, original_ncol).
    """
    spec = column_sharding(mesh)
    n_dev = mesh.devices.size
    placed = []
    ncol = None
    for a in arrays:
        a = np.asarray(a)
        if ncol is None:
            ncol = a.shape[0]
        placed.append(jax.device_put(pad_to_mesh(a, n_dev), spec))
    return placed, ncol


def shard_columns_call(fn, mesh: Mesh, args, ncol: int, batch_leaf=None,
                       replicated_argnums=()):
    """Run ``fn(*args)`` as an SPMD program over the columns mesh.

    By default every pytree leaf whose leading axis equals ``ncol`` is
    split over the ``columns`` axis; everything else (lookup tables,
    scalars) is replicated.  Pass ``batch_leaf`` (leaf -> bool) to mark
    batch leaves explicitly, or ``replicated_argnums`` (positions into
    ``args``) to force whole subtrees replicated — REQUIRED when passing
    a model pytree whose table leaves could have a leading extent equal
    to ``ncol`` (e.g. a 12-point h2o mole-fraction axis vs ncol == 12):
    the heuristic would silently shard such a table over columns.  Each
    device runs ``fn`` on its column shard as a per-device program; no
    collectives are needed because the physics is column-independent.

    ``ncol`` must divide the mesh size (see shard_batch / pad_columns).
    Outputs must have a leading column axis.
    """
    if batch_leaf is None:
        batch_leaf = (lambda x: hasattr(x, "ndim") and x.ndim >= 1
                      and x.shape[0] == ncol)

    def spec_of(x):
        return P(COLUMNS) if batch_leaf(x) else P()

    if replicated_argnums:
        rep = frozenset(replicated_argnums)
        in_specs = tuple(
            jax.tree_util.tree_map((lambda x: P()) if i in rep else spec_of,
                                   a)
            for i, a in enumerate(args))
    else:
        in_specs = jax.tree_util.tree_map(spec_of, args)
    # check_vma off: scan carries built from replicated inputs (e.g. the
    # zero TOA incidence) trip the varying-manual-axes checker even though
    # the program is valid per-shard.
    wrapped = jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                            out_specs=P(COLUMNS), check_vma=False)
    return wrapped(*args)


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Multi-process SPMD initialization (one process per host).  No-op
    when single-process (the common CI / single-device case)."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)
