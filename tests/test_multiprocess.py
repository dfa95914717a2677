"""Multi-PROCESS (multi-host model) SPMD execution of the flux pipeline.

SURVEY section 5.8 / parallel/mesh.py claim: `jax.distributed.initialize`
+ the same column NamedSharding span hosts transparently, each host
feeding its local shard (jax.make_array_from_process_local_data).  This
test actually runs it: two coordinator-connected processes, each with two
virtual CPU devices (a 4-device global mesh), execute ONE global jitted
LW flux solve on per-process input shards, and every process checks its
addressable output shards bitwise against a single-process reference.

This is the closest a single machine gets to the multi-host leg of
BASELINE config 5 (the multi-process launch on GPUs, one process per card,
has not run yet); the program — GSPMD partitioning, process-local feeding,
global jit — is the multi-host program.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r'''
import os, sys
sys.path.insert(0, os.environ["ECCKD_REPO"])
pid = int(os.environ["ECCKD_MP_PID"])
nproc = int(os.environ["ECCKD_MP_NPROC"])
port = os.environ["ECCKD_MP_PORT"]
# Replace (not append) any inherited device-count flag: the parent
# pytest process carries --xla_force_host_platform_device_count=8 from
# tests/conftest.py, and duplicated flags rely on last-wins parsing.
flags = [f for f in os.environ.get("XLA_FLAGS", "").split()
         if "xla_force_host_platform_device_count" not in f]
os.environ["XLA_FLAGS"] = " ".join(
    flags + ["--xla_force_host_platform_device_count=2"])
import jax
jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                           num_processes=nproc, process_id=pid)
assert jax.device_count() == 2 * nproc, jax.devices()

import numpy as np
from ecckd_tpu.gases import GasConcs
from ecckd_tpu.models.loader import load_ckd_model
from ecckd_tpu.parallel import mesh as pmesh
from ecckd_tpu.pipeline import lw_fluxes

model = load_ckd_model(os.environ["ECCKD_MP_LW_FILE"],
                       dtype=np.dtype(np.float32))

# Identical global batch in every process (same seed).
ncol, nlay = 4 * nproc, 16
rng = np.random.default_rng(7)
plev = np.sort(np.exp(rng.uniform(np.log(40.0), np.log(1.01e5),
                                  (ncol, nlay + 1))), axis=1).astype(np.float32)
tlay = rng.uniform(200, 310, (ncol, nlay)).astype(np.float32)
tlev = rng.uniform(200, 310, (ncol, nlay + 1)).astype(np.float32)
tsfc = rng.uniform(250, 320, ncol).astype(np.float32)
emis = np.linspace(0.8, 1.0, ncol).astype(np.float32)
h2o = (10.0 ** rng.uniform(-6, -2, (ncol, nlay))).astype(np.float32)
co2 = np.full(ncol, 4e-4, np.float32)

# Single-process reference on plain host arrays (no sharding) — jitted,
# like the distributed leg, so both sides are XLA-compiled programs (the
# eager reference differed by ~2e-7: op-by-op dispatch vs fused fma).
concs_ref = GasConcs.create([("h2o", h2o), ("co2", co2)])
ref = jax.jit(lambda *a: lw_fluxes(model, *a))(
    plev, tlay, tlev, tsfc, emis, concs_ref)
ref_up = np.asarray(ref.flux_up)
ref_dn = np.asarray(ref.flux_dn)

# Distributed leg: global mesh over all processes' devices; each process
# feeds ONLY its local rows.
mesh = pmesh.make_column_mesh()
col = pmesh.column_sharding(mesh)
lo, hi = pid * 4, (pid + 1) * 4
feed = lambda a: jax.make_array_from_process_local_data(col, a[lo:hi])
concs = GasConcs.create([("h2o", feed(h2o)), ("co2", feed(co2))])
out = jax.jit(lambda *a: lw_fluxes(model, *a))(
    feed(plev), feed(tlay), feed(tlev), feed(tsfc), feed(emis), concs)
jax.block_until_ready(out)

# Check every addressable shard bitwise against the reference rows.
for name, garr, refa in (("up", out.flux_up, ref_up),
                         ("dn", out.flux_dn, ref_dn)):
    for shard in garr.addressable_shards:
        rows = shard.index[0]
        np.testing.assert_array_equal(np.asarray(shard.data),
                                      refa[rows], err_msg=name)

print(f"MP_OK p{pid}", flush=True)
'''


def _launch(port: int, nproc: int, lw_file: str):
    procs = []
    for pid in range(nproc):
        env = dict(os.environ, ECCKD_REPO=REPO, ECCKD_MP_PID=str(pid),
                   ECCKD_MP_NPROC=str(nproc), ECCKD_MP_PORT=str(port),
                   ECCKD_MP_LW_FILE=lw_file)
        # A fresh interpreter per process: the parent's initialized JAX
        # backend (8 virtual devices, no coordinator) must not leak in.
        procs.append(subprocess.Popen(
            [sys.executable, "-c", WORKER], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        return [(p, p.communicate(timeout=900)[0]) for p in procs]
    finally:
        # A deadlocked worker (e.g. jax.distributed.initialize waiting on
        # a dead peer) raises TimeoutExpired above; without this, BOTH
        # children would outlive the test holding the coordinator port
        # and CPU, and the retry would stack two more alongside them.
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.mark.filterwarnings("ignore")
def test_two_process_spmd_flux_pipeline(ckd_paths):
    nproc = 2
    # Bind-then-close port picking has a TOCTOU window (another process can
    # grab the port before the coordinator binds it); retry the whole
    # launch once on a coordinator-bind-shaped failure.
    for attempt in range(2):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        results = _launch(port, nproc, ckd_paths["lw_fsck"])
        failed = [(pid, p, out) for pid, (p, out) in enumerate(results)
                  if p.returncode != 0 or f"MP_OK p{pid}" not in out]
        if not failed:
            return
        bind_race = any("address already in use" in out.lower()
                        or "failed to bind" in out.lower()
                        for _, _, out in failed)
        if not (bind_race and attempt == 0):
            pid, p, out = failed[0]
            assert False, f"process {pid} failed:\n{out[-3000:]}"
