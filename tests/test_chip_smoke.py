"""chip_smoke.py and bench.py: they refuse to run without a GPU, the
trace reduction they print, and (on a card, with the ``gpu`` marker) the
whole smoke run."""
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest

from ecckd_tpu.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(argv, cwd, env_update):
    """``python argv`` in ``cwd``; ``env_update`` values of None unset."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "XLA_FLAGS")}
    env.update(env_update)
    env = {k: v for k, v in env.items() if v is not None}
    return subprocess.run([sys.executable] + argv, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _json_lines(stdout):
    return [ln for ln in stdout.splitlines() if ln.startswith("{")]


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_refuses_to_run_on_cpu(script):
    r = _run([script], REPO, {"JAX_PLATFORMS": "cpu"})
    assert r.returncode != 0
    assert "needs an NVIDIA GPU" in r.stderr
    assert not _json_lines(r.stdout)


def test_smoke_fails_without_the_repository(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(["chip_smoke.py"], str(tmp_path), {"JAX_PLATFORMS": "cpu"})
    assert r.returncode != 0
    assert "ModuleNotFoundError" in r.stderr
    assert not _json_lines(r.stdout)


TRACE = '''
planes {
  id: 1 name: "/device:GPU:0"
  lines { id: 1 name: "XLA Ops" timestamp_ns: 100
    events { metadata_id: 1 offset_ps: 0 duration_ps: 3000000 }
    events { metadata_id: 2 offset_ps: 4000000 duration_ps: 1000000 }
    events { metadata_id: 1 offset_ps: 6000000 duration_ps: 2000000 }
    events { metadata_id: 3 offset_ps: 9000000 duration_ps: 500000 } }
  lines { id: 2 name: "XLA Modules" timestamp_ns: 100
    events { metadata_id: 4 offset_ps: 0 duration_ps: 9500000 } }
  event_metadata { key: 1 value { id: 1 name: "fusion.1" } }
  event_metadata { key: 2 value { id: 2 name: "gather.2" } }
  event_metadata { key: 3 value { id: 3 name: "copy.3" } }
  event_metadata { key: 4 value { id: 4 name: "jit_step" } }
}
planes {
  id: 2 name: "/device:GPU:1"
  lines { id: 1 name: "Stream #13(Compute)" timestamp_ns: 100
    events { metadata_id: 1 offset_ps: 0 duration_ps: 4500000 } }
  event_metadata { key: 1 value { id: 1 name: "gather.2" } }
}
planes {
  id: 3 name: "/host:CPU"
  lines { id: 1 name: "python" timestamp_ns: 100
    events { metadata_id: 1 offset_ps: 0 duration_ps: 99000000 } }
  event_metadata { key: 1 value { id: 1 name: "host_work" } }
}
'''


def test_top_device_ops_from_recorded_trace():
    """Ops are summed over the "XLA Ops" line (or, where a plane has none,
    its Stream lines) of every device plane; module spans and host
    planes are not device ops."""
    top = profiling.top_device_ops(
        jax.profiler.ProfileData.from_text_proto(TRACE), n=2)
    assert [(n, round(s * 1e6, 3), c) for n, s, c in top] == [
        ("gather.2", 5.5, 2), ("fusion.1", 5.0, 2)]
    every = profiling.top_device_ops(
        jax.profiler.ProfileData.from_text_proto(TRACE), n=None)
    assert [n for n, _, _ in every] == ["gather.2", "fusion.1", "copy.3"]


def test_top_device_ops_rejects_host_only_trace():
    host_only = TRACE[TRACE.index("planes {\n  id: 3"):]
    with pytest.raises(ValueError, match="no device operations"):
        profiling.top_device_ops(
            jax.profiler.ProfileData.from_text_proto(host_only))


def test_compile_counter_and_timer():
    counter = profiling.CompileCounter()
    f = jax.jit(lambda x: jnp.cos(x) * 3.0 + 1.0)
    x = jnp.arange(7.0)
    seconds = profiling.time_fn(f, x, iters=3, warmup=1)
    compiled = counter.count
    assert compiled >= 1 and seconds > 0.0
    profiling.time_fn(f, x, iters=3, warmup=0)
    assert counter.count == compiled
    f(jnp.arange(9.0))                      # a new shape compiles again
    assert counter.count > compiled


@pytest.mark.gpu
def test_chip_smoke_on_gpu(gpu_card):
    """The whole smoke run on the card: run with ``python -m pytest -m gpu
    tests/test_chip_smoke.py`` on a machine with an NVIDIA GPU."""
    r = _run(["chip_smoke.py"], REPO, {"JAX_PLATFORMS": None})
    assert r.returncode == 0, r.stderr[-4000:]
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last["ok"] and last["device"]["platform"] == "gpu"
