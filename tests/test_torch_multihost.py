"""The port's multi-process demo for real (mirror of tests/test_multihost.py):
two `python -m asm_tpu_torch.parallel.multihost_demo` processes join one
torch.distributed group on gloo over localhost, each runs the sharded
pipeline on its half of the seeded corpus, and both must report the
summed counters of asm_tpu's pipeline on the whole corpus
(`generate_dataset_arrays(256, 100, 0.10, 0.96, seed=77)`, one-device
mesh).

Tolerance: exact (integer counters)."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import jax.numpy as jnp

from asm_tpu.config import AlignConfig
from asm_tpu.data.generator import generate_dataset_arrays
from asm_tpu.parallel import make_mesh, shard_batch
from asm_tpu.parallel.runner import make_sharded_pipeline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_distributed_pipeline(tmp_path):
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = (REPO + os.pathsep + env["PYTHONPATH"]
                         if env.get("PYTHONPATH") else REPO)
    outs = [tmp_path / f"stats{pid}.json" for pid in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "asm_tpu_torch.parallel.multihost_demo",
         "--process-id", str(pid), "--num-processes", "2",
         "--port", str(port), "--out", str(out), "--device", "cpu",
         "--reps", "1"],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid, out in enumerate(outs)]
    try:
        logs = [p.communicate(timeout=300)[0].decode(errors="replace")
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]

    results = [json.loads(o.read_text()) for o in outs]
    for pid, r in enumerate(results):
        assert r["process_id"] == pid
        assert r["process_count"] == r["global_devices"] == 2
        assert r["local_devices"] == 1
        assert r["device"] == "cpu"
        assert r["pairs_global"] == 256
        assert len(r["rep_seconds"]) == 1
    assert results[0]["stats"] == results[1]["stats"]

    corpus = generate_dataset_arrays(256, 100, 0.10, 0.96, seed=77)
    mesh = make_mesh(1)
    pipeline = make_sharded_pipeline(mesh, AlignConfig(x=1, o=1, e=1, k=3))
    *_, stats_vec = pipeline(*shard_batch(mesh, *map(jnp.asarray, corpus)))
    want = [int(v) for v in np.asarray(stats_vec)]
    assert results[0]["stats"] == want
    assert results[0]["greedy_accuracy"] == want[1] / want[0]
    assert results[0]["leap_accuracy"] == want[2] / want[0]
