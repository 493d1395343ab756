"""The port's mesh and sharded steps (`asm_tpu_torch.parallel`) on the CPU:
the mesh's errors and shards, then a real 2-rank torch.distributed run
(two spawned processes on gloo) of `make_sharded_pipeline` and of
`make_sharded_greedy` on tile-major planes, gathered and held against
asm_tpu: `make_sharded_pipeline` over its one-device mesh per pair and
in the 7 counters (the per-pair check of __graft_entry__.py's
dryrun_multichip), and `kernels.greedy.greedy_align` per pair.

Tolerance: exact (every output is an integer or a CIGAR string)."""

import os
import socket
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from asm_tpu.config import AlignConfig as JaxConfig
from asm_tpu.kernels.greedy import greedy_align as jax_greedy_align
from asm_tpu.ops.cigar import batch_greedy_cigars as jax_cigars
from asm_tpu.parallel import make_mesh as jax_make_mesh
from asm_tpu.parallel import shard_batch as jax_shard_batch
from asm_tpu.parallel.runner import make_sharded_pipeline as jax_pipeline
from asm_tpu_torch.config import AlignConfig
from asm_tpu_torch.data.generator import generate_dataset_arrays
from asm_tpu_torch.ops.cigar import batch_greedy_cigars
from asm_tpu_torch.parallel import (
    Mesh,
    make_mesh,
    make_sharded_pipeline,
    shard_batch,
    shard_on_axis,
    unpack_stats,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = 2
TILE = 128  # one tile per rank
CFG = AlignConfig(x=1, o=1, e=1, k=3)
# variable lengths, so shards differ in their work
CORPUS = dict(num_reads=256, length=100, error_rate=0.12, mismatch_rate=0.8,
              seed=95, length_range=(60, 120))

_RANK = """
import sys
sys.path.insert(0, {repo!r})
import numpy as np
import torch
import torch.distributed as dist
from asm_tpu_torch.config import AlignConfig
from asm_tpu_torch.data.generator import generate_dataset_arrays
from asm_tpu_torch.kernels.greedy_cuda import stage_planes_tiled_t
from asm_tpu_torch.parallel import (initialize_distributed, make_mesh,
    make_sharded_greedy, make_sharded_pipeline, shard_batch, shard_on_axis)

rank, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
initialize_distributed(f"127.0.0.1:{{port}}", {ranks}, rank, backend="gloo")
initialize_distributed(f"127.0.0.1:{{port}}", {ranks}, rank,
                       backend="gloo")  # a second call is a no-op
mesh = make_mesh(device="cpu")
assert (mesh.rank, mesh.size) == (rank, {ranks})
cfg = AlignConfig(x=1, o=1, e=1, k=3)
rc, rl, fc, fl = generate_dataset_arrays(**{corpus!r})
nw, g, l, stats = make_sharded_pipeline(mesh, cfg)(
    *shard_batch(mesh, rc, rl, fc, fl))
planes = [stage_planes_tiled_t(c, tile={tile}) for c in (rc, fc)]
res = make_sharded_greedy(mesh, cfg, want_cigar=True,
                          pre_staged="planes_tiled", tile={tile})(
    shard_on_axis(mesh, planes[0], 0), *shard_batch(mesh, rl),
    shard_on_axis(mesh, planes[1], 0), *shard_batch(mesh, fl))
np.savez(out, nw=nw.numpy(), g=g.numpy(), l=l.numpy(), stats=stats.numpy(),
         cost=res["cost"].numpy(), cigar_ops=res["cigar_ops"].numpy(),
         cigar_runs=res["cigar_runs"].numpy())
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run the 2-rank cluster once; returns each rank's outputs."""
    tmp = tmp_path_factory.mktemp("ranks")
    code = _RANK.format(repo=REPO, ranks=RANKS, corpus=CORPUS, tile=TILE)
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-I", "-c", code, str(r), str(port),
         str(tmp / f"rank{r}.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(RANKS)]
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
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(RANKS)]


def test_two_rank_pipeline_matches_asm_tpu(ranks):
    corpus = generate_dataset_arrays(**CORPUS)
    mesh = jax_make_mesh(1)
    nw, g, l, stats = jax_pipeline(mesh, JaxConfig(x=1, o=1, e=1, k=3))(
        *jax_shard_batch(mesh, *map(jnp.asarray, corpus)))
    want = [int(v) for v in np.asarray(stats)]
    for r in ranks:  # the summed counters reach every rank
        assert r["stats"].tolist() == want
    assert unpack_stats(want).pairs == CORPUS["num_reads"]
    for key, ref in (("nw", nw), ("g", g), ("l", l)):
        got = np.concatenate([r[key] for r in ranks])
        np.testing.assert_array_equal(got, np.asarray(ref), err_msg=key)


def test_two_rank_greedy_planes_tiled_matches_asm_tpu(ranks):
    rc, rl, fc, fl = generate_dataset_arrays(**CORPUS)
    ref = jax_greedy_align(*map(jnp.asarray, (rc, rl, fc, fl)),
                           JaxConfig(x=1, o=1, e=1, k=3))
    np.testing.assert_array_equal(
        np.concatenate([r["cost"] for r in ranks]), np.asarray(ref["cost"]))
    got = [c for r in ranks for c in batch_greedy_cigars(r)]
    assert got == jax_cigars({k: np.asarray(v) for k, v in ref.items()})


def test_make_mesh_errors_and_one_rank_mesh():
    mesh = make_mesh(device="cpu")  # no process group: one rank
    assert (mesh.rank, mesh.size, mesh.device) == (0, 1, torch.device("cpu"))
    with pytest.raises(ValueError):
        make_mesh(n_devices=2, device="cpu")
    # a one-rank mesh's sharded pipeline is the one-device step
    corpus = generate_dataset_arrays(32, 100, 0.10, seed=3)
    *_, stats = make_sharded_pipeline(mesh, CFG)(*shard_batch(mesh,
                                                                 *corpus))
    assert int(stats[0]) == 32


def test_shard_batch_slices_and_errors():
    a = np.arange(24, dtype=np.int32).reshape(6, 4)
    for rank in range(2):
        mesh = Mesh(group=None, rank=rank, size=2, device=torch.device("cpu"))
        (got,) = shard_batch(mesh, a)
        np.testing.assert_array_equal(got.numpy(), a[3 * rank:3 * rank + 3])
        got = shard_on_axis(mesh, a, 1)
        np.testing.assert_array_equal(got.numpy(), a[:, 2 * rank:2 * rank + 2])
    mesh = Mesh(group=None, rank=0, size=4, device=torch.device("cpu"))
    with pytest.raises(ValueError):
        shard_batch(mesh, a)  # 6 rows over 4 ranks
    with pytest.raises(ValueError):
        shard_on_axis(mesh, a.T, 1)
    # a multi-rank mesh without a process group cannot sum its counters
    mesh2 = Mesh(group=None, rank=0, size=2, device=torch.device("cpu"))
    corpus = generate_dataset_arrays(8, 100, 0.10, seed=3)
    with pytest.raises(RuntimeError):
        make_sharded_pipeline(mesh2, CFG)(*shard_batch(mesh2, *corpus))
