"""Process group and batch sharding for data-parallel alignment (port of
`asm_tpu.parallel.mesh`).

The workload is embarrassingly parallel over read pairs. The port's
distributed model is one rank per process and one device per rank; the
corpus is sharded on the batch axis over the ranks, each rank holding one
contiguous slice. Penalty parameters are Python statics and each rank's
tables are built from its own shard, so nothing is replicated: the only
collective is the `all_reduce` of scalar statistics
(`parallel.runner.make_sharded_pipeline`).

JAX's `batch_pspec` (a `PartitionSpec`) has no torch counterpart: a
rank's slice is its whole placement.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks a batch is sharded over: this process's rank in `group`
    (None: the default group, or no group at all for a one-rank mesh),
    the group's size and the device this rank computes on."""

    group: object
    rank: int
    size: int
    device: torch.device


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None, *,
                           backend: str | None = None) -> None:
    """Join the process group: `torch.distributed.init_process_group` with
    init method tcp://`coordinator_address` ("host:port"), world size
    `num_processes` and rank `process_id`. `backend` defaults to "nccl"
    where a card is present and to "gloo" otherwise (two ranks that share
    one card must pass "gloo": NCCL refuses two ranks on one GPU). A
    second call is a no-op."""
    if dist.is_initialized():
        return
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("initialize_distributed needs coordinator_address, "
                         "num_processes and process_id (nothing in the "
                         "environment names a cluster)")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def make_mesh(n_devices: int | None = None, device=None) -> Mesh:
    """The mesh of this process: every rank of the initialised process
    group, or a one-rank mesh when no group is initialised. `device`
    (default: cuda:<local rank>; without a card the default raises, so
    a CPU mesh is asked for by name) is where this rank computes.
    `n_devices` larger than the world size raises; smaller is not
    supported, as a rank outside it would have no shard."""
    if dist.is_initialized():
        rank, size = dist.get_rank(), dist.get_world_size()
    else:
        rank, size = 0, 1
    if n_devices is not None:
        if n_devices > size:
            raise ValueError(f"requested {n_devices} devices, have {size}")
        if n_devices < size:
            raise ValueError(f"a mesh spans every rank: requested "
                             f"{n_devices} of {size}")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh's default device is the rank's "
                               "card and there is none; pass device='cpu' "
                               "for a CPU mesh")
        device = torch.device("cuda", rank % torch.cuda.device_count())
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return Mesh(group=None, rank=rank, size=size, device=device)


def shard_on_axis(mesh: Mesh, array, axis_index: int) -> torch.Tensor:
    """This rank's contiguous slice of `array` (a host array of the global
    batch) along dimension `axis_index`, as a tensor on the mesh's
    device. The dimension must divide by the mesh size."""
    a = np.asarray(array)
    n = a.shape[axis_index]
    if n % mesh.size != 0:
        raise ValueError(f"dim {axis_index} of {a.shape} not divisible by "
                         f"mesh size {mesh.size}")
    per = n // mesh.size
    part = np.take(a, np.arange(mesh.rank * per, (mesh.rank + 1) * per),
                   axis=axis_index)
    return torch.from_numpy(np.ascontiguousarray(part)).to(mesh.device)


def shard_batch(mesh: Mesh, *arrays) -> tuple[torch.Tensor, ...]:
    """This rank's contiguous slice of each global array's leading (batch)
    axis, on the mesh's device. Every batch must divide by the mesh size:
    pad the corpus to a multiple first."""
    for a in arrays:
        if np.shape(a)[0] % mesh.size != 0:
            raise ValueError(f"batch {np.shape(a)[0]} not divisible by mesh "
                             f"size {mesh.size}")
    return tuple(shard_on_axis(mesh, a, 0) for a in arrays)
