"""Scale-out of the alignment steps: batch scheduling, one-device steps
and their sharded forms over a torch.distributed process group (one rank
per process, one device per rank, the batch sharded over the ranks, the
corpus counters summed with `all_reduce`)."""

from asm_tpu_torch.parallel.mesh import (
    Mesh,
    initialize_distributed,
    make_mesh,
    shard_batch,
    shard_on_axis,
)
from asm_tpu_torch.parallel.runner import (
    BatchStats,
    make_greedy_step,
    make_pipeline_step,
    make_sharded_greedy,
    make_sharded_pipeline,
    unpack_stats,
)
from asm_tpu_torch.parallel.schedule import (
    difficulty_order,
    difficulty_proxy,
    inverse_permutation,
    quantized_step_bounds,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "shard_batch",
    "shard_on_axis",
    "initialize_distributed",
    "make_sharded_pipeline",
    "make_sharded_greedy",
    "make_pipeline_step",
    "make_greedy_step",
    "BatchStats",
    "unpack_stats",
    "difficulty_proxy",
    "difficulty_order",
    "quantized_step_bounds",
    "inverse_permutation",
]
