"""The alignment steps on one device and over a mesh of ranks (port of
`asm_tpu.parallel.runner`):

  make_greedy_step       greedy only, on one device (the headline's)
  make_pipeline_step     the evaluation step on one device: NW oracle,
                         greedy cost and LEAP penalty per pair, and the 7
                         corpus counters `unpack_stats` reads
  make_sharded_greedy    greedy on this rank's shard of a mesh
  make_sharded_pipeline  the evaluation step on this rank's shard, its 7
                         counters summed over the mesh (`all_reduce`)

Over a mesh (`parallel.mesh`) each rank runs the one-device step on its
own contiguous slice of the batch. Per-pair outputs stay on their rank,
as they stay sharded in JAX; only the counter vector travels, the
reference's accuracy numbers (benchmark_utils.h:390-402) read from it.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from asm_tpu_torch.config import AlignConfig
from asm_tpu_torch.encoding import PAD_READ, PAD_REF
from asm_tpu_torch.kernels.greedy import greedy_align
from asm_tpu_torch.kernels.greedy_cuda import (
    codes_from_planes_tiled,
    greedy_align_cuda,
)
from asm_tpu_torch.kernels.leap import leap_align
from asm_tpu_torch.kernels.leap_cuda import leap_align_cuda
from asm_tpu_torch.kernels.nw import nw_penalty
from asm_tpu_torch.kernels.nw_band import BWS, nw_penalty_partitioned


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _on_device(step, device):
    """`step` behind a check that every input lies on `device`."""
    def checked(read, read_len, ref, ref_len):
        for t in (read, read_len, ref, ref_len):
            if t.device != device:
                raise ValueError(f"input on {t.device}, step on {device}")
        return step(read, read_len, ref, ref_len)

    return checked


def make_greedy_step(cfg: AlignConfig, device, impl: str = "cuda",
                     pre_staged=False, tile: int = 2048,
                     want_cigar: bool = False):
    """(read, read_len, ref, ref_len) -> greedy result dict, with every
    input already on `device`.

    impl="cuda": `greedy_align_cuda` — the kernel for CUDA tensors, its
    plain version for CPU tensors; returns cost / steps / step_rec (+ the
    CIGAR slots with want_cigar).
    impl="torch": the plain version `kernels.greedy.greedy_align` on any
    device (planes are unpacked to codes first); returns its dict.
    pre_staged: False ([B, L] int8 codes) or "planes_tiled" (tile-major
    planes from `stage_planes_tiled_t(..., tile=tile)`).
    """
    device = _device(device)
    if impl == "cuda":
        def step(read, read_len, ref, ref_len):
            return greedy_align_cuda(read, read_len, ref, ref_len, cfg,
                                     pre_staged=pre_staged, tile=tile,
                                     want_cigar=want_cigar)
    elif impl == "torch":
        def step(read, read_len, ref, ref_len):
            if pre_staged == "planes_tiled":
                read = codes_from_planes_tiled(read, read_len, PAD_READ)
                ref = codes_from_planes_tiled(ref, ref_len, PAD_REF)
            elif pre_staged:
                raise NotImplementedError(f"pre_staged={pre_staged!r}")
            return greedy_align(read, read_len, ref, ref_len, cfg)
    else:
        raise ValueError(f"impl must be 'cuda' or 'torch', got {impl!r}")
    return _on_device(step, device)


@dataclasses.dataclass
class BatchStats:
    """The pipeline's corpus counters (host-side view)."""

    pairs: int
    greedy_correct: int
    leap_correct: int
    leap_passed: int
    nw_penalty_sum: int
    greedy_cost_sum: int
    leap_penalty_sum: int

    @property
    def greedy_accuracy(self) -> float:
        return self.greedy_correct / max(self.pairs, 1)

    @property
    def leap_accuracy(self) -> float:
        return self.leap_correct / max(self.pairs, 1)


def unpack_stats(stats_vec) -> BatchStats:
    return BatchStats(*[int(x) for x in stats_vec])


def make_pipeline_step(cfg: AlignConfig, device, impl: str = "cuda"):
    """(read, read_len, ref, ref_len) int8 codes [B, L] and int32 lengths
    on `device` -> (nw_pen int32[B], greedy_cost int32[B], leap_pen
    int32[B], stats int32[7]); `unpack_stats` reads the 7-vector.

    impl="torch": the plain versions (`nw.nw_penalty`,
    `greedy.greedy_align`, `leap.leap_align`), as the JAX pipeline runs
    the XLA kernels. impl="cuda": the kernels' wrappers — NW through the
    partitioned dispatch (`nw_band.nw_penalty_partitioned` over the band
    widths BWS, the residue to the full kernel), `greedy_align_cuda`
    without CIGAR slots, `leap_align_cuda`; on CPU tensors they run their
    plain versions."""
    device = _device(device)
    if impl == "torch":
        def nw_fn(rc, rl, fc, fl):
            return nw_penalty(rc, rl, fc, fl, cfg.x, cfg.o, cfg.e)

        def greedy_fn(rc, rl, fc, fl):
            return greedy_align(rc, rl, fc, fl, cfg)["cost"]

        def leap_fn(rc, rl, fc, fl):
            return leap_align(rc, rl, fc, fl, cfg)
    elif impl == "cuda":
        def nw_fn(rc, rl, fc, fl):
            pen = nw_penalty_partitioned(rc, rl, fc, fl, x=cfg.x, o=cfg.o,
                                         e=cfg.e, bws=BWS)
            return torch.from_numpy(pen).to(device)

        def greedy_fn(rc, rl, fc, fl):
            return greedy_align_cuda(rc, rl, fc, fl, cfg,
                                     want_cigar=False)["cost"]

        def leap_fn(rc, rl, fc, fl):
            return leap_align_cuda(rc, rl, fc, fl, cfg)
    else:
        raise ValueError(f"impl must be 'cuda' or 'torch', got {impl!r}")

    def step(read, read_len, ref, ref_len):
        nw_pen = nw_fn(read, read_len, ref, ref_len)
        g_cost = greedy_fn(read, read_len, ref, ref_len)
        lp = leap_fn(read, read_len, ref, ref_len)
        l_pen = lp["penalty"]
        i32 = torch.int32
        stats = torch.stack([
            torch.tensor(read.shape[0], dtype=i32, device=device),
            (g_cost == nw_pen).sum(dtype=i32),
            (l_pen == nw_pen).sum(dtype=i32),
            lp["passed"].sum(dtype=i32),
            nw_pen.sum(dtype=i32),
            g_cost.sum(dtype=i32),
            l_pen.sum(dtype=i32),
        ])
        return nw_pen, g_cost, l_pen, stats

    return _on_device(step, device)


def _all_reduce_sum(v: torch.Tensor, mesh) -> torch.Tensor:
    """Sum `v` over the mesh's ranks. gloo reduces a host copy (its CUDA
    support is partial); a one-rank mesh outside a process group is
    itself."""
    if not dist.is_initialized():
        if mesh.size != 1:
            raise RuntimeError(f"a mesh of {mesh.size} ranks needs an "
                               f"initialised process group")
        return v
    if v.is_cuda and dist.get_backend(mesh.group) == "gloo":
        w = v.cpu()
        dist.all_reduce(w, op=dist.ReduceOp.SUM, group=mesh.group)
        return w.to(v.device)
    dist.all_reduce(v, op=dist.ReduceOp.SUM, group=mesh.group)
    return v


def make_sharded_pipeline(mesh, cfg: AlignConfig, impl: str = "cuda"):
    """(read, read_len, ref, ref_len), this rank's shard on the mesh's
    device (`mesh.shard_batch`) -> (nw_pen[b], greedy_cost[b],
    leap_pen[b], stats int32[7]): `make_pipeline_step` on the shard, its
    counter vector summed over every rank of the mesh. Every rank must
    call it, as a collective."""
    step = make_pipeline_step(cfg, mesh.device, impl)

    def sharded(read, read_len, ref, ref_len):
        nw_pen, g_cost, l_pen, stats = step(read, read_len, ref, ref_len)
        return nw_pen, g_cost, l_pen, _all_reduce_sum(stats, mesh)

    return sharded


def make_sharded_greedy(mesh, cfg: AlignConfig, impl: str = "cuda",
                        want_cigar: bool = False, pre_staged=False,
                        tile: int = 2048):
    """`make_greedy_step` on this rank's shard: (read, read_len, ref,
    ref_len) on the mesh's device -> the greedy result dict of the shard.
    pre_staged=False shards int8 codes [B, L] by rows; "planes_tiled"
    shards tile-major planes [B / tile, L / 16, tile] by whole tiles on
    their leading axis (`mesh.shard_on_axis(mesh, planes, 0)`), so the
    global batch must be a multiple of tile x mesh size. Nothing is
    reduced: the per-pair outputs stay on their rank."""
    return make_greedy_step(cfg, mesh.device, impl, pre_staged=pre_staged,
                            tile=tile, want_cigar=want_cigar)
