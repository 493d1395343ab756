"""Single-device greedy step (port of
`asm_tpu.parallel.runner.make_sharded_greedy`, one GPU; the multi-device
half waits for the torch.distributed slice)."""

from __future__ import annotations

import torch

from asm_tpu_torch.config import AlignConfig
from asm_tpu_torch.encoding import PAD_READ, PAD_REF
from asm_tpu_torch.kernels.greedy import greedy_align
from asm_tpu_torch.kernels.greedy_cuda import (
    codes_from_planes_tiled,
    greedy_align_cuda,
)


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
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
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

    def checked(read, read_len, ref, ref_len):
        for t in (read, read_len, ref, ref_len):
            if t.device != device:
                raise ValueError(f"input on {t.device}, step on {device}")
        return step(read, read_len, ref, ref_len)

    return checked
