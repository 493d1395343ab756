"""asm_tpu_torch — the PyTorch / CUDA port of asm_tpu.

A second package beside the JAX one, laid out like it (each module has
its counterpart at the same path in asm_tpu/). It imports torch and
numpy, never jax and never asm_tpu. Its kernels are hand-written CUDA
for Hopper (sm_90a), built from asm_tpu_torch/csrc at first use; each has
a plain PyTorch version beside it, which its wrapper runs for tensors
that lie on the CPU.

Ported paths:
  * the greedy headline: corpus -> difficulty sort -> tile-major 2-bit
    planes -> the greedy kernel (`python -m asm_tpu_torch.headline`);
  * the exact NW oracle: measured bands -> band-major plan -> the band
    kernel, with the full kernel for the band-0 residue
    (`python -m asm_tpu_torch.nw_headline`), and NW with traceback for the
    coverage metric (`metrics.coverage_device.coverage_counts`);
  * LEAP in its three modes (`python -m asm_tpu_torch.leap_headline`) and
    the LEAP filter CLI (`python -m asm_tpu_torch.apps.leap_filter`);
  * the three-way harness over NW, LEAP and greedy
    (`python -m asm_tpu_torch.bench`) and the roofline tool, which
    measures the card's issue and stream rates and counts the kernels'
    SASS (`python -m asm_tpu_torch.tools.roofline`);
  * the read mapper (`python -m asm_tpu_torch.mapper`), long sequences
    (max_len 256 and 512) and profile-profile alignment
    (`kernels.msa.profile_align`, eager tensor ops);
  * the evaluation pipeline over a torch.distributed process group
    (`parallel.make_sharded_pipeline`,
    `python -m asm_tpu_torch.parallel.multihost_demo`), the demo
    (`python -m asm_tpu_torch.apps.demo`) and profiling
    (`utils.profiling`).

The exports below are the counterparts of asm_tpu's: each Pallas entry
point maps to its CUDA wrapper (`greedy_align_pallas` ->
`greedy_align_cuda`, `nw_align_pallas` -> `nw_align_cuda`,
`nw_penalty_pallas` -> `nw_penalty_cuda`, `leap_align_pallas` ->
`leap_align_cuda`); `nw_penalty_auto` has none (`nw_penalty_partitioned`
covers it). Importing the package builds nothing.
"""

from asm_tpu_torch.config import (
    AlignConfig,
    AlignmentType,
    GapPenalty,
    LeapMode,
    config_from_jax,
)
from asm_tpu_torch.encoding import (
    CODE_A,
    CODE_C,
    CODE_G,
    CODE_T,
    PAD_READ,
    PAD_REF,
    decode_string,
    encode_batch,
    encode_string,
    pack_bitplanes,
)
from asm_tpu_torch.kernels.greedy import greedy_align
from asm_tpu_torch.kernels.greedy_cuda import greedy_align_cuda
from asm_tpu_torch.kernels.leap import leap_align
from asm_tpu_torch.kernels.leap_cuda import leap_align_cuda, leap_cigar_auto
from asm_tpu_torch.kernels.msa import profile_align, profiles_from_alignments
from asm_tpu_torch.kernels.nw import nw_align, nw_penalty
from asm_tpu_torch.kernels.nw_band import nw_penalty_partitioned, required_band
from asm_tpu_torch.kernels.nw_cuda import nw_align_cuda, nw_penalty_cuda
from asm_tpu_torch.kernels.shd import shd_filter

__all__ = [
    "AlignConfig",
    "AlignmentType",
    "GapPenalty",
    "LeapMode",
    "config_from_jax",
    "encode_batch",
    "encode_string",
    "decode_string",
    "pack_bitplanes",
    "nw_align",
    "nw_penalty",
    "nw_align_cuda",
    "nw_penalty_cuda",
    "nw_penalty_partitioned",
    "required_band",
    "greedy_align",
    "greedy_align_cuda",
    "leap_align",
    "leap_align_cuda",
    "leap_cigar_auto",
    "shd_filter",
    "profile_align",
    "profiles_from_alignments",
    "CODE_A",
    "CODE_C",
    "CODE_G",
    "CODE_T",
    "PAD_READ",
    "PAD_REF",
]
