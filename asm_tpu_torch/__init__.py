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
    SASS (`python -m asm_tpu_torch.tools.roofline`).
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
)

__all__ = [
    "AlignConfig",
    "AlignmentType",
    "GapPenalty",
    "LeapMode",
    "config_from_jax",
    "encode_batch",
    "encode_string",
    "decode_string",
    "CODE_A",
    "CODE_C",
    "CODE_G",
    "CODE_T",
    "PAD_READ",
    "PAD_REF",
]
