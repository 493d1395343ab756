"""Alignment quality metrics."""

from asm_tpu_torch.metrics.coverage import (
    check_coverage,
    covers,
    long_consecutive_matching_substring,
)
from asm_tpu_torch.metrics.numleaps import num_leaps

__all__ = [
    "long_consecutive_matching_substring",
    "covers",
    "check_coverage",
    "num_leaps",
]
