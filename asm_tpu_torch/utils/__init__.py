"""Profiling and counters, host memory, corpus cache and build helpers."""

from asm_tpu_torch.utils.corpus_cache import load_corpus, save_corpus
from asm_tpu_torch.utils.profiling import (
    KernelStats,
    Timer,
    force_completion,
    trace_to,
)

__all__ = [
    "Timer",
    "KernelStats",
    "trace_to",
    "force_completion",
    "save_corpus",
    "load_corpus",
]
