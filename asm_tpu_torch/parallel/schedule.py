"""Difficulty-aware batch scheduling (copy of `asm_tpu.parallel.schedule`).

The greedy kernel gives each pair one thread, and a warp runs until its
slowest pair converges. Ordering the corpus by a difficulty proxy groups
pairs of similar step count into the same warp (and chunk), so easy warps
exit after a few steps. Per-pair results are unchanged, only their order.

The proxy: adjacent mismatch pairs on lane 0 — mismatch-only pairs count
their >= 2-wide clusters (isolated mismatches are denoised away), indel
pairs mismatch almost everywhere past the first indel.
"""

from __future__ import annotations

import numpy as np

from asm_tpu_torch.native import load_native


def difficulty_proxy(read_codes, read_len, ref_codes, ref_len) -> np.ndarray:
    """int32[B] monotone-ish proxy for per-pair greedy step count."""
    rc = np.asarray(read_codes)
    fc = np.asarray(ref_codes)
    d = rc != fc  # pads (4 vs 5) mismatch, matching kernel semantics
    return (d[:, 1:] & d[:, :-1]).sum(axis=1, dtype=np.int32)


def difficulty_order(read_codes, read_len, ref_codes, ref_len) -> np.ndarray:
    """Permutation that sorts the batch easy -> hard (stable); the native
    parallel counting sort is bit-identical to the numpy stable argsort."""
    rc = np.ascontiguousarray(read_codes)
    fc = np.ascontiguousarray(ref_codes)
    if (rc.dtype == np.int8 and fc.dtype == np.int8 and rc.ndim == 2
            and rc.shape == fc.shape):
        lib = load_native()
        if lib is not None:
            perm = np.empty(rc.shape[0], np.int64)
            lib.asm_difficulty_sort(rc, fc, rc.shape[0], rc.shape[1],
                                    perm, 0)
            return perm
    return np.argsort(
        difficulty_proxy(read_codes, read_len, ref_codes, ref_len),
        kind="stable",
    )


def inverse_permutation(perm: np.ndarray) -> np.ndarray:
    """inv with inv[perm[i]] = i — maps sorted-order results back."""
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size, dtype=perm.dtype)
    return inv


def quantized_step_bounds(steps: np.ndarray, chunk: int,
                          slack: int = 2, floor: int = 4) -> list[int]:
    """Per-chunk loop bounds from measured per-pair step counts (already
    in sorted order), rounded up to powers of two. Each bound strictly
    exceeds its chunk's measured max (+`slack` before rounding), so the
    truncation check still holds; a trailing partial chunk gets its own
    bound."""
    n_chunks = -(-len(steps) // chunk)
    return [
        max(floor,
            1 << int(steps[i * chunk:(i + 1) * chunk].max() + slack - 1)
            .bit_length())
        for i in range(n_chunks)
    ]
