"""Device-side full-corpus coverage (port of
`asm_tpu.metrics.coverage_device`, plus the harness's coverage loop).

The reference computes, for every pair, whether the greedy alignment's
LCM (long consecutive matches, threshold 1) covers the NW alignment's LCM
(threshold 3) (benchmark_utils.h:256-258). Both LCM strings are
subsequences of the READ, so each is described by a read-position mask:
the greedy one from the (op, run) slots (`greedy_match_mask`), the NW one
from the trace kernel's traceback (`nw_align_cuda(...,
match_mask_threshold=3)`). If the NW mask is a positional subset of the
greedy mask, the pair is covered (`positional_covered`, sound, no false
positives); the remainder takes the exact character-based check, in C++
(`native.coverage_batch_native`) or, without the native library, in
Python (`metrics.coverage.check_coverage`).
"""

from __future__ import annotations

import numpy as np
import torch

from asm_tpu_torch.config import AlignConfig
from asm_tpu_torch.encoding import decode_string
from asm_tpu_torch.kernels.greedy import greedy_align
from asm_tpu_torch.kernels.greedy_cuda import greedy_align_cuda
from asm_tpu_torch.kernels.nw import nw_align
from asm_tpu_torch.kernels.nw_cuda import nw_align_cuda
from asm_tpu_torch.metrics.coverage import check_coverage
from asm_tpu_torch.native import coverage_batch_native, load_native
from asm_tpu_torch.ops.cigar import batch_greedy_cigars, batch_nw_cigars

OP_M = 5
OP_I = 3


def greedy_match_mask(cigar_ops, cigar_runs, L: int,
                      threshold: int = 1) -> torch.Tensor:
    """bool[B, L]: read positions inside greedy 'M' runs of length >=
    threshold. cigar_ops/cigar_runs: the greedy slot buffers [B, C]
    (empty slots have run 0); 'I' leaps and 'M' runs consume the read,
    'D' leaps only the ref. The read cursor only advances, so the marked
    runs are disjoint and one +1/-1 difference array per pair marks them
    all."""
    B, C = cigar_ops.shape
    ops = cigar_ops.to(torch.int64)
    runs = cigar_runs.to(torch.int64)
    is_m = (ops == OP_M) & (runs > 0)
    consumes = torch.where(is_m | (ops == OP_I), runs, 0)
    start = torch.cumsum(consumes, dim=1) - consumes  # cursor before slot
    mark = (is_m & (runs >= threshold)).to(torch.int32)
    diff = torch.zeros((B, L + 1), dtype=torch.int32, device=ops.device)
    diff.scatter_add_(1, start.clamp(max=L), mark)
    diff.scatter_add_(1, (start + runs).clamp(max=L), -mark)
    return torch.cumsum(diff[:, :L], dim=1) > 0


def positional_covered(greedy_mask, nw_mask) -> torch.Tensor:
    """bool[B]: True where the NW LCM positions are a subset of the greedy
    LCM positions (a sound certificate for covers() == True)."""
    return ~torch.any(nw_mask & ~greedy_mask, dim=1)


def coverage_counts(read_codes, read_len, ref_codes, ref_len,
                    cfg: AlignConfig, coverage_sample: int | None = None,
                    chunk: int = 1 << 17, device="cuda",
                    impl: str = "cuda") -> dict:
    """The harness's coverage loop (asm_tpu/bench/harness.py:247-334) on
    a host corpus (int8 codes [B, L], int32 lengths): in chunks of at most
    8192 pairs, NW with traceback and match mask through the trace kernel,
    greedy CIGAR slots through the greedy kernel, the positional
    certificate on the device, and the exact check for the pairs it
    leaves open. impl="torch" runs the plain versions (`nw.nw_align`,
    `greedy.greedy_align`) in place of the kernels' wrappers.

    Returns covered (pairs whose greedy LCM covers the NW LCM), checked
    (pairs examined: all, or the first `coverage_sample`), certified (of
    them, by the positional certificate alone) and greedy_equal_nw (pairs
    whose greedy cost equals the NW penalty)."""
    if impl == "cuda":
        nw_fn, greedy_fn = nw_align_cuda, greedy_align_cuda
    elif impl == "torch":
        nw_fn, greedy_fn = nw_align, greedy_align
    else:
        raise ValueError(f"impl must be 'cuda' or 'torch', got {impl!r}")
    B = read_len.shape[0]
    checked = B if coverage_sample is None else min(coverage_sample, B)
    L = read_codes.shape[1]
    align_chunk = max(1, min(chunk, 1 << 13, checked))
    native_ok = load_native() is not None
    covered = certified = equal = 0
    for i in range(0, checked, align_chunk):
        j = min(i + align_chunk, checked)
        rc, rl = read_codes[i:j], read_len[i:j]
        fc, fl = ref_codes[i:j], ref_len[i:j]
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
                for a in (rc, rl, fc, fl)]
        pen, nw_ops, nw_mask = nw_fn(
            *args, x=cfg.x, o=cfg.o, e=cfg.e, match_mask_threshold=3)
        g = greedy_fn(*args, cfg)
        g_mask = greedy_match_mask(g["cigar_ops"], g["cigar_runs"], L, 1)
        cert = positional_covered(g_mask, nw_mask).cpu().numpy()
        equal += int((g["cost"] == pen).sum())
        certified += int(cert.sum())
        rest = np.nonzero(~cert)[0]
        if rest.size == 0:
            continue
        # exact character-based covers() for the uncertified few
        nw_cols = nw_ops.cpu().numpy()[rest]
        g_ops = g["cigar_ops"].cpu().numpy()[rest]
        g_runs = g["cigar_runs"].cpu().numpy()[rest]
        if native_ok:
            covered += int(coverage_batch_native(
                rc[rest], rl[rest], g_ops, g_runs, nw_cols, 1, 3).sum())
        else:
            nw_cigars = batch_nw_cigars(nw_cols)
            g_cigars = batch_greedy_cigars({"cigar_ops": g_ops,
                                            "cigar_runs": g_runs})
            for bi, b in enumerate(rest):
                s1 = decode_string(rc[b], int(rl[b]))
                s2 = decode_string(fc[b], int(fl[b]))
                covered += check_coverage(s1, s2, g_cigars[bi],
                                          nw_cigars[bi], 1, 3)
    return dict(covered=covered + certified, checked=checked,
                certified=certified, greedy_equal_nw=equal)
