"""The least time an H100 could take for each ported kernel's work: the
larger of its integer operations over the card's integer issue rate and
its bytes over its memory rate.

INT32_OPS_PER_S is the H100 SXM's issue limit for 32-bit integer work:
132 SMs x 4 schedulers, each issuing one 32-lane instruction per clock, at
1980 MHz, the SM clock sampled under load (PERF.md section 5). An add /
logic mix reaches it, since ptxas spreads such work over the ALU pipe and
the FMA pipe (the issue chain, PERF.md section 3); the INT32 pipe alone
(64 lanes per SM) would give half the rate and a bound that a kernel can
beat.
HBM_BYTES_PER_S is the card's 3.35 TB/s. Bytes count each input read once
and each output written once. Operations are counted on one basis for every
kernel: the fewest integer operations the recurrence itself needs per
unit of the work the data needs (the *_work functions: steps a pair
takes, band and DP cells, energy levels), with no index clamps, borders,
address math or float operations, and not the most the data could need.
No single PyTorch call computes any of these functions, so there is no
library time to set beside them.
"""

from __future__ import annotations

import numpy as np

INT32_OPS_PER_S = 132 * 4 * 32 * 1.98e9
HBM_BYTES_PER_S = 3.35e12

# per Gotoh cell: E = max(E - e, H - o - e) and F likewise (3 each), the
# substitution (compare the codes, select x or 0, add: 3), H = max of three
# (2)
GOTOH_CELL_OPS = 11


def bound_entry(ops: float, nbytes: float) -> dict:
    """bound_ms / bound_by of (ops, bytes); library_ms is null (no single
    PyTorch call computes the function)."""
    t_ops = ops / INT32_OPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return dict(bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                library_ms=None)


def greedy_work(steps, bounds, chunk, k=3, L=128) -> tuple[float, float]:
    """csrc/greedy.cu. Per pair, for each of the 2k+1 lanes and W = L/32
    words: the hurdle row (shift, XOR, OR: 4) and its denoise (two shifts,
    OR, AND: 4). Per step (the pair's own count), for each lane: per word
    the highway query (OR the start mask, add, AND, find the first set
    bit: 4) and two popcount windows (AND, popcount, add: 3 each), and 12
    for the highway's start, end and clamp (4), the switch penalty (2),
    the selection compare (2) and the choice test (4). Bytes: 2 x L/4 of
    planes, 8 of lengths, 8 of cost and steps, and each chunk's (T+1)
    int16 records."""
    NL, W = 2 * k + 1, L // 32
    n = len(steps)
    ops = n * NL * W * 8 + float(np.sum(steps)) * NL * (10 * W + 12)
    rec = sum(min(chunk, n - i * chunk) * (b + 1) * 2
              for i, b in enumerate(bounds))
    return ops, n * (2 * (L // 4) + 16) + rec


def nw_band_work(lens_sum, bands, L=128) -> tuple[float, float]:
    """csrc/nw_band.cu: BW Gotoh cells per pair on each of its m+n
    diagonals, GOTOH_CELL_OPS each. Bytes: 2 x L/4 of planes, 8 of
    lengths, 4 of penalty per pair."""
    cells = float(np.sum(bands.astype(np.int64) * lens_sum))
    return GOTOH_CELL_OPS * cells, len(bands) * (2 * (L // 4) + 12)


def nw_full_work(m, n, L=128, trace=False) -> tuple[float, float]:
    """csrc/nw.cu: the m x n Gotoh cells, GOTOH_CELL_OPS each; with the
    trace 4 more per cell for the pointer byte (which of the three gave
    H: 2 compares; whether E and F opened: 2) and 3 per step of the m+n
    traceback (read the op, step i or j, emit). Bytes: 2L of codes, 8 of
    lengths, 4 of penalty; with the trace 2L of ops and L of mask."""
    cells = float(np.sum(m.astype(np.int64) * n))
    if not trace:
        return GOTOH_CELL_OPS * cells, len(m) * (2 * L + 12)
    return ((GOTOH_CELL_OPS + 4) * cells + 3.0 * float(np.sum(m + n)),
            len(m) * (5 * L + 12))


def leap_levels(passed, penalty, lane_shift, af: int,
                semantics: str = "lv_bag") -> np.ndarray:
    """Energy levels past e = 0 that each pair ran, read from its outputs
    (GLOBAL or SEMI_FREE_BEGIN mode). lv_bag: its pass energy, af when it
    did not pass. simd_ed_lev: a gated pair (not passed, penalty 0) none;
    else the stop level, its penalty e + |lane_shift| less the shift, at
    most af (a pair that never converged reports af + 1)."""
    passed = np.asarray(passed, dtype=bool)
    pen = np.asarray(penalty, dtype=np.int64)
    if semantics == "lv_bag":
        return np.where(passed, pen, af)
    if semantics != "simd_ed_lev":
        raise ValueError(f"no level count for semantics {semantics!r}")
    ran = np.minimum(pen - np.abs(np.asarray(lane_shift, np.int64)), af)
    return np.where(~passed & (pen == 0), 0, ran)


def leap_work(n_pairs: int, level_rows: int, k=3, L=128, record_rows=0,
              walk_steps=0, gate=False) -> tuple[float, float]:
    """csrc/leap.cu: per pair the 2k+1 interior lane rows, 4 ops per lane
    and word (shift, XOR, OR); per wavefront row computed (the e = 0 row of
    every pair and each level a pair runs, `leap_levels`: `level_rows` in
    all) 16 per lane: I, D and start 3 each, count_ID 5 (mask, AND, ctz,
    add, min) and convergence 2; the SHD gate 5 per lane and word + 8 per
    word; the CIGAR walk 20 per step. Bytes: 2 x L/4 of planes, 8 of
    lengths and 9 of outputs per pair, 4 per record row of each pair."""
    NI, W = 2 * k + 1, L // 32
    ops = n_pairs * NI * W * 4 + level_rows * NI * 16 + 20 * walk_steps
    if gate:
        ops += n_pairs * W * (5 * NI + 8)
    return float(ops), float(n_pairs * (2 * (L // 4) + 17) + 4 * record_rows)
