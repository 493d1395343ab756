"""The least time an H100 needs for a job's work: the larger of its integer
operations over the card's issue rate and its bytes over its memory rate.

Frozen here so that the yardstick stays put when the program's kernels,
widths or launches change. The work is counted from the pairs and from
the answers of the reference semantics (steps, energy levels,
penalties), never from what the program launched. Operations are the
fewest integer instructions each recurrence needs, one that fuses two
operations (Hopper's DPX add-min) counted once. Bytes are each input byte
read once (the int8 codes of read and reference, the two int32 lengths)
and each output byte that the job returns written once.

INT32_OPS_PER_S: 132 SMs x 4 schedulers, one 32-lane instruction a clock
each, at 1980 MHz (the H100 SXM's integer issue limit at its full 700 W).
HBM_BYTES_PER_S: its 3.35 TB/s.
"""

from __future__ import annotations

import numpy as np

INT32_OPS_PER_S = 132 * 4 * 32 * 1.98e9
HBM_BYTES_PER_S = 3.35e12

# a Gotoh cell in issue slots: H + o + e once (IADD); E and F one DPX
# add-min each; the substitution (ISETP + SEL); H = min(H_diag + sub, E,
# F) (add-min + min)
GOTOH_CELL_OPS = 7
def bound_seconds(ops: float, nbytes: float) -> tuple[float, str]:
    """(least seconds, "operations" or "bytes": which bound it)."""
    t_ops = ops / INT32_OPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def greedy_work(steps, k: int, L: int) -> tuple[float, float]:
    """Greedy (GASMA hurdle matrix) over pairs whose walks took `steps`.
    Per pair, for each of the 2k+1 lanes and W = L/32 words: the hurdle
    row (shift, XOR, OR: 4) and its denoise (two shifts, OR, AND: 4). Per
    step, for each lane: per word the highway query (4) and two popcount
    windows (3 each), and 12 for the highway's ends, the switch penalty,
    the selection and the choice. Above W = 16 a step's queries need only
    the word that holds their start: per lane 10 + 12. Bytes: the codes
    2L, lengths 8, cost and steps 8."""
    NL, W = 2 * k + 1, L // 32
    QW = 1 if W > 16 else W
    n = len(steps)
    ops = n * NL * W * 8 + float(np.sum(steps, dtype=np.int64)) * NL * (
        10 * QW + 12)
    return float(ops), float(n * (2 * L + 16))


def leap_work(passed, penalty, k: int, L: int, af: int) -> tuple[float, float]:
    """LEAP, lv_bag, over pairs with these answers. A pair runs its e = 0
    row and one row a level up to its pass energy (af when it does not
    pass). Per pair the 2k+1 interior lane rows, 4 ops per lane and word
    (shift, XOR, OR); per row 16 per lane (I, D and start 3 each,
    count_ID 5, convergence 2). Bytes: the codes 2L, lengths 8, passed 1,
    penalty and lane_shift 8."""
    NI, W = 2 * k + 1, L // 32
    n = len(passed)
    levels = np.where(np.asarray(passed, bool),
                      np.asarray(penalty, np.int64), af)
    rows = n + float(np.sum(levels))
    return float(n * NI * W * 4 + rows * NI * 16), float(n * (2 * L + 17))


def band_cells(m, n, bw: int) -> np.ndarray:
    """Cells (i, j), 1 <= i <= m, 1 <= j <= n, whose offset k = i - j lies
    in the band [1 - BW/2, BW/2], per pair of lengths (broadcast)."""
    m, n = np.asarray(m, np.int64), np.asarray(n, np.int64)
    out = np.zeros(np.broadcast(m, n).shape, np.int64)
    for k in range(1 - bw // 2, bw // 2 + 1):
        out += np.maximum(np.minimum(n, m - k) - max(1, 1 - k) + 1, 0)
    return out


def gap_floor(k, d, o: int, e: int) -> np.ndarray:
    """The least gap cost of a global path from offset 0 (i - j at the
    start) through offset k to offset d (at the end): it moves |k| + |d -
    k| offsets in gap runs, one run where k lies between 0 and d (none
    where k = d = 0) and two otherwise, and a run of g characters costs o
    + (g - 1) min(o, e) at the least."""
    k, d = np.asarray(k, np.int64), np.asarray(d, np.int64)
    moves = np.abs(k) + np.abs(d - k)
    runs = np.where(moves == 0, 0, np.where(
        (np.minimum(0, d) <= k) & (k <= np.maximum(0, d)), 1, 2))
    return runs * o + (moves - runs) * min(o, e)


def nw_cells(m, n, penalty, o: int, e: int) -> np.ndarray:
    """The Gotoh cells an exact penalty needs at the least: those whose
    offset i - j a path of that penalty can reach, i.e. where gap_floor
    is at most the pair's exact penalty. Every path of that penalty lies
    in them, so a DP over them alone gets the penalty exactly, and a
    narrower one could miss it. With no gap cost to bound the offsets
    (min(o, e) = 0), m x n."""
    m, n = np.asarray(m, np.int64), np.asarray(n, np.int64)
    pen = np.asarray(penalty, np.int64)
    m, n, pen = np.broadcast_arrays(m, n, pen)
    if min(o, e) <= 0 or m.size == 0:
        return m * n
    d = m - n
    reach = int(pen.max()) // min(o, e) + int(np.abs(d).max()) + 1
    cells = np.zeros(m.shape, np.int64)
    for k in range(-reach, reach + 1):
        rows = np.maximum(np.minimum(n, m - k) - max(1, 1 - k) + 1, 0)
        cells += np.where(gap_floor(k, d, o, e) <= pen, rows, 0)
    return cells


def nw_work(m, n, penalty, o: int, e: int, L: int) -> tuple[float, float]:
    """Exact NW penalties: GOTOH_CELL_OPS a cell of `nw_cells`. Bytes: the
    codes 2L, lengths 8, penalty 4."""
    cells = float(np.sum(nw_cells(m, n, penalty, o, e)))
    return GOTOH_CELL_OPS * cells, float(len(m) * (2 * L + 12))
