"""CIGAR handling: fixed-size device op buffers -> host strings, and a
CIGAR's aligned string pair (copy of `asm_tpu.ops.cigar`, numpy only).

The kernels emit fixed-shape op arrays:
  * greedy: (cigar_ops int8[B, C], cigar_runs int32[B, C], count int32[B])
    in emission order — op codes 3 'I', 4 'D', 5 'M'
    (cf. _update_CIGAR, GASMA/hurdle_matrix.h:238-251);
  * NW traceback: ops int8[B, 2L] in REVERSE alignment order with codes
    1 '=', 2 'X', 3 'I', 4 'D' (parasail-style, what parasail_cigar_decode
    produces for the coverage metric, benchmark_utils.h:115).

Host-side decoding produces the same text format the reference prints.
"""

from __future__ import annotations

import re

import numpy as np

OP_CHARS = {1: "=", 2: "X", 3: "I", 4: "D", 5: "M"}


def runs_to_cigar(ops: np.ndarray, runs: np.ndarray, count: int | None = None) -> str:
    """Greedy-style (op, run) slot buffer -> CIGAR string.

    Slots with run == 0 are empty (the kernel writes fixed slots per step;
    frozen rows write zero runs) and are skipped — matching the reference's
    append-only string (_update_CIGAR emits nothing for zero runs).
    """
    n = len(ops) if count is None else int(count)
    return "".join(
        f"{int(runs[i])}{OP_CHARS[int(ops[i])]}"
        for i in range(n)
        if runs[i] > 0
    )


def ops_to_cigar(ops: np.ndarray, reverse: bool = True) -> str:
    """Per-column op codes (0-padded) -> run-length-encoded CIGAR string.

    reverse=True for NW traceback output (emitted end-to-start).
    """
    ops = np.asarray(ops)
    ops = ops[ops != 0]
    if reverse:
        ops = ops[::-1]
    if ops.size == 0:
        return ""
    out = []
    run_start = 0
    for i in range(1, len(ops) + 1):
        if i == len(ops) or ops[i] != ops[run_start]:
            out.append(f"{i - run_start}{OP_CHARS[int(ops[run_start])]}")
            run_start = i
    return "".join(out)


def batch_greedy_cigars(result: dict) -> list[str]:
    return runs_to_cigars_batch(result["cigar_ops"], result["cigar_runs"])


_OP_LUT = np.array(["?", "=", "X", "I", "D", "M"], dtype="U1")


def runs_to_cigars_batch(ops: np.ndarray, runs: np.ndarray) -> list[str]:
    """Vectorized `runs_to_cigar` over a whole [N, C] slot batch.

    One numpy pass builds every "<run><op>" token (np.nonzero order is
    row-major, i.e. emission order), then each row joins its ~4 tokens —
    ~20x less Python-level work than the per-slot scalar loop at mapper
    scale (100k reads x 66 slots)."""
    ops = np.asarray(ops)
    runs = np.asarray(runs)
    if ops.shape[0] == 0:
        return []
    valid = runs > 0
    tok = np.char.add(runs[valid].astype("U11"), _OP_LUT[ops[valid]])
    bounds = np.cumsum(valid.sum(axis=1))[:-1]
    return ["".join(row) for row in np.split(tok, bounds)]


def batch_nw_cigars(ops: np.ndarray) -> list[str]:
    ops = np.asarray(ops)
    return [ops_to_cigar(ops[b]) for b in range(ops.shape[0])]


def aligned_strings(read: str, ref: str, cigar: str) -> tuple[str, str]:
    """The DISPLAY-style aligned string pair of a CIGAR
    (_update_match, GASMA/hurdle_matrix.h:204-228): an 'I' run consumes
    read characters against '-' in the ref row, a 'D' run the reverse,
    'M' / '=' / 'X' runs one character from each. Returns (read_row,
    ref_row) of equal length; a suffix the CIGAR never reaches is left
    off."""
    if re.fullmatch(r"(?:\d+[MIDX=])*", cigar) is None:
        raise ValueError(f"unrecognized CIGAR syntax or op: {cigar!r}")
    a_row, b_row = [], []
    ai = bi = 0
    for count, op in re.findall(r"(\d+)([MIDX=])", cigar):
        r = int(count)
        if op == "I":
            a_row.append(read[ai:ai + r])
            b_row.append("-" * r)
            ai += r
        elif op == "D":
            a_row.append("-" * r)
            b_row.append(ref[bi:bi + r])
            bi += r
        else:  # M / = / X
            a_row.append(read[ai:ai + r])
            b_row.append(ref[bi:bi + r])
            ai += r
            bi += r
    return "".join(a_row), "".join(b_row)
