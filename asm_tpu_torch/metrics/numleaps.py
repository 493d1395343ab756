"""Leap-count metric (copy of `asm_tpu.metrics.numleaps`, itself a port of
pymatch/metrics/numLeaps.py:1-13).

Counts gap OPENINGS in an alignment: positions where a '-' run starts in
either aligned string (the prototype counts transitions into '-')."""

from __future__ import annotations

import re

_CIGAR_RE = re.compile(r"(\d+)([A-Za-z=])")


def num_leaps(cigar: str) -> int:
    """Number of I/D runs in a CIGAR (each run = one leap/gap opening)."""
    return sum(1 for _, op in _CIGAR_RE.findall(cigar) if op in ("I", "D"))


def num_leaps_aligned(a1: str, a2: str) -> int:
    """pymatch-style: count '-' run starts in two aligned strings."""
    count = 0
    for s in (a1, a2):
        prev = None
        for ch in s:
            if ch == "-" and prev != "-":
                count += 1
            prev = ch
    return count
