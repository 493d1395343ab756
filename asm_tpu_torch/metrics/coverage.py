"""LCM-coverage quality metric (copy of `asm_tpu.metrics.coverage`).

Faithful port of GASMA/benchmark/benchmark_coverage.h (also prototyped in
pymatch/metrics/coverage.py): the Long Consecutive Matching substring (LCM)
of an alignment is the concatenation of the READ characters consumed by
'M'/'=' runs of length >= threshold; alignment 1 "covers" alignment 2 if
LCM2 is a subsequence of LCM1.

Notable reference quirks kept: 'M' runs count toward the LCM without
verifying the characters actually match (benchmark_coverage.h:51-60 —
greedy's 'M' runs merge matches AND mismatches), and `covers` is a greedy
subsequence scan (benchmark_coverage.h:73-91).

A fast C++ implementation is bound in asm_tpu_torch.native
(`coverage_batch_native`); this module is the pure-Python reference.
"""

from __future__ import annotations

import re

_CIGAR_RE = re.compile(r"(\d+)([A-Za-z=])")


def long_consecutive_matching_substring(
    s1: str, s2: str, cigar: str, threshold: int = 3
) -> str:
    """cf. benchmark_coverage.h:26-67."""
    lcm: list[str] = []
    i1 = 0
    for run_s, op in _CIGAR_RE.findall(cigar):
        run = int(run_s)
        if op == "X":
            i1 += run
        elif op == "I":
            i1 += run
        elif op == "D":
            pass
        elif op in ("=", "M"):
            if run >= threshold:
                lcm.append(s1[i1 : i1 + run])
            i1 += run
    return "".join(lcm)


def covers(s1: str, s2: str) -> bool:
    """True iff s2 is a subsequence of s1 (benchmark_coverage.h:73-91)."""
    n, m = len(s1), len(s2)
    if n < m:
        return False
    i = 0
    for j in range(m):
        if i >= n:
            return False
        while s1[i] != s2[j]:
            i += 1
            if i >= n:
                return False
        i += 1
    return True


def check_coverage(
    s1: str,
    s2: str,
    cigar1: str,
    cigar2: str,
    threshold1: int = 1,
    threshold2: int = 3,
) -> bool:
    """Does alignment 1's LCM cover alignment 2's?
    cf. benchmark::_check_coverage (benchmark_utils.h:214-225); the headline
    benchmark calls this with (greedy CIGAR, NW CIGAR, 1, 3)
    (benchmark_utils.h:256)."""
    lcm1 = long_consecutive_matching_substring(s1, s2, cigar1, threshold1)
    lcm2 = long_consecutive_matching_substring(s1, s2, cigar2, threshold2)
    return covers(lcm1, lcm2)
