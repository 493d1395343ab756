"""Pair-file IO in the reference's format (copy of `asm_tpu.data.io`).

Format: alternating lines `>READ` / `<REF` (one char sigil then the
sequence), cf. Dataset::output (benchmark_dataset.h:225-235) and
benchmark::read_string_file (benchmark_utils.h:325-352, which simply skips
the first character of each line).
"""

from __future__ import annotations

import os


def write_pair_file(path: str, reads: list[str], refs: list[str]) -> None:
    with open(path, "w") as f:
        for r, t in zip(reads, refs):
            f.write(f">{r}\n<{t}\n")


def read_pair_file(
    path: str, max_tests: int | None = None, skip_first_char: bool = True
) -> tuple[list[str], list[str]]:
    reads: list[str] = []
    refs: list[str] = []
    with open(path) as f:
        while max_tests is None or len(reads) < max_tests:
            line1 = f.readline()
            if not line1:
                break
            line2 = f.readline()
            if not line2:
                break
            s = 1 if skip_first_char else 0
            reads.append(line1[s:].rstrip("\n"))
            refs.append(line2[s:].rstrip("\n"))
    return reads, refs


def read_answer_file(path: str, max_tests: int | None = None) -> list[int]:
    """Optimal-penalty answer file (one int per line),
    cf. benchmark::read_answer_file (benchmark_utils.h:358-368)."""
    out: list[int] = []
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            if max_tests is not None and len(out) >= max_tests:
                break
            out.append(int(line.strip() or 0))
    return out
