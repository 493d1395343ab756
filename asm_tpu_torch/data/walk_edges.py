"""Pairs that drive the NW traceback over the long trace kernel's walk
tiles (csrc/nw.cu: 64 x 64 cells) at max_len L > 512, for holding that
kernel against its plain version (tests, chip_smoke phase 18a).

Each pair's path crosses many tile edges, or runs along one:
- a 300-base deletion (the read skips 300 bases of the ref) and a
  300-base insertion, each starting at a multiple of 64, so that the run
  of D moves goes along a tile's bottom row and the run of I moves down a
  tile's last column;
- a read of length 1 against a ref of length L, and the reverse;
- two pairs that differ at every position (a diagonal of X through the
  tiles' corners at m == n, and one beside it);
- lengths m and n at multiples of 64 and one either side, near L and in
  the middle of the range, as copies with 5% substitutions and a few
  single-base indels, and one pair of equal sequences (the main diagonal,
  corner to corner).

Numpy only; deterministic in (L, seed). Not in asm_tpu: the JAX package
has no tiled walk to drive.
"""

from __future__ import annotations

import numpy as np

from asm_tpu_torch.encoding import encode_batch

TILE = 64
GAP = 300


def _mutate(rng, seq, sub=0.05, indels=0):
    """A copy of seq with `sub` substitutions per base and `indels`
    single-base insertions or deletions at random places."""
    out = np.where(rng.random(seq.size) < sub,
                   (seq + rng.integers(1, 4, seq.size)) % 4, seq).tolist()
    for _ in range(indels):
        i = int(rng.integers(0, len(out) + 1))
        if rng.random() < 0.5 and out:
            del out[min(i, len(out) - 1)]
        else:
            out.insert(i, int(rng.integers(0, 4)))
    return np.asarray(out, np.int64)


def walk_edge_pairs(L: int, seed: int = 16):
    """(read codes, read lengths, ref codes, ref lengths) of the pairs
    above at max_len L (L > GAP + 2 * TILE)."""
    rng = np.random.default_rng(seed + L)
    reads, refs = [], []

    def add(read, ref):
        reads.append(read[:L])
        refs.append(ref[:L])

    at = TILE * max(1, (L // 3) // TILE)  # a gap's start: a multiple of 64
    ref = rng.integers(0, 4, L - 8)
    add(_mutate(rng, np.concatenate([ref[:at], ref[at + GAP:]]), 0.02), ref)
    ref = rng.integers(0, 4, L - GAP - 8)
    add(_mutate(rng, np.concatenate([ref[:at], rng.integers(0, 4, GAP),
                                     ref[at:]]), 0.02), ref)
    add(rng.integers(0, 4, 1), rng.integers(0, 4, L))
    add(rng.integers(0, 4, L), rng.integers(0, 4, 1))
    for m, n in ((L, L), (L - 37, L - 5)):
        read = rng.integers(0, 4, m)
        ref = (read[:n] + rng.integers(1, 4, min(m, n))) % 4
        add(read, np.concatenate([ref, rng.integers(0, 4, n - ref.size)]))
    top = TILE * (L // TILE - 1)
    for a, b in ((top, top), (top, TILE * 5), (TILE * 7, top)):
        for da in (-1, 0, 1):
            for db in (-1, 0, 1):
                read = rng.integers(0, 4, a + da)
                ref = _mutate(rng, read, 0.05, 3)
                if ref.size < b + db:
                    ref = np.concatenate([ref, rng.integers(
                        0, 4, b + db - ref.size)])
                add(read, ref[:b + db])
    read = rng.integers(0, 4, top)
    add(read, read.copy())
    as_str = ["".join("ACGT"[c] for c in x) for x in reads]
    return encode_batch(as_str, ["".join("ACGT"[c] for c in x)
                                 for x in refs], L)
