"""Pairs at the edges of the long NW full kernel's layout (csrc/nw.cu
nw_long_full_kernel) at max_len L > 512, for holding that kernel against
its plain version (tests, chip_smoke phase 18a).

The kernel gives each of a warp's 32 threads a strip of R rows
(shapes.nw_long_rows) in horizontal blocks of RB = 32 R rows
(shapes.nw_blocks of them), parks a block's bottom row for the next, and
splits its step loop into a head (the first 31 steps), a steady loop
(steps 32..n) and a tail. The pairs put:
- the read length m at strip edges (multiples of R and one either side:
  the first strip, the first block's last thread, the last strip below
  L) and at block edges (RB - 1, RB, RB + 1 and the same at 2 RB where
  there are three blocks; e.g. 1023, 1024, 1025 at L = 2048);
- the ref length n where the step loop's parts meet (1, 30, 31, 32, 33:
  below 32 there is no steady loop) and at L;
- m or n at 0, 1 and L, and both at L;
- equal sequences (a path down the main diagonal) and sequences that
  differ at every position.
Each read is random; its ref a copy with 5% substitutions and a few
single-base indels, cut or extended to n, except where stated.

Numpy only; deterministic in (L, seed). Not in asm_tpu: the JAX package
has no row blocks to drive.
"""

from __future__ import annotations

import numpy as np

from asm_tpu_torch.data.walk_edges import _mutate
from asm_tpu_torch.encoding import encode_batch
from asm_tpu_torch.kernels.shapes import NW_LONG_G, nw_blocks, nw_long_rows


def block_edge_lengths(L: int) -> list[tuple[int, int]]:
    """(m, n) of the pairs above at max_len L, before the sequences."""
    R = nw_long_rows(L)
    RB = NW_LONG_G * R
    nb = nw_blocks(L)
    last = (L - 1) // R * R  # the last strip's first row, less one
    ms = {R - 1, R, R + 1, 31 * R - 1, 31 * R, 31 * R + 1,
          last - 1, last, last + 1}
    edges = {b * RB + d for b in range(1, nb) for d in (-1, 0, 1)}
    ms = sorted(v for v in ms | edges if 2 <= v < L)
    ns = (1, 30, 31, 32, 33, L)
    pairs = [(m, ns[i % len(ns)]) for i, m in enumerate(ms)]
    # the block edges and the last strip's again, beside a long ref
    pairs += [(m, L - 3) for m in sorted(edges) + ms[-3:]]
    pairs += [(0, L), (L, 0), (0, 0), (1, L), (L, 1), (L, L), (L, 32),
              (32, L)]
    return pairs


def block_edge_pairs(L: int, seed: int = 18):
    """(read codes, read lengths, ref codes, ref lengths) of the pairs
    above at max_len L; the last two are equal sequences of length L and
    sequences of length L - 7 that differ at every position."""
    rng = np.random.default_rng(seed + L)
    reads, refs = [], []
    for m, n in block_edge_lengths(L):
        read = rng.integers(0, 4, m)
        ref = _mutate(rng, read, 0.05, 3)[:n]
        if ref.size < n:
            ref = np.concatenate([ref, rng.integers(0, 4, n - ref.size)])
        reads.append(read)
        refs.append(ref)
    read = rng.integers(0, 4, L)
    reads.append(read)
    refs.append(read.copy())
    read = rng.integers(0, 4, L - 7)
    reads.append(read)
    refs.append((read + rng.integers(1, 4, read.size)) % 4)
    return encode_batch(["".join("ACGT"[c] for c in x) for x in reads],
                        ["".join("ACGT"[c] for c in x) for x in refs], L)
