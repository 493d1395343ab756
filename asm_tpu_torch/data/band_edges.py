"""Pairs whose destinations lie at the edges of the NW band's layout, for
holding the band kernel (csrc/nw_band.cu, its wide path above max_len
512 and at BW 128) against its plain version (tests, chip_smoke phase
18a).

The band of BW offsets holds diagonal offset k = i - j at u = k + KB, KB
= BW/2 - 1, and the destination of a pair of lengths (m, n) lies at u =
m - n + KB on diagonal m + n. A thread of the wide path owns 2 NP
adjacent offsets (NP = shapes.band_wide_np(BW, L)). The pairs put the
destination at:
- u = 0, 1, 2, 2 NP - 1, 2 NP, BW - 2 and BW - 1: the band's two edges
  and the first two threads' boundary (at u = 2 on band_kernel's layout
  of one offset pair a thread); u = KB, the main diagonal;
- u = -1 and BW: just off the band (INF, or the closed form of an empty
  read);
each at m + n of both parities: near 2L (m or n equal to L), near L,
with m or n equal to 0 or 1, and at the end of the border trips (m + n
= BW/2 - 1, BW/2 and BW/2 + 1, those of them the offset admits).

Reads are random; a ref is a copy of its read with 5% substitutions, cut
or extended to its length. Numpy only; deterministic in (L, BW, seed).
Not in asm_tpu: the JAX package's band has no thread layout to drive.
"""

from __future__ import annotations

import numpy as np

from asm_tpu_torch.encoding import encode_batch
from asm_tpu_torch.kernels.shapes import band_wide_np


def band_edge_lengths(L: int, bw: int) -> list[tuple[int, int]]:
    """(m, n) of the pairs above at max_len L and band width bw, without
    repeats, in a fixed order."""
    kb = bw // 2 - 1
    two_np = 2 * band_wide_np(bw, L)
    offsets = (0, 1, 2, two_np - 1, two_np, bw - 2, bw - 1, kb, -1, bw)
    out = []
    for u in dict.fromkeys(offsets):
        dk = u - kb  # m - n
        cands = []
        for top in (L, L - 1):  # near 2L, both parities
            cands.append((top, top - dk) if dk >= 0 else (top + dk, top))
        for mid in (L // 2, L // 2 + 1):  # near L
            cands.append((mid + dk, mid))
        for small in (0, 1):  # an empty or one-base sequence
            cands.append((dk + small, small) if dk >= 0 else
                         (small, small - dk))
        for s in (bw // 2 - 1, bw // 2, bw // 2 + 1):  # the borders' end
            if (s + dk) % 2 == 0:
                cands.append(((s + dk) // 2, (s - dk) // 2))
        out += [c for c in cands if 0 <= c[0] <= L and 0 <= c[1] <= L]
    return list(dict.fromkeys(out))


def band_edge_pairs(L: int, bw: int, seed: int = 17):
    """(read codes, read lengths, ref codes, ref lengths) of the pairs
    above at max_len L and band width bw."""
    rng = np.random.default_rng([seed, L, bw])
    reads, refs = [], []
    for m, n in band_edge_lengths(L, bw):
        read = rng.integers(0, 4, m)
        ref = rng.integers(0, 4, n)
        k = min(m, n)
        ref[:k] = np.where(rng.random(k) < 0.05, rng.integers(0, 4, k),
                           read[:k])
        reads.append("".join("ACGT"[c] for c in read))
        refs.append("".join("ACGT"[c] for c in ref))
    return encode_batch(reads, refs, L)
