"""Known-origin read simulation for mapper quality evaluation (a copy of
`asm_tpu.mapper.simulate`: the same draws in the same order, so a seeded
generator gives the same reads, origins and error counts).

The biological fault injector at genome scale: reads sampled at recorded
origins with per-base mismatch/insert/delete injection at the reference's
real-data profile rates (SRR611076: ~2.45% mismatch, ~0.047% insert,
~0.055% delete — reference README.md:73-76). Origins + per-read injected
error counts let recall be scored exactly (asm_tpu_torch/tools/mapper_eval.py,
tests/test_torch_mapper.py).
"""

from __future__ import annotations

import numpy as np


def sample_reads(genome, n_reads, rlen, rng, mis=0.0245, ins=0.00047,
                 dele=0.00055, max_len=128):
    """Returns (reads int8[n,max_len] 4-padded, lens, origins, nerr)."""
    n = genome.shape[0]
    # genome slack past the read must absorb every deletion: mean + 6
    # sigma of the geometric-ish deletion count (floor 8 keeps the
    # historical layout at the default ~0.055% rate); a read that still
    # exhausts its slice (possible only at extreme injected rates) is
    # resampled at a fresh origin rather than read out of bounds
    mean_del = rlen * dele / max(1e-9, 1.0 - dele)
    slack = max(8, int(np.ceil(mean_del + 6.0 * np.sqrt(mean_del))))
    origins = rng.integers(0, n - rlen - slack, size=n_reads)
    reads = np.full((n_reads, max_len), 4, np.int8)
    lens = np.full(n_reads, rlen, np.int32)
    nerr = np.zeros(n_reads, np.int32)
    for i in range(n_reads):
        while True:
            s = origins[i]
            src = genome[s: s + rlen + slack]
            out = []
            j = 0
            ne = 0
            while len(out) < rlen and j < src.shape[0]:
                r = rng.random()
                if r < dele:
                    j += 1  # deletion: skip a genome base
                    ne += 1
                    continue
                if r < dele + ins:
                    out.append(int(rng.integers(0, 4)))  # insertion
                    ne += 1
                    continue
                b = int(src[j])
                if r < dele + ins + mis:
                    b = (b + 1 + int(rng.integers(0, 3))) % 4  # mismatch
                    ne += 1
                out.append(b)
                j += 1
            if len(out) == rlen:
                break
            origins[i] = rng.integers(0, n - rlen - slack)
        reads[i, :rlen] = out[:rlen]
        nerr[i] = ne
    return reads, lens, origins, nerr
