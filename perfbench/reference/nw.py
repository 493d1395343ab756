"""Plain Gotoh global alignment penalty, the reference of the `nw` job.

A mismatch costs x, a gap of g characters o + (g - 1) e, and the penalty
of a pair is the least total over all global alignments of its read
(length m) and reference (length n). The matrix is swept row by row
(row i = read position i), each row vectorised over the batch and the
reference positions:

  F[i][j] = min(F[i-1][j] + e, H[i-1][j] + o)          gap in the reference
  D[i][j] = min(H[i-1][j-1] + x [a_i != b_j], F[i][j])
  E[i][j] = min over j' < j of D[i][j'] + o + (j - j' - 1) min(o, e)
  H[i][j] = min(D[i][j], E[i][j])                      gap in the read

with the borders H[0][j] = o + (j - 1) e, H[i][0] = o + (i - 1) e and
H[0][0] = 0. E is the standard recurrence E[i][j] = min(E[i][j-1] + e,
H[i][j-1] + o) unrolled into one running minimum over the row. `band`
= (lo, hi) keeps only the cells with lo <= i - j <= hi: a banded penalty
taken without its certificate, which is the control of a run (PERF.md),
never the reference.

Imports torch only.
"""

from __future__ import annotations

import torch

INF = 1 << 29


def penalty(read, read_len, ref, ref_len, x=1, o=1, e=1,
            band: tuple[int, int] | None = None) -> torch.Tensor:
    """int32[B] penalties of int8 code rows read/ref [B, L] (codes past a
    length are ignored) with int32 lengths, on their device."""
    B, L = read.shape
    dev = read.device
    i32 = torch.int32
    m = read_len.to(dev, torch.int64)
    n = ref_len.to(dev, torch.int64)
    out = torch.where(n == 0, 0, o + (n - 1) * e).to(i32)  # m == 0
    if B == 0:
        return out
    jj = torch.arange(L + 1, device=dev, dtype=torch.int64)
    ext = min(o, e)
    h = torch.where(jj == 0, 0, o + (jj - 1) * e).to(i32).expand(B, L + 1)
    f = torch.full((B, L + 1), INF, dtype=i32, device=dev)
    a = read.to(i32)
    b = ref.to(i32)
    m_max = int(m.max())
    for i in range(1, m_max + 1):
        f = torch.minimum(f + e, h + o)
        mis = (a[:, i - 1:i] != b).to(i32)
        d = torch.minimum(h[:, :-1] + x * mis, f[:, 1:])
        border = torch.full((B, 1), o + (i - 1) * e, dtype=i32, device=dev)
        d = torch.cat([border, d], dim=1)
        # E[j] = o + (j - 1) ext + min_{j' < j} (D[j'] - j' ext)
        run = torch.cummin(d - (jj * ext).to(i32), dim=1).values
        e_row = torch.cat([torch.full((B, 1), INF, dtype=i32, device=dev),
                           run[:, :-1] + o + ((jj[1:] - 1) * ext).to(i32)],
                          dim=1)
        h = torch.minimum(d, e_row).clamp(max=INF)
        if band is not None:
            h = torch.where((i - jj >= band[0]) & (i - jj <= band[1]), h, INF)
        f = f.clamp(max=INF)
        at = torch.gather(h, 1, n.clamp(max=L)[:, None])[:, 0]
        out = torch.where(m == i, at, out)
    return out


def reference(read, read_len, ref, ref_len, config: dict) -> dict:
    """The exact penalty."""
    return {"penalty": penalty(read, read_len, ref, ref_len, config["x"],
                               config["o"], config["e"])}


def control(read, read_len, ref, ref_len, config: dict) -> dict:
    """The exactness broken: the penalty inside the narrowest band the
    program dispatches (BW 8, offsets i - j in [-3, 4]), taken without
    its certificate."""
    return {"penalty": penalty(read, read_len, ref, ref_len, config["x"],
                               config["o"], config["e"], band=(-3, 4))}
