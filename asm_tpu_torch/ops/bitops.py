"""Vectorised replacements for the reference's bit-parallel primitives
(port of `asm_tpu.ops.bitops`).

Rows are tensors [.., L], bit/position p at index p. The reference's
per-step register scans become per-row scan tables built once, so every
query is a gather:

  next_one_index / next_zero_index : [.., L+1] first set / unset index
      >= p (a reverse cummin — every tzcnt query, GASMA/utils.h:168-191)
  prefix_count : [.., L+1] cumulative popcount; pop_count_between(f, t)
      is cum[t] - cum[f] (GASMA/utils.h:263-270)

Shifts (the reference's names are inverted: x86 "left" moves bits away
from position 0):

  shift_toward_0(x, s)[p] = x[p+s]   == reference shift_left  (utils.h:143)
  shift_away_0(x, s)[p]   = x[p-s]   == reference shift_right (utils.h:131)
"""

from __future__ import annotations

import torch


def shift_toward_0(x: torch.Tensor, s: int, fill=0) -> torch.Tensor:
    """out[p] = x[p+s]; positions past the end filled with `fill`."""
    if s == 0:
        return x
    pad = torch.full(x.shape[:-1] + (s,), fill, dtype=x.dtype, device=x.device)
    return torch.cat([x[..., s:], pad], dim=-1)


def shift_away_0(x: torch.Tensor, s: int, fill=0) -> torch.Tensor:
    """out[p] = x[p-s]; positions before 0 filled with `fill`."""
    if s == 0:
        return x
    pad = torch.full(x.shape[:-1] + (s,), fill, dtype=x.dtype, device=x.device)
    return torch.cat([pad, x[..., :-s]], dim=-1)


def flip_short_hurdles(h: torch.Tensor, threshold: int = 1) -> torch.Tensor:
    """Drop isolated hurdles: a 1 at p survives only if a neighbour within
    `threshold` positions is also 1 (zeros shifted in at the boundaries),
    GASMA/utils.h:200-216."""
    near = shift_toward_0(h, 1) | shift_away_0(h, 1)
    if threshold > 1:
        near = near | shift_toward_0(h, 2) | shift_away_0(h, 2)
    return h & near


def flip_short_matches(h: torch.Tensor, threshold: int = 1) -> torch.Tensor:
    """Fill isolated matches: a 0 at p becomes 1 if both neighbours are 1,
    ones shifted in at the boundaries (the reference's shift_*_one,
    GASMA/utils.h:155-163, 223-240). threshold=2 keeps the reference's
    quirk of deriving r2 from l2 (utils.h:228-229)."""

    def toward_one(x):  # shift_left_one: toward 0, top bit set
        out = shift_toward_0(x, 1).clone()
        out[..., -1] = 1
        return out

    def away_one(x):  # shift_right_one: away from 0, bit 0 set
        out = shift_away_0(x, 1).clone()
        out[..., 0] = 1
        return out

    l1 = toward_one(h)
    r1 = away_one(h)
    mask1 = l1 & r1
    if threshold > 1:
        l2 = toward_one(l1)
        r2 = away_one(l2)  # sic — reference utils.h:229 shifts l2, not r1
        mask2 = (l1 & r2) | (l2 & r1)
        return h | mask1 | mask2
    return h | mask1


def next_one_index(h: torch.Tensor) -> torch.Tensor:
    """n[.., L+1] int32 with n[p] = min{q >= p : h[q] == 1}, or L if none
    (tzcnt returns the register width on an empty register)."""
    L = h.shape[-1]
    pos = torch.arange(L, dtype=torch.int32, device=h.device)
    idx = torch.where(h.to(torch.bool), pos,
                      torch.full_like(pos, L)).flip(-1)
    nxt = torch.cummin(idx, dim=-1).values.flip(-1)
    tail = torch.full(h.shape[:-1] + (1,), L, dtype=torch.int32,
                      device=h.device)
    return torch.cat([nxt, tail], dim=-1)


def next_zero_index(h: torch.Tensor) -> torch.Tensor:
    """n[p] = min{q >= p : h[q] == 0}, or L if none."""
    return next_one_index(h == 0)


def prefix_count(h: torch.Tensor) -> torch.Tensor:
    """cum[.., L+1] int32 with cum[p] = sum(h[..., :p])."""
    zeros = torch.zeros(h.shape[:-1] + (1,), dtype=torch.int32,
                        device=h.device)
    return torch.cat([zeros, torch.cumsum(h.to(torch.int32), dim=-1,
                                          dtype=torch.int32)], dim=-1)


def count_between(cum: torch.Tensor, lo: torch.Tensor,
                  hi: torch.Tensor) -> torch.Tensor:
    """pop_count_between(lo, hi) on the row whose prefix counts are `cum`
    [.., L+1]; an inverted or out-of-range window counts 0, as
    GASMA/utils.h:263-270 saturates."""
    L = cum.shape[-1] - 1
    a = gather_last(cum, lo.clamp(0, L))
    b = gather_last(cum, hi.clamp(0, L))
    return torch.clamp(b - a, min=0)


def gather_last(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[.., idx] along the last axis; idx clipped into range."""
    idx_c = idx.clamp(0, x.shape[-1] - 1).to(torch.int64)
    return torch.gather(x, -1, idx_c[..., None])[..., 0]
