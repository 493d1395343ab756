"""Position-space shifts and the hurdle denoise (port of the parts of
`asm_tpu.ops.bitops` the greedy path uses).

Rows are tensors [.., L], bit/position p at index p:

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
