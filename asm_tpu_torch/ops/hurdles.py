"""Hurdle-lane construction and lane geometry (port of
`asm_tpu.ops.hurdles`' greedy half).

A lane is a diagonal of the alignment matrix; per lane, bit p says
whether the read and ref characters on that diagonal at column p differ
(a hurdle), _construct_hurdles in GASMA/hurdle_matrix.h:441-455:

  lane s >= 0: column c compares  A[c]      vs  B[c + s]
  lane s <  0: column c compares  A[c - s]  vs  B[c]

Positions past a string's end are always hurdles (the sentinels PAD_READ,
PAD_REF and PAD_SHIFT mismatch everything).
"""

from __future__ import annotations

import torch

from asm_tpu_torch.encoding import PAD_SHIFT
from asm_tpu_torch.ops.bitops import shift_toward_0


def switch_lane_penalty(l1, l2, o: int, e: int):
    """Leap penalty between lanes: o + e*(|l1-l2|-1), 0 if equal
    (GASMA/utils.h:576-579)."""
    d = torch.abs(l1 - l2)
    return torch.where(d == 0, torch.zeros_like(d), o + e * (d - 1))


def switch_forward_column(l1, l2):
    """Columns auto-advanced by leaping l1 -> l2 (GASMA/utils.h:587-593)."""
    a1, a2 = torch.abs(l1), torch.abs(l2)
    same_sign = l1 * l2 >= 0
    return torch.where(same_sign, torch.clamp(a1 - a2, min=0), a1)


def lane_destination(m, n, lane):
    """Final column of a lane (_calculate_destination,
    GASMA/hurdle_matrix.h:58-68); broadcasts m, n and lane."""
    m, n, lane = torch.broadcast_tensors(m, n, lane)
    ge = m >= n
    dest_ge = torch.where(
        lane > 0, n - lane, torch.where(lane >= n - m, n, m + lane)
    )
    dest_lt = torch.where(
        lane < 0, m + lane, torch.where(lane <= n - m, m, n - lane)
    )
    return torch.where(ge, dest_ge, dest_lt)


def build_greedy_lanes(read_codes: torch.Tensor, ref_codes: torch.Tensor,
                       k: int) -> torch.Tensor:
    """Hurdle rows for greedy lanes -k..k: int8[B, 2k+1, L]; row i is
    lane i - k."""
    rows = []
    for lane in range(-k, k + 1):
        if lane < 0:
            a = shift_toward_0(read_codes, -lane, fill=PAD_SHIFT)
            b = ref_codes
        else:
            a = read_codes
            b = shift_toward_0(ref_codes, lane, fill=PAD_SHIFT)
        rows.append((a != b).to(torch.int8))
    return torch.stack(rows, dim=-2)
