"""Row operations on torch tensors: position shifts and scan tables,
hurdle lanes, packed words."""

from asm_tpu_torch.ops.bitops import (
    count_between,
    flip_short_hurdles,
    flip_short_matches,
    next_one_index,
    next_zero_index,
    prefix_count,
    shift_away_0,
    shift_toward_0,
)
from asm_tpu_torch.ops.hurdles import (
    build_greedy_lanes,
    build_leap_lanes,
    lane_destination,
    switch_forward_column,
    switch_lane_penalty,
)

__all__ = [
    "shift_toward_0",
    "shift_away_0",
    "flip_short_hurdles",
    "flip_short_matches",
    "next_one_index",
    "next_zero_index",
    "prefix_count",
    "count_between",
    "build_greedy_lanes",
    "build_leap_lanes",
    "lane_destination",
    "switch_lane_penalty",
    "switch_forward_column",
]
