"""Wide (16-bit, L = 256) LEAP history cells: the port's packed edit
records against the Pallas kernel's raw edit_rec in interpret mode (the
narrow cells, and the rest of the CIGAR path, in test_torch_leap_cigar.py).

Tolerance: exact equality of raw records, passed, penalty, lane_shift and
decoded edit lists."""

import torch

from asm_tpu.config import AlignConfig as JaxConfig
from asm_tpu.config import LeapMode as JaxMode
from test_torch_leap_cigar import check_records

torch.set_num_threads(1)


def test_wide_edit_records_match_pallas():
    check_records(dict(err=0.08, mr=0.90, seed=63, L=256, length=200),
                  JaxConfig(x=2, o=3, e=1, k=3, leap_af_threshold=40,
                            max_len=256, leap_mode=JaxMode.SEMI_FREE_END),
                  planes=False)


def test_wide_edit_records_match_pallas_unit_planes():
    check_records(dict(err=0.1, mr=0.5, seed=66, L=256, length=230),
                  JaxConfig(k=4, leap_af_threshold=40, max_len=256),
                  planes=True)
