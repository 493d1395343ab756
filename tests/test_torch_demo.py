"""The port's demo (`python -m asm_tpu_torch.apps.demo`, plain version on
the CPU) prints byte for byte what asm_tpu's demo prints: the hurdle
matrix lanes, the CIGAR, the cost, the aligned rows and the LCM, on the
reference's pair and on three more (one with unequal lengths). The CLI
refuses the card when there is none.

Tolerance: exact (text)."""

import contextlib
import io

import pytest
import torch

from asm_tpu.apps import demo as jdemo
from asm_tpu.data.generator import generate_dataset
from asm_tpu_torch.apps import demo

torch.set_num_threads(1)

_reads, _refs = generate_dataset(2, 100, 0.10, 0.96, seed=11)
PAIRS = [
    [],  # the reference's pair (GASMA/main.cpp:8-9)
    [_reads[0], _refs[0]],
    [_reads[1], _refs[1]],
    ["ACGTTGCAACGTAAGGCTTACG", "ACGTGCAACGTTAAGGCTACGGATC"],  # 22 vs 25
]


def _stdout(fn, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(argv)
    return buf.getvalue()


@pytest.mark.parametrize("pair", PAIRS, ids=["default", "gen0", "gen1",
                                             "unequal"])
def test_demo_stdout_equals_asm_tpu(pair):
    want = _stdout(jdemo.main, list(pair))
    got = _stdout(demo.main, list(pair) + ["--device", "cpu"])
    assert got.encode() == want.encode()
    assert "CIGAR: " in got and "LCM (threshold 3): " in got


def test_demo_refuses_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        demo.main([])
