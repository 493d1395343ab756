"""Each reference against the program's plain versions on small pools (the
test may import the program; the references import nothing of it), and
each control against its reference."""

from __future__ import annotations

import pytest
import torch

from asm_tpu_torch.config import AlignConfig
from asm_tpu_torch.kernels.greedy import greedy_align
from asm_tpu_torch.kernels.leap import leap_align
from asm_tpu_torch.kernels.nw import nw_penalty
from perfbench.generator import make_pool
from perfbench.reference import greedy, leap, nw
from perfbench.tests.conftest import tiny_config

RATES = [0.05, 0.10, 0.15, 0.20]


def pool(n, length=100, max_len=128, seed=21, rates=RATES, mismatch=0.96):
    p = make_pool(n, length, rates, [1 / len(rates)] * len(rates), mismatch,
                  max_len, "interleaved", seed, "cpu")
    return [p[k] for k in ("read", "read_len", "ref", "ref_len")]


def differ(a, b, keys):
    return int(sum((a[k] != b[k]) for k in keys).bool().sum())


@pytest.mark.parametrize("length,max_len,n,xoe,rates,mismatch", [
    (100, 128, 1024, (1, 1, 1), RATES, 0.96),
    (200, 256, 256, (1, 1, 1), RATES, 0.96),
    (998, 1024, 32, (1, 1, 1), RATES, 0.96),
    (1000, 1056, 24, (4, 8, 2), [0.05], 1 / 3),
])
def test_greedy_reference_is_the_plain_version(length, max_len, n, xoe,
                                               rates, mismatch):
    inputs = pool(n, length, max_len, rates=rates, mismatch=mismatch)
    x, o, e = xoe
    want = greedy_align(*inputs, AlignConfig(x=x, o=o, e=e, k=3,
                                             max_len=max_len))
    got = greedy.align(*inputs, x=x, o=o, e=e, k=3)
    assert differ(got, want, ("cost", "steps")) == 0


def test_greedy_reference_takes_the_stated_float():
    """The reference computes its heuristic in the configuration's
    `heuristic_float` and the control one type below; a type it does not
    know is refused."""
    inputs = pool(256, rates=[0.20])
    cfg = tiny_config(heuristic_float="float64")
    assert greedy.float_types(cfg) == (torch.float64, torch.float32)
    want = greedy.align(*inputs, float_dtype=torch.float32)
    got = greedy.control(*inputs, cfg)
    assert differ(got, want, ("cost", "steps")) == 0
    with pytest.raises(ValueError):
        greedy.reference(*inputs, tiny_config(heuristic_float="float16"))


@pytest.mark.parametrize("xoe,k", [((1, 1, 1), 3), ((2, 3, 1), 3),
                                   ((1, 1, 1), 2)])
def test_leap_reference_is_the_plain_version(xoe, k):
    inputs = pool(1024)
    x, o, e = xoe
    want = leap_align(*inputs, AlignConfig(x=x, o=o, e=e, k=k),
                      semantics="lv_bag")
    got = leap.align(*inputs, x=x, o=o, e=e, k=k, af=200)
    assert differ(got, want, ("passed", "penalty", "lane_shift")) == 0


@pytest.mark.parametrize("xoe", [(1, 1, 1), (2, 3, 1), (1, 4, 2), (3, 1, 2),
                                 (4, 8, 2)])
def test_nw_reference_is_the_plain_version(xoe):
    inputs = pool(256, mismatch=0.5)
    assert torch.equal(nw.penalty(*inputs, *xoe), nw_penalty(*inputs, *xoe))


def test_nw_reference_edges():
    codes = torch.zeros((4, 32), dtype=torch.int8)
    lens = torch.tensor([0, 0, 3, 5], dtype=torch.int32)
    other = torch.tensor([0, 4, 0, 5], dtype=torch.int32)
    assert nw.penalty(codes, lens, codes, other).tolist() == [0, 4, 3, 0]
    assert nw.penalty(codes, lens, codes, other, 1, 3, 1).tolist() == [
        0, 6, 5, 0]


@pytest.mark.parametrize("kind,data", [
    (greedy, dict(rates=[0.20], n=2048)),
    (leap, dict(rates=[0.20], n=2048)),
    (nw, dict(rates=[0.20], n=256, length=200, max_len=256, mismatch=0.5)),
])
def test_each_control_differs_from_its_reference(kind, data):
    cfg = tiny_config(max_len=data.get("max_len", 128),
                      max_steps=data.get("max_len", 128))
    inputs = pool(**data)
    want = kind.reference(*inputs, cfg)
    got = kind.control(*inputs, cfg)
    assert differ(got, want, tuple(want)) > 0
