"""The frozen generator: deterministic per seed, ceil(len x rate) errors a
pair, the mix's shares and order."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from perfbench.generator import PAD_READ, PAD_REF, make_pool, nominal_errors
from perfbench.reference import nw


def pool(seed, n=512, length=100, rates=(0.05, 0.20), shares=(0.5, 0.5),
         mismatch=0.96, max_len=128, order="interleaved"):
    return make_pool(n, length, list(rates), list(shares), mismatch, max_len,
                     order, seed, "cpu")


def test_same_seed_same_pool():
    a, b, c = pool(2**31 + 9), pool(2**31 + 9), pool(2**31 + 10)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["ref"], c["ref"])


def test_nominal_errors_is_the_float32_ceil():
    assert nominal_errors(100, 0.15) == 16
    assert nominal_errors(100, 0.05) == 5
    assert nominal_errors(998, 0.05) == 50


@pytest.mark.parametrize("mismatch", [0.96, 0.5, 0.0])
def test_each_pair_takes_its_errors(mismatch):
    p = pool(7, n=256, mismatch=mismatch)
    want = torch.tensor([nominal_errors(100, r) for r in (0.05, 0.20)])
    nerr = want[p["label"]]
    assert torch.equal(p["events"], nerr.to(torch.int32))
    assert torch.all(p["read_len"] == 100)
    assert torch.all((p["ref_len"] - 100).abs() <= nerr)
    # an error changes the edit distance by one at most
    ed = nw.penalty(p["read"], p["read_len"], p["ref"], p["ref_len"])
    assert torch.all(ed <= nerr)
    if mismatch == 0.0:  # indels only: the length moves with every one
        assert torch.all((p["ref_len"] - 100) % 2 == nerr % 2)


def test_padding_and_codes():
    p = pool(3, n=128)
    pos = torch.arange(128)[None, :]
    assert torch.all(p["read"][:, 100:] == PAD_READ)
    past = pos >= p["ref_len"][:, None].long()
    assert torch.all(p["ref"][past] == PAD_REF)
    assert torch.all((p["ref"][~past] >= 0) & (p["ref"][~past] <= 3))


def test_shares_and_order():
    blocks = pool(5, n=400, rates=(0.05, 0.1, 0.2), shares=(0.25, 0.25, 0.5),
                  order="blocks")
    counts = np.bincount(blocks["label"].numpy(), minlength=3)
    assert counts.tolist() == [100, 100, 200]
    assert torch.equal(blocks["label"], blocks["label"].sort().values)
    mixed = pool(5, n=400, rates=(0.05, 0.1, 0.2), shares=(0.25, 0.25, 0.5))
    assert np.bincount(mixed["label"].numpy()).tolist() == [100, 100, 200]
    assert not torch.equal(mixed["label"], mixed["label"].sort().values)


def test_long_reads_are_cut_to_max_len():
    p = pool(11, n=64, length=998, rates=(0.05,), shares=(1.0,),
             max_len=1024, order="blocks")
    assert torch.all(p["read_len"] == 998)
    assert torch.all(p["ref_len"] <= 1024)
    assert torch.all(p["events"] == 50)
