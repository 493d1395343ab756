"""The CUDA kernels (greedy; NW band, full and trace) against their plain
PyTorch versions on the card.

Runs only where CUDA is present; elsewhere each test skips. The card's
machine has no jax, so run these without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: exact equality of cost, steps and raw step records (greedy);
of penalties, ops and match masks (NW)."""

import numpy as np
import pytest
import torch

from asm_tpu_torch.config import AlignConfig, AlignmentType
from asm_tpu_torch.data.generator import generate_dataset_arrays
from asm_tpu_torch.encoding import encode_batch
from asm_tpu_torch.kernels import greedy_cuda, nw, nw_band, nw_cuda
from asm_tpu_torch.kernels.greedy import greedy_align

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _corpus(dev, **kw):
    return [torch.from_numpy(a).to(dev) for a in generate_dataset_arrays(**kw)]


def _check(got, want):
    torch.cuda.synchronize()
    for key in ("cost", "steps", "step_rec"):
        assert torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("cfg,kw", [
    (AlignConfig(max_steps=24), dict(error_rate=0.05, seed=5)),
    (AlignConfig(max_steps=24, alignment_type=AlignmentType.SEMI_GLOBAL),
     dict(error_rate=0.4, mismatch_rate=0.5, seed=40)),
    (AlignConfig(x=2, o=3, e=1, k=2, max_steps=2), dict(error_rate=0.1,
                                                        seed=17)),
    (AlignConfig(max_len=256, max_steps=64), dict(error_rate=0.1, seed=3,
                                                  length=200, max_len=256)),
])
@pytest.mark.parametrize("form", ["codes", "planes_tiled"])
def test_kernel_matches_plain(dev, cfg, kw, form):
    kw = dict(dict(num_reads=1000, length=100), **kw)
    rc, rl, fc, fl = _corpus(dev, **kw)
    want = greedy_align(rc, rl, fc, fl, cfg, records=True)
    if form == "planes_tiled":
        rc, fc = (torch.from_numpy(greedy_cuda.stage_planes_tiled_t(
            a.cpu().numpy(), tile=256).view(np.int32)).to(dev)
            for a in (rc, fc))
    before = greedy_cuda.LAUNCHES
    got = greedy_cuda.greedy_align_cuda(
        rc, rl, fc, fl, cfg,
        pre_staged="planes_tiled" if form == "planes_tiled" else False,
        tile=256)
    assert greedy_cuda.LAUNCHES == before + 1
    _check(got, want)


def test_kernel_refuses_unbuilt_shapes(dev):
    rc, rl, fc, fl = _corpus(dev, num_reads=8, length=50, error_rate=0.1,
                             seed=1)
    with pytest.raises(NotImplementedError):
        greedy_cuda.greedy_align_cuda(rc, rl, fc, fl, AlignConfig(k=4))
    with pytest.raises(ValueError):
        greedy_cuda.greedy_align_cuda(rc, rl.cpu(), fc, fl, AlignConfig())


# NW corpora: the main path's profile, indel-heavy, variable lengths,
# edge pairs (empty, one base, 128 bases), and L = 256
NW_CASES = [
    ("err0.05", dict(num_reads=1001, length=100, error_rate=0.05, seed=5)),
    ("err0.4-mr0.5", dict(num_reads=777, length=100, error_rate=0.4,
                          mismatch_rate=0.5, seed=40)),
    ("length_range", dict(num_reads=501, length=100, error_rate=0.12,
                          mismatch_rate=0.8, seed=95,
                          length_range=(40, 120))),
    ("edges", None),
    ("max_len256", dict(num_reads=301, length=200, error_rate=0.1, seed=3,
                        max_len=256)),
]


def _nw_corpus(dev, kw):
    if kw is None:
        reads = ["A", "ACGT" * 32, "ACGTACGT", "", "ACGT" * 25, "AC"]
        refs = ["ACGT" * 32, "A", "ACGTACGT", "ACG", "ACGT" * 25, "TGCA" * 20]
        return [torch.from_numpy(a).to(dev)
                for a in encode_batch(reads, refs, 128)]
    return _corpus(dev, **kw)


@pytest.mark.parametrize("label,kw", NW_CASES, ids=[c[0] for c in NW_CASES])
@pytest.mark.parametrize("bw", nw_band.BWS)
def test_nw_band_kernel_matches_plain(dev, label, kw, bw):
    rc, rl, fc, fl = _nw_corpus(dev, kw)
    planes = [torch.from_numpy(greedy_cuda.stage_planes_t(
        a.cpu().numpy()).view(np.int32)).to(dev) for a in (rc, fc)]
    for x, o, e in [(1, 1, 1), (2, 3, 1)]:
        want = nw_band.banded_plain(rc, rl, fc, fl, bw, x, o, e)
        for pre, (a, b) in ((False, (rc, fc)), (True, planes)):
            before = nw_band.LAUNCHES
            got = nw_band.nw_penalty_banded(a, rl, b, fl, bw=bw, x=x, o=o,
                                            e=e, pre_staged=pre)
            assert nw_band.LAUNCHES == before + 1
            torch.cuda.synchronize()
            assert torch.equal(got, want), (x, o, e, pre)


@pytest.mark.parametrize("label,kw", NW_CASES, ids=[c[0] for c in NW_CASES])
def test_nw_full_and_trace_kernels_match_plain(dev, label, kw):
    rc, rl, fc, fl = _nw_corpus(dev, kw)
    for x, o, e in [(1, 1, 1), (1, 4, 2)]:
        pen, ops, mask = nw.nw_align(rc, rl, fc, fl, x, o, e,
                                     match_mask_threshold=3)
        before = dict(nw_cuda.LAUNCHES)
        got = nw_cuda.nw_penalty_cuda(rc, rl, fc, fl, x, o, e)
        torch.cuda.synchronize()
        assert torch.equal(got, pen)
        got = nw_cuda.nw_align_cuda(rc, rl, fc, fl, x, o, e,
                                    match_mask_threshold=3)
        torch.cuda.synchronize()
        for g, w in zip(got, (pen, ops, mask)):
            assert torch.equal(g, w)
        got = nw_cuda.nw_align_cuda(rc, rl, fc, fl, x, o, e)
        assert len(got) == 2 and torch.equal(got[1], ops)
        assert nw_cuda.LAUNCHES["nw"] == before["nw"] + 1
        assert nw_cuda.LAUNCHES["nw_trace"] == before["nw_trace"] + 2


def test_nw_trace_kernel_in_pieces(dev, monkeypatch):
    """A launch larger than the pointer scratch runs in pieces."""
    rc, rl, fc, fl = _corpus(dev, num_reads=300, length=100,
                             error_rate=0.1, seed=9)
    want = nw.nw_align(rc, rl, fc, fl, match_mask_threshold=3)
    monkeypatch.setattr(nw_cuda, "TRACE_SCRATCH_BYTES", 2 * 128 * 128 * 64)
    before = nw_cuda.LAUNCHES["nw_trace"]
    got = nw_cuda.nw_align_cuda(rc, rl, fc, fl, match_mask_threshold=3)
    torch.cuda.synchronize()
    assert nw_cuda.LAUNCHES["nw_trace"] == before + 5  # ceil(300 / 64)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_nw_kernels_refuse_unbuilt_shapes(dev):
    rc, rl, fc, fl = _corpus(dev, num_reads=8, length=50, error_rate=0.1,
                             seed=1, max_len=96)
    with pytest.raises(NotImplementedError):
        nw_cuda.nw_penalty_cuda(rc, rl, fc, fl)
    with pytest.raises(NotImplementedError):
        nw_band.nw_penalty_banded(rc, rl, fc, fl, bw=16)
    rc, rl, fc, fl = _corpus(dev, num_reads=8, length=50, error_rate=0.1,
                             seed=1)
    with pytest.raises(NotImplementedError):
        nw_band.nw_penalty_banded(rc, rl, fc, fl, bw=12)
    with pytest.raises(ValueError):
        nw_cuda.nw_align_cuda(rc, rl.cpu(), fc, fl)
