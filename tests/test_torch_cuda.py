"""The CUDA greedy kernel against its plain PyTorch version on the card.

Runs only where CUDA is present; elsewhere each test skips. The card's
machine has no jax, so run these without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: exact equality of cost, steps and raw step records."""

import numpy as np
import pytest
import torch

from asm_tpu_torch.config import AlignConfig, AlignmentType
from asm_tpu_torch.data.generator import generate_dataset_arrays
from asm_tpu_torch.kernels import greedy_cuda
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
