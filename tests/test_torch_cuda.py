"""The CUDA kernels (greedy; NW band, full and trace; LEAP; the roofline
microkernels) against their plain PyTorch versions on the card, the SASS
counter on the probe kernel's real SASS, and the harness's and the
pipeline step's kernel routes against their plain routes.

Runs only where CUDA is present; elsewhere each test skips. The card's
machine has no jax, so run these without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: exact equality of cost, steps and raw step records (greedy);
of penalties, ops and match masks (NW); of passed, penalty, lane_shift and
raw edit records (LEAP); of the roofline kernels' words; of the harness's
counts and the pipeline step's outputs."""

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
    # the step loop's trips, read from the kernel's records
    assert torch.equal(greedy_cuda.step_trips(got["steps"], got["step_rec"]),
                       want["trips"])


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


# LEAP: the main path's profile, error 0.2, the indel-heavy corpus, unequal
# lengths, the edge pairs, L = 256 (full-length buffers included)
LEAP_CASES = [
    ("err0.05", dict(num_reads=1001, length=100, error_rate=0.05, seed=5)),
    ("err0.2", dict(num_reads=501, length=100, error_rate=0.2, seed=6)),
    ("err0.4-mr0.5", dict(num_reads=501, length=100, error_rate=0.4,
                          mismatch_rate=0.5, seed=40)),
    ("length_range", dict(num_reads=701, length=100, error_rate=0.12,
                          mismatch_rate=0.8, seed=95,
                          length_range=(60, 120))),
    ("edges", None),
    ("max_len256", dict(num_reads=301, length=200, error_rate=0.1, seed=3,
                        max_len=256)),
    ("max_len256-full", dict(num_reads=131, length=256, error_rate=0.01,
                             seed=4, max_len=256)),
]
# (semantics, use_shd_gate, (x, o, e)); simd_ed_lev is unit-cost, af == k
LEAP_VARIANTS = [
    ("lv_bag", False, (1, 1, 1)),
    ("lv_bag", False, (2, 3, 1)),
    ("simd_ed_lev", False, (1, 1, 1)),
    ("simd_ed_lev", True, (1, 1, 1)),
    ("simd_ed_affine", False, (1, 1, 1)),
    ("simd_ed_affine", False, (2, 3, 1)),
]


def _leap_cfg(sem, pens, mode, max_len, k=3):
    from asm_tpu_torch.config import LeapMode

    if sem == "simd_ed_lev":
        return AlignConfig(k=k, leap_af_threshold=k, max_len=max_len,
                           leap_mode=LeapMode(mode))
    return AlignConfig(x=pens[0], o=pens[1], e=pens[2], k=k,
                       leap_af_threshold=40, leap_max_energy=40,
                       max_len=max_len, leap_mode=LeapMode(mode))


def _leap_check(dev, corpus, cfg, sem, gate, tile=256, launches=1):
    from asm_tpu_torch.kernels import leap_cuda
    from asm_tpu_torch.kernels.leap import leap_align
    from asm_tpu_torch.kernels.leap_backtrack import leap_edit_records

    rc, rl, fc, fl = corpus
    cigar = sem == "lv_bag"
    want = leap_align(rc, rl, fc, fl, cfg, semantics=sem, use_shd_gate=gate,
                      want_history=cigar)
    planes = [torch.from_numpy(greedy_cuda.stage_planes_tiled_t(
        a.cpu().numpy(), tile=tile).view(np.int32)).to(dev) for a in (rc, fc)]
    for pre, (a, b) in ((False, (rc, fc)), ("planes_tiled", planes)):
        before = leap_cuda.LAUNCHES
        got = leap_cuda.leap_align_cuda(a, rl, b, fl, cfg, pre_staged=pre,
                                        tile=tile, semantics=sem,
                                        use_shd_gate=gate, want_cigar=cigar)
        assert leap_cuda.LAUNCHES == before + launches
        torch.cuda.synchronize()
        for key in ("passed", "penalty", "lane_shift"):
            assert torch.equal(got[key], want[key]), (key, pre)
        if cigar:
            rec = leap_edit_records(want, cfg, cfg.leap_energy_bound)
            assert np.array_equal(got["edit_rec"].cpu().numpy(), rec), pre


@pytest.mark.parametrize("label,kw", LEAP_CASES,
                         ids=[c[0] for c in LEAP_CASES])
@pytest.mark.parametrize("sem,gate,pens", LEAP_VARIANTS,
                         ids=[f"{v[0]}-gate{int(v[1])}-{''.join(map(str, v[2]))}"
                              for v in LEAP_VARIANTS])
def test_leap_kernel_matches_plain(dev, label, kw, sem, gate, pens):
    corpus = _nw_corpus(dev, kw)
    max_len = corpus[0].shape[1]
    for mode in range(4):  # LOCAL, GLOBAL, SEMI_FREE_BEGIN, SEMI_FREE_END
        _leap_check(dev, corpus, _leap_cfg(sem, pens, mode, max_len), sem,
                    gate)


@pytest.mark.parametrize("k", [2, 4])
def test_leap_kernel_band_widths(dev, k):
    corpus = _corpus(dev, num_reads=401, length=100, error_rate=0.1, seed=7)
    for sem, gate, pens in LEAP_VARIANTS:
        _leap_check(dev, corpus, _leap_cfg(sem, pens, 1, 128, k=k), sem,
                    gate)


def test_leap_cigar_in_pieces_and_tight_threshold(dev, monkeypatch):
    """A CIGAR launch larger than the history scratch runs in pieces; a
    tight threshold leaves most pairs unpassed."""
    from asm_tpu_torch.kernels import leap_cuda

    corpus = _corpus(dev, num_reads=300, length=100, error_rate=0.1, seed=9)
    cfg = AlignConfig(leap_af_threshold=24)
    monkeypatch.setattr(leap_cuda, "CIGAR_SCRATCH_BYTES",
                        4 * leap_cuda.history_words(cfg) * 128)
    _leap_check(dev, corpus, cfg, "lv_bag", False, launches=3)  # 300/128
    _leap_check(dev, corpus, AlignConfig(leap_af_threshold=2), "lv_bag",
                False)


def test_leap_kernel_builds_every_instantiation(dev):
    from asm_tpu_torch.kernels import leap_cuda

    path, _ = leap_cuda.build_kernel()
    assert path.endswith(".so")
    with open(leap_cuda.ptxas_report()) as f:
        report = f.read()
    # k in {2, 3, 4} x W in {4, 8} x 2 penalty sets x {penalty, CIGAR}
    assert report.count("Compiling entry function") == 24


def test_leap_kernel_refuses_unbuilt_shapes(dev):
    from asm_tpu_torch.kernels import leap_cuda

    rc, rl, fc, fl = _corpus(dev, num_reads=8, length=50, error_rate=0.1,
                             seed=1)
    with pytest.raises(NotImplementedError):
        leap_cuda.leap_align_cuda(rc, rl, fc, fl, AlignConfig(k=5))
    with pytest.raises(NotImplementedError):
        leap_cuda.leap_align_cuda(rc, rl, fc, fl, AlignConfig(x=1, o=4, e=2))
    with pytest.raises(ValueError):
        leap_cuda.leap_align_cuda(rc, rl.cpu(), fc, fl, AlignConfig())
    with pytest.raises(ValueError):
        leap_cuda.leap_align_cuda(rc, rl, fc, fl, AlignConfig(),
                                  semantics="simd_ed_affine", want_cigar=True)


# the roofline microkernels (csrc/roofline.cu) and the SASS counter


def test_roofline_kernels_match_plain(dev):
    from asm_tpu_torch.kernels import roofline_cuda as rc
    from asm_tpu_torch.tools import roofline as rl

    seeds = rl.issue_seeds(dev, blocks_per_sm=1)
    before = dict(rc.LAUNCHES)
    got = rc.issue_chain(seeds, 9)
    torch.cuda.synchronize()
    assert torch.equal(got, rc.issue_chain_plain(seeds, 9))
    for n in (4, 1 << 20, (1 << 24) + 12):  # a grid-stride tail, too
        x = rl.seeded_words(n, dev, seed=n)
        assert torch.equal(rc.stream_fold(x), rc.stream_fold_plain(x)), n
    x = rl.seeded_words(1000, dev, seed=3)
    for trips in (7, 0, -5):
        x[0] = trips
        assert torch.equal(rc.probe(x), rc.probe_plain(x)), trips
    assert rc.LAUNCHES == dict(issue_chain=before["issue_chain"] + 1,
                               stream_fold=before["stream_fold"] + 3,
                               probe=before["probe"] + 3)
    with pytest.raises(ValueError):
        rc.stream_fold(x[1:7])  # not a multiple of 4 words


def test_counter_on_probe_sass(dev):
    from asm_tpu_torch.kernels import roofline_cuda as rc
    from asm_tpu_torch.tools import roofline as rl

    sass = rl.sass_listing(rc.build_kernel()[0], "probe_kernel")
    c0, c7 = rl.count_sass(sass, [0]), rl.count_sass(sass, [7])
    assert len(c7["loops"]) == 1 and c7["loops"][0]["weighted"]
    body = c7["loops"][0]["body"]
    assert body["mem"] >= 2  # the volatile load and store of every trip
    for cat in rl.CATEGORIES:
        assert c7["counts"][cat] - c0["counts"][cat] == 7 * body[cat], cat


def test_harness_cuda_matches_torch(dev):
    from asm_tpu_torch.bench.harness import run_benchmark

    corpus = generate_dataset_arrays(4096, 100, 0.1, seed=12)
    got = run_benchmark(*corpus, AlignConfig(), chunk=1500, impl="cuda",
                        device=dev)
    want = run_benchmark(*corpus, AlignConfig(), chunk=1500, impl="torch",
                         device=dev)
    for f in ("total", "leap_accuracy", "greedy_accuracy", "greedy_coverage",
              "coverage_checked"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.device == torch.cuda.get_device_name(dev)


def test_pipeline_step_cuda_matches_torch(dev):
    from asm_tpu_torch.kernels import leap_cuda
    from asm_tpu_torch.parallel.runner import make_pipeline_step

    args = _corpus(dev, num_reads=3000, length=100, error_rate=0.1, seed=21)
    before = (greedy_cuda.LAUNCHES, nw_band.LAUNCHES, leap_cuda.LAUNCHES)
    got = make_pipeline_step(AlignConfig(), dev, "cuda")(*args)
    assert min(a - b for a, b in zip(
        (greedy_cuda.LAUNCHES, nw_band.LAUNCHES, leap_cuda.LAUNCHES),
        before)) > 0
    want = make_pipeline_step(AlignConfig(), dev, "torch")(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
