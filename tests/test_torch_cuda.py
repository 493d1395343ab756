"""The CUDA kernels (greedy; NW band, full and trace; LEAP; the roofline
microkernels) against their plain PyTorch versions on the card, the SASS
counter on the probe kernel's real SASS, and the harness's and the
pipeline step's kernel routes against their plain routes.

Runs only where CUDA is present; elsewhere each test skips. The card's
machine has no jax, so run these without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: exact equality of cost, steps, raw step records, the trips
read from them and the decoded CIGARs (greedy);
of penalties, ops and match masks (NW); of passed, penalty, lane_shift and
raw edit records (LEAP); of the roofline kernels' words; of the harness's
counts and the pipeline step's outputs; of the mapper's best hits and SAM
text. The mapper corpora below (numpy only) serve
tests/test_torch_mapper.py too."""

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
    from asm_tpu_torch.ops.cigar import runs_to_cigars_batch

    torch.cuda.synchronize()
    for key in ("cost", "steps", "step_rec"):
        assert torch.equal(got[key], want[key]), key
    # the step loop's trips, read from the kernel's records
    assert torch.equal(greedy_cuda.step_trips(got["steps"], got["step_rec"]),
                       want["trips"])
    assert runs_to_cigars_batch(
        got["cigar_ops"].cpu().numpy(), got["cigar_runs"].cpu().numpy()
    ) == runs_to_cigars_batch(want["cigar_ops"].cpu().numpy(),
                              want["cigar_runs"].cpu().numpy())


def _greedy_edges(n=3001, seed=8):
    """n pairs (no multiple of 128): every third an edge pair (empty, one
    base, 128 bases, on either side or both), the rest 100-base reads
    against copies with 6% substitutions."""
    rng = np.random.default_rng(seed)
    full = "ACGT" * 32
    edge = [("", ""), ("A", ""), ("", "A"), ("A", "A"), ("A", "C"),
            (full, full), (full, ""), ("", full[::-1]), (full, "A"),
            ("C", full), (full, full[1:] + "T")]
    reads, refs = [], []
    for i in range(n):
        if i % 3 == 0:
            read, ref = edge[(i // 3) % len(edge)]
        else:
            codes = rng.integers(0, 4, 100)
            sub = np.where(rng.random(100) < 0.06, rng.integers(0, 4, 100),
                           codes)
            read, ref = ("".join("ACGT"[c] for c in a) for a in (codes, sub))
        reads.append(read)
        refs.append(ref)
    return encode_batch(reads, refs, 128)


# corpus: keyword arguments of generate_dataset_arrays, or a corpus name
GREEDY_CASES = [
    ("err0.05", AlignConfig(max_steps=24), dict(error_rate=0.05, seed=5)),
    ("semi-err0.4", AlignConfig(max_steps=24,
                                alignment_type=AlignmentType.SEMI_GLOBAL),
     dict(error_rate=0.4, mismatch_rate=0.5, seed=40)),
    ("x2o3e1k2", AlignConfig(x=2, o=3, e=1, k=2, max_steps=2),
     dict(error_rate=0.1, seed=17)),
    ("max_len256", AlignConfig(max_len=256, max_steps=64),
     dict(error_rate=0.1, seed=3, length=200, max_len=256)),
    # empty, 1-base and 128-base pairs beside ordinary ones
    ("edges", AlignConfig(max_steps=24), "edges"),
    ("edges-semi-x2o3e1k2", AlignConfig(
        x=2, o=3, e=1, k=2, max_steps=24,
        alignment_type=AlignmentType.SEMI_GLOBAL), "edges"),
    # every SM holds several resident blocks; the last block is partial
    ("many_blocks", AlignConfig(max_steps=24),
     dict(num_reads=200_003, error_rate=0.05, seed=23)),
    # L = 512 (int32 records), k = 2 and a truncating bound at err 0.15
    ("max_len512", AlignConfig(max_len=512, max_steps=128),
     dict(error_rate=0.05, seed=3, length=496, max_len=512)),
    ("max_len512-k2-err0.15", AlignConfig(max_len=512, k=2, max_steps=16),
     dict(error_rate=0.15, seed=4, length=496, max_len=512)),
    ("edges512", AlignConfig(max_len=512, max_steps=128), "edges512"),
    ("edges512-semi", AlignConfig(
        max_len=512, max_steps=128,
        alignment_type=AlignmentType.SEMI_GLOBAL), "edges512"),
    # k = 4 at every max_len
    ("k4", AlignConfig(k=4, max_steps=24), dict(error_rate=0.1, seed=6)),
    ("k4-max_len256", AlignConfig(k=4, max_len=256, max_steps=64),
     dict(error_rate=0.1, seed=7, length=200, max_len=256)),
    ("k4-max_len512", AlignConfig(k=4, max_len=512, max_steps=128),
     dict(error_rate=0.15, seed=8, length=496, max_len=512)),
    ("k4-edges512-x2o3e1", AlignConfig(x=2, o=3, e=1, k=4, max_len=512,
                                       max_steps=128), "edges512"),
]


def long_edges(L=512, seed=31, err=0.05):
    """Pairs of lengths 0, 1, 31, 32, 33, 496, L - 1 and L, each against
    each (reads random, refs a copy with `err` substitutions, cut or
    extended to their length), beside the same lengths on both sides
    with a third of the error as indels; numpy only, so the CPU tests
    share it."""
    rng = np.random.default_rng(seed)
    lens = [0, 1, 31, 32, 33, 496, L - 1, L]
    reads, refs = [], []
    for a in lens:
        for b in lens:
            read = rng.integers(0, 4, a)
            ref = rng.integers(0, 4, b)
            n = min(a, b)
            ref[:n] = np.where(rng.random(n) < err, rng.integers(0, 4, n),
                               read[:n])
            reads.append(read)
            refs.append(ref)
    for a in lens:
        read = rng.integers(0, 4, a)
        ref = list(np.where(rng.random(a) < err, rng.integers(0, 4, a), read))
        for _ in range(int(a * err / 3)):
            i = int(rng.integers(0, len(ref) + 1))
            if rng.random() < 0.5 and ref:
                del ref[min(i, len(ref) - 1)]
            else:
                ref.insert(i, int(rng.integers(0, 4)))
        reads.append(read)
        refs.append(np.asarray(ref[:L], np.int64))
    as_str = ["".join("ACGT"[c] for c in x) for x in reads]
    return encode_batch(as_str, ["".join("ACGT"[c] for c in x)
                                 for x in refs], L)


@pytest.mark.parametrize("label,cfg,kw", GREEDY_CASES,
                         ids=[c[0] for c in GREEDY_CASES])
@pytest.mark.parametrize("form", ["codes", "planes_tiled"])
def test_kernel_matches_plain(dev, label, cfg, kw, form):
    if kw == "edges":
        rc, rl, fc, fl = (torch.from_numpy(a).to(dev) for a in _greedy_edges())
    elif kw == "edges512":
        rc, rl, fc, fl = (torch.from_numpy(a).to(dev) for a in long_edges())
    else:
        rc, rl, fc, fl = _corpus(dev, **dict(dict(num_reads=1000, length=100),
                                             **kw))
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


def test_kernel_occupancy_and_spills(dev):
    """Every instantiation builds without spills; the shared-memory rows
    leave room for at least 5 resident blocks of 128 threads (20 warps)
    of the main path's (k = 3, L = 128) and 3 (12 warps) at L = 256; at
    k = 4, 4 and 2 blocks; at L = 512 at least the one 128-thread block
    (4 warps) a block of that size leaves. The occupancy query answers
    warps, since the block size is per instantiation."""
    from asm_tpu_torch.tools import roofline as rl
    from asm_tpu_torch.utils.build import ptxas_usage

    greedy_cuda.build_kernel()
    with open(greedy_cuda.ptxas_report()) as f:
        usage = ptxas_usage(f.read())
    # k in {2, 3, 4} x L in {128, 256, 512} x 2 input forms
    assert len(usage) == 18
    for name, u in usage.items():
        assert u["spill_stores"] == u["spill_loads"] == 0, name
    assert greedy_cuda.block_threads(128) == greedy_cuda.block_threads(
        256) == 128
    for k in (2, 3):
        for planes in (True, False):
            assert greedy_cuda.occupancy(k, 128, planes) >= 5 * 4
            assert greedy_cuda.occupancy(k, 256, planes) >= 3 * 4
    for planes in (True, False):
        assert greedy_cuda.occupancy(4, 128, planes) >= 4 * 4
        assert greedy_cuda.occupancy(4, 256, planes) >= 2 * 4
        for k in (2, 3, 4):
            assert greedy_cuda.occupancy(k, 512, planes) >= 4
    got = rl.greedy_resources()
    assert got["warps_per_sm"] == greedy_cuda.occupancy()
    got = rl.greedy_resources(k=3, max_len=512)
    assert got["warps_per_sm"] == greedy_cuda.occupancy(3, 512)
    assert got["spill_stores"] == 0


def test_kernel_refuses_unbuilt_shapes(dev):
    rc, rl, fc, fl = _corpus(dev, num_reads=8, length=50, error_rate=0.1,
                             seed=1)
    with pytest.raises(NotImplementedError):
        greedy_cuda.greedy_align_cuda(rc, rl, fc, fl, AlignConfig(k=5))
    rc3, rl3, fc3, fl3 = _corpus(dev, num_reads=8, length=50,
                                 error_rate=0.1, seed=1, max_len=384)
    with pytest.raises(NotImplementedError):
        greedy_cuda.greedy_align_cuda(rc3, rl3, fc3, fl3,
                                      AlignConfig(max_len=384))
    with pytest.raises(ValueError):
        greedy_cuda.greedy_align_cuda(rc, rl.cpu(), fc, fl, AlignConfig())


# NW corpora: the main path's profile, indel-heavy, variable lengths,
# edge pairs (empty, one base, 128 bases), ragged warps, and L = 256
NW_CASES = [
    ("err0.05", dict(num_reads=1001, length=100, error_rate=0.05, seed=5)),
    ("err0.4-mr0.5", dict(num_reads=777, length=100, error_rate=0.4,
                          mismatch_rate=0.5, seed=40)),
    ("length_range", dict(num_reads=501, length=100, error_rate=0.12,
                          mismatch_rate=0.8, seed=95,
                          length_range=(40, 120))),
    ("edges", None),
    ("ragged_warps", "ragged_warps"),
    ("max_len256", dict(num_reads=301, length=200, error_rate=0.1, seed=3,
                        max_len=256)),
    ("edges256", "edges256"),
    ("max_len512", dict(num_reads=301, length=496, error_rate=0.1, seed=3,
                        max_len=512)),
    ("edges512", "edges512"),
    ("long_edges512", "long_edges512"),
]


def _ragged_warps(n=4099, seed=21):
    """n pairs (the last block partial at every BW): in each group of 8
    consecutive pairs one 128-base read against a 100-128-base ref (a copy
    with substitutions) beside empty, 1-base and short pairs, so m+n
    varies inside every warp."""
    rng = np.random.default_rng(seed)
    short = [(0, 0), (1, 0), (0, 1), (1, 1), (3, 5), (10, 7), (2, 9)]
    reads, refs = [], []
    for i in range(n):
        if i % 8 == 0:
            read = rng.integers(0, 4, 128)
            ref = np.where(rng.random(128) < 0.05, rng.integers(0, 4, 128),
                           read)[:int(rng.integers(100, 129))]
        else:
            lr, lf = short[i % 8 - 1]
            read, ref = rng.integers(0, 4, lr), rng.integers(0, 4, lf)
        reads.append("".join("ACGT"[c] for c in read))
        refs.append("".join("ACGT"[c] for c in ref))
    return encode_batch(reads, refs, 128)


def _leap_runs():
    """17 pairs at each length 31, 32, 33, 63, 64, 65, 127 and 128 (word
    boundaries of L = 128) and error rate 0 or 0.01."""
    parts = [generate_dataset_arrays(17, n, err, seed=n + int(100 * err))
             for n in (31, 32, 33, 63, 64, 65, 127, 128)
             for err in (0.0, 0.01)]
    return [np.concatenate([p[i] for p in parts]) for i in range(4)]


def _nw_edges(L):
    """Lengths 0, 1 and L on both sides, each against each, and a few
    short and near-full pairs."""
    rng = np.random.default_rng(L)
    seqs = ["", "A", "".join("ACGT"[c] for c in rng.integers(0, 4, L))]
    reads = [a for a in seqs for _ in seqs] + ["ACGTACGT", "ACGT" * 25, "AC"]
    refs = [b for _ in seqs for b in seqs] + ["ACGTACGT", "ACGT" * 25,
                                              "TGCA" * 20]
    reads.append(seqs[2][:L - 1])
    refs.append(seqs[2][1:])
    return encode_batch(reads, refs, L)


def _nw_corpus(dev, kw):
    if kw is None:
        reads = ["A", "ACGT" * 32, "ACGTACGT", "", "ACGT" * 25, "AC"]
        refs = ["ACGT" * 32, "A", "ACGTACGT", "ACG", "ACGT" * 25, "TGCA" * 20]
        return [torch.from_numpy(np.concatenate([a, b])).to(dev) for a, b in
                zip(encode_batch(reads, refs, 128), _nw_edges(128))]
    if kw in ("edges256", "edges512"):
        return [torch.from_numpy(a).to(dev) for a in _nw_edges(int(kw[5:]))]
    if kw == "long_edges512":
        return [torch.from_numpy(a).to(dev) for a in long_edges()]
    if kw == "ragged_warps":
        return [torch.from_numpy(a).to(dev) for a in _ragged_warps()]
    if kw == "leap_runs":
        return [torch.from_numpy(a).to(dev) for a in _leap_runs()]
    return _corpus(dev, **kw)


@pytest.mark.parametrize("label,kw", NW_CASES, ids=[c[0] for c in NW_CASES])
@pytest.mark.parametrize("bw", nw_band.BWS)
def test_nw_band_kernel_matches_plain(dev, label, kw, bw):
    rc, rl, fc, fl = _nw_corpus(dev, kw)
    planes = [torch.from_numpy(greedy_cuda.stage_planes_t(
        a.cpu().numpy()).view(np.int32)).to(dev) for a in (rc, fc)]
    for x, o, e in [(1, 1, 1), (2, 3, 1), (1, 4, 2)]:
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
    """At L = 128 the pointers live in shared memory: a batch larger than
    the global scratch of the old layout (256 MiB of 2L * L bytes per
    pair: 8,192 pairs) runs in one launch, whatever the scratch limit."""
    rc, rl, fc, fl = _corpus(dev, num_reads=9001, length=100,
                             error_rate=0.1, seed=9)
    want = nw.nw_align(rc, rl, fc, fl, match_mask_threshold=3)
    assert nw_cuda.instance(True, 128)[1] == nw_cuda.ROUTE_SHARED
    monkeypatch.setattr(nw_cuda, "TRACE_SCRATCH_BYTES", 2 * 128 * 128 * 64)
    before = nw_cuda.LAUNCHES["nw_trace"]
    got = nw_cuda.nw_align_cuda(rc, rl, fc, fl, match_mask_threshold=3)
    torch.cuda.synchronize()
    assert nw_cuda.LAUNCHES["nw_trace"] == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_nw_trace_kernel_in_pieces_at_256(dev, monkeypatch):
    """At L = 256 the pointers take the global scratch: a launch larger
    than TRACE_SCRATCH_BYTES runs in pieces."""
    rc, rl, fc, fl = _corpus(dev, num_reads=300, length=200,
                             error_rate=0.1, seed=9, max_len=256)
    want = nw.nw_align(rc, rl, fc, fl, match_mask_threshold=3)
    assert nw_cuda.instance(True, 256)[1] == nw_cuda.ROUTE_GLOBAL
    monkeypatch.setattr(nw_cuda, "TRACE_SCRATCH_BYTES", 256 * 256 // 2 * 64)
    before = nw_cuda.LAUNCHES["nw_trace"]
    got = nw_cuda.nw_align_cuda(rc, rl, fc, fl, match_mask_threshold=3)
    torch.cuda.synchronize()
    assert nw_cuda.LAUNCHES["nw_trace"] == before + 5  # ceil(300 / 64)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_nw_trace_kernel_in_pieces_at_512(dev, monkeypatch):
    """At L = 512 the pointers take the global scratch too: a launch
    larger than TRACE_SCRATCH_BYTES runs in pieces."""
    rc, rl, fc, fl = _corpus(dev, num_reads=300, length=496,
                             error_rate=0.1, seed=9, max_len=512)
    want = nw.nw_align(rc, rl, fc, fl, match_mask_threshold=3)
    assert nw_cuda.instance(True, 512)[1] == nw_cuda.ROUTE_GLOBAL
    monkeypatch.setattr(nw_cuda, "TRACE_SCRATCH_BYTES", 512 * 512 // 2 * 128)
    before = nw_cuda.LAUNCHES["nw_trace"]
    got = nw_cuda.nw_align_cuda(rc, rl, fc, fl, match_mask_threshold=3)
    torch.cuda.synchronize()
    assert nw_cuda.LAUNCHES["nw_trace"] == before + 3  # ceil(300 / 128)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_nw_kernels_many_blocks(dev):
    """200,003 pairs, many waves of blocks, in one launch each."""
    rc, rl, fc, fl = _corpus(dev, num_reads=200_003, length=100,
                             error_rate=0.1, seed=12)
    pen, ops, mask = nw.nw_align(rc, rl, fc, fl, match_mask_threshold=3)
    before = dict(nw_cuda.LAUNCHES)
    assert torch.equal(nw_cuda.nw_penalty_cuda(rc, rl, fc, fl), pen)
    got = nw_cuda.nw_align_cuda(rc, rl, fc, fl, match_mask_threshold=3)
    torch.cuda.synchronize()
    for g, w in zip(got, (pen, ops, mask)):
        assert torch.equal(g, w)
    assert nw_cuda.LAUNCHES == dict(nw=before["nw"] + 1,
                                    nw_trace=before["nw_trace"] + 1)


def test_nw_kernels_spills_and_occupancy(dev):
    """The library holds the six instantiations the wrappers launch
    (penalty and trace, L = 128, 256 and 512) and no other; each builds
    without spills and resides on the SM, the trace kernel at L = 128
    (pointers in shared memory) with at least 8 warps per SM; the
    roofline's resources read the launched instantiation."""
    from asm_tpu_torch.tools import roofline as rl
    from asm_tpu_torch.utils.build import ptxas_usage

    nw_cuda.build_kernel()
    with open(nw_cuda.ptxas_report()) as f:
        usage = ptxas_usage(f.read())
    names = [nw_cuda.function_name(t, L) for t in (False, True)
             for L in (128, 256, 512)]
    assert len([k for k in usage if "nw_kernel" in k]) == len(names)
    for fn in names:
        hits = [u for k, u in usage.items() if fn in k]
        assert len(hits) == 1, fn
        assert hits[0]["spill_stores"] == hits[0]["spill_loads"] == 0
    for trace in (False, True):
        for L in (128, 256, 512):
            assert nw_cuda.occupancy(trace, L) >= 1
    assert nw_cuda.occupancy(True, 128) >= 8
    got = rl.nw_resources(True, 128)
    assert got["warps_per_sm"] == nw_cuda.occupancy(True, 128)


def test_nw_kernels_refuse_unbuilt_shapes(dev):
    rc, rl, fc, fl = _corpus(dev, num_reads=8, length=50, error_rate=0.1,
                             seed=1, max_len=96)
    with pytest.raises(NotImplementedError):
        nw_cuda.nw_penalty_cuda(rc, rl, fc, fl)
    with pytest.raises(NotImplementedError):
        nw_band.nw_penalty_banded(rc, rl, fc, fl, bw=16)
    long = _corpus(dev, num_reads=8, length=50, error_rate=0.1, seed=1,
                   max_len=384)
    for fn in (nw_cuda.nw_penalty_cuda, nw_cuda.nw_align_cuda,
               nw_band.nw_penalty_banded):
        with pytest.raises(NotImplementedError):
            fn(*long)
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
    ("max_len512", dict(num_reads=301, length=496, error_rate=0.05, seed=3,
                        max_len=512)),
    ("max_len512-full", dict(num_reads=131, length=512, error_rate=0.01,
                             seed=4, max_len=512)),
    ("long_edges512", "long_edges512"),
    # match runs that start inside a word, end on a word boundary or reach
    # the buffer's end
    ("runs", "leap_runs"),
    # every SM holds several resident blocks; the last block is partial
    ("many_blocks", dict(num_reads=200_003, length=100, error_rate=0.05,
                         seed=23)),
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


@pytest.mark.parametrize("k", [2, 4])
def test_leap_kernel_band_widths_at_512(dev, k):
    corpus = _corpus(dev, num_reads=201, length=496, error_rate=0.05,
                     seed=7, max_len=512)
    for sem, gate, pens in LEAP_VARIANTS:
        _leap_check(dev, corpus, _leap_cfg(sem, pens, 1, 512, k=k), sem,
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
    # k in {2, 3, 4} x W in {4, 8, 16} x (unit penalties: lv_bag and its
    # CIGAR mode, simd_ed_lev with and without the gate, simd_ed_affine;
    # x = 2, o = 3, e = 1: lv_bag and its CIGAR mode, simd_ed_affine;
    # simd_ed_lev is unit-cost alone), each on both input routes
    assert report.count("Compiling entry function") == 3 * 3 * (5 + 3) * 2


def test_leap_kernel_spills_and_occupancy(dev):
    """No instantiation spills; the main path's line reads its registers
    from the ptxas report and its warps per SM from the occupancy query."""
    from asm_tpu_torch.kernels import leap_cuda
    from asm_tpu_torch.tools import roofline as rl
    from asm_tpu_torch.utils.build import ptxas_usage

    leap_cuda.build_kernel()
    with open(leap_cuda.ptxas_report()) as f:
        usage = ptxas_usage(f.read())
    assert len(usage) == 144
    for name, u in usage.items():
        assert u["spill_stores"] == u["spill_loads"] == 0, name
    for k in (2, 3, 4):
        for L in (128, 256, 512):
            for cigar in (False, True):
                assert leap_cuda.occupancy(k, L, cigar) >= 1
    got = rl.leap_resources()
    assert got["warps_per_sm"] == 4 * leap_cuda.occupancy()
    got = rl.leap_resources(k=3, max_len=512, cigar=True)
    assert got["warps_per_sm"] == 4 * leap_cuda.occupancy(3, 512, True)


def test_leap_kernel_refuses_unbuilt_shapes(dev):
    from asm_tpu_torch.kernels import leap_cuda

    rc, rl, fc, fl = _corpus(dev, num_reads=8, length=50, error_rate=0.1,
                             seed=1)
    with pytest.raises(NotImplementedError):
        leap_cuda.leap_align_cuda(rc, rl, fc, fl, AlignConfig(k=5))
    long = _corpus(dev, num_reads=8, length=50, error_rate=0.1, seed=1,
                   max_len=384)
    with pytest.raises(NotImplementedError):
        leap_cuda.leap_align_cuda(*long, AlignConfig(max_len=384))
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


# ---- the read mapper -------------------------------------------------------

def mapper_planted(seed=11, n_genome=20000, n_reads=40, rlen=100):
    """tests/test_native_mapper.py's end-to-end corpus: reads cut from a
    random genome at known starts, two substitutions each."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, size=n_genome).astype(np.int8)
    starts = rng.integers(0, genome.shape[0] - rlen - 5, size=n_reads)
    reads = np.full((n_reads, 128), 4, np.int8)
    lens = np.full(n_reads, rlen, np.int32)
    for i, s in enumerate(starts):
        r = genome[s: s + rlen].copy()
        for _ in range(2):
            p = int(rng.integers(0, rlen))
            r[p] = (r[p] + 1 + rng.integers(0, 3)) % 4
        reads[i, :rlen] = r
    return genome, reads, lens


def mapper_repeat():
    """A read whose every pigeonhole seed lies in a 64-copy repeat
    (tests/test_native_mapper.py), with a candidate cap below the copies."""
    from asm_tpu_torch.encoding import PAD_READ, encode_string

    unit = "ACGTTGCATCGATCAGGTCCAATGCCGTAGGACTTACGGA"
    genome = encode_string(unit * 64, 40 * 64, pad=5)
    read = unit * 2
    reads = encode_string(read, 128, pad=PAD_READ)[None, :]
    return genome, reads, np.array([len(read)], np.int32)


def mapper_edges(seed=4, n_genome=6000):
    """Reads cut at the genome's last bases (windows clipped at its end),
    reads of 60-100 bases, random reads with no candidate, reads shorter
    than the seed count, and an empty read."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, size=n_genome).astype(np.int8)
    rows = []
    for back in (100, 101, 103, 90, 70):  # ends at or near the last base
        r = genome[n_genome - back: n_genome - back + min(back, 100)].copy()
        r[5] = (r[5] + 1) % 4
        rows.append(r)
    for rlen in (60, 75, 99, 100):
        s = int(rng.integers(0, n_genome - rlen))
        r = genome[s: s + rlen].copy()
        r[rlen // 2] = (r[rlen // 2] + 2) % 4
        rows.append(r)
    rows += [rng.integers(0, 4, size=100).astype(np.int8) for _ in range(4)]
    rows += [genome[:3].copy(), genome[10:12].copy(), genome[:0].copy()]
    reads = np.full((len(rows), 128), 4, np.int8)
    lens = np.array([r.size for r in rows], np.int32)
    for i, r in enumerate(rows):
        reads[i, :r.size] = r
    return genome, reads, lens


# case -> (corpus, MapperConfig keywords; "max_steps" sets align.max_steps)
MAPPER_CARD_CASES = {
    "planted": (mapper_planted, dict(batch=16)),
    "repeat": (mapper_repeat, dict(max_hits_per_seed=8, max_candidates=32)),
    "truncation": (mapper_planted, dict(max_steps=2, two_phase=True)),
}


def mapper_config(MapperConfig, kw):
    """MapperConfig(**kw) of either package, max_steps applied to align."""
    kw = dict(kw)
    max_steps = kw.pop("max_steps", None)
    mcfg = MapperConfig(**kw)
    if max_steps is not None:
        import dataclasses

        mcfg = dataclasses.replace(mcfg, align=dataclasses.replace(
            mcfg.align, max_steps=max_steps))
    return mcfg


@pytest.mark.parametrize("case", sorted(MAPPER_CARD_CASES))
def test_mapper_cuda_matches_torch(dev, case):
    from asm_tpu_torch.mapper.core import MapperConfig, build_index, map_reads

    corpus, kw = MAPPER_CARD_CASES[case]
    genome, reads, lens = corpus()
    mcfg = mapper_config(MapperConfig, kw)
    idx = build_index(genome)
    before = greedy_cuda.LAUNCHES
    prof = {}
    got = map_reads(idx, genome, reads, lens, mcfg=mcfg, profile=prof,
                    device=dev, impl="cuda")
    assert greedy_cuda.LAUNCHES - before >= prof["p1_batches"] > 0
    assert prof["kernel_ms"] > 0
    want = map_reads(idx, genome, reads, lens, mcfg=mcfg, device=dev,
                     impl="torch")
    assert got[0] == want[0]
    assert got[1] == want[1]


def test_mapper_refuses_unbuilt_k(dev):
    from asm_tpu_torch.mapper.core import MapperConfig, build_index, map_reads

    genome, reads, lens = mapper_planted(n_reads=8)
    mcfg = MapperConfig(align=AlignConfig(k=5, max_steps=32))
    with pytest.raises(NotImplementedError):
        map_reads(build_index(genome), genome, reads, lens, mcfg=mcfg,
                  device=dev, impl="cuda")


def test_msa_on_card_matches_cpu(dev):
    """profile_align's eager ops on the card give the CPU's bits (which
    tests/test_torch_msa.py holds against asm_tpu), at max_len 32 (fused
    multiply-adds) and 128."""
    from asm_tpu_torch.kernels import msa

    rng = np.random.default_rng(5)
    for L in (32, 128):
        als = [["".join(rng.choice(list("ACGT-"), size=int(n)))
                for _ in range(3)]
               for n in rng.integers(1, L + 1, size=400)]
        host = (*msa.profiles_from_alignments(als[:200], L),
                *msa.profiles_from_alignments(als[200:], L))
        cpu = msa.profile_align(*map(torch.from_numpy, host))
        card = msa.profile_align(*(torch.from_numpy(a).to(dev)
                                   for a in host))
        assert torch.equal(card["ops"].cpu(), cpu["ops"])
        assert torch.equal(card["score"].cpu(), cpu["score"])


def test_demo_on_card_matches_cpu(dev, capsys):
    from asm_tpu_torch.apps import demo

    for argv in ([], ["ACGTTGCAACGTAAGGCTTACG", "ACGTGCAACGTTAAGGCTACGGATC"]):
        demo.main(argv)
        card = capsys.readouterr().out
        demo.main(argv + ["--device", "cpu"])
        assert card == capsys.readouterr().out
