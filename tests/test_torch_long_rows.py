"""The port above max_len 512 on the CPU (max_len 544, 800, 1024 and 2048;
the band also at BW 128): every CUDA wrapper runs its plain version for
CPU tensors and is held against asm_tpu's XLA kernels (greedy_align,
leap_align, nw_penalty, nw_align), its scalar references on a few pairs
(greedy_ref, leap_ref, nw_ref), the Pallas band kernel in interpret mode
at max_len 544 and at BW 128 (above it, the XLA nw_penalty where the
band certifies), and leap_align(want_history) + leap_backtrack_batch for the fused
CIGAR; the harness at max_len 1024 against asm_tpu's; the long-sequence tool at
max_len 1024 against the JAX totals; and the shape plan's long-row rules.
The Pallas greedy, NW and LEAP kernels run no case here: in interpret
mode at L >= 1024 one call takes minutes.

Tolerance: exact equality everywhere."""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asm_tpu.bench.harness import run_benchmark as jax_run_benchmark
from asm_tpu.config import AlignConfig as JaxConfig
from asm_tpu.data.generator import generate_dataset
from asm_tpu.encoding import decode_string, encode_batch
from asm_tpu.kernels.greedy import greedy_align as jax_greedy
from asm_tpu.kernels.leap import leap_align as jax_leap
from asm_tpu.kernels.leap_backtrack import leap_backtrack_batch as jax_bt
from asm_tpu.kernels.nw import nw_align as jax_nw_align
from asm_tpu.kernels.nw import nw_penalty as jax_nw_penalty
from asm_tpu.kernels.nw_band import nw_penalty_banded as jax_banded
from asm_tpu.metrics.coverage import check_coverage
from asm_tpu.native import generate_dataset_native
from asm_tpu.ops.cigar import batch_greedy_cigars, batch_nw_cigars
from asm_tpu.reference_impl.greedy_ref import greedy_ref
from asm_tpu.reference_impl.leap_ref import leap_ref
from asm_tpu.reference_impl.nw_ref import nw_ref
from asm_tpu_torch.bench.harness import run_benchmark
from asm_tpu_torch.config import AlignConfig, config_from_jax
from asm_tpu_torch.kernels import nw_band, nw_cuda, shapes
from asm_tpu_torch.kernels.greedy_cuda import (
    greedy_align_cuda,
    stage_planes_t,
    stage_planes_tiled_t,
)
from asm_tpu_torch.kernels.leap_cuda import leap_align_cuda, leap_cigar_decode
from asm_tpu_torch.kernels.nw_band import nw_penalty_banded
from asm_tpu_torch.kernels.nw_cuda import nw_align_cuda, nw_penalty_cuda
from asm_tpu_torch.tools import longseq_headline as lh
from asm_tpu_torch.utils.bounds import greedy_work
from test_torch_cuda import long_edges

torch.set_num_threads(1)

LENGTHS = [544, 800, 1024, 2048]
_CORPORA = {}


def corpus(L):
    """Per max_len: generated reads of L - 6 - L // 50 bases at err 0.05
    and 0.15 (12 pairs each), then the edge lengths 0, 1, 31, L - 1 and L
    each against each plus the indel pairs of `long_edges`; and the
    generated pairs' strings (for the scalar references)."""
    if L not in _CORPORA:
        parts, strings = [], ([], [])
        for err in (0.05, 0.15):
            reads, refs = generate_dataset(12, lh.read_length(L), err, 0.96,
                                           seed=L + int(100 * err))
            parts.append(encode_batch(reads, refs, L))
            strings[0].extend(reads)
            strings[1].extend(refs)
        parts.append(long_edges(L, seed=L, lens=[0, 1, 31, L - 1, L]))
        _CORPORA[L] = (tuple(np.ascontiguousarray(np.concatenate(c))
                             for c in zip(*parts)), strings)
    return _CORPORA[L]


def _port_greedy(c, cfg, form):
    rc, rl, fc, fl = c
    if form == "codes":
        return greedy_align_cuda(*map(torch.from_numpy, c), cfg)
    return greedy_align_cuda(
        torch.from_numpy(stage_planes_tiled_t(rc, tile=128)),
        torch.from_numpy(rl),
        torch.from_numpy(stage_planes_tiled_t(fc, tile=128)),
        torch.from_numpy(fl), cfg, pre_staged="planes_tiled", tile=128)


def _cigars(out):
    return batch_greedy_cigars({k: np.asarray(v) for k, v in out.items()})


@pytest.mark.parametrize("L", LENGTHS)
@pytest.mark.parametrize("k", [3, 4])
def test_greedy_long_rows(L, k):
    """Greedy at k = 3 and 4 in both input forms equals the XLA greedy
    (cost, steps, CIGARs), and greedy_ref on three err 0.05 pairs
    (greedy_ref may part from the kernels at exact heuristic ties on
    high-error pairs; see asm_tpu's greedy_ref)."""
    c, (reads, refs) = corpus(L)
    jcfg = JaxConfig(k=k, max_len=L, max_steps=L // 2)
    ref = jax_greedy(*map(jnp.asarray, c), jcfg)
    assert int(np.asarray(ref["steps"]).max()) < L // 2
    for form in ("codes", "planes_tiled"):
        got = _port_greedy(c, config_from_jax(jcfg), form)
        for key in ("cost", "steps"):
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(ref[key]), err_msg=key)
        assert _cigars(got) == _cigars(ref)
    for i in (0, 1, 2):
        assert int(got["cost"][i]) == greedy_ref(
            reads[i], refs[i], k=k, max_len=L)[0], i


LEAP_VARIANTS = [("lv_bag", False, (1, 1, 1)), ("lv_bag", False, (2, 3, 1)),
                 ("simd_ed_lev", False, (1, 1, 1)),
                 ("simd_ed_lev", True, (1, 1, 1)),
                 ("simd_ed_affine", False, (2, 3, 1))]


@pytest.mark.parametrize("L", LENGTHS)
@pytest.mark.parametrize("sem,gate,pens", LEAP_VARIANTS,
                         ids=["-".join(map(str, v)) for v in LEAP_VARIANTS])
def test_leap_long_rows(L, sem, gate, pens):
    """LEAP in three semantics (the SHD gate too) with both penalty sets
    equals the XLA leap_align; lv_bag also leap_ref on three pairs."""
    c, (reads, refs) = corpus(L)
    x, o, e = pens
    af = 3 if sem == "simd_ed_lev" else 200
    jcfg = JaxConfig(x=x, o=o, e=e, k=3, max_len=L, leap_af_threshold=af)
    ref = jax_leap(*map(jnp.asarray, c), jcfg, semantics=sem,
                   use_shd_gate=gate)
    got = leap_align_cuda(*map(torch.from_numpy, c), config_from_jax(jcfg),
                          semantics=sem, use_shd_gate=gate)
    for key in ("passed", "penalty", "lane_shift"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]),
                                      err_msg=key)
    if sem != "lv_bag":
        return
    for i in (0, 12, 13):
        passed, pen, shift = leap_ref(
            reads[i], refs[i], k=3, af_threshold=af, ms_penalty=x,
            gap_open_penalty=o, gap_ext_penalty=e, max_len=L)
        assert (bool(got["passed"][i]), int(got["penalty"][i]),
                int(got["lane_shift"][i])) == (bool(passed), pen, shift), i


@pytest.mark.parametrize("kernel,k", [("greedy", 28), ("leap", 20)])
def test_newly_admitted_k_at_1024(kernel, k):
    """The long-row plans admit k up to 31 at max_len 1024 (one copy of a
    pair's rows or planes for its group, not one a thread), where shared
    memory held greedy to 24 and LEAP to 13: the port at greedy k = 28 in both
    input forms (cost, steps, CIGARs) and LEAP k = 20 (lv_bag, and
    simd_ed_affine at 2/3/1) equals asm_tpu's XLA kernels."""
    L = 1024
    c, _ = corpus(L)
    if kernel == "greedy":
        assert shapes.greedy_plan(k, L).group == 32
        jcfg = JaxConfig(k=k, max_len=L, max_steps=L // 2)
        ref = jax_greedy(*map(jnp.asarray, c), jcfg)
        for form in ("codes", "planes_tiled"):
            got = _port_greedy(c, config_from_jax(jcfg), form)
            for key in ("cost", "steps"):
                np.testing.assert_array_equal(got[key].numpy(),
                                              np.asarray(ref[key]))
            assert _cigars(got) == _cigars(ref)
        return
    for sem, (x, o, e) in (("lv_bag", (1, 1, 1)),
                           ("simd_ed_affine", (2, 3, 1))):
        assert shapes.leap_plan(k, L, x, o, e).group == 32
        jcfg = JaxConfig(x=x, o=o, e=e, k=k, max_len=L, leap_af_threshold=200)
        ref = jax_leap(*map(jnp.asarray, c), jcfg, semantics=sem)
        got = leap_align_cuda(*map(torch.from_numpy, c),
                              config_from_jax(jcfg), semantics=sem)
        for key in ("passed", "penalty", "lane_shift"):
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(ref[key]), err_msg=key)


@pytest.mark.parametrize("L", LENGTHS)
@pytest.mark.parametrize("pens", [(1, 1, 1), (2, 3, 1)])
def test_fused_leap_cigar_long_rows(L, pens):
    """The fused-CIGAR records (16-bit history cells) decode to
    leap_align(want_history) + leap_backtrack_batch's CIGARs."""
    c, _ = corpus(L)
    x, o, e = pens
    jcfg = JaxConfig(x=x, o=o, e=e, k=3, max_len=L, leap_af_threshold=200)
    first = jax_leap(*map(jnp.asarray, c), jcfg)
    pen, ok = np.asarray(first["penalty"]), np.asarray(first["passed"])
    E = max(8, int(pen[ok].max()))
    jcfg = JaxConfig(x=x, o=o, e=e, k=3, max_len=L, leap_af_threshold=200,
                     leap_max_energy=E)
    h = jax_leap(*map(jnp.asarray, c), jcfg, want_history=True)
    cfg = config_from_jax(jcfg)
    got = leap_align_cuda(*map(torch.from_numpy, c), cfg, want_cigar=True)
    np.testing.assert_array_equal(got["penalty"].numpy(),
                                  np.asarray(h["penalty"]))
    assert [d and d[1] for d in leap_cigar_decode(got, cfg)] == [
        d and d[1] for d in jax_bt(h, jcfg)]


NW_XOE = {544: (1, 1, 1), 800: (2, 3, 1), 1024: (1, 1, 1), 2048: (2, 3, 1)}


@pytest.mark.parametrize("L", LENGTHS)
def test_nw_long_rows(L):
    """NW penalty and trace (ops, match mask) equal the XLA nw_penalty /
    nw_align (x/o/e 1/1/1 at 544 and 1024, 2/3/1 at 800 and 2048) on six
    err 0.15 pairs and the edge lengths (0, L), (1, 31), (31, L), (L, 0),
    (L - 1, L) and (L, L) and an indel pair; nw_ref on two pairs at 544
    (a Python loop: 1 s a pair there, 15 s at 2048)."""
    c, (reads, refs) = corpus(L)
    pick = list(range(12, 18)) + [24 + i for i in (4, 7, 14, 20, 23, 24,
                                                    29)]
    c = tuple(np.ascontiguousarray(a[pick]) for a in c)
    a = list(map(jnp.asarray, c))
    t = list(map(torch.from_numpy, c))
    x, o, e = NW_XOE[L]
    pen = nw_penalty_cuda(*t, x, o, e).numpy()
    np.testing.assert_array_equal(pen, np.asarray(jax_nw_penalty(*a, x, o, e)))
    got = nw_align_cuda(*t, x, o, e, match_mask_threshold=3)
    for g, w in zip(got, jax_nw_align(*a, x, o, e, match_mask_threshold=3)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if L == 544:
        for i in (0, 1):
            assert nw_penalty_cuda(*t)[i] == nw_ref(
                reads[12 + i], refs[12 + i], traceback=False)[0], i


@pytest.mark.parametrize("L", [1024, 2048])
def test_nw_walk_tile_edges(L):
    """The walk-edge pairs (asm_tpu_torch.data.walk_edges: 300-base
    deletion and insertion at a multiple of 64, a read of length 1 against
    a ref of length L and the reverse, pairs that differ at every
    position, lengths at multiples of 64 and one either side, equal
    sequences), whose tracebacks cross the long trace kernel's 64 x 64
    walk tiles at their edges and corners and run along one: the CPU path
    of nw_align_cuda (penalty, ops, mask at 3) and nw_penalty_cuda equal
    the XLA nw_align / nw_penalty, x/o/e 1/1/1 and 2/3/1. chip_smoke 18a
    and tests/test_torch_cuda.py hold the kernel on the same pairs."""
    from asm_tpu_torch.data.walk_edges import walk_edge_pairs

    c = walk_edge_pairs(L)
    a = list(map(jnp.asarray, c))
    t = list(map(torch.from_numpy, c))
    for x, o, e in ((1, 1, 1), (2, 3, 1)):
        want = jax_nw_align(*a, x, o, e, match_mask_threshold=3)
        got = nw_align_cuda(*t, x, o, e, match_mask_threshold=3)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(nw_penalty_cuda(*t, x, o, e).numpy(),
                                      np.asarray(jax_nw_penalty(*a, x, o,
                                                                e)))
    # the pairs' paths: the gaps run along a tile edge, the rest cross
    m, n = c[1].astype(int), c[3].astype(int)
    assert (n[0] - m[0], m[1] - n[1]) == (300, 300)
    assert (m[2], n[2]) == (1, L) and (m[3], n[3]) == (L, 1)
    assert {v % 64 for v in m[6:]} >= {63, 0, 1}


@pytest.mark.parametrize("L", [544, 2048, 3072])
def test_nw_block_edges(L):
    """The block-edge pairs (asm_tpu_torch.data.block_edges: the read
    length at the long full kernel's strip edges and block edges, e.g.
    1023, 1024 and 1025 at 2048; the ref length where its step loop's
    head, steady loop and tail meet, 1 and 30-33, and at L; empty and
    one-base sides, equal sequences, sequences that differ everywhere):
    the CPU path of nw_penalty_cuda equals the XLA nw_penalty, x/o/e 1/1/1
    and 2/3/1, at one block (544), two (2048) and three (3072).
    chip_smoke 18a and tests/test_torch_cuda.py hold the kernel on the
    same pairs."""
    from asm_tpu_torch.data.block_edges import block_edge_pairs

    c = block_edge_pairs(L)
    a = list(map(jnp.asarray, c))
    t = list(map(torch.from_numpy, c))
    for x, o, e in ((1, 1, 1), (2, 3, 1)):
        np.testing.assert_array_equal(nw_penalty_cuda(*t, x, o, e).numpy(),
                                      np.asarray(jax_nw_penalty(*a, x, o,
                                                                e)))
    # the pairs reach the layout's edges
    R = shapes.nw_long_rows(L)
    RB = shapes.NW_LONG_G * R
    m, n = set(c[1].tolist()), set(c[3].tolist())
    assert {R - 1, R, R + 1, 0, 1, L} <= m and {0, 1, 30, 31, 32, 33, L} <= n
    for b in range(1, shapes.nw_blocks(L)):
        assert {b * RB - 1, b * RB, b * RB + 1} <= m
    assert np.array_equal(c[0][-2], c[2][-2]) and c[1][-2] == L
    k = c[1][-1]
    assert (c[0][-1][:k] != c[2][-1][:k]).all() and c[3][-1] == k


def test_trace_pieces_fill_the_card():
    """shapes.trace_piece: a launch of the trace kernel's global route
    holds the pairs whose pointer scratch the cap holds, which at L =
    1024 and 2048 is several waves of the pairs an H100 holds at once (16
    and 10 warps per SM, one pair a warp, 132 SMs), where the 2 GiB it
    was held 0.78 of one at 2048; a cap below one pair's scratch
    raises."""
    per = {L: shapes.nw_launch(True, L)["scratch_per_pair"]
           for L in (1024, 2048)}
    assert per == {1024: 1024 * 1024 // 2, 2048: 2048 * 2048 // 2}
    waves = {L: shapes.trace_piece(per[L], shapes.TRACE_SCRATCH_BYTES)
             / (w * 132)
             for L, w in ((1024, 16), (2048, 10))}
    assert waves[1024] > 7 and waves[2048] > 3
    assert shapes.trace_piece(per[2048], 2 << 30) / (10 * 132) < 1
    assert shapes.trace_piece(per[2048], per[2048] * 64) == 64
    assert shapes.trace_piece(per[2048], per[2048]) == 1
    with pytest.raises(NotImplementedError, match="trace scratch"):
        shapes.trace_piece(per[2048], per[2048] - 1)


def _band_corpus(L):
    """Four pairs for the interpret-mode band: an err 0.15 pair, the
    lengths (L, 1), (31, L) and (L, L); at L <= 512 max_len 544's, cut."""
    c, _ = corpus(max(L, 544))
    if L <= 512:
        c = tuple(np.ascontiguousarray(a[:, :L]) if a.ndim == 2 else
                  np.minimum(a, L) for a in c)
    pick = [12, 24 + 4 * 5 + 1, 24 + 2 * 5 + 4, 24 + 4 * 5 + 4]
    return tuple(np.ascontiguousarray(a[pick]) for a in c)


@pytest.mark.parametrize("L,bw", [(544, 128), (128, 128)])
def test_band_matches_pallas_interpret(L, bw):
    """The band at BW 128, max_len 544 and 128, equals the Pallas band kernel in interpret mode, INF and
    uncertified upper bounds included, in both input forms. (One such
    call costs 5-20 s whatever the batch, the interpreter's price per
    diagonal, so the longer rows are held by the next test.)"""
    c = _band_corpus(L)
    a = list(map(jnp.asarray, c))
    t = list(map(torch.from_numpy, c))
    planes = [torch.from_numpy(stage_planes_t(v)) for v in (c[0], c[2])]
    want = np.asarray(jax_banded(*a, bw=bw, x=2, o=3, e=1, interpret=True))
    got = nw_penalty_banded(*t, bw=bw, x=2, o=3, e=1)
    np.testing.assert_array_equal(got.numpy(), want)
    got = nw_penalty_banded(planes[0], t[1], planes[1], t[3], bw=bw, x=2,
                            o=3, e=1, pre_staged=True)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("L", [800, 1024, 2048])
def test_band_long_rows_certify_the_xla_penalty(L):
    """At max_len 800, 1024 and 2048, BW 4-128: where the band certifies,
    its penalty is asm_tpu's XLA nw_penalty; where the destination lies
    off the band it is INF (a pair with an empty read takes the closed
    form); elsewhere an upper bound of it. BW 128
    certifies penalties up to 63, so up to max_len 1024 it certifies
    every err 0.05 pair (at 2048 those cost about 100)."""
    c, _ = corpus(L)
    t = list(map(torch.from_numpy, c))
    exact = np.asarray(jax_nw_penalty(*map(jnp.asarray, c)))
    dk = np.minimum(c[1], L) - np.minimum(c[3], L)
    for bw in shapes.BAND_WIDTHS:
        got = nw_penalty_banded(*t, bw=bw).numpy()
        off = (dk < 1 - bw // 2) | (dk > bw // 2)
        cert = nw_band.band_certified(got, bw)
        # an empty read takes the closed form on or off the band
        np.testing.assert_array_equal(got[off & (c[1] > 0)], nw_band.INF)
        np.testing.assert_array_equal(got[cert], exact[cert])
        assert (got >= exact).all()
        if bw == 128 and L <= 1024:
            assert cert[:12].all()


@pytest.mark.parametrize("L", [544, 1024, 2048])
def test_band_edges_certify_the_xla_penalty(L):
    """The band-edge pairs (data/band_edges: destinations at both band
    edges, at the first two threads' boundary, on the main diagonal and
    just off the band, m+n of both parities, empty and one-base
    sequences, the border trips' end) at BW 4-128: where the band
    certifies, its penalty is asm_tpu's XLA nw_penalty; off the band it
    is INF (an empty read takes the closed form); elsewhere an upper
    bound. Every width's pairs go through nw_penalty in one batch."""
    from asm_tpu_torch.data.band_edges import band_edge_pairs

    sets = {bw: band_edge_pairs(L, bw) for bw in shapes.BAND_WIDTHS}
    exact = np.asarray(jax_nw_penalty(*(
        jnp.asarray(np.concatenate([c[i] for c in sets.values()]))
        for i in range(4))))
    at = 0
    for bw, c in sets.items():
        want = exact[at:at + c[1].size]
        at += c[1].size
        got = nw_penalty_banded(*map(torch.from_numpy, c), bw=bw).numpy()
        dk = c[1] - c[3]
        off = (dk < 1 - bw // 2) | (dk > bw // 2)
        assert off.sum() >= 4 and (~off).sum() >= 8
        np.testing.assert_array_equal(got[off & (c[1] > 0)], nw_band.INF)
        np.testing.assert_array_equal(got[off & (c[1] == 0)],
                                      want[off & (c[1] == 0)])
        cert = nw_band.band_certified(got, bw)
        np.testing.assert_array_equal(got[cert], want[cert])
        assert (got >= want).all()


def test_harness_at_max_len_1024():
    """The harness (impl torch on the CPU) at max_len 1024 on 64 pairs
    of 998 bases: the greedy == NW and LEAP == NW counts equal asm_tpu's
    harness (XLA), and the covered count equals asm_tpu's exact coverage
    check (check_coverage on the XLA nw_align and greedy CIGARs, the
    check the harness's certificate stands in for)."""
    L = 1024
    c = generate_dataset_native(64, L - 26, 0.05, 0.96, seed=42, max_len=L)
    got = run_benchmark(*c, cfg=AlignConfig(max_len=L), chunk=64,
                        device="cpu", impl="torch")
    jcfg = JaxConfig(max_len=L)
    want = jax_run_benchmark(*c, cfg=jcfg, chunk=64, want_coverage=False)
    assert got.total == want.total == 64
    assert got.greedy_accuracy == want.greedy_accuracy
    assert got.leap_accuracy == want.leap_accuracy
    a = list(map(jnp.asarray, c))
    _, nw_ops, _ = jax_nw_align(*a, match_mask_threshold=3)
    nw_cig = batch_nw_cigars(np.asarray(nw_ops))
    g_cig = _cigars(jax_greedy(*a, jcfg))
    covered = sum(check_coverage(decode_string(c[0][i], int(c[1][i])),
                                 decode_string(c[2][i], int(c[3][i])),
                                 g_cig[i], nw_cig[i], 1, 3)
                  for i in range(64))
    assert got.coverage_checked == 64
    assert round(got.greedy_coverage * 64) == covered


def test_longseq_tool_at_1024_matches_jax():
    """The long-sequence tool at max_len 1024 on the CPU (plain versions)
    gives the greedy cost total, LEAP penalty total and passed count of
    the XLA kernels on the same native corpus, and the CIGAR digest of
    leap_align(want_history) + leap_backtrack_batch."""
    L, pairs = 1024, 256
    res = lh.run_length(L, pairs, reps=1, tile=128, device="cpu",
                        digest=pairs, check_plain=16)
    rows = {r["kernel"]: r for r in res["rows"]}
    c = generate_dataset_native(pairs, lh.read_length(L), 0.05, 0.96,
                                seed=7, max_len=L)
    a = list(map(jnp.asarray, c))
    g = jax_greedy(*a, JaxConfig(k=3, max_len=L, max_steps=512))
    assert int(np.asarray(g["steps"]).max()) < 512
    assert rows["greedy"]["checksum"] == int(np.asarray(g["cost"]).sum())
    jcfg = JaxConfig(k=3, max_len=L)
    lp = jax_leap(*a, jcfg)
    pen, ok = np.asarray(lp["penalty"]), np.asarray(lp["passed"])
    for key in ("leap_penalty", "leap_cigar"):
        assert rows[key]["checksum"] == int(pen.sum())
    assert rows["leap_penalty"]["passed"] == int(ok.sum())
    hcfg = JaxConfig(k=3, max_len=L, leap_max_energy=int(pen[ok].max()))
    cig = [d[1] for d in jax_bt(jax_leap(*a, hcfg, want_history=True), hcfg)
           if d is not None]
    assert res["digest"] == (
        hashlib.sha256("\n".join(cig).encode()).hexdigest(), len(cig))


@pytest.mark.parametrize("L", range(544, 2049, 32))
def test_long_row_plans(L):
    """Every max_len 544-2048 has a plan: greedy and LEAP at k 0-4 (LEAP
    at both tuned penalty sets) on the long path's groups, one lane a
    thread (the least power of two >= 2k + 1 threads a pair, LEAP's at
    least 4), in blocks of 128 threads; greedy's shared memory the block's
    pairs' hurdle rows
    (2k + 1 rows of W | 1 words), LEAP's the pairs' staged planes (W + 1
    words of 16 bytes); NW full and trace, the band at BW 4-128; each
    library is one of its own, named by the shape."""
    W = L // 32
    for k in range(5):
        G = {0: 1, 1: 4, 2: 8, 3: 8, 4: 16}[k]
        GL = max(4, G)
        p = shapes.greedy_plan(k, L)
        assert (p.stem, p.threads, p.group) == (f"greedy_k{k}_w{W}", 128, G)
        assert dict(p.defines) == dict(ASM_SHAPE_K=k, ASM_SHAPE_W=W,
                                       ASM_SHAPE_THREADS=128,
                                       ASM_SHAPE_GROUP=G)
        assert p.smem_bytes == 4 * (2 * k + 1) * (W | 1) * (128 // G)
        assert p.smem_bytes <= shapes.SMEM_BLOCK_LIMIT
        for pens in shapes.LEAP_PENALTIES:
            p = shapes.leap_plan(k, L, *pens)
            assert (p.threads, p.group) == (128, GL) and not p.tuned
            assert dict(p.defines)["ASM_SHAPE_GROUP"] == GL
            assert p.smem_bytes == 16 * (W + 1) * (128 // GL)
            assert p.pairs_per_block == 128 // GL
    p = shapes.nw_plan(L)
    assert p.stem == f"nw_w{W}" and dict(p.defines) == dict(
        ASM_SHAPE_W=W, ASM_NW_G=32, ASM_NW_TRACE_G=32,
        ASM_NW_TRACE_ROUTE=shapes.ROUTE_GLOBAL)
    for trace in (False, True):
        got = shapes.nw_launch(trace, L)
        R, nb = got["rows"], got["blocks"]
        assert nb == -(-L // 1024) and R % 4 == 0 and R <= 32
        assert L <= nb * 32 * R and got["threads"] == 32
        # the trace's walk buffers (4 tiles of 2 KiB, ops, mask) reuse the
        # parked row's bytes
        assert got["smem_bytes"] == (2 * L if trace else L) + max(
            8 * L if nb > 1 else 0, 8192 + 3 * L if trace else 0)
        assert got["scratch_per_pair"] == (L * nb * 32 * R // 2 if trace
                                           else 0)
        assert nw_cuda.function_name(trace, L) == (
            f"nw_long_kernelILi{W}ELb1E" if trace
            else f"nw_long_full_kernelILi{W}E")
    for bw in shapes.BAND_WIDTHS:
        assert shapes.band_plan(L, bw).stem == f"nw_band_w{W}"
        got = shapes.band_wide_launch(bw, L)
        assert got["threads"] in (32, 64, 128)
        assert got["smem_bytes"] <= shapes.SMEM_BLOCK_LIMIT


def test_long_row_limits_are_computed():
    """Past the shared memory of a block's rows (greedy: at 32 threads,
    32 / G pairs of 2k + 1 rows) the greedy plan raises
    NotImplementedError naming it, far past the per-thread rows' limit
    (k = 3 reaches max_len 8,160 there, 16,384 at 128 threads now); LEAP
    past a lane shift of one word (k 31) names it, past its 16-bit history
    cells names them, and its block shrinks to fit the staged planes (k =
    0 on groups of 4 reaches 58,080); every max_len that the per-thread
    layouts before the groups admitted (greedy 4 (2W + 4)(2k + 1) bytes a
    thread, LEAP 8 W (2k + 1), at 32 threads) still has a plan; the NW long
    path and the band past shared memory name it; off the 32 grid is a
    ValueError. The long path's greedy bound and NW warp steps."""
    assert shapes.greedy_plan(3, 16384).threads == 128
    assert shapes.greedy_plan(3, 65536).threads == 32
    with pytest.raises(NotImplementedError, match="shared memory"):
        shapes.greedy_plan(3, 66560)
    assert shapes.greedy_plan(31, 2048).group == 32
    with pytest.raises(NotImplementedError, match="shared memory"):
        shapes.greedy_plan(31, 32768)
    assert shapes.leap_plan(31, 2048, 1, 1, 1).group == 32
    with pytest.raises(NotImplementedError, match="one word"):
        shapes.leap_plan(32, 544, 1, 1, 1)
    assert shapes.leap_plan(4, 4096, 1, 1, 1).threads == 128
    assert shapes.leap_plan(0, 8192, 1, 1, 1).threads == 128
    assert shapes.leap_plan(0, 16384, 1, 1, 1).threads == 64
    for pens in shapes.LEAP_PENALTIES:
        p = shapes.leap_plan(0, 29056, *pens)
        assert (p.group, p.threads) == (4, 32)
        assert shapes.leap_plan(0, 58080, *pens).threads == 32
        with pytest.raises(NotImplementedError, match="shared memory"):
            shapes.leap_plan(0, 58112, *pens)
    for k in range(shapes.GREEDY_MAX_K + 1):
        top = shapes.SMEM_BLOCK_LIMIT // (4 * (2 * k + 1) * 32) // 2 - 2
        for W in range(shapes.LONG_W + 1, top + 1):
            shapes.greedy_plan(k, 32 * W)
        top = shapes.SMEM_BLOCK_LIMIT // (8 * (2 * k + 1) * 32)
        for W in range(shapes.LONG_W + 1, top + 1):
            for pens in shapes.LEAP_PENALTIES:
                shapes.leap_plan(k, 32 * W, *pens)
    with pytest.raises(NotImplementedError, match="16 bits"):
        shapes.leap_plan(0, 1 << 16, 1, 1, 1)
    with pytest.raises(NotImplementedError, match="shared memory"):
        shapes.nw_plan(32 * 1024)
    with pytest.raises(NotImplementedError, match="shared memory"):
        shapes.band_plan(8192, 4)
    assert shapes.band_plan(8192, 128).stem == "nw_band_w256"
    with pytest.raises(ValueError):
        shapes.nw_plan(1000)
    # greedy's bound above 512: a step's queries need one word a lane
    assert greedy_work([3, 5], [8], 2, k=3, L=1024)[0] == (
        2 * 7 * 32 * 8 + 8 * 7 * (10 + 12))
    assert greedy_work([3, 5], [8], 2, k=3, L=512)[0] == (
        2 * 7 * 16 * 8 + 8 * 7 * (10 * 16 + 12))
    # the warp steps of the long path: the blocks above the pair's last run
    # n + 31 steps, the last until its row m's thread reaches column n
    steps = nw_cuda.warp_steps([2000, 1024, 1025, 0], [1990, 5, 5, 9], 2048,
                               32)
    assert steps.tolist() == [1990 + 31 + 1990 + 975 // 32, 5 + 1023 // 32,
                              5 + 31 + 5, 0]


def _listing(ns, body):
    """Two kernels in cuobjdump -sass's format under anonymous namespace
    `ns`; the leap kernel's body is `body`."""
    g = f"_ZN{len(ns)}{ns}13greedy_kernelILi3ELi4ELb1EsEEvPKjS2_"
    lp = f"_ZN{len(ns)}{ns}11leap_kernelILi3ELi4ELi1ELi1ELi1ELi0ELb0ELb1EEEv"
    return (f"\tcode for sm_90a\n\t\tFunction : {g}\n"
            f"        /*0000*/   IADD3 R2, R2, 0x1, RZ ;\n"
            f"        /*0010*/   CALL.REL.NOINC `({ns}x) ;\n"
            f"\t\tFunction : {lp}\n        /*0000*/   {body} ;\n")


def test_sass_pin_keys_and_compares(monkeypatch):
    """tools/sass_pin: each kernel's digest is keyed by its mangled name
    from the kernel's own name on and ignores the anonymous namespace's
    per-source hash, so two builds of one text compare equal and a changed
    body shows as moved; the pin names every short-row library of
    SHORT_SHAPES with the nvcc that built them; `check` compares under
    that nvcc alone (and raises on a moved kernel), under another it says
    it compared nothing."""
    import json

    from asm_tpu_torch.tools import roofline, sass_pin

    listings = {"a": _listing("_GLOBAL__N__1a2b3c4d_9_greedy_cu_5e6f7a8b",
                              "LOP3.LUT R2, R2, 0x3, RZ, 0x3c, !PT"),
                "b": _listing("_GLOBAL__N__99aa88bb_9_greedy_cu_77cc66dd",
                              "LOP3.LUT R2, R2, 0x3, RZ, 0x3c, !PT"),
                "c": _listing("_GLOBAL__N__99aa88bb_9_greedy_cu_77cc66dd",
                              "LOP3.LUT R2, R2, 0x5, RZ, 0x3c, !PT")}
    monkeypatch.setattr(roofline, "sass_listing", lambda path: listings[path])
    # a wider instruction column (a longer instruction elsewhere in the
    # library) is layout, not SASS
    listings["d"] = listings["a"].replace(" ;", "      ;")
    a, b, c, d = (sass_pin.digests(x) for x in "abcd")
    assert a == d
    assert sorted(a) == ["greedy_kernelILi3ELi4ELb1EsEEvPKjS2_",
                         "leap_kernelILi3ELi4ELi1ELi1ELi1ELi0ELb0ELb1EEEv"]
    assert a == b
    got = sass_pin.compare(dict(lib=c), dict(lib=a))
    assert got["held"] == 2 and got["moved"] == [
        "lib:leap_kernelILi3ELi4ELi1ELi1ELi1ELi0ELb0ELb1EEEv"]
    assert sass_pin.compare(dict(lib={}), dict(lib=a))["missing"] != []
    with open(sass_pin.PIN_PATH) as f:
        pin = json.load(f)
    assert sorted(pin["libraries"]) == sorted(
        sass_pin.stem(*s) for s in sass_pin.SHORT_SHAPES)
    assert pin["nvcc"].startswith("Build cuda_")
    # the tuned tables: greedy 3 k x 3 W x 2 forms, LEAP 144, NW 3 W x 2,
    # the band's short path 3 W x BW 4-64 and its wide path at BW 128; at
    # W 32 and 64 the long NW trace kernel alone (the full kernel, which
    # the pin's sources predate, not held)
    assert len(pin["libraries"]["greedy"]) == 18
    assert len(pin["libraries"]["leap"]) == 144
    assert len(pin["libraries"]["nw"]) == 6
    assert sorted(k[:k.index("EE") + 2] for k in pin["libraries"][
        "nw_band"]) == sorted([f"band_kernelILi{bw}ELi{W}EE"
                               for W in (4, 8, 16) for bw in (4, 8, 16, 32, 64)]
                              + [f"band_wide_kernelILi128ELi{W}EE"
                                 for W in (4, 8, 16)])
    for W in (32, 64):
        assert [k[:k.index("EE") + 2] for k in pin["libraries"][
            f"nw_w{W}"]] == [f"nw_long_kernelILi{W}ELb1EE"]
    # the full kernel under its name before the redesign and after it
    for full in ("14nw_long_kernelILi32ELb0EE", "19nw_long_full_kernelILi32EE"):
        nw_listing = (_listing("_GLOBAL__N__1a2b3c4d_5_nw_cu_5e6f7a8b", "NOP")
                      .replace("13greedy_kernelILi3ELi4ELb1EsE", full)
                      .replace("11leap_kernelILi3ELi4ELi1ELi1ELi1ELi0ELb0ELb1EE",
                               "14nw_long_kernelILi32ELb1EE"))
        monkeypatch.setattr(roofline, "sass_listing",
                            lambda path, text=nw_listing: text)
        assert [k[:25] for k in sass_pin.digests("nw")] == [
            "nw_long_kernelILi32ELb1EE"]
    band_listing = (_listing("_GLOBAL__N__1a2b3c4d_10_nw_band_cu_5e6f7a8b",
                             "NOP")
                    .replace("13greedy_kernelILi3ELi4ELb1EsE",
                             "11band_kernelILi4ELi4EE")
                    .replace("11leap_kernelILi3ELi4ELi1ELi1ELi1ELi0ELb0ELb1EE",
                             "16band_wide_kernelILi128ELi4EE"))
    monkeypatch.setattr(roofline, "sass_listing", lambda path: band_listing)
    assert [k[:21] for k in sass_pin.digests("nw_band")] == [
        "band_kernelILi4ELi4EE", "band_wide_kernelILi12"]
    res = sass_pin.check(got=pin["libraries"], version=pin["nvcc"])
    assert res["compared"] and res["moved"] == res["missing"] == []
    bad = dict(pin["libraries"], greedy=dict(pin["libraries"]["greedy"]))
    bad["greedy"][next(iter(bad["greedy"]))] = "0" * 64
    with pytest.raises(AssertionError, match="1 moved"):
        sass_pin.check(got=bad, version=pin["nvcc"])
    assert sass_pin.check(got=bad, version="Build cuda_0.0") == dict(
        compared=False, pin_nvcc=pin["nvcc"], nvcc="Build cuda_0.0")
