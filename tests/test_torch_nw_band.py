"""The port's banded NW, partitioned runs and dispatch plan on the CPU
(the band wrapper's plain version for CPU tensors), against asm_tpu:
every banded penalty — certified, uncertified upper bound or INF — equal
to asm_tpu.kernels.nw_band.nw_penalty_banded (Pallas, interpret mode) in
both input forms, and the partitioned / dispatch paths equal to the exact
XLA oracle asm_tpu.kernels.nw.nw_penalty, mirroring tests/test_nw_band.py;
and utils.bounds.nw_band_work against a brute-force count of the band
cells that lie in the DP matrix; the staging kernel's plain version
against the host staging (`greedy_cuda.stage_planes_t`, native and NumPy
routes).

Tolerance everywhere: exact equality (integer DP, integer counts)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asm_tpu.data.generator import generate_dataset_arrays
from asm_tpu.encoding import encode_batch
from asm_tpu.kernels.greedy_pallas import stage_planes_t as jax_stage
from asm_tpu.kernels.nw import nw_penalty
from asm_tpu.kernels.nw_band import nw_penalty_banded as jax_banded
from asm_tpu.kernels.nw_band import required_band as jax_required_band
from asm_tpu_torch.encoding import PAD_READ, PAD_REF
from asm_tpu_torch.kernels import greedy_cuda, nw_band
from asm_tpu_torch.kernels.greedy_cuda import stage_planes_t
from asm_tpu_torch.kernels.nw_band import (
    band_certified,
    nw_penalty_banded,
    nw_penalty_partitioned,
    required_band,
)
from asm_tpu_torch.kernels.nw_dispatch import (
    band_major_order,
    nw_partition_execute,
    nw_partition_plan,
)
from asm_tpu_torch.utils.bounds import (
    GOTOH_CELL_OPS,
    band_cells,
    nw_band_work,
)

torch.set_num_threads(1)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _exact(corpus):
    return np.asarray(nw_penalty(*map(jnp.asarray, corpus)))


def _mixed_corpus(seed=70):
    """tests/test_nw_band.py's mix: bands 16/32/64/full."""
    blocks = [
        generate_dataset_arrays(24, 100, 0.02, 0.96, seed=seed),
        generate_dataset_arrays(24, 100, 0.10, 0.96, seed=seed + 1),
        generate_dataset_arrays(24, 100, 0.20, 0.96, seed=seed + 2),
        generate_dataset_arrays(16, 100, 0.45, 0.10, seed=seed + 3),
    ]
    return [np.concatenate([b[i] for b in blocks]) for i in range(4)]


BANDED_CASES = {
    "err0.05": lambda: generate_dataset_arrays(600, 100, 0.05, 0.96,
                                               seed=11),
    "err0.15": lambda: generate_dataset_arrays(600, 100, 0.15, 0.96,
                                               seed=11),
    "err0.4-mr0.5": lambda: generate_dataset_arrays(600, 100, 0.4, 0.5,
                                                    seed=11),
    "length_range": lambda: generate_dataset_arrays(
        300, 100, 0.12, 0.8, seed=95, length_range=(40, 120)),
    "edges": lambda: encode_batch(
        ["A", "ACGT" * 32, "ACGTACGT", "", "ACGT" * 25, "AC", "", "ACGT"],
        ["ACGT" * 32, "A", "ACGTACGT", "ACG", "ACGT" * 25, "TGCA" * 20, "",
         ""], 128),
}


@pytest.mark.parametrize("label", list(BANDED_CASES))
@pytest.mark.parametrize("bw", [8, 16, 32, 64])
def test_banded_every_entry_matches_pallas(label, bw):
    rc, rl, fc, fl = BANDED_CASES[label]()
    xoes = [(1, 1, 1), (1, 4, 2)] if label == "edges" else [(1, 1, 1)]
    for x, o, e in xoes:
        want = np.asarray(jax_banded(*map(jnp.asarray, (rc, rl, fc, fl)),
                                     bw=bw, x=x, o=o, e=e, interpret=True))
        got = nw_penalty_banded(*_t(rc, rl, fc, fl), bw=bw, x=x, o=o, e=e)
        np.testing.assert_array_equal(got.numpy(), want)
        planes = _t(stage_planes_t(rc).view(np.int32), rl,
                    stage_planes_t(fc).view(np.int32), fl)
        got = nw_penalty_banded(*planes, bw=bw, x=x, o=o, e=e,
                                pre_staged=True)
        np.testing.assert_array_equal(got.numpy(), want)
        if label == "err0.05":  # the JAX kernel's own planes route
            want2 = jax_banded(jnp.asarray(jax_stage(rc)), jnp.asarray(rl),
                               jnp.asarray(jax_stage(fc)), jnp.asarray(fl),
                               bw=bw, x=x, o=o, e=e, interpret=True,
                               pre_staged=True)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want2))
    assert nw_band.LAUNCHES == 0  # CPU tensors never launch


@pytest.mark.parametrize("route", ["native", "numpy"])
@pytest.mark.parametrize("L,B", [(32, 0), (32, 1), (128, 301), (1056, 0),
                                 (1056, 33), (2048, 7)])
def test_stage_plain_matches_host_staging(monkeypatch, route, L, B):
    """stage_plain's words equal stage_planes_t's and asm_tpu's
    (greedy_pallas.stage_planes_t) bit for bit, on codes padded past
    random lengths with PAD_READ (reads) and PAD_REF (refs) and a few
    pads inside; the CPU wrapper returns them and launches nothing."""
    rng = np.random.default_rng(L + B)
    pos = np.arange(L)
    sides = []
    for pad in (PAD_READ, PAD_REF):
        codes = rng.integers(0, 4, (B, L))
        codes[rng.random((B, L)) < 0.01] = pad
        lens = rng.integers(0, L + 1, B)
        sides.append(np.where(pos < lens[:, None], codes, pad).astype(np.int8))
    if route == "numpy":
        monkeypatch.setattr(greedy_cuda, "load_native",
                            lambda required=False: None)
    else:
        assert greedy_cuda.load_native() is not None
    before = nw_band.STAGE_LAUNCHES
    got = nw_band.stage_planes(*map(torch.from_numpy, sides))
    for codes, planes in zip(sides, got):
        want = stage_planes_t(codes).view(np.int32)
        np.testing.assert_array_equal(jax_stage(codes).view(np.int32), want)
        plain = nw_band.stage_plain(torch.from_numpy(codes))
        assert plain.dtype == planes.dtype == torch.int32
        assert plain.shape == (L // 16, B)
        np.testing.assert_array_equal(plain.numpy(), want)
        np.testing.assert_array_equal(planes.numpy(), want)
    assert nw_band.STAGE_LAUNCHES == before


@pytest.mark.parametrize("bw", [8, 16, 32, 64])
def test_band_work_counts_band_cells_in_the_matrix(bw):
    """nw_band_work's cells against a brute-force count of the cells (i, j)
    with 1 <= i <= m, 1 <= j <= n and i - j in the band [-KB, BW/2]; never
    more than the BW/2 x (m+n) band cells that exist on the m+n
    diagonals."""
    rng = np.random.default_rng(bw)
    m = np.concatenate([[0, 0, 1, 128, 128, 5], rng.integers(0, 129, 12)])
    n = np.concatenate([[0, 1, 0, 128, 90, 120], rng.integers(0, 129, 12)])
    bands = np.full(m.shape, bw, np.int32)
    kb = bw // 2 - 1
    per_pair = []
    for mi, ni in zip(m, n):
        i, j = np.meshgrid(np.arange(1, mi + 1), np.arange(1, ni + 1),
                           indexing="ij")
        per_pair.append(int(np.sum((i - j >= -kb) & (i - j <= bw // 2))))
    np.testing.assert_array_equal(band_cells(m, n, bw), per_pair)
    assert all(c <= bw // 2 * (a + b) for c, a, b in zip(per_pair, m, n))
    ops, nbytes = nw_band_work(m, n, bands)
    assert ops == GOTOH_CELL_OPS * sum(per_pair)
    assert nbytes == len(m) * (2 * 32 + 12)
    # a band-0 pair (the full kernel's residue) holds no band cells
    assert nw_band_work(m, n, np.zeros_like(bands))[0] == 0
    # mixed widths: each pair counted at its own
    mixed = np.where(np.arange(len(m)) % 2, bw, 0).astype(np.int32)
    assert nw_band_work(m, n, mixed)[0] == GOTOH_CELL_OPS * sum(
        c for c, w in zip(per_pair, mixed) if w)


def test_certificate_and_required_band_match_jax():
    pen = np.arange(-1, 40, dtype=np.int32)
    for bws in [(16, 32, 64), (8, 16, 32, 64)]:
        np.testing.assert_array_equal(required_band(pen, bws=bws),
                                      jax_required_band(pen, bws=bws))
        np.testing.assert_array_equal(required_band(pen, 2, 3, bws),
                                      jax_required_band(pen, 2, 3, bws))
    assert band_certified(torch.tensor([7, 8]), 16).tolist() == [True, False]


def test_partitioned_bit_equal_mixed():
    corpus = _mixed_corpus()
    want = _exact(corpus)
    np.testing.assert_array_equal(nw_penalty_partitioned(*_t(*corpus)),
                                  want)
    bands = required_band(want)
    assert {int(b) for b in np.unique(bands)} >= {16, 64}
    np.testing.assert_array_equal(
        nw_penalty_partitioned(*_t(*corpus), bands=bands), want)


def test_partitioned_stale_bands_self_heal():
    corpus = _mixed_corpus(seed=80)
    want = _exact(corpus)
    stale = np.full(want.shape, 16, np.int32)
    np.testing.assert_array_equal(
        nw_penalty_partitioned(*_t(*corpus), bands=stale), want)


def test_partitioned_pre_staged_planes():
    rc, rl, fc, fl = _mixed_corpus(seed=90)
    want = _exact((rc, rl, fc, fl))
    got = nw_penalty_partitioned(*_t(stage_planes_t(rc).view(np.int32), rl,
                                     stage_planes_t(fc).view(np.int32), fl),
                                 pre_staged=True)
    np.testing.assert_array_equal(got, want)


def test_partitioned_variable_length():
    corpus = generate_dataset_arrays(96, 100, 0.12, 0.8, seed=95,
                                     length_range=(40, 120))
    np.testing.assert_array_equal(nw_penalty_partitioned(*_t(*corpus)),
                                  _exact(corpus))


def test_bw8_stage_and_partition():
    corpus = _mixed_corpus(seed=99)
    want = _exact(corpus)
    p8 = nw_penalty_banded(*_t(*corpus), bw=8).numpy()
    c8 = band_certified(p8, 8)
    assert 0 < c8.sum() < len(c8)
    np.testing.assert_array_equal(p8[c8], want[c8])
    bws = (8, 16, 32, 64)
    np.testing.assert_array_equal(
        nw_penalty_partitioned(*_t(*corpus), bws=bws), want)
    np.testing.assert_array_equal(
        nw_penalty_partitioned(*_t(*corpus), bws=bws,
                               bands=required_band(want, bws=bws)), want)


def test_dispatch_plan_execute_bit_equal():
    easy = generate_dataset_arrays(300, 100, 0.05, 0.96, seed=31)
    hard = generate_dataset_arrays(212, 100, 0.4, 0.5, seed=32)
    corpus = tuple(np.concatenate([a, b]) for a, b in zip(easy, hard))
    ref = _exact(corpus)
    bands = required_band(ref, bws=(8, 16, 32, 64))

    plan = nw_partition_plan(*corpus, bands, max_chunk=128, device="cpu")
    assert len(plan.chunks) > 1 and 0 in plan.widths
    assert np.array_equal(nw_partition_execute(plan), ref)
    assert plan.last_exec_seconds > 0
    assert len(plan.last_dispatch_seconds) == len(plan.chunks)
    assert 0 < sum(plan.last_dispatch_seconds) <= plan.last_exec_seconds
    assert plan.last_enqueue_seconds > 0 and plan.last_pull_seconds > 0

    rc, rl, fc, fl = corpus
    plan2 = nw_partition_plan(stage_planes_t(rc), rl, stage_planes_t(fc),
                              fl, bands, max_chunk=256, pre_staged=True,
                              device="cpu")
    assert np.array_equal(nw_partition_execute(plan2), ref)
    assert sum(plan2.partitions.values()) == len(rl)


def test_band_major_order_stable_residue_last():
    bands = np.array([0, 16, 8, 16, 0, 8, 64], np.int32)
    np.testing.assert_array_equal(band_major_order(bands),
                                  [2, 5, 1, 3, 6, 0, 4])


def test_dispatch_bad_bands_fail_certificate():
    corpus = generate_dataset_arrays(64, 100, 0.4, 0.5, seed=33)
    plan = nw_partition_plan(*corpus, np.full(64, 8, np.int32),
                             device="cpu")
    with pytest.raises(ValueError, match="certificate"):
        nw_partition_execute(plan)


def test_banded_wrapper_checks_arguments():
    rc, rl, fc, fl = _t(*generate_dataset_arrays(8, 50, 0.1, seed=1))
    with pytest.raises(NotImplementedError):
        nw_penalty_banded(rc, rl, fc, fl, bw=12)
    with pytest.raises(TypeError):
        nw_penalty_banded(rc, rl, fc, fl, pre_staged=True)
    with pytest.raises(ValueError):
        nw_penalty_banded(rc, rl[:3], fc, fl)
