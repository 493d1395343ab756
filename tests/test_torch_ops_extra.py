"""The port's row helpers, CIGAR display, device encoding, bit-plane
packing and string generator on the CPU against asm_tpu's on the same
seeded inputs: `ops.bitops` (flip_short_matches, next_one_index,
next_zero_index, prefix_count, count_between, gather_last),
`ops.cigar.aligned_strings`, `encoding.encode_ascii_device`,
`encoding.pack_bitplanes` and `data.generator.generate_dataset`.

Tolerance: exact (integer and string outputs)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from asm_tpu import encoding as jenc
from asm_tpu.data import generator as jgen
from asm_tpu.ops import bitops as jbit
from asm_tpu.ops import cigar as jcig
from asm_tpu_torch import encoding as tenc
from asm_tpu_torch.data import generator as tgen
from asm_tpu_torch.ops import bitops as tbit
from asm_tpu_torch.ops import cigar as tcig

torch.set_num_threads(1)


def _rows(rng, shape, p=0.5):
    return (rng.random(shape) < p).astype(np.int8)


def _eq(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    assert np.array_equal(got.numpy().astype(np.int64),
                          want.astype(np.int64))


@pytest.mark.parametrize("threshold", [1, 2])
@pytest.mark.parametrize("p", [0.2, 0.5, 0.8])
def test_flip_short_matches(rng, threshold, p):
    h = _rows(rng, (64, 7, 40), p)
    _eq(tbit.flip_short_matches(torch.from_numpy(h), threshold),
        jbit.flip_short_matches(jnp.asarray(h), threshold))


def test_flip_short_matches_threshold2_quirk():
    """threshold=2 derives r2 from l2, not from r1 (GASMA/utils.h:228-229).
    On this row the two forms fill different zeros; the port fills the
    reference's."""
    h = np.array([[0, 1, 1, 0, 0, 1, 0, 0, 0, 1, 1, 0]], np.int8)
    got = tbit.flip_short_matches(torch.from_numpy(h), 2).numpy()
    want = np.asarray(jbit.flip_short_matches(jnp.asarray(h), 2))
    assert np.array_equal(got, want)
    # the symmetric variant (r2 from r1) differs on this row
    t = torch.from_numpy(h)
    l1 = torch.cat([t[..., 1:], torch.ones_like(t[..., :1])], -1)
    r1 = torch.cat([torch.ones_like(t[..., :1]), t[..., :-1]], -1)
    l2 = torch.cat([l1[..., 1:], torch.ones_like(t[..., :1])], -1)
    r2 = torch.cat([torch.ones_like(t[..., :1]), r1[..., :-1]], -1)
    symmetric = (t | (l1 & r1) | (l1 & r2) | (l2 & r1)).numpy()
    assert not np.array_equal(symmetric, want)


@pytest.mark.parametrize("p", [0.0, 0.1, 0.5, 1.0])
def test_next_index_tables(rng, p):
    h = _rows(rng, (32, 5, 37), p)
    t = torch.from_numpy(h)
    _eq(tbit.next_one_index(t), jbit.next_one_index(jnp.asarray(h)))
    _eq(tbit.next_zero_index(t), jbit.next_zero_index(jnp.asarray(h)))
    _eq(tbit.prefix_count(t), jbit.prefix_count(jnp.asarray(h)))
    assert tbit.next_one_index(t).dtype == torch.int32
    assert tbit.prefix_count(t).dtype == torch.int32


def test_count_between_and_gather_last(rng):
    h = _rows(rng, (200, 33))
    cum_j = jbit.prefix_count(jnp.asarray(h))
    cum_t = tbit.prefix_count(torch.from_numpy(h))
    # windows in and out of range, inverted ones too
    lo = rng.integers(-5, 40, size=200).astype(np.int32)
    hi = rng.integers(-5, 40, size=200).astype(np.int32)
    _eq(tbit.count_between(cum_t, torch.from_numpy(lo), torch.from_numpy(hi)),
        jbit.count_between(cum_j, jnp.asarray(lo), jnp.asarray(hi)))
    x = rng.integers(-100, 100, size=(200, 17)).astype(np.int32)
    idx = rng.integers(-3, 20, size=200).astype(np.int32)
    _eq(tbit.gather_last(torch.from_numpy(x), torch.from_numpy(idx)),
        jbit.gather_last(jnp.asarray(x), jnp.asarray(idx)))


@pytest.mark.parametrize("seed", [0, 1])
def test_aligned_strings(seed):
    rng = np.random.default_rng(seed)
    reads, refs = jgen.generate_dataset(20, 60, 0.2, 0.5, seed=seed)
    for read, ref in zip(reads, refs):
        ops = rng.choice(list("MIDX="), size=int(rng.integers(0, 12)))
        cigar = "".join(f"{int(rng.integers(1, 9))}{op}" for op in ops)
        assert tcig.aligned_strings(read, ref, cigar) \
            == jcig.aligned_strings(read, ref, cigar)
    for bad in ("3Q", "M3", "3M2"):
        with pytest.raises(ValueError):
            tcig.aligned_strings("ACGT", "ACGT", bad)


def test_encode_ascii_device(rng):
    chars = np.frombuffer(b"ACGTacgtNn-xZ", np.uint8)
    b = chars[rng.integers(0, chars.size, size=(50, 64))]
    lens = rng.integers(0, 65, size=50).astype(np.int32)
    for pad in (tenc.PAD_READ, tenc.PAD_REF):
        got = tenc.encode_ascii_device(torch.from_numpy(b),
                                       torch.from_numpy(lens), pad)
        assert got.dtype == torch.int8
        _eq(got, jenc.encode_ascii_device(jnp.asarray(b), jnp.asarray(lens),
                                          pad))


def test_pack_bitplanes(rng):
    codes = rng.integers(0, 4, size=(3, 9, 128)).astype(np.int8)
    got = tenc.pack_bitplanes(torch.from_numpy(codes))
    want = jenc.pack_bitplanes(jnp.asarray(codes))
    for g, w in zip(got, want):
        assert g.dtype == torch.int64 and int(g.min()) >= 0
        assert int(g.max()) < 1 << 32
        _eq(g, np.asarray(w).astype(np.int64))
    with pytest.raises(ValueError):
        tenc.pack_bitplanes(torch.zeros((2, 48), dtype=torch.int8))


@pytest.mark.parametrize("kw", [
    dict(num_reads=40, length=100, error_rate=0.10, seed=3),
    dict(num_reads=40, length=60, error_rate=0.4, mismatch_rate=0.5, seed=4),
    dict(num_reads=30, length=50, error_rate=0.15, exact_error_rate=False,
         seed=5),
    dict(num_reads=10, length=3, error_rate=0.7, mismatch_rate=0.0, seed=6),
])
def test_generate_dataset(kw):
    assert tgen.generate_dataset(**kw) == jgen.generate_dataset(**kw)


def test_generate_dataset_rejects_rates():
    with pytest.raises(ValueError):
        tgen.generate_dataset(1, 10, 0.8)
    with pytest.raises(ValueError):
        tgen.generate_dataset(1, 10, 0.1, mismatch_rate=1.5)
