"""The port's word ops equal asm_tpu.ops on seeded random inputs
(including positions below 0 and past L, and empty or inverted windows).
The port holds 32-bit words in int64; asm_tpu in uint32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import asm_tpu.ops.bitops as jbit
import asm_tpu.ops.hurdles as jhur
import asm_tpu.ops.packed as jpk
import asm_tpu_torch.ops.bitops as tbit
import asm_tpu_torch.ops.hurdles as thur
import asm_tpu_torch.ops.packed as tpk

torch.set_num_threads(1)


def _np(x):
    return np.asarray(x).astype(np.int64)


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def _words(rng, shape):
    w = rng.integers(0, 2**32, size=shape, dtype=np.uint64)
    # plenty of edge words: all-zero, all-one, single bits
    w.flat[::7] = 0
    w.flat[3::11] = 0xFFFFFFFF
    w.flat[5::13] = np.uint64(1) << rng.integers(0, 32, w.flat[5::13].shape,
                                                 dtype=np.uint64)
    return w.astype(np.uint32)


@pytest.mark.parametrize("L", [32, 128, 256])
def test_pack_rows(L):
    rng = np.random.default_rng(L)
    rows = rng.random((5, 3, L)) < 0.3
    np.testing.assert_array_equal(tpk.pack_rows(torch.from_numpy(rows)),
                                  _np(jpk.pack_rows(jnp.asarray(rows))))


@pytest.mark.parametrize("W", [1, 4, 8])
def test_masks(W):
    c = np.arange(-40, 32 * W + 40, dtype=np.int32)
    np.testing.assert_array_equal(tpk.mask_ge(_t(c), W),
                                  _np(jpk.mask_ge(jnp.asarray(c), W)))
    np.testing.assert_array_equal(tpk.mask_lt(_t(c), W),
                                  _np(jpk.mask_lt(jnp.asarray(c), W)))


def test_popcount_ctz():
    rng = np.random.default_rng(0)
    w = _words(rng, 5000)
    np.testing.assert_array_equal(
        tpk.popcount32(_t(w)),
        [bin(int(v)).count("1") for v in w])
    np.testing.assert_array_equal(tpk.ctz32(_t(w)),
                                  _np(jpk.ctz32(jnp.asarray(w))))
    assert int(tpk.ctz32(_t([0]))[0]) == 32


@pytest.mark.parametrize("W", [4, 8])
def test_first_set_from(W):
    rng = np.random.default_rng(W)
    packed = _words(rng, (400, 7, W))
    c = rng.integers(-10, 32 * W + 10, size=(400, 7)).astype(np.int32)
    np.testing.assert_array_equal(
        tpk.first_set_from(_t(packed), _t(c)),
        _np(jpk.first_set_from(jnp.asarray(packed), jnp.asarray(c))))


@pytest.mark.parametrize("W", [4, 8])
def test_count_range(W):
    rng = np.random.default_rng(10 + W)
    packed = _words(rng, (400, 7, W))
    lo = rng.integers(-20, 32 * W + 20, size=(400, 7)).astype(np.int32)
    hi = rng.integers(-20, 32 * W + 20, size=(400, 7)).astype(np.int32)
    hi[::5] = lo[::5]  # empty windows
    got = tpk.count_range(_t(packed), _t(lo), _t(hi))
    np.testing.assert_array_equal(
        got, _np(jpk.count_range(jnp.asarray(packed), jnp.asarray(lo),
                                 jnp.asarray(hi))))
    assert (got[::5] == 0).all() and (got[hi < lo] == 0).all()


@pytest.mark.parametrize("s", [0, 1, 3, 7])
def test_shifts(s):
    rng = np.random.default_rng(s)
    x = rng.integers(0, 7, size=(6, 64)).astype(np.int8)
    for tf, jf in ((tbit.shift_toward_0, jbit.shift_toward_0),
                   (tbit.shift_away_0, jbit.shift_away_0)):
        np.testing.assert_array_equal(
            tf(torch.from_numpy(x), s, fill=6).numpy(),
            np.asarray(jf(jnp.asarray(x), s, fill=6)))


@pytest.mark.parametrize("threshold", [1, 2])
def test_flip_short_hurdles(threshold):
    rng = np.random.default_rng(threshold)
    h = (rng.random((50, 7, 128)) < 0.3).astype(np.int8)
    np.testing.assert_array_equal(
        tbit.flip_short_hurdles(torch.from_numpy(h), threshold).numpy(),
        np.asarray(jbit.flip_short_hurdles(jnp.asarray(h), threshold)))


def test_lane_geometry():
    lanes = np.arange(-5, 6)
    l1, l2 = np.meshgrid(lanes, lanes, indexing="ij")
    for o, e in [(1, 1), (3, 1), (0, 2)]:
        np.testing.assert_array_equal(
            thur.switch_lane_penalty(_t(l1), _t(l2), o, e),
            _np(jhur.switch_lane_penalty(jnp.asarray(l1), jnp.asarray(l2),
                                         o, e)))
    np.testing.assert_array_equal(
        thur.switch_forward_column(_t(l1), _t(l2)),
        _np(jhur.switch_forward_column(jnp.asarray(l1), jnp.asarray(l2))))
    m, n = np.meshgrid(np.arange(0, 130, 3), np.arange(0, 130, 5),
                       indexing="ij")
    m, n = m.ravel()[:, None], n.ravel()[:, None]
    np.testing.assert_array_equal(
        thur.lane_destination(_t(m), _t(n), _t(lanes[None, :])),
        _np(jhur.lane_destination(jnp.asarray(m), jnp.asarray(n),
                                  jnp.asarray(lanes[None, :]))))


@pytest.mark.parametrize("k", [0, 2, 3])
def test_build_greedy_lanes(k):
    from asm_tpu.data.generator import generate_dataset_arrays

    rc, _, fc, _ = generate_dataset_arrays(40, 100, 0.2, 0.7, seed=k,
                                           length_range=(50, 128))
    np.testing.assert_array_equal(
        thur.build_greedy_lanes(torch.from_numpy(rc), torch.from_numpy(fc),
                                k).numpy(),
        np.asarray(jhur.build_greedy_lanes(jnp.asarray(rc), jnp.asarray(fc),
                                           k)))
