"""The port's SHD pre-filter (asm_tpu_torch.kernels.shd) and LEAP lane rows
(ops.hurdles.build_leap_lanes) against asm_tpu's, on the same numpy
inputs.

Tolerance: exact equality of every row, count and verdict."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asm_tpu.data.generator import generate_dataset_arrays
from asm_tpu.kernels import shd as jshd
from asm_tpu.ops.hurdles import build_leap_lanes as jax_leap_lanes
from asm_tpu_torch.kernels import shd
from asm_tpu_torch.ops.hurdles import build_leap_lanes

torch.set_num_threads(1)


@pytest.mark.parametrize("L,density", [(128, 0.5), (128, 0.85), (256, 0.3)])
def test_flip_false_zeros_and_popcount_match_jax(L, density):
    rng = np.random.default_rng(L + int(density * 100))
    rows = (rng.random((64, L)) < density).astype(np.int8)
    np.testing.assert_array_equal(
        shd._flip_false_zeros(torch.from_numpy(rows)).numpy(),
        np.asarray(jshd._flip_false_zeros(jnp.asarray(rows))))
    np.testing.assert_array_equal(
        shd._popcount_shd(torch.from_numpy(rows)).numpy(),
        np.asarray(jshd._popcount_shd(jnp.asarray(rows))))


@pytest.mark.parametrize("k,L,kw", [
    (3, 128, dict(error_rate=0.02, seed=1)),
    (3, 128, dict(error_rate=0.05, mismatch_rate=0.5, seed=2,
                  length_range=(60, 120))),
    (2, 128, dict(error_rate=0.03, seed=3)),
    (4, 256, dict(length=200, error_rate=0.02, seed=4, max_len=256)),
])
def test_build_leap_lanes_matches_jax(k, L, kw):
    kw = dict(dict(num_reads=128, length=100), **kw)
    rc, rl, fc, fl = generate_dataset_arrays(**kw)
    want = np.asarray(jax_leap_lanes(jnp.asarray(rc), jnp.asarray(fc), k))
    got = build_leap_lanes(torch.from_numpy(rc), torch.from_numpy(fc), k)
    assert got.dtype == torch.int8 and got.shape == (len(rl), 2 * k + 3, L)
    np.testing.assert_array_equal(got.numpy(), want)


# error counts uniform in 0..ceil(rate * length): both verdicts occur
@pytest.mark.parametrize("max_error,kw", [
    (3, dict(error_rate=0.08, seed=11)),
    (3, dict(error_rate=0.08, mismatch_rate=0.5, seed=12,
             length_range=(60, 120))),
    (2, dict(error_rate=0.05, seed=13)),
    (4, dict(length=200, error_rate=0.1, seed=14, max_len=256)),
])
def test_shd_filter_matches_jax(max_error, kw):
    kw = dict(dict(num_reads=256, length=100, exact_error_rate=False), **kw)
    corpus = generate_dataset_arrays(**kw)
    want = np.asarray(jshd.shd_filter(*map(jnp.asarray, corpus),
                                      max_error=max_error))
    got = shd.shd_filter(*map(torch.from_numpy, corpus), max_error=max_error)
    assert 0 < want.sum() < len(want)  # both verdicts occur
    np.testing.assert_array_equal(got.numpy(), want)


# the AND of 2k+1 lanes rejects only near-random pairs: error counts
# uniform in 0..40% of the length
@pytest.mark.parametrize("k,kw", [
    (3, dict(error_rate=0.4, seed=21)),
    (3, dict(error_rate=0.4, mismatch_rate=0.5, seed=22,
             length_range=(60, 120))),
    (4, dict(length=200, error_rate=0.4, seed=23, max_len=256)),
])
def test_shd_gate_masks_matches_jax(k, kw):
    kw = dict(dict(num_reads=256, length=100, exact_error_rate=False), **kw)
    rc, rl, fc, fl = generate_dataset_arrays(**kw)
    rc0, fc0 = np.where(rc < 4, rc, 0), np.where(fc < 4, fc, 0)
    L = rc.shape[1]
    length = np.minimum(np.maximum(rl, fl), L).astype(np.int32)
    lanes = np.asarray(jax_leap_lanes(jnp.asarray(rc0), jnp.asarray(fc0),
                                      k))[:, 1:-1, :]
    want = np.asarray(jshd.shd_gate_masks(jnp.asarray(lanes),
                                          jnp.asarray(length), k))
    got = shd.shd_gate_masks(torch.from_numpy(lanes),
                             torch.from_numpy(length), k)
    assert 0 < want.sum() < len(want)
    np.testing.assert_array_equal(got.numpy(), want)
