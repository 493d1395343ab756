"""The port's exact NW on the CPU: the plain version (kernels/nw.py)
against asm_tpu.kernels.nw (XLA) and the scalar oracle nw_ref, and the
kernel wrappers nw_penalty_cuda / nw_align_cuda on CPU tensors (their
plain version) against asm_tpu's Pallas kernels in interpret mode; plus
pack_planes_t against asm_tpu.encoding's.

Tolerance everywhere: exact equality (integer DP, no rounding) of
penalties, traceback ops and match masks."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asm_tpu.data.generator import generate_dataset_arrays
from asm_tpu.encoding import encode_batch
from asm_tpu.encoding import pack_planes_t as jax_pack_planes_t
from asm_tpu.kernels import nw as jnw
from asm_tpu.kernels.nw_pallas import nw_align_pallas, nw_penalty_pallas
from asm_tpu.ops.cigar import batch_nw_cigars as jax_nw_cigars
from asm_tpu.reference_impl.nw_ref import nw_ref
from asm_tpu_torch.encoding import decode_string, pack_planes_t
from asm_tpu_torch.kernels import nw, nw_cuda
from asm_tpu_torch.ops.cigar import batch_nw_cigars

torch.set_num_threads(1)

# the edge pairs of tests/test_nw_band.py: one base, 128 bases, empty
EDGE_READS = ["A", "ACGT" * 32, "ACGTACGT", "", "ACGT" * 25, "AC", ""]
EDGE_REFS = ["ACGT" * 32, "A", "ACGTACGT", "ACG", "ACGT" * 25, "TGCA" * 20, ""]

CORPORA = {
    "err0.05": dict(num_reads=64, length=100, error_rate=0.05, seed=1),
    "err0.2": dict(num_reads=64, length=100, error_rate=0.2, seed=2),
    "err0.4-mr0.5": dict(num_reads=64, length=100, error_rate=0.4,
                         mismatch_rate=0.5, seed=3),
    "length_range": dict(num_reads=64, length=100, error_rate=0.12,
                         mismatch_rate=0.8, seed=95, length_range=(40, 120)),
}
XOE = [(1, 1, 1), (2, 3, 1), (1, 4, 2)]


def _corpus(label):
    if label == "edges":
        return encode_batch(EDGE_READS, EDGE_REFS, 128)
    return generate_dataset_arrays(**CORPORA[label])


def _t(corpus):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in corpus]


@pytest.mark.parametrize("label", list(CORPORA) + ["edges"])
@pytest.mark.parametrize("xoe", XOE, ids=lambda v: "x%do%de%d" % v)
def test_plain_matches_xla(label, xoe):
    c = _corpus(label)
    a = [jnp.asarray(v) for v in c]
    np.testing.assert_array_equal(nw.nw_penalty(*_t(c), *xoe).numpy(),
                                  np.asarray(jnw.nw_penalty(*a, *xoe)))
    want = jnw.nw_align(*a, *xoe, match_mask_threshold=3)
    got = nw.nw_align(*_t(c), *xoe, match_mask_threshold=3)
    for g, w, key in zip(got, want, ("pen", "ops", "mask")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=key)
    pen, ops = nw.nw_align(*_t(c), *xoe)
    np.testing.assert_array_equal(ops.numpy(), np.asarray(want[1]))


def test_plain_matches_scalar_oracle():
    c = generate_dataset_arrays(12, 60, 0.15, 0.8, seed=7)
    rc, rl, fc, fl = c
    pen, ops = nw.nw_align(*_t(c), 2, 3, 1)
    for b in range(len(rl)):
        want, _ = nw_ref(decode_string(rc[b], int(rl[b])),
                         decode_string(fc[b], int(fl[b])), 2, 3, 1,
                         traceback=False)
        assert int(pen[b]) == want, b
    assert batch_nw_cigars(ops.numpy()) == jax_nw_cigars(
        np.asarray(jnw.nw_align(*map(jnp.asarray, c), 2, 3, 1)[1]))


@pytest.mark.parametrize("label", ["err0.05", "err0.4-mr0.5",
                                   "length_range", "edges"])
def test_wrappers_on_cpu_match_pallas_interpret(label):
    c = _corpus(label)
    a = [jnp.asarray(v) for v in c]
    t = _t(c)
    for xoe in [(1, 1, 1), (1, 4, 2)]:
        np.testing.assert_array_equal(
            nw_cuda.nw_penalty_cuda(*t, *xoe).numpy(),
            np.asarray(nw_penalty_pallas(*a, *xoe, interpret=True)))
        want = nw_align_pallas(*a, *xoe, match_mask_threshold=3,
                               interpret=True)
        got = nw_cuda.nw_align_cuda(*t, *xoe, match_mask_threshold=3)
        for g, w, key in zip(got, want, ("pen", "ops", "mask")):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=key)
    assert nw_cuda.LAUNCHES == {"nw": 0, "nw_trace": 0}


def test_wrappers_check_arguments():
    rc, rl, fc, fl = _t(generate_dataset_arrays(8, 50, 0.1, seed=1))
    with pytest.raises(TypeError):
        nw_cuda.nw_penalty_cuda(rc.to(torch.int32), rl, fc, fl)
    with pytest.raises(ValueError):
        nw_cuda.nw_penalty_cuda(rc, rl[:4], fc, fl)
    with pytest.raises(ValueError):
        nw_cuda.nw_align_cuda(rc.T, rl, fc, fl)
    with pytest.raises(ValueError):
        nw_cuda.nw_align_cuda(rc, rl, fc, fl, match_mask_threshold=-1)
    pen, ops = nw_cuda.nw_align_cuda(rc[:0], rl[:0], fc[:0], fl[:0])
    assert pen.shape == (0,) and ops.shape == (0, 256)


@pytest.mark.parametrize("L", [32, 128, 256])
def test_pack_planes_t_matches_jax(L):
    rc, _, fc, _ = generate_dataset_arrays(37, L - 10, 0.1, seed=L,
                                           max_len=L)
    for codes in (rc, fc):
        want = jax_pack_planes_t(jnp.asarray(codes))
        got = pack_planes_t(torch.from_numpy(codes))
        for g, w in zip(got, want):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(),
                                          np.asarray(w).view(np.int32))
