"""The port's coverage metric and CIGAR rendering on the CPU against
asm_tpu: greedy_match_mask / positional_covered (torch) against
asm_tpu.metrics.coverage_device, the host copies (ops.cigar,
metrics.coverage) and the native coverage binding against asm_tpu's, and
the harness's coverage loop (`coverage_counts`, every kernel wrapper on
its plain version) against the same loop run with the JAX package.

Tolerance: exact equality of masks, CIGAR strings and counts."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asm_tpu.config import AlignConfig as JaxConfig
from asm_tpu.data.generator import generate_dataset_arrays
from asm_tpu.kernels.greedy import greedy_align as jax_greedy
from asm_tpu.kernels.nw import nw_align as jax_nw_align
from asm_tpu.metrics import coverage as jax_cov
from asm_tpu.metrics.coverage_device import greedy_match_mask as jax_gmm
from asm_tpu.metrics.coverage_device import positional_covered as jax_pc
from asm_tpu.native import coverage_batch_native as jax_cov_native
from asm_tpu.native import generate_dataset_native
from asm_tpu.ops import cigar as jax_cigar
from asm_tpu_torch import native
from asm_tpu_torch.config import AlignConfig
from asm_tpu_torch.kernels import greedy_cuda, nw_cuda
from asm_tpu_torch.metrics import coverage, coverage_device
from asm_tpu_torch.ops import cigar

torch.set_num_threads(1)


def _greedy_and_nw(corpus):
    a = [jnp.asarray(v) for v in corpus]
    g = jax_greedy(*a, JaxConfig())
    pen, ops, mask = jax_nw_align(*a, match_mask_threshold=3)
    return ({k: np.asarray(v) for k, v in g.items()}, np.asarray(pen),
            np.asarray(ops), np.asarray(mask))


@pytest.mark.parametrize("err,mr", [(0.1, 0.96), (0.4, 0.5)])
def test_masks_match_jax(err, mr):
    corpus = generate_dataset_arrays(200, 100, err, mr, seed=3)
    g, _, _, nw_mask = _greedy_and_nw(corpus)
    ops = torch.from_numpy(np.array(g["cigar_ops"]))
    runs = torch.from_numpy(np.array(g["cigar_runs"]))
    for thr in (1, 3, 8):
        got = coverage_device.greedy_match_mask(ops, runs, 128, thr)
        want = jax_gmm(jnp.asarray(g["cigar_ops"]),
                       jnp.asarray(g["cigar_runs"]), 128, thr)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    gm = coverage_device.greedy_match_mask(ops, runs, 128, 1)
    np.testing.assert_array_equal(
        coverage_device.positional_covered(gm, torch.from_numpy(nw_mask))
        .numpy(), np.asarray(jax_pc(jnp.asarray(gm.numpy()),
                                    jnp.asarray(nw_mask))))


def test_cigar_and_host_coverage_match_jax():
    corpus = generate_dataset_arrays(64, 100, 0.2, 0.8, seed=4)
    g, _, ops, _ = _greedy_and_nw(corpus)
    assert cigar.batch_nw_cigars(ops) == jax_cigar.batch_nw_cigars(ops)
    assert cigar.batch_greedy_cigars(g) == jax_cigar.batch_greedy_cigars(g)
    assert cigar.runs_to_cigar(g["cigar_ops"][0], g["cigar_runs"][0]) == \
        jax_cigar.runs_to_cigar(g["cigar_ops"][0], g["cigar_runs"][0])
    assert cigar.ops_to_cigar(ops[1], reverse=False) == \
        jax_cigar.ops_to_cigar(ops[1], reverse=False)
    nw_c = cigar.batch_nw_cigars(ops)
    g_c = cigar.batch_greedy_cigars(g)
    rc, rl, fc, fl = corpus
    for b in range(len(rl)):
        args = ("".join("ACGT"[c] for c in rc[b, :rl[b]]),
                "".join("ACGT"[c] for c in fc[b, :fl[b]]), g_c[b], nw_c[b])
        assert coverage.check_coverage(*args) == \
            jax_cov.check_coverage(*args)
    got = native.coverage_batch_native(rc, rl, g["cigar_ops"],
                                       g["cigar_runs"], ops)
    want = jax_cov_native(rc, rl, g["cigar_ops"], g["cigar_runs"], ops)
    np.testing.assert_array_equal(got, want)


def _jax_coverage_loop(corpus, chunk=1 << 13):
    """asm_tpu/bench/harness.py:247-334 with the XLA kernels, plus the
    greedy == NW count over the same pairs."""
    read_codes, read_len, ref_codes, ref_len = corpus
    a_fn = jax.jit(functools.partial(jax_nw_align, match_mask_threshold=3))
    g_fn = jax.jit(functools.partial(jax_greedy, cfg=JaxConfig()))
    covered = equal = 0
    for i in range(0, len(read_len), chunk):
        rc, rl = read_codes[i:i + chunk], read_len[i:i + chunk]
        fc, fl = ref_codes[i:i + chunk], ref_len[i:i + chunk]
        args = [jnp.asarray(v) for v in (rc, rl, fc, fl)]
        pen, nw_ops, nw_mask = a_fn(*args)
        g = g_fn(*args)
        cert = np.asarray(jax_pc(jax_gmm(g["cigar_ops"], g["cigar_runs"],
                                         rc.shape[1], 1), nw_mask))
        equal += int((np.asarray(pen) == np.asarray(g["cost"])).sum())
        covered += int(cert.sum())
        rest = np.nonzero(~cert)[0]
        if rest.size:
            covered += int(jax_cov_native(
                rc[rest], rl[rest], np.asarray(g["cigar_ops"])[rest],
                np.asarray(g["cigar_runs"])[rest],
                np.asarray(nw_ops)[rest], 1, 3).sum())
    return covered, equal


@pytest.mark.parametrize("use_native", [True, False])
def test_coverage_counts_match_jax_harness_loop(monkeypatch, use_native):
    corpus = generate_dataset_native(512, 100, 0.10, mismatch_rate=0.96,
                                     seed=42, max_len=128)
    covered, equal = _jax_coverage_loop(corpus)
    if not use_native:  # the pure-Python fallback of the exact check
        monkeypatch.setattr(coverage_device, "load_native", lambda: None)
    got = coverage_device.coverage_counts(*corpus, AlignConfig(),
                                          chunk=200, device="cpu")
    assert got["checked"] == 512
    assert (got["covered"], got["greedy_equal_nw"]) == (covered, equal)
    assert 0 < got["certified"] < got["covered"]
    assert nw_cuda.LAUNCHES["nw_trace"] == 0 and greedy_cuda.LAUNCHES == 0


def test_coverage_counts_sample():
    corpus = generate_dataset_arrays(40, 100, 0.1, seed=9)
    got = coverage_device.coverage_counts(*corpus, AlignConfig(),
                                          coverage_sample=25, device="cpu")
    covered, equal = _jax_coverage_loop([a[:25] for a in corpus])
    assert (got["checked"], got["covered"], got["greedy_equal_nw"]) == (
        25, covered, equal)
