"""LEAP CIGARs in the port against asm_tpu: the plain history + backtrack
(leap_align(want_history=True) + leap_backtrack_batch) against the JAX
package's, the packed edit records (leap_edit_records, which the CUDA
kernel writes and the wrapper's CPU route returns) against the Pallas
kernel's raw `edit_rec` in interpret mode with narrow (L = 128) cells
(the wide cells in test_torch_leap_cigar_wide.py), their decode, and
leap_cigar_auto's two passes.

Tolerance: exact equality of edits, CIGAR strings, raw records, passed,
penalty and lane_shift."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asm_tpu.config import AlignConfig as JaxConfig
from asm_tpu.config import LeapMode as JaxMode
from asm_tpu.data.generator import generate_dataset_arrays
from asm_tpu.kernels.greedy_pallas import stage_planes_tiled_t as jax_stage
from asm_tpu.kernels.leap import leap_align as jax_leap
from asm_tpu.kernels.leap_backtrack import leap_backtrack_batch as jax_bt
from asm_tpu.kernels.leap_pallas import leap_align_pallas
from asm_tpu.kernels.leap_pallas import leap_cigar_decode as jax_decode
from asm_tpu_torch.config import config_from_jax
from asm_tpu_torch.kernels.greedy_cuda import stage_planes_tiled_t
from asm_tpu_torch.kernels.leap import leap_align
from asm_tpu_torch.kernels.leap_backtrack import (
    leap_backtrack_batch,
    leap_edit_records,
)
from asm_tpu_torch.kernels.leap_cuda import (
    leap_align_cuda,
    leap_cigar_auto,
    leap_cigar_decode,
)

torch.set_num_threads(1)

TILE = 256

# the configurations of asm_tpu's fused-CIGAR tests: unit GLOBAL, affine,
# indel-heavy with a wider band, and the other three modes
HISTORY_CASES = [
    (0.05, 0.96, 50, JaxConfig(k=3, leap_af_threshold=24)),
    (0.10, 0.96, 51, JaxConfig(x=2, o=3, e=1, k=3, leap_af_threshold=30)),
    (0.20, 0.50, 52, JaxConfig(x=2, o=3, e=1, k=4, leap_af_threshold=36)),
    (0.10, 0.96, 53, JaxConfig(k=3, leap_af_threshold=24,
                               leap_mode=JaxMode.LOCAL)),
    (0.10, 0.80, 54, JaxConfig(x=2, o=3, e=1, k=3, leap_af_threshold=30,
                               leap_mode=JaxMode.SEMI_FREE_BEGIN)),
    (0.10, 0.80, 55, JaxConfig(k=3, leap_af_threshold=24,
                               leap_mode=JaxMode.SEMI_FREE_END)),
]


def _corpus(err, mr, seed, L=128, n=64, length=100, **kw):
    return generate_dataset_arrays(n, length, err, mr, seed=seed, max_len=L,
                                   **kw)


@pytest.mark.parametrize("err,mr,seed,jcfg", HISTORY_CASES)
def test_backtrack_matches_jax(err, mr, seed, jcfg):
    corpus = _corpus(err, mr, seed, length_range=(80, 110))
    hist = jax_leap(*map(jnp.asarray, corpus), jcfg, want_history=True)
    cfg = config_from_jax(jcfg)
    got = leap_align(*map(torch.from_numpy, corpus), cfg, want_history=True)
    want = jax_bt(hist, jcfg)
    assert leap_backtrack_batch(got, cfg) == want
    assert sum(w is not None for w in want) >= 16
    # the packed records decode to the same edit lists
    rec = leap_edit_records(got, cfg, jcfg.leap_af_threshold)
    out = dict(edit_rec=torch.from_numpy(rec), passed=got["passed"],
               lane_shift=got["lane_shift"])
    assert leap_cigar_decode(out, cfg) == want


# (corpus kwargs, config, input form): narrow cells at L = 128 (the wide
# cells of L = 256 in test_torch_leap_cigar_wide.py)
RECORD_CASES = [
    ("narrow-global-planes", dict(err=0.05, mr=0.96, seed=60),
     JaxConfig(k=3, leap_af_threshold=24), True),
    ("narrow-affine-semi_free_begin", dict(err=0.10, mr=0.80, seed=61,
                                           length_range=(80, 110)),
     JaxConfig(x=2, o=3, e=1, k=3, leap_af_threshold=30,
               leap_mode=JaxMode.SEMI_FREE_BEGIN), False),
]


def check_records(kw, jcfg, planes):
    """The wrapper's records (CPU route: leap_edit_records) against the
    Pallas kernel's raw edit_rec, with passed / penalty / lane_shift and
    the decoded edit lists."""
    rc, rl, fc, fl = corpus = _corpus(**kw)
    if planes:
        want = leap_align_pallas(
            jnp.asarray(jax_stage(rc, tile=TILE)), jnp.asarray(rl),
            jnp.asarray(jax_stage(fc, tile=TILE)), jnp.asarray(fl), jcfg,
            interpret=True, pre_staged="planes_tiled", want_cigar=True,
            tile=TILE)
        rc, fc = (stage_planes_tiled_t(a, tile=TILE) for a in (rc, fc))
    else:
        want = leap_align_pallas(*map(jnp.asarray, corpus), jcfg,
                                 interpret=True, want_cigar=True, tile=TILE)
    cfg = config_from_jax(jcfg)
    got = leap_align_cuda(*map(torch.from_numpy, (rc, rl, fc, fl)), cfg,
                          pre_staged="planes_tiled" if planes else False,
                          tile=TILE, want_cigar=True)
    for key in ("passed", "penalty", "lane_shift", "edit_rec"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    assert got["edit_rec"].shape == (cfg.leap_energy_bound + 1, len(rl))
    assert leap_cigar_decode(got, cfg) == jax_decode(want, jcfg)


@pytest.mark.parametrize("label,kw,jcfg,planes", RECORD_CASES,
                         ids=[c[0] for c in RECORD_CASES])
def test_edit_records_match_pallas(label, kw, jcfg, planes):
    check_records(kw, jcfg, planes)


def test_records_above_the_bound_stay_empty():
    """A pair passing above E is not walked (the kernel's contract): its
    records are all zero, the other pairs' are unchanged."""
    corpus = _corpus(0.2, 0.96, 64)
    cfg = config_from_jax(JaxConfig(k=3, leap_af_threshold=40))
    hist = leap_align(*map(torch.from_numpy, corpus), cfg, want_history=True)
    pen = hist["penalty"].numpy()
    E = int(np.median(pen))
    rec = leap_edit_records(hist, cfg, E)
    full = leap_edit_records(hist, cfg, 40)
    above = hist["passed"].numpy() & (pen > E)
    assert above.any() and not rec[:, above].any()
    np.testing.assert_array_equal(rec[:, ~above], full[:E + 1, ~above])


@pytest.mark.parametrize("err,expect_bound", [(0.05, 16), (0.25, 32)])
def test_cigar_auto_two_passes(err, expect_bound):
    """Pass 1 gives the largest passed energy, rounded up to 16; pass 2's
    CIGARs equal the JAX package's XLA history + backtrack."""
    jcfg = JaxConfig(k=3)  # af = 200
    corpus = _corpus(err, 0.96, 65)
    hist = jax_leap(*map(jnp.asarray, corpus), jcfg, want_history=True)
    pen, ps = np.asarray(hist["penalty"]), np.asarray(hist["passed"])
    maxe = int(pen[ps].max())
    assert expect_bound - 16 < maxe <= expect_bound
    cfg = config_from_jax(jcfg)
    out = leap_cigar_auto(*map(torch.from_numpy, corpus), cfg)
    assert out["energy_bound"] == expect_bound
    assert out["edit_rec"].shape == (expect_bound + 1, len(pen))
    assert out["cigars"] == jax_bt(hist, jcfg)
    with pytest.raises(ValueError):
        leap_cigar_auto(*map(torch.from_numpy, corpus),
                        dataclasses.replace(cfg, leap_max_energy=16))
