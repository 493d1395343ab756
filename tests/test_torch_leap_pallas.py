"""The LEAP kernel wrapper (leap_cuda.leap_align_cuda, which runs its plain
version for CPU tensors) against asm_tpu's Pallas LEAP kernel in
interpret mode: the SIMD_ED semantics, with and without the SHD gate, unit
and affine penalties, across the four LeapModes, on corpora with unequal
lengths, in both input forms (lv_bag is held against Pallas in
test_torch_leap_cigar.py, the gate's edge cases in test_torch_leap_gate.py).

Tolerance: exact equality of passed, penalty and lane_shift. The one
known difference: the Pallas gate counts a position past the shorter
string's end as a hurdle, where the reference (and the XLA path, and the
port) compares the zero-padded buffer's 'A' there; on pairs of unequal
length the two gates can disagree, and there the port equals the XLA
path."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asm_tpu.config import AlignConfig as JaxConfig
from asm_tpu.config import LeapMode as JaxMode
from asm_tpu.data.generator import generate_dataset_arrays
from asm_tpu.kernels.greedy_pallas import stage_planes_tiled_t as jax_stage
from asm_tpu.kernels.leap import leap_align as jax_leap
from asm_tpu.kernels.leap_pallas import leap_align_pallas
from asm_tpu_torch.config import config_from_jax
from asm_tpu_torch.kernels.greedy_cuda import stage_planes_tiled_t
from asm_tpu_torch.kernels.leap_cuda import leap_align_cuda

torch.set_num_threads(1)

TILE = 256
KEYS = ("passed", "penalty", "lane_shift")


def _corpus():
    """Unequal lengths (60-120) and the indel-heavy profile, 80 pairs."""
    blocks = [generate_dataset_arrays(40, 100, 0.12, 0.8, seed=95,
                                      length_range=(60, 120)),
              generate_dataset_arrays(40, 100, 0.4, 0.5, seed=40)]
    return tuple(np.concatenate([b[i] for b in blocks]) for i in range(4))


def _port(corpus, jcfg, sem, gate, planes=False):
    rc, rl, fc, fl = corpus
    if planes:
        rc, fc = (stage_planes_tiled_t(a, tile=TILE) for a in (rc, fc))
    return leap_align_cuda(
        *map(torch.from_numpy, (rc, rl, fc, fl)), config_from_jax(jcfg),
        pre_staged="planes_tiled" if planes else False, tile=TILE,
        semantics=sem, use_shd_gate=gate)


def pallas(corpus, jcfg, sem, gate, planes=False):
    rc, rl, fc, fl = corpus
    if planes:
        rc, fc = (jax_stage(a, tile=TILE) for a in (rc, fc))
    return leap_align_pallas(
        *map(jnp.asarray, (rc, rl, fc, fl)), jcfg, interpret=True,
        pre_staged="planes_tiled" if planes else False, tile=TILE,
        semantics=sem, use_shd_gate=gate)


def check(corpus, jcfg, sem, gate, planes=False, want=None):
    """The port against the Pallas result `want` (computed when None)."""
    got = _port(corpus, jcfg, sem, gate, planes)
    if want is None:
        want = pallas(corpus, jcfg, sem, gate, planes)
    differ = np.zeros(len(corpus[1]), bool)
    for key in KEYS:
        differ |= got[key].numpy() != np.asarray(want[key])
    if differ.any():
        # only the gate may differ, on pairs of unequal length, where the
        # port equals the XLA path
        assert gate
        assert (corpus[1] != corpus[3])[differ].all()
        xla = jax_leap(*map(jnp.asarray, corpus), jcfg, semantics=sem,
                       use_shd_gate=gate)
        for key in KEYS:
            np.testing.assert_array_equal(got[key].numpy()[differ],
                                          np.asarray(xla[key])[differ])
    return got


# (semantics, gate, (x, o, e), mode): each variant in a different mode
CASES = [
    ("simd_ed_lev", True, (1, 1, 1), JaxMode.GLOBAL),
    ("simd_ed_lev", False, (1, 1, 1), JaxMode.SEMI_FREE_BEGIN),
    ("simd_ed_affine", False, (1, 1, 1), JaxMode.SEMI_FREE_END),
    ("simd_ed_affine", False, (2, 3, 1), JaxMode.GLOBAL),
]


@pytest.mark.parametrize("sem,gate,pens,mode", CASES,
                         ids=[f"{c[0]}-gate{int(c[1])}-{c[3].name}"
                              for c in CASES])
def test_wrapper_matches_pallas(sem, gate, pens, mode):
    if sem == "simd_ed_lev":
        jcfg = JaxConfig(k=3, leap_af_threshold=3, leap_mode=mode)
    else:
        jcfg = JaxConfig(x=pens[0], o=pens[1], e=pens[2], k=3,
                         leap_af_threshold=40, leap_mode=mode)
    check(_corpus(), jcfg, sem, gate, planes=mode == JaxMode.GLOBAL)
