"""The port's plain LEAP (asm_tpu_torch.kernels.leap.leap_align) against
asm_tpu's XLA leap_align, every semantics x LeapMode x SHD gate x
penalty set, at L = 128 and 256, on corpora with unequal lengths and on
the edge pairs; and against the scalar emulators leap_ref and simd_ed_ref
(a fresh object per pair) on a few pairs.

Tolerance: exact equality of passed, penalty and lane_shift (and of the
history tables where asked). The one known difference, at L = 256 with a
256-long buffer under the SHD gate, is pinned in test_torch_leap_gate.py;
no corpus here holds such a pair."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asm_tpu.config import AlignConfig as JaxConfig
from asm_tpu.config import LeapMode as JaxMode
from asm_tpu.data.generator import generate_dataset, generate_dataset_arrays
from asm_tpu.encoding import encode_batch
from asm_tpu.kernels.leap import leap_align as jax_leap
from asm_tpu.reference_impl.leap_ref import leap_ref
from asm_tpu.reference_impl.simd_ed_ref import SimdEdRef
from asm_tpu_torch.config import config_from_jax
from asm_tpu_torch.kernels.leap import leap_align

torch.set_num_threads(1)

# one batch size per max_len, so XLA compiles once per configuration
B = 96
EDGE_READS = ["A", "ACGT" * 32, "ACGTACGT", "", "ACGT" * 25, "AC", ""]
EDGE_REFS = ["ACGT" * 32, "A", "ACGTACGT", "ACG", "ACGT" * 25, "TGCA" * 20,
             ""]


def _corpus128():
    """err 0.05 / 0.2 / indel-heavy 0.4 with mismatch rate 0.5 / lengths
    60-120 / the edge pairs, in one batch of B pairs."""
    blocks = [
        generate_dataset_arrays(22, 100, 0.05, 0.96, seed=5),
        generate_dataset_arrays(22, 100, 0.2, 0.96, seed=6),
        generate_dataset_arrays(22, 100, 0.4, 0.5, seed=40),
        generate_dataset_arrays(23, 100, 0.12, 0.8, seed=95,
                                length_range=(60, 120)),
        encode_batch(EDGE_READS, EDGE_REFS, 128),
    ]
    return tuple(np.concatenate([b[i] for b in blocks]) for i in range(4))


def _corpus256():
    return generate_dataset_arrays(B, 200, 0.1, 0.9, seed=3, max_len=256)


CORPORA = {128: _corpus128(), 256: _corpus256()}
# (semantics, use_shd_gate, (x, o, e))
VARIANTS = [
    ("lv_bag", False, (1, 1, 1)),
    ("lv_bag", False, (2, 3, 1)),
    ("simd_ed_lev", False, (1, 1, 1)),
    ("simd_ed_lev", True, (1, 1, 1)),
    ("simd_ed_affine", False, (1, 1, 1)),
    ("simd_ed_affine", False, (2, 3, 1)),
]
IDS = [f"{s}-gate{int(g)}-{''.join(map(str, p))}" for s, g, p in VARIANTS]


def jax_cfg(sem, pens, mode, L, k=3, af=40):
    if sem == "simd_ed_lev":
        return JaxConfig(k=k, leap_af_threshold=k, leap_mode=mode, max_len=L)
    return JaxConfig(x=pens[0], o=pens[1], e=pens[2], k=k,
                     leap_af_threshold=af, leap_mode=mode, max_len=L)


def _compare(corpus, jcfg, sem, gate, want_history=False):
    ref = jax_leap(*map(jnp.asarray, corpus), jcfg, semantics=sem,
                   use_shd_gate=gate, want_history=want_history)
    got = leap_align(*map(torch.from_numpy, corpus), config_from_jax(jcfg),
                     semantics=sem, use_shd_gate=gate,
                     want_history=want_history)
    keys = ["passed", "penalty", "lane_shift"]
    if want_history:
        keys += ["start", "end", "i_pos", "d_pos", "final_lane_idx"]
    for key in keys:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]),
                                      err_msg=key)
    assert got["penalty"].dtype == torch.int32
    return got


@pytest.mark.parametrize("sem,gate,pens", VARIANTS, ids=IDS)
@pytest.mark.parametrize("mode", list(JaxMode), ids=lambda m: m.name)
def test_matches_xla_L128(sem, gate, pens, mode):
    _compare(CORPORA[128], jax_cfg(sem, pens, mode, 128), sem, gate)


@pytest.mark.parametrize("sem,gate,pens", VARIANTS, ids=IDS)
def test_matches_xla_L256(sem, gate, pens):
    _compare(CORPORA[256], jax_cfg(sem, pens, JaxMode.GLOBAL, 256), sem,
             gate)


@pytest.mark.parametrize("k", [2, 4])
def test_matches_xla_other_bands(k):
    for sem, gate, pens in VARIANTS:
        _compare(CORPORA[128], jax_cfg(sem, pens, JaxMode.SEMI_FREE_BEGIN,
                                       128, k=k), sem, gate)


@pytest.mark.parametrize("mode", list(JaxMode), ids=lambda m: m.name)
def test_history_matches_xla(mode):
    _compare(CORPORA[128], jax_cfg("lv_bag", (2, 3, 1), mode, 128), "lv_bag",
             False, want_history=True)


def test_tight_threshold_matches_xla():
    got = _compare(CORPORA[128], JaxConfig(leap_af_threshold=2), "lv_bag",
                   False)
    assert 0 < int(got["passed"].sum()) < B


@pytest.mark.parametrize("err", [0.05, 0.2])
def test_matches_leap_ref(err):
    reads, refs = generate_dataset(24, 100, err, 0.96, seed=int(err * 100))
    for pens, mode in [((1, 1, 1), JaxMode.GLOBAL),
                       ((2, 3, 1), JaxMode.SEMI_FREE_END)]:
        jcfg = jax_cfg("lv_bag", pens, mode, 128, af=60)
        out = leap_align(*map(torch.from_numpy, encode_batch(reads, refs,
                                                               128)),
                         config_from_jax(jcfg))
        for i in range(len(reads)):
            want = leap_ref(reads[i], refs[i], k=3, af_threshold=60,
                            mode=mode, ms_penalty=pens[0],
                            gap_open_penalty=pens[1],
                            gap_ext_penalty=pens[2])
            got = (bool(out["passed"][i]), int(out["penalty"][i]),
                   int(out["lane_shift"][i]))
            assert got == want, i


def _main_cpp(reads, refs, L):
    """main.cpp's pairs: the read's length for both; the ref cut to it or
    zero-padded ('A') up to it."""
    rc, rl, fc, _ = encode_batch(reads, refs, L)
    pos = np.arange(L)[None, :]
    fc = np.where((pos < rl[:, None]) & (fc >= 4), 0, fc).astype(np.int8)
    return [torch.from_numpy(a) for a in (rc, rl, fc, rl)]


@pytest.mark.parametrize("lev,shd", [(1, 1), (1, 0), (0, 0)])
def test_matches_fresh_simd_ed_ref(lev, shd):
    reads, refs = generate_dataset(32, 100, 0.05, 0.96, seed=66)
    k = 3
    jcfg = (JaxConfig(k=k, leap_af_threshold=k) if lev else
            JaxConfig(x=2, o=3, e=1, k=k, leap_af_threshold=3 * k))
    sem = "simd_ed_lev" if lev else "simd_ed_affine"
    out = leap_align(*_main_cpp(reads, refs, 128), config_from_jax(jcfg),
                     semantics=sem, use_shd_gate=bool(shd))
    for i in range(len(reads)):
        emu = SimdEdRef()
        if lev:
            emu.init_levenshtein(k, JaxMode.GLOBAL, bool(shd))
        else:
            emu.init_affine(k, 3 * k, JaxMode.GLOBAL, 2, 3, 1, False)
        emu.load_pair(reads[i], refs[i])
        emu.reset()
        emu.run()
        want = (bool(emu.check_pass()), int(emu.get_ed()))
        assert (bool(out["passed"][i]), int(out["penalty"][i])) == want, i
