"""Edge cases of the port's in-run SHD gate (kernels.leap.shd_gate, inside
leap_align(semantics="simd_ed_lev", use_shd_gate=True) and the CUDA
kernel) against the scalar reference simd_ed_ref, asm_tpu's XLA path and
its Pallas kernel in interpret mode: 256-long buffers at L = 256 and
pairs of unequal length.

Tolerance: exact equality; where the two JAX gates disagree, the test
says which one the port follows and why."""

import jax.numpy as jnp
import numpy as np
import torch

from asm_tpu.config import AlignConfig as JaxConfig
from asm_tpu.config import LeapMode as JaxMode
from asm_tpu.data.generator import generate_dataset, generate_dataset_arrays
from asm_tpu.encoding import encode_batch
from asm_tpu.kernels.leap import leap_align as jax_leap
from asm_tpu.reference_impl.simd_ed_ref import SimdEdRef
from asm_tpu_torch.config import config_from_jax
from asm_tpu_torch.kernels.leap import leap_align, shd_gate
from test_torch_leap_pallas import check, pallas

torch.set_num_threads(1)


def _main_cpp(reads, refs, L):
    """main.cpp's pairs: the read's length for both; the ref cut to it or
    zero-padded ('A') up to it."""
    rc, rl, fc, _ = encode_batch(reads, refs, L)
    pos = np.arange(L)[None, :]
    fc = np.where((pos < rl[:, None]) & (fc >= 4), 0, fc).astype(np.int8)
    return [torch.from_numpy(a) for a in (rc, rl, fc, rl)]


def test_gate_clears_bit_255_at_L256():
    """Three isolated all-lane mismatches plus one at position 255 of a
    256-long pair: the reference's gate (its OOB row clears bit 255)
    counts 3 <= k and runs the pair; the XLA gate counts 4 and stops it
    with penalty 0. The port follows the reference."""
    read = list("A" * 256)
    ref = list("A" * 256)
    for p in (40, 120, 200, 255):
        read[p], ref[p] = "C", "G"
    read, ref = "".join(read), "".join(ref)
    jcfg = JaxConfig(k=3, leap_af_threshold=3, max_len=256)
    t = _main_cpp([read], [ref], 256)
    out = leap_align(*t, config_from_jax(jcfg), semantics="simd_ed_lev",
                     use_shd_gate=True)
    emu = SimdEdRef()
    emu.init_levenshtein(3, JaxMode.GLOBAL, True)
    emu.load_pair(read, ref)
    assert bool(shd_gate(t[0], t[2], t[1], 3)[0]) == emu._shd_gate() is True
    xla = jax_leap(*[jnp.asarray(a.numpy()) for a in t], jcfg,
                   semantics="simd_ed_lev", use_shd_gate=True)
    assert int(xla["penalty"][0]) == 0 and not bool(xla["passed"][0])
    assert int(out["penalty"][0]) == 4 and not bool(out["passed"][0])


def test_gate_matches_scalar_reference():
    """The port's gate verdict equals the emulator's on main.cpp pairs of
    every length up to 256, full-length buffers included."""
    reads, refs = [], []
    for length, seed in ((100, 1), (200, 2), (256, 3)):
        r, f = generate_dataset(40, length, 0.4, 0.5, seed=seed,
                                exact_error_rate=False)
        reads += r
        refs += f
    t = _main_cpp(reads, refs, 256)
    got = shd_gate(t[0], t[2], t[1], 3).numpy()
    want = []
    for read, ref in zip(reads, refs):
        emu = SimdEdRef()
        emu.init_levenshtein(3, JaxMode.GLOBAL, True)
        emu.load_pair(read, ref)
        want.append(emu._shd_gate())
    assert 0 < sum(want) < len(want)
    np.testing.assert_array_equal(got, np.array(want))


def test_wrapper_matches_pallas_L256_gated_full_length():
    """L = 256 with 256-long buffers: both clear bit 255 of the gate."""
    blocks = [generate_dataset_arrays(24, 256, 0.01, 0.9, seed=4,
                                      max_len=256),
              generate_dataset_arrays(24, 200, 0.02, 0.9, seed=3,
                                      max_len=256)]
    corpus = tuple(np.concatenate([b[i] for b in blocks]) for i in range(4))
    assert (np.maximum(corpus[1], corpus[3]) == 256).any()
    got = check(corpus, JaxConfig(k=3, leap_af_threshold=3, max_len=256),
                "simd_ed_lev", True)
    assert 0 < int(got["passed"].sum()) < len(corpus[1])


def test_gate_on_unequal_lengths_follows_xla():
    """A 60 / 59-base pair the two JAX gates disagree on: the XLA gate
    (padding as 'A') runs it and it fails at e > k (penalty 4); the Pallas
    gate (padding as hurdles) stops it (penalty 0)."""
    read = "GATTCCCCACGGGACGTGTATGCTACGGCTCTCCCGCATCGGGTGGTCTCGCTACGGATA"
    ref = "GATTCCCCACGGGACGTGTACGCTACGGCGCGCCCGCATCCGGCGGTCTAGCTACGGTC"
    corpus = encode_batch([read, read], [ref, read], 128)
    jcfg = JaxConfig(k=3, leap_af_threshold=3)
    want = pallas(corpus, jcfg, "simd_ed_lev", True)
    got = check(corpus, jcfg, "simd_ed_lev", True, want=want)
    assert int(got["penalty"][0]) == 4 and int(want["penalty"][0]) == 0
    assert bool(got["passed"][1]) and int(got["penalty"][1]) == 0
