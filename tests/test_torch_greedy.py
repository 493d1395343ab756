"""The plain PyTorch greedy (asm_tpu_torch.kernels.greedy) equals the JAX
XLA greedy (asm_tpu.kernels.greedy) exactly — cost, steps, (op, run) slots
and decoded CIGARs — on the corpora the GPU smoke test runs (here at a
small size), and the scalar emulator greedy_ref in float64 mode.

Tolerance: exact equality everywhere. Both sides evaluate the float32
heuristic as separate multiplies and adds in the same order, so even the
exact heuristic ties of the err 0.4 / mr 0.5 corpus break alike."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asm_tpu.config import AlignConfig as JaxConfig
from asm_tpu.config import AlignmentType as JaxAT
from asm_tpu.data.generator import generate_dataset, generate_dataset_arrays
from asm_tpu.encoding import encode_batch
from asm_tpu.kernels.greedy import greedy_align as jax_greedy
from asm_tpu.ops.cigar import batch_greedy_cigars
from asm_tpu.reference_impl.greedy_ref import greedy_ref
from asm_tpu_torch.config import AlignConfig, config_from_jax
from asm_tpu_torch.kernels.greedy import greedy_align
from asm_tpu_torch.kernels.greedy_cuda import expand_records

torch.set_num_threads(1)

G, S = JaxAT.GLOBAL, JaxAT.SEMI_GLOBAL

# (label, config, corpus) — chip_smoke.py phase 3, cut to test size
CASES = [
    *[(f"err{err}-mr{mr}-{at.name}", JaxConfig(max_steps=24,
                                               alignment_type=at),
       dict(num_reads=96, length=100, error_rate=err, mismatch_rate=mr,
            seed=int(err * 100)))
      for err, mr in [(0.05, 0.96), (0.2, 0.96), (0.4, 0.5)]
      for at in (G, S)],
    ("x2o3e1k2", JaxConfig(x=2, o=3, e=1, k=2, max_steps=24),
     dict(num_reads=64, length=80, error_rate=0.1, mismatch_rate=0.8,
          seed=5)),
    *[(f"max_steps{b}-{at.name}", JaxConfig(max_steps=b, alignment_type=at),
       dict(num_reads=64, length=100, error_rate=0.1, mismatch_rate=0.9,
            seed=17))
      for b in (1, 2) for at in (G, S)],
    ("length_range", JaxConfig(max_steps=24),
     dict(num_reads=96, length=100, error_rate=0.15, mismatch_rate=0.96,
          seed=44, length_range=(60, 120))),
    ("max_len256", JaxConfig(max_len=256, max_steps=64),
     dict(num_reads=48, length=200, error_rate=0.1, mismatch_rate=0.9,
          seed=3, max_len=256)),
    ("flip_threshold2", JaxConfig(max_steps=24, flip_threshold=2),
     dict(num_reads=64, length=100, error_rate=0.15, mismatch_rate=0.9,
          seed=12)),
]


def _cigars(out):
    return batch_greedy_cigars({k: np.asarray(v) for k, v in out.items()})


@pytest.mark.parametrize("label,jcfg,kw", CASES, ids=[c[0] for c in CASES])
def test_plain_matches_jax_xla(label, jcfg, kw):
    corpus = generate_dataset_arrays(**kw)
    ref = jax_greedy(*map(jnp.asarray, corpus), jcfg)
    got = greedy_align(*map(torch.from_numpy, corpus), config_from_jax(jcfg))
    for key in ("cost", "steps", "cigar_ops", "cigar_runs", "cigar_count",
                "final_lane", "final_col"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]),
                                      err_msg=key)
        assert got[key].dtype == getattr(torch, str(ref[key].dtype)), key
    assert _cigars(got) == _cigars(ref)


@pytest.mark.parametrize("label,jcfg,kw", CASES[:7], ids=[c[0] for c in
                                                          CASES[:7]])
def test_records_decode_to_the_same_cigars(label, jcfg, kw):
    """step_rec (the kernel's record layout) expands to the CIGARs of the
    slot buffers."""
    cfg = config_from_jax(jcfg)
    corpus = [torch.from_numpy(a) for a in generate_dataset_arrays(**kw)]
    got = greedy_align(*corpus, cfg, records=True)
    rec = got["step_rec"]
    assert rec.shape == (cfg.steps_bound + 1, corpus[0].shape[0])
    assert rec.dtype == torch.int16
    exp = expand_records(rec, corpus[1], corpus[3], cfg)
    assert _cigars(exp) == _cigars(got)


def _run_strings(reads, refs, cfg):
    corpus = encode_batch(reads, refs, cfg.max_len)
    return greedy_align(*map(torch.from_numpy, corpus), cfg)


def test_empty_and_equal_pairs():
    cfg = AlignConfig(k=3)
    reads = ["", "", "ACGT", "ACGTACGTAC" * 10, "GATTACA", "A"]
    refs = ["", "ACGTA", "", "ACGTACGTAC" * 10, "GATTACA", "A"]
    out = _run_strings(reads, refs, cfg)
    cigars = _cigars(out)
    for i, (a, b) in enumerate(zip(reads, refs)):
        exp_cost, exp_cigar = greedy_ref(a, b, k=3)
        assert int(out["cost"][i]) == exp_cost, i
        assert cigars[i] == exp_cigar, i
        if a == b:
            assert int(out["cost"][i]) == 0
    assert cigars[3] == "100M"


@pytest.mark.parametrize("err", [0.05, 0.10])
def test_exact_floats_matches_scalar_ref(err):
    """float64 heuristic (the C++ doubles) against the scalar emulator;
    the JAX XLA path would need x64 switched on process-wide."""
    cfg = AlignConfig(exact_floats=True)
    reads, refs = generate_dataset(64, 100, err, 0.96, seed=int(err * 1000))
    out = _run_strings(reads, refs, cfg)
    cigars = _cigars(out)
    for i in range(len(reads)):
        exp_cost, exp_cigar = greedy_ref(reads[i], refs[i], k=3)
        assert int(out["cost"][i]) == exp_cost, i
        assert cigars[i] == exp_cigar, i


def test_semi_global_and_penalties_match_scalar_ref():
    reads, refs = generate_dataset(32, 80, 0.1, 0.8, seed=5)
    cfg = AlignConfig(x=2, o=3, e=1, k=2)
    out = _run_strings(reads, refs, cfg)
    cigars = _cigars(out)
    for i in range(len(reads)):
        exp = greedy_ref(reads[i], refs[i], k=2, x=2, o=3, e=1)
        assert (int(out["cost"][i]), cigars[i]) == exp, i
    cfg = AlignConfig(k=3, alignment_type=S)
    out = _run_strings(reads, refs, cfg)
    cigars = _cigars(out)
    for i in range(len(reads)):
        exp = greedy_ref(reads[i], refs[i], k=3, alignment_type=S)
        assert (int(out["cost"][i]), cigars[i]) == exp, i
