"""The port's three-way harness and evaluation pipeline on the CPU against
the JAX package's: `bench.harness.run_benchmark` with impl="torch" (the
plain versions) and impl="cuda" (the kernels' wrappers, which run their
plain versions for CPU tensors: the partitioned NW dispatch, greedy and
LEAP on tile-major planes) against `asm_tpu.bench.harness.run_benchmark(
impl="xla")`, and `parallel.runner.make_pipeline_step` against
`asm_tpu.parallel.runner.make_sharded_pipeline` on a one-device mesh.

Tolerance: exact. The accuracies and coverage are ratios of integer
counts over the same pairs, and every pipeline output is an integer."""

import numpy as np
import pytest
import torch

from asm_tpu.bench.harness import format_report as jax_format_report
from asm_tpu.bench.harness import run_benchmark as jax_run_benchmark
from asm_tpu.config import AlignConfig as JaxConfig
from asm_tpu.parallel import make_mesh, shard_batch
from asm_tpu.parallel.runner import make_sharded_pipeline
from asm_tpu_torch.bench.harness import format_report, run_benchmark
from asm_tpu_torch.config import AlignConfig
from asm_tpu_torch.data.generator import generate_dataset_arrays
from asm_tpu_torch.parallel.runner import (
    BatchStats,
    make_pipeline_step,
    unpack_stats,
)

torch.set_num_threads(1)

# fixed length at err 0.10, variable lengths, and the reference's lt_eq
# error counts (uniform in [0, ceil(err * len)])
CORPORA = {
    "err0.10": dict(error_rate=0.10, seed=4),
    "length_range": dict(error_rate=0.12, mismatch_rate=0.8, seed=95,
                         length_range=(60, 120)),
    "lt_eq": dict(error_rate=0.10, seed=7, exact_error_rate=False),
}
N_PAIRS = 256
FIELDS = ("total", "nw_accuracy", "leap_accuracy", "greedy_accuracy",
          "greedy_coverage", "coverage_checked")
_JAX = {}


def _corpus(name):
    return generate_dataset_arrays(N_PAIRS, 100, **CORPORA[name])


def _jax_result(name):
    """The JAX harness (impl="xla") on a corpus, once per corpus."""
    if name not in _JAX:
        _JAX[name] = jax_run_benchmark(*_corpus(name), cfg=JaxConfig(),
                                       chunk=128, impl="xla")
    return _JAX[name]


def _untimed(report: str) -> list[str]:
    return [ln for ln in report.splitlines() if " s  (" not in ln]


@pytest.mark.parametrize("impl", ["torch", "cuda"])
@pytest.mark.parametrize("name", list(CORPORA))
def test_harness_matches_jax(name, impl):
    got = run_benchmark(*_corpus(name), cfg=AlignConfig(), chunk=96,
                        impl=impl, device="cpu")
    want = _jax_result(name)
    for f in FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    assert _untimed(format_report(got)) == _untimed(jax_format_report(want))
    assert got.device == "cpu"
    assert all(ln.endswith("aligns/s on cpu)")
               for ln in format_report(got).splitlines() if " s  (" in ln)


def test_harness_coverage_prefix_and_off():
    corpus = _corpus("err0.10")
    got = run_benchmark(*corpus, cfg=AlignConfig(), chunk=N_PAIRS,
                        coverage_sample=40, impl="torch", device="cpu")
    want = jax_run_benchmark(*corpus, cfg=JaxConfig(), chunk=N_PAIRS,
                             coverage_sample=40, impl="xla")
    assert (got.coverage_checked, got.greedy_coverage) == (
        40, want.greedy_coverage)
    off = run_benchmark(*corpus, cfg=AlignConfig(), chunk=N_PAIRS,
                        want_coverage=False, impl="torch", device="cpu")
    assert (off.coverage_checked, off.greedy_coverage) == (0, 0.0)
    with pytest.raises(ValueError):
        run_benchmark(*corpus, impl="xla", device="cpu")


@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_pipeline_matches_sharded_pipeline(impl):
    corpus = _corpus("length_range")
    mesh = make_mesh(1)
    want = make_sharded_pipeline(mesh, JaxConfig())(*shard_batch(mesh,
                                                                 *corpus))
    step = make_pipeline_step(AlignConfig(), "cpu", impl=impl)
    got = step(*[torch.from_numpy(a) for a in corpus])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    stats = unpack_stats(got[3])
    assert isinstance(stats, BatchStats) and stats.pairs == N_PAIRS
    assert stats.greedy_accuracy == stats.greedy_correct / N_PAIRS
    with pytest.raises(ValueError):
        step(*[torch.from_numpy(a) for a in corpus[:3]],
             torch.from_numpy(corpus[3]).to("meta"))
