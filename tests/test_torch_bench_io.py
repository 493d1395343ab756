"""The harness's host modules in the port against the JAX package's: the
pair-file IO (files byte-equal), the real-profile generator (arrays
equal), the numLeaps metric (equal on a corpus's CIGARs), and the CLI
(`python -m asm_tpu_torch.bench --device cpu --impl torch`), whose
numbers must equal `run_benchmark`'s on the same corpus.

Tolerance: exact (bytes, integer arrays, counts)."""

import numpy as np
import pytest
import torch

from asm_tpu.data import generator as jax_generator
from asm_tpu.data import io as jax_io
from asm_tpu.encoding import decode_string
from asm_tpu.metrics import numleaps as jax_numleaps
from asm_tpu.ops.cigar import aligned_strings
from asm_tpu_torch.bench import __main__ as cli
from asm_tpu_torch.bench.harness import run_benchmark
from asm_tpu_torch.config import AlignConfig
from asm_tpu_torch.data import generator, io
from asm_tpu_torch.data.generator import (
    generate_dataset_arrays,
    generate_dataset_native,
)
from asm_tpu_torch.encoding import encode_batch
from asm_tpu_torch.kernels.greedy import greedy_align
from asm_tpu_torch.kernels.nw import nw_align
from asm_tpu_torch.metrics import numleaps
from asm_tpu_torch.ops.cigar import batch_greedy_cigars, batch_nw_cigars

torch.set_num_threads(1)

REPORTED = ("total", "nw_accuracy", "leap_accuracy", "greedy_accuracy",
            "greedy_coverage", "coverage_checked")


def _strings(corpus):
    rc, rl, fc, fl = corpus
    return ([decode_string(rc[i], int(rl[i])) for i in range(len(rl))],
            [decode_string(fc[i], int(fl[i])) for i in range(len(fl))])


def test_pair_file_round_trip_byte_equal(tmp_path):
    reads, refs = _strings(generate_dataset_arrays(50, 100, 0.1, seed=3,
                                                   length_range=(1, 120)))
    reads[0], refs[1] = "", ""  # empty sequences survive the round trip
    ours, theirs = tmp_path / "port.seq", tmp_path / "jax.seq"
    io.write_pair_file(str(ours), reads, refs)
    jax_io.write_pair_file(str(theirs), reads, refs)
    assert ours.read_bytes() == theirs.read_bytes()
    for kw in ({}, {"max_tests": 7}, {"skip_first_char": False}):
        assert (io.read_pair_file(str(ours), **kw)
                == jax_io.read_pair_file(str(ours), **kw))
    assert io.read_pair_file(str(ours)) == (reads, refs)

    answers = tmp_path / "answers.txt"
    answers.write_text("3\n\n17\n4\n")
    for kw in ({}, {"max_tests": 2}):
        assert (io.read_answer_file(str(answers), **kw)
                == jax_io.read_answer_file(str(answers), **kw))
    assert io.read_answer_file(str(tmp_path / "missing.txt")) == []


@pytest.mark.parametrize("seed", [0, 11])
@pytest.mark.parametrize("length_range", [None, (40, 130)])
def test_real_profile_arrays_equal(seed, length_range):
    kw = dict(seed=seed, length_range=length_range)
    got = generator.generate_real_profile_arrays(300, 100, **kw)
    want = jax_generator.generate_real_profile_arrays(300, 100, **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert (generator.dataset_filename(5000000, 100, 0.15, exact=False)
            == jax_generator.dataset_filename(5000000, 100, 0.15,
                                              exact=False))


def test_num_leaps_equal_on_corpus_cigars():
    corpus = generate_dataset_arrays(128, 100, 0.2, 0.5, seed=8)
    args = [torch.from_numpy(a) for a in corpus]
    cigars = (batch_nw_cigars(nw_align(*args)[1].numpy())
              + batch_greedy_cigars({k: v.numpy() for k, v in greedy_align(
                  *args, AlignConfig()).items() if k.startswith("cigar")}))
    reads, refs = _strings(corpus)
    assert sum(numleaps.num_leaps(c) for c in cigars) > 0
    for i, c in enumerate(cigars):
        assert numleaps.num_leaps(c) == jax_numleaps.num_leaps(c)
        a1, a2 = aligned_strings(reads[i % 128], refs[i % 128], c)
        assert (numleaps.num_leaps_aligned(a1, a2)
                == jax_numleaps.num_leaps_aligned(a1, a2))


def _same_numbers(got, want):
    for f in REPORTED:
        assert getattr(got, f) == getattr(want, f), f


def test_cli_file_run(tmp_path, capsys):
    corpus = generate_dataset_arrays(100, 100, 0.1, seed=21)
    path = tmp_path / "pairs.seq"
    io.write_pair_file(str(path), *_strings(corpus))
    (got,) = cli.main(["--device", "cpu", "--impl", "torch", "--file",
                       str(path), "--pairs", "80", "--coverage-sample", "32"])
    reads, refs = io.read_pair_file(str(path), max_tests=80)
    want = run_benchmark(*encode_batch(reads, refs, 128), AlignConfig(),
                         coverage_sample=32, impl="torch", device="cpu")
    _same_numbers(got, want)
    assert got.total == 80
    assert f"--- file:{path}: 80 pairs ---" in capsys.readouterr().out


def test_cli_lt_eq_and_real_profile_runs():
    (lt,) = cli.main(["--device", "cpu", "--impl", "torch", "--lt-eq",
                      "--pairs", "96", "--err", "0.10", "--seed", "5",
                      "--coverage-sample", "24"])
    corpus = generate_dataset_native(96, 100, 0.10, 0.96,
                                     exact_error_rate=False, seed=5)
    _same_numbers(lt, run_benchmark(*corpus, AlignConfig(),
                                    coverage_sample=24, impl="torch",
                                    device="cpu"))
    (rp,) = cli.main(["--device", "cpu", "--impl", "torch", "--real-profile",
                      "--pairs", "96", "--length-range", "60", "110",
                      "--no-coverage"])
    corpus = generator.generate_real_profile_arrays(96, 100, seed=42,
                                                    length_range=(60, 110))
    _same_numbers(rp, run_benchmark(*corpus, AlignConfig(),
                                    want_coverage=False, impl="torch",
                                    device="cpu"))
    assert rp.coverage_checked == 0
