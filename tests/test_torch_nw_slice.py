"""The port's NW slice end to end on the CPU: the NW headline flow
(`nw_headline.run`, every kernel wrapper on its plain version) over
native-corpus pairs against the JAX package's exact nw_penalty and
required_band on the same pairs.

Tolerance: exact equality of the checksum, the partitions and every
pair's penalty."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asm_tpu.data.generator import generate_dataset_arrays
from asm_tpu.kernels.nw import nw_penalty
from asm_tpu.kernels.nw_band import required_band
from asm_tpu.native import generate_dataset_native
from asm_tpu_torch import nw_headline
from asm_tpu_torch.kernels import nw_band, nw_cuda

torch.set_num_threads(1)


def _jax_reference(corpus):
    pen = np.asarray(nw_penalty(*map(jnp.asarray, corpus)))
    bands = required_band(pen, bws=(8, 16, 32, 64))
    parts = dict(zip(*[v.tolist() for v in np.unique(bands,
                                                     return_counts=True)]))
    return pen, parts


@pytest.mark.parametrize("err,n,chunk", [(0.05, 3000, 1024),
                                         (0.20, 2000, 2000)])
def test_headline_flow_matches_jax(err, n, chunk):
    res = nw_headline.run(n_pairs=n, chunk=chunk, err=err, device="cpu",
                          reps=0)
    corpus = generate_dataset_native(n, 100, err, mismatch_rate=0.96,
                                     seed=42, max_len=128)
    for a, b in zip(res["corpus"], corpus):
        np.testing.assert_array_equal(a, b)
    pen, parts = _jax_reference(corpus)
    assert res["checksum"] == int(pen.sum(dtype=np.int64))
    assert res["partitions"] == parts
    np.testing.assert_array_equal(res["pen"], pen[res["perm"]])
    assert res["dispatches"] == sum(-(-v // chunk) for v in parts.values())
    assert nw_band.LAUNCHES == 0 and nw_cuda.LAUNCHES["nw"] == 0


def test_headline_flow_mixed_corpus_residue():
    """A corpus with a band-0 residue: the flow sends it to the full NW
    and stays exact."""
    blocks = [generate_dataset_arrays(40, 100, 0.10, 0.96, seed=71),
              generate_dataset_arrays(24, 100, 0.45, 0.10, seed=73)]
    corpus = [np.concatenate([b[i] for b in blocks]) for i in range(4)]
    res = nw_headline.run(chunk=16, device="cpu", reps=0, corpus=corpus)
    pen, parts = _jax_reference(corpus)
    assert 0 in res["partitions"] and res["partitions"] == parts
    np.testing.assert_array_equal(res["pen"], pen[res["perm"]])
    assert res["checksum"] == int(pen.sum(dtype=np.int64))


def test_baseline_rate_nearest():
    assert nw_headline.baseline_rate(0.05) == 1e6 / 36.22
    assert nw_headline.baseline_rate(0.19) == 1e6 / 31.55
