"""The port's host layer is byte-equal to asm_tpu's: generators, staging,
sort, step bounds, encoding, host arrays and the corpus cache."""

import numpy as np
import pytest
import torch

import asm_tpu.data.generator as jgen
import asm_tpu.encoding as jenc
import asm_tpu.kernels.greedy_pallas as jgp
import asm_tpu.native as jnative
import asm_tpu.parallel.schedule as jsched
import asm_tpu.utils.corpus_cache as jcache
import asm_tpu.utils.hostmem as jhost
import asm_tpu_torch.data.generator as tgen
import asm_tpu_torch.encoding as tenc
import asm_tpu_torch.kernels.greedy_cuda as tgc
import asm_tpu_torch.parallel.schedule as tsched
import asm_tpu_torch.utils.corpus_cache as tcache
import asm_tpu_torch.utils.hostmem as thost

torch.set_num_threads(1)


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("kw", [
    dict(num_reads=64, length=100, error_rate=0.05, seed=0),
    dict(num_reads=64, length=100, error_rate=0.15, mismatch_rate=0.8,
         seed=3),
    dict(num_reads=50, length=100, error_rate=0.4, mismatch_rate=0.5,
         seed=40),
    dict(num_reads=40, length=100, error_rate=0.2, exact_error_rate=False,
         seed=7),
    dict(num_reads=64, length=100, error_rate=0.15, seed=44,
         length_range=(60, 120)),
    dict(num_reads=30, length=100, error_rate=0.1, seed=8,
         length_range=(10, 40), exact_error_rate=False),
    dict(num_reads=16, length=200, error_rate=0.1, seed=3, max_len=256),
])
def test_numpy_generator_byte_equal(kw):
    _equal(tgen.generate_dataset_arrays(**kw),
           jgen.generate_dataset_arrays(**kw))


def test_nominal_errors_float32_ceil():
    for length, rate in [(100, 0.15), (100, 0.05), (80, 0.1), (128, 0.33)]:
        assert (tgen.nominal_errors(length, rate)
                == jgen.nominal_errors(length, rate))
    assert tgen.nominal_errors(100, 0.15) == 16


@pytest.mark.parametrize("err,seed,exact", [(0.05, 42, True), (0.2, 1, True),
                                            (0.1, 5, False)])
def test_native_generator_byte_equal_both_loaders(err, seed, exact):
    kw = dict(mismatch_rate=0.96, exact_error_rate=exact, seed=seed,
              max_len=128)
    _equal(tgen.generate_dataset_native(3000, 100, err, **kw),
           jnative.generate_dataset_native(3000, 100, err, **kw))


@pytest.mark.parametrize("B,L", [(200, 128), (4096, 128), (77, 256)])
@pytest.mark.parametrize("use_perm", [False, True])
def test_stage_planes_t_byte_equal(B, L, use_perm):
    rc, _, fc, _ = jgen.generate_dataset_arrays(B, L - 28, 0.1, seed=B,
                                                max_len=L)
    perm = np.random.default_rng(B).permutation(B) if use_perm else None
    for codes in (rc, fc):
        _equal([tgc.stage_planes_t(codes, perm=perm)],
               [jgp.stage_planes_t(codes, perm=perm)])


@pytest.mark.parametrize("tile", [2048, 4096])
@pytest.mark.parametrize("B", [2048, 5000, 300])
@pytest.mark.parametrize("use_perm", [False, True])
def test_stage_planes_tiled_t_byte_equal(tile, B, use_perm):
    rc, _, fc, _ = jgen.generate_dataset_arrays(B, 100, 0.1, seed=B + tile)
    perm = np.random.default_rng(B).permutation(B) if use_perm else None
    for codes in (rc, fc):
        _equal([tgc.stage_planes_tiled_t(codes, perm=perm, tile=tile)],
               [jgp.stage_planes_tiled_t(codes, perm=perm, tile=tile)])


def test_stage_planes_numpy_fallback_equal(monkeypatch):
    """Without the native runtime the numpy path stages the same bytes."""
    rc, _, _, _ = jgen.generate_dataset_arrays(700, 100, 0.1, seed=2)
    perm = np.random.default_rng(2).permutation(700)
    native = [tgc.stage_planes_t(rc, perm=perm),
              tgc.stage_planes_tiled_t(rc, perm=perm, tile=256)]
    monkeypatch.setattr(tgc, "load_native", lambda required=False: None)
    _equal([tgc.stage_planes_t(rc, perm=perm),
            tgc.stage_planes_tiled_t(rc, perm=perm, tile=256)], native)


def test_stage_planes_perm_slice_is_chunk():
    """A slice of the permutation stages exactly that chunk's tiles."""
    rc, _, _, _ = jgen.generate_dataset_arrays(1000, 100, 0.1, seed=4)
    perm = np.random.default_rng(4).permutation(1000)
    whole = tgc.stage_planes_tiled_t(rc, perm=perm, tile=256)  # 4 tiles
    first = tgc.stage_planes_tiled_t(rc, perm=perm[:512], tile=256)
    rest = tgc.stage_planes_tiled_t(rc, perm=perm[512:], tile=256)
    _equal([first, rest], [whole[:2], whole[2:]])


@pytest.mark.parametrize("err,mr", [(0.05, 0.96), (0.2, 0.96), (0.4, 0.5)])
def test_difficulty_order_equal(err, mr):
    c = jgen.generate_dataset_arrays(3000, 100, err, mr, seed=11)
    got = tsched.difficulty_order(*c)
    _equal([got], [jsched.difficulty_order(*c)])
    _equal([tsched.difficulty_proxy(*c)], [jsched.difficulty_proxy(*c)])
    _equal([tsched.inverse_permutation(got)],
           [jsched.inverse_permutation(got)])


@pytest.mark.parametrize("n,chunk", [(4096, 2048), (5000, 2048), (100, 7)])
def test_quantized_step_bounds_equal(n, chunk):
    steps = np.sort(np.random.default_rng(n).integers(0, 40, n))
    got = tsched.quantized_step_bounds(steps, chunk)
    assert got == jsched.quantized_step_bounds(steps, chunk)
    for i, b in enumerate(got):
        assert steps[i * chunk:(i + 1) * chunk].max() < b


def test_encoding_equal():
    reads = ["ACGTTGCA", "", "acgtNNNNacgt" * 20, "T"]
    refs = ["ACGA", "GGGG", "ACGT", ""]
    _equal(tenc.encode_batch(reads, refs, 128), jenc.encode_batch(reads, refs,
                                                                  128))
    for s in reads:
        _equal([tenc.encode_string(s, 64)], [jenc.encode_string(s, 64)])
        codes = tenc.encode_string(s, 64)
        assert tenc.decode_string(codes) == jenc.decode_string(codes)
        assert (tenc.decode_string(codes, len(s[:64]))
                == jenc.decode_string(codes, len(s[:64])))
    assert (tenc.PAD_READ, tenc.PAD_REF, tenc.PAD_SHIFT) == (4, 5, 6)


def test_hostmem_equal():
    a = thost.host_array((33, 7), np.int32)
    assert a.shape == (33, 7) and a.dtype == np.int32 and not a.any()
    src = np.arange(600, dtype=np.int32).reshape(200, 3)
    perm = np.random.default_rng(0).permutation(200)
    _equal([thost.take_rows(src, perm)], [jhost.take_rows(src, perm)])
    v = np.arange(50, dtype=np.int8)
    _equal([thost.take_rows(v, perm[:50] % 50)],
           [jhost.take_rows(v, perm[:50] % 50)])


def test_corpus_cache_round_trip_and_cross_read(tmp_path):
    c = jgen.generate_dataset_arrays(300, 100, 0.1, seed=6)
    params = dict(n=300, err=0.1, seed=6)
    tcache.save_corpus(str(tmp_path / "t.npz"), *c, **params)
    _equal(tcache.load_corpus(str(tmp_path / "t.npz"), **params), c)
    _equal(jcache.load_corpus(str(tmp_path / "t.npz"), **params), c)
    jcache.save_corpus(str(tmp_path / "j.npz"), *c, **params)
    _equal(tcache.load_corpus(str(tmp_path / "j.npz"), **params), c)
    assert tcache.load_corpus(str(tmp_path / "t.npz"), n=301) is None
    assert tcache.load_corpus(str(tmp_path / "absent.npz"), **params) is None
