"""The port's greedy slice end to end on the CPU: the kernel wrapper
(greedy_align_cuda, which runs its plain version for CPU tensors) in both
input forms against asm_tpu's XLA greedy, the runner, the headline flow,
and the wrapper's argument checks (test_torch_pallas.py holds the
comparison with the Pallas kernel in interpret mode).

Tolerance: exact equality of cost, steps and decoded CIGARs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asm_tpu.config import AlignConfig as JaxConfig
from asm_tpu.config import AlignmentType as JaxAT
from asm_tpu.data.generator import generate_dataset_arrays
from asm_tpu.kernels.greedy import greedy_align as jax_greedy
from asm_tpu.native import generate_dataset_native
from asm_tpu.ops.cigar import batch_greedy_cigars
from asm_tpu_torch import headline
from asm_tpu_torch.config import AlignConfig, config_from_jax
from asm_tpu_torch.kernels import greedy_cuda
from asm_tpu_torch.kernels.greedy_cuda import (
    greedy_align_cuda,
    stage_planes_tiled_t,
)
from asm_tpu_torch.parallel.runner import make_greedy_step

torch.set_num_threads(1)


def _cigars(out):
    return batch_greedy_cigars({k: np.asarray(v) for k, v in out.items()})


def _same(got, ref):
    for key in ("cost", "steps"):
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(ref[key]), err_msg=key)
    assert _cigars(got) == _cigars(ref)


# (label, config, corpus)
CASES = [
    ("err0.05", JaxConfig(max_steps=24),
     dict(num_reads=300, length=100, error_rate=0.05, seed=5)),
    ("err0.4-mr0.5-semi", JaxConfig(max_steps=24,
                                    alignment_type=JaxAT.SEMI_GLOBAL),
     dict(num_reads=200, length=100, error_rate=0.4, mismatch_rate=0.5,
          seed=40)),
    ("x2o3e1k2", JaxConfig(x=2, o=3, e=1, k=2, max_steps=24),
     dict(num_reads=100, length=80, error_rate=0.1, mismatch_rate=0.8,
          seed=5)),
    ("max_steps1", JaxConfig(max_steps=1),
     dict(num_reads=100, length=100, error_rate=0.1, mismatch_rate=0.9,
          seed=17)),
    ("max_steps0", JaxConfig(max_steps=0),
     dict(num_reads=40, length=100, error_rate=0.1, seed=1)),
    ("length_range", JaxConfig(max_steps=24),
     dict(num_reads=150, length=100, error_rate=0.15, seed=44,
          length_range=(60, 120))),
]


XLA_CASES = [c for c in CASES if c[0] != "max_steps0"]  # XLA needs T >= 1


@pytest.mark.parametrize("label,jcfg,kw", XLA_CASES,
                         ids=[c[0] for c in XLA_CASES])
@pytest.mark.parametrize("form", ["codes", "planes_tiled"])
def test_wrapper_matches_xla(label, jcfg, kw, form):
    rc, rl, fc, fl = generate_dataset_arrays(**kw)
    ref = jax_greedy(*map(jnp.asarray, (rc, rl, fc, fl)), jcfg)
    cfg = config_from_jax(jcfg)
    if form == "codes":
        got = greedy_align_cuda(*map(torch.from_numpy, (rc, rl, fc, fl)),
                                cfg)
    else:
        got = greedy_align_cuda(
            torch.from_numpy(stage_planes_tiled_t(rc, tile=128)),
            torch.from_numpy(rl),
            torch.from_numpy(stage_planes_tiled_t(fc, tile=128)),
            torch.from_numpy(fl), cfg, pre_staged="planes_tiled", tile=128)
    _same(got, ref)


@pytest.mark.parametrize("label,jcfg,kw", CASES, ids=[c[0] for c in CASES])
def test_step_trips_from_records_match_plain(label, jcfg, kw):
    """step_trips reads from steps and records the step loop's trips that
    the plain version counts (its steps, plus one where a walk stopped on
    an empty highway)."""
    rc, rl, fc, fl = map(torch.from_numpy, generate_dataset_arrays(**kw))
    g = greedy_cuda.greedy_align(rc, rl, fc, fl, config_from_jax(jcfg),
                                 records=True)
    got = greedy_cuda.step_trips(g["steps"], g["step_rec"])
    assert torch.equal(got, g["trips"])
    extra = (g["trips"] - g["steps"]).unique().tolist()
    assert set(extra) <= {0, 1}, extra


def test_step_trips_count_empty_highway_trips():
    # indel-heavy walks and empty strings stop on an empty highway: trips
    # exceed steps there
    rc, rl, fc, fl = map(torch.from_numpy, generate_dataset_arrays(
        300, 100, 0.4, mismatch_rate=0.5, seed=40))
    rl[:8] = 0
    fl[4:12] = 0
    g = greedy_cuda.greedy_align(rc, rl, fc, fl, AlignConfig(max_steps=24),
                                 records=True)
    trips = greedy_cuda.step_trips(g["steps"], g["step_rec"])
    assert torch.equal(trips, g["trips"])
    assert bool((trips > g["steps"]).any())


def test_wrapper_want_cigar_false():
    rc, rl, fc, fl = map(torch.from_numpy,
                         generate_dataset_arrays(64, 100, 0.1, seed=9))
    cfg = AlignConfig(max_steps=24)
    got = greedy_align_cuda(rc, rl, fc, fl, cfg, want_cigar=False)
    assert set(got) == {"cost", "steps", "step_rec"}
    full = greedy_align_cuda(rc, rl, fc, fl, cfg)
    for key in got:
        assert torch.equal(got[key], full[key])


def test_runner_torch_and_cuda_routes_agree():
    rc, rl, fc, fl = generate_dataset_arrays(500, 100, 0.15, seed=3)
    cfg = AlignConfig(max_steps=24)
    planes = [torch.from_numpy(stage_planes_tiled_t(a, tile=256)
                               .view(np.int32)) for a in (rc, fc)]
    lens = [torch.from_numpy(a) for a in (rl, fl)]
    outs = [make_greedy_step(cfg, "cpu", impl=impl, pre_staged="planes_tiled",
                             tile=256, want_cigar=True)(
                planes[0], lens[0], planes[1], lens[1])
            for impl in ("torch", "cuda")]
    _same(outs[1], outs[0])
    with pytest.raises(ValueError):
        make_greedy_step(cfg, "cpu", impl="xla")


def test_headline_flow_matches_jax_xla():
    """Native corpus -> sort -> tile-major planes -> greedy, two chunks
    with the measured-order second pass: the same checksum and per-chunk
    maxima as asm_tpu's XLA greedy on the same corpus in the same order."""
    n, chunk = 8192, 4096
    res = headline.run(n_pairs=n, chunk=chunk, tile=2048, device="cpu",
                       impl="cuda", reps=1)
    assert res["first"]["checksum"] == res["checksum"]
    rc, rl, fc, fl = generate_dataset_native(n, 100, 0.05, mismatch_rate=0.96,
                                             seed=42, max_len=128)
    cfg = JaxConfig(x=1, o=1, e=1, k=3, max_len=128, max_steps=32)
    maxima, cost = [], []
    for i in range(n // chunk):
        p = res["perm"][i * chunk:(i + 1) * chunk]
        g = jax_greedy(*map(jnp.asarray, (rc[p], rl[p], fc[p], fl[p])), cfg)
        cost.append(np.asarray(g["cost"]))
        maxima.append(int(np.asarray(g["steps"]).max()))
    assert res["checksum"] == int(np.concatenate(cost).sum())
    assert res["chunk_max"] == maxima
    np.testing.assert_array_equal(res["cost"], np.concatenate(cost))
    assert all(m < b for m, b in zip(maxima, res["bounds"]))
    assert sorted(res["perm"].tolist()) == list(range(n))


def test_wrapper_refuses_what_the_kernel_lacks():
    rc, rl, fc, fl = map(torch.from_numpy,
                         generate_dataset_arrays(8, 50, 0.1, seed=1))
    for cfg in (AlignConfig(flip_threshold=2, max_steps=8),
                AlignConfig(exact_floats=True, max_steps=8)):
        with pytest.raises(NotImplementedError):
            greedy_align_cuda(rc, rl, fc, fl, cfg)
    with pytest.raises(NotImplementedError):
        greedy_align_cuda(rc, rl, fc, fl, AlignConfig(), pre_staged="swar")


def test_wrapper_checks_arguments():
    rc, rl, fc, fl = map(torch.from_numpy,
                         generate_dataset_arrays(8, 50, 0.1, seed=1))
    cfg = AlignConfig(max_steps=8)
    with pytest.raises(TypeError):
        greedy_align_cuda(rc.to(torch.int32), rl, fc, fl, cfg)
    with pytest.raises(TypeError):
        greedy_align_cuda(rc, rl.to(torch.int64), fc, fl, cfg)
    with pytest.raises(ValueError):
        greedy_align_cuda(rc[:, :64], rl, fc[:, :64], fl, cfg)
    with pytest.raises(ValueError):
        greedy_align_cuda(rc, rl[:4], fc, fl, cfg)
    with pytest.raises(ValueError):  # staged at another tile
        planes = torch.from_numpy(stage_planes_tiled_t(rc.numpy(), tile=256))
        greedy_align_cuda(planes, rl, planes, fl, cfg,
                          pre_staged="planes_tiled", tile=128)
    with pytest.raises(ValueError):
        greedy_align_cuda(rc.t().contiguous().t(), rl, fc, fl, cfg)


def test_cpu_route_counts_no_launch():
    before = greedy_cuda.LAUNCHES
    rc, rl, fc, fl = map(torch.from_numpy,
                         generate_dataset_arrays(16, 100, 0.1, seed=2))
    greedy_align_cuda(rc, rl, fc, fl, AlignConfig(max_steps=8))
    assert greedy_cuda.LAUNCHES == before
