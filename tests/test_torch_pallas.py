"""The kernel wrapper greedy_align_cuda on CPU tensors (its plain
version) with tile-major plane input equals asm_tpu's Pallas greedy kernel
in interpret mode with the same planes (pre_staged="planes_tiled").

Tolerance: exact equality of cost, steps and decoded CIGARs. Raw slots
differ by design: the CUDA kernel's final-leap record sits at the pair's
own trip count, the Pallas kernel's at its tile's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asm_tpu.config import AlignConfig as JaxConfig
from asm_tpu.config import AlignmentType as JaxAT
from asm_tpu.data.generator import generate_dataset_arrays
from asm_tpu.kernels.greedy_pallas import _TILE as PALLAS_TILE
from asm_tpu.kernels.greedy_pallas import greedy_align_pallas
from asm_tpu.kernels.greedy_pallas import stage_planes_tiled_t as jax_stage
from asm_tpu.ops.cigar import batch_greedy_cigars
from asm_tpu_torch.config import config_from_jax
from asm_tpu_torch.kernels.greedy_cuda import (
    greedy_align_cuda,
    stage_planes_tiled_t,
)

torch.set_num_threads(1)

# (label, config, corpus): the main path's config, the heuristic-tie-heavy
# indel corpus, and a zero step bound (final leap only)
CASES = [
    ("err0.05", JaxConfig(max_steps=32),
     dict(num_reads=300, length=100, error_rate=0.05, seed=5)),
    ("err0.4-mr0.5-semi", JaxConfig(max_steps=24,
                                    alignment_type=JaxAT.SEMI_GLOBAL),
     dict(num_reads=200, length=100, error_rate=0.4, mismatch_rate=0.5,
          seed=40)),
    ("max_steps0", JaxConfig(max_steps=0),
     dict(num_reads=40, length=100, error_rate=0.1, seed=1)),
]


def _cigars(out):
    return batch_greedy_cigars({k: np.asarray(v) for k, v in out.items()})


@pytest.mark.parametrize("label,jcfg,kw", CASES, ids=[c[0] for c in CASES])
def test_wrapper_planes_tiled_matches_pallas(label, jcfg, kw):
    rc, rl, fc, fl = generate_dataset_arrays(**kw)
    ref = greedy_align_pallas(
        jnp.asarray(jax_stage(rc, tile=PALLAS_TILE)), jnp.asarray(rl),
        jnp.asarray(jax_stage(fc, tile=PALLAS_TILE)), jnp.asarray(fl), jcfg,
        interpret=True, pre_staged="planes_tiled")
    cfg = config_from_jax(jcfg)
    for tile in (PALLAS_TILE, 128):
        got = greedy_align_cuda(
            torch.from_numpy(stage_planes_tiled_t(rc, tile=tile)),
            torch.from_numpy(rl),
            torch.from_numpy(stage_planes_tiled_t(fc, tile=tile)),
            torch.from_numpy(fl), cfg, pre_staged="planes_tiled", tile=tile)
        for key in ("cost", "steps"):
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(ref[key]), err_msg=key)
        assert _cigars(got) == _cigars(ref)
        assert got["step_rec"].shape == (cfg.steps_bound + 1, len(rl))
