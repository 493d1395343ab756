"""The PyTorch port stands alone: importing it pulls in neither jax nor
the JAX package, and its config carries every field of asm_tpu's."""

import dataclasses
import os
import subprocess
import sys

import pytest
import torch

from asm_tpu.config import AlignConfig as JaxConfig
from asm_tpu.config import AlignmentType as JaxAlignmentType
from asm_tpu.config import LeapMode as JaxLeapMode
from asm_tpu_torch.config import AlignConfig, AlignmentType, config_from_jax

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PORT_MODULES = [
    "asm_tpu_torch",
    "asm_tpu_torch.config",
    "asm_tpu_torch.encoding",
    "asm_tpu_torch.native",
    "asm_tpu_torch.utils.hostmem",
    "asm_tpu_torch.utils.corpus_cache",
    "asm_tpu_torch.data.generator",
    "asm_tpu_torch.parallel.schedule",
    "asm_tpu_torch.parallel.runner",
    "asm_tpu_torch.ops.bitops",
    "asm_tpu_torch.ops.packed",
    "asm_tpu_torch.ops.hurdles",
    "asm_tpu_torch.kernels.greedy",
    "asm_tpu_torch.kernels.greedy_cuda",
    "asm_tpu_torch.headline",
    "asm_tpu_torch.kernels.nw",
    "asm_tpu_torch.kernels.nw_cuda",
    "asm_tpu_torch.kernels.nw_band",
    "asm_tpu_torch.kernels.nw_dispatch",
    "asm_tpu_torch.ops.cigar",
    "asm_tpu_torch.metrics.coverage",
    "asm_tpu_torch.metrics.coverage_device",
    "asm_tpu_torch.nw_headline",
    "asm_tpu_torch.utils.bounds",
    "asm_tpu_torch.utils.timing",
    "asm_tpu_torch.kernels.shd",
    "asm_tpu_torch.kernels.leap",
    "asm_tpu_torch.kernels.leap_backtrack",
    "asm_tpu_torch.kernels.leap_cuda",
    "asm_tpu_torch.leap_headline",
    "asm_tpu_torch.apps",
    "asm_tpu_torch.apps.leap_filter",
    "asm_tpu_torch.data.io",
    "asm_tpu_torch.metrics.numleaps",
    "asm_tpu_torch.bench",
    "asm_tpu_torch.bench.harness",
    "asm_tpu_torch.bench.__main__",
    "asm_tpu_torch.kernels.roofline_cuda",
    "asm_tpu_torch.tools",
    "asm_tpu_torch.tools.roofline",
    "asm_tpu_torch.mapper",
    "asm_tpu_torch.mapper.core",
    "asm_tpu_torch.mapper.simulate",
    "asm_tpu_torch.mapper.indexer",
    "asm_tpu_torch.mapper.__main__",
    "asm_tpu_torch.tools.mapper_eval",
]
# the LEAP slice's entry points
_LEAP_MODULES = ["asm_tpu_torch.kernels.leap_cuda",
                 "asm_tpu_torch.leap_headline",
                 "asm_tpu_torch.apps.leap_filter"]
# the mapper's entry points
_MAPPER_MODULES = ["asm_tpu_torch.mapper", "asm_tpu_torch.mapper.indexer",
                   "asm_tpu_torch.mapper.__main__",
                   "asm_tpu_torch.tools.mapper_eval"]


@pytest.mark.parametrize("module", ["asm_tpu_torch", "leap", "mapper", "all"])
def test_port_imports_no_jax(module):
    mods = {"all": _PORT_MODULES, "leap": _LEAP_MODULES,
            "mapper": _MAPPER_MODULES}.get(module, [module])
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in ('jax', 'asm_tpu', 'triton') if m in sys.modules]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-I", "-c", code],
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


@pytest.mark.parametrize("jcfg", [
    JaxConfig(),
    JaxConfig(x=2, o=3, e=1, k=2, max_len=256, max_steps=24),
    JaxConfig(alignment_type=JaxAlignmentType.SEMI_GLOBAL, flip_threshold=2,
              exact_floats=True, match_prob=0.9, mismatch_prob=0.05,
              indel_prob=0.05, max_cigar_ops=9),
    JaxConfig(leap_mode=JaxLeapMode.SEMI_FREE_END, leap_af_threshold=40,
              leap_max_energy=12),
])
def test_config_from_jax_field_by_field(jcfg):
    cfg = config_from_jax(jcfg)
    assert isinstance(cfg, AlignConfig)
    for f in dataclasses.fields(JaxConfig):
        a, b = getattr(cfg, f.name), getattr(jcfg, f.name)
        assert a == b, f.name
        assert type(a).__name__ == type(b).__name__, f.name
    for prop in ("num_lanes", "leap_total_lanes", "steps_bound",
                 "leap_energy_bound", "cigar_ops_bound", "significance"):
        assert getattr(cfg, prop) == getattr(jcfg, prop), prop
    assert cfg.alignment_type is AlignmentType(int(jcfg.alignment_type))


def test_config_fields_match():
    assert ([f.name for f in dataclasses.fields(AlignConfig)]
            == [f.name for f in dataclasses.fields(JaxConfig)])
    assert ([(f.name, f.default) for f in dataclasses.fields(AlignConfig)]
            == [(f.name, f.default) for f in dataclasses.fields(JaxConfig)])


def test_config_validation():
    with pytest.raises(ValueError):
        AlignConfig(k=-1)
    with pytest.raises(ValueError):
        AlignConfig(max_len=0)
    with pytest.raises(ValueError):
        AlignConfig(x=-1)
