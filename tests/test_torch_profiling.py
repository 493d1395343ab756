"""The port's profiling module (`asm_tpu_torch.utils.profiling`) on the
CPU: KernelStats' fields, properties and text equal asm_tpu's; Timer and
force_completion; `trace_to` writes a Chrome trace of the span and raises
when its profiler cannot start (asm_tpu's falls back to a no-op).

Tolerance: exact (text and counts)."""

import json

import pytest
import torch

from asm_tpu.utils.profiling import KernelStats as JaxKernelStats
from asm_tpu_torch.utils.profiling import (
    KernelStats,
    Timer,
    force_completion,
    trace_to,
)

torch.set_num_threads(1)


@pytest.mark.parametrize("pairs,seconds,cells", [
    (1_000_000, 0.25, 0), (65_536, 1.5, 128 * 128), (3, 0.0, 10),
    (67_108_864, 14.848, 100 * 100),
])
def test_kernel_stats_equal_asm_tpu(pairs, seconds, cells):
    got, want = KernelStats(pairs, seconds, cells), \
        JaxKernelStats(pairs, seconds, cells)
    for name in ("greedy", "NW (band 16)", "x" * 30):
        assert got.line(name) == want.line(name)
    assert got.aligns_per_sec == want.aligns_per_sec
    assert got.cells_per_sec == want.cells_per_sec


def test_timer_and_force_completion():
    t = Timer()
    for _ in range(3):
        with t.span() as out:
            out["result"] = {"a": torch.arange(10), "b": [torch.ones(2)]}
    assert t.count == 3 and t.total > 0
    assert force_completion({"x": torch.arange(5)}) == 10
    assert force_completion([]) == 0


def test_trace_to_writes_chrome_trace(tmp_path):
    with trace_to(str(tmp_path / "trace")) as prof:
        x = torch.arange(4096, dtype=torch.float32)
        float((x * 2).cumsum(0)[-1])
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert any("cumsum" in str(n) for n in names)
    assert any("cumsum" in e.key for e in prof.key_averages())


def test_trace_to_raises_when_profiler_cannot_start(tmp_path):
    with torch.profiler.profile():
        with pytest.raises(RuntimeError, match="already running"):
            with trace_to(str(tmp_path / "t")):
                pass
    assert not (tmp_path / "t" / "trace.json").exists()
    assert not torch.autograd._profiler_enabled()


@pytest.mark.parametrize("intervals,want", [
    ([], 0.0),
    ([(0, 10)], 10.0),
    ([(0, 10), (5, 12), (20, 25)], 17.0),
    ([(20, 25), (0, 10), (10, 11), (1, 2)], 16.0),
])
def test_union_us(intervals, want):
    from asm_tpu_torch.utils.profiling import union_us

    assert union_us(intervals) == want


def test_device_activity_of_a_cpu_span(tmp_path):
    """A span with no card records no device activity."""
    from asm_tpu_torch.utils.profiling import device_activity

    with trace_to(str(tmp_path)) as prof:
        torch.arange(100).sum()
    assert device_activity(prof) == dict(kernel_us=0.0, copy_us=0.0,
                                         busy_us=0.0, kernels=0, copies=0,
                                         top_kernels_us={})
