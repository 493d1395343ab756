"""Profiling and performance counters (port of `asm_tpu.utils.profiling`).

  * force_completion — a barrier that waits for the device's work: a
    synchronise on the tensors' CUDA device, then a reduced scalar pulled
    to the host;
  * Timer — wall-clock spans that stop behind that barrier;
  * KernelStats — derived counters: alignments/s and DP cells/s;
  * trace_to — a `torch.profiler` span over the CPU and, where there is
    one, the CUDA device, exported as a Chrome trace into a directory;
    `device_activity` reads the device's busy time from it;
  * span — a named range inside the program, recorded only while a
    profiler runs.

`utils/timing.py` keeps the CUDA-event timers the headlines use.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time

import torch


def _leaves(tree) -> list[torch.Tensor]:
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _leaves(x)]
    return []


def force_completion(tree) -> int:
    """Wait for the device work behind every tensor of `tree` (a tensor,
    or dicts / lists / tuples of them): synchronise each CUDA device they
    lie on, then pull the sum of the first one to the host. Returns that
    sum, int-cast (0 for a tree without tensors)."""
    leaves = _leaves(tree)
    if not leaves:
        return 0
    for dev in {t.device for t in leaves if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)
    return int(leaves[0].sum().to(torch.float32).item())


class Timer:
    """Accumulating wall-clock timer with device-barrier stops."""

    def __init__(self):
        self.total = 0.0
        self.count = 0
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()
        return self

    def stop(self, result_tree=None):
        if result_tree is not None:
            force_completion(result_tree)
        self.total += time.perf_counter() - self._t0
        self.count += 1
        return self.total

    @contextlib.contextmanager
    def span(self):
        """with t.span() as out: ...; out["result"] = tree  (barrier on exit)."""
        self.start()
        out = {}
        yield out
        self.stop(out.get("result"))


@dataclasses.dataclass
class KernelStats:
    """Throughput counters for one kernel pass."""

    pairs: int
    seconds: float
    cells_per_pair: int = 0  # DP cells (or lane positions) per pair

    @property
    def aligns_per_sec(self) -> float:
        return self.pairs / self.seconds if self.seconds else 0.0

    @property
    def cells_per_sec(self) -> float:
        return self.pairs * self.cells_per_pair / self.seconds \
            if self.seconds else 0.0

    def line(self, name: str) -> str:
        s = f"{name:>18} | {self.seconds:8.3f} s | " \
            f"{self.aligns_per_sec / 1e6:8.3f}M aligns/s"
        if self.cells_per_pair:
            s += f" | {self.cells_per_sec / 1e9:8.2f}G cells/s"
        return s


@contextlib.contextmanager
def trace_to(logdir: str):
    """Trace the span with `torch.profiler` (CPU activity, and CUDA
    activity where a card is present) and write it as a Chrome trace,
    `logdir/trace.json`. Yields the profiler, whose `key_averages()` sums
    the span by op and kernel. A profiler that cannot start or export
    raises: a run asked to trace never goes on untraced."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    # a second profiler on the thread would start silently and trace nothing
    if torch.autograd._profiler_enabled():
        raise RuntimeError("trace_to: a profiler is already running")
    with profile(activities=activities) as prof:
        if not torch.autograd._profiler_enabled():
            raise RuntimeError("trace_to: the profiler did not start")
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


_UNTRACED = contextlib.nullcontext()


def span(name: str):
    """A context manager that records `name` as a range of the trace
    (`torch.profiler.record_function`) while a profiler is running, and
    otherwise the one shared null context: with no profiler nothing is
    built and the dispatcher is not called (on a CPU build of torch 2.13
    a bare `record_function` cost 11-13 us a range with no profiler
    running, this check under 1 us).
    A range whose name ends in ".wait" is time the host spends blocked
    on the device; no other range is named so."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _UNTRACED


def union_us(intervals) -> float:
    """Length of the union of (start, end) intervals (overlaps once)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def device_activity(prof) -> dict:
    """The CUDA device's activity in a `trace_to` span, in microseconds:
    kernels (`kernel_us`, their union), copies and sets (`copy_us`), and
    the union of both (`busy_us`: time the device was doing anything),
    the number of kernel and copy records, and the five kernel names of
    most summed time (`top_kernels_us`)."""
    from torch.autograd import DeviceType

    kernels, copies, by_name = [], [], {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        span = (ev.time_range.start, ev.time_range.end)
        if ev.name.startswith(("Memcpy", "Memset")):
            copies.append(span)
        else:
            kernels.append(span)
            by_name[ev.name] = by_name.get(ev.name, 0.0) + span[1] - span[0]
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return dict(kernel_us=union_us(kernels), copy_us=union_us(copies),
                busy_us=union_us(kernels + copies), kernels=len(kernels),
                copies=len(copies), top_kernels_us=dict(ranked))
