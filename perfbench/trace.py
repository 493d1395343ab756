"""Reading a traced stretch of the window: a `torch.profiler` Chrome trace
turned into device intervals, job spans and host events, and what the
harness itself reports from them (busy and window seconds, the
breakdown). Times are microseconds on the trace's one clock.
"""

from __future__ import annotations

import dataclasses
import json

JOB_SPAN = "perfbench.job"
DEVICE_KERNEL = "kernel"
DEVICE_OTHER = ("gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


@dataclasses.dataclass
class Trace:
    """The profiler runs only across whole jobs (started and stopped
    between them, with no device work of the harness's own in between),
    so every device record in it belongs to a traced job; device and host
    timestamps may be skewed against each other by the clock conversion,
    so a record is never matched to a job span by its time."""
    kernels: list      # (start, end, name) of every kernel
    copies: list       # (start, end, name) of every copy and set
    jobs: list         # (start, end) of every job span, in order
    host: list         # (start, end, name) of host events

    @property
    def window(self) -> tuple[float, float]:
        """The traced stretch: from the first job span or device record
        to the last."""
        ivs = self.jobs + [iv[:2] for iv in self.kernels + self.copies]
        return min(s for s, _ in ivs), max(e for _, e in ivs)


def load(path: str) -> Trace:
    """The Trace of a Chrome trace file written by `torch.profiler`."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels, copies, jobs, host = [], [], [], []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        iv = (float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]),
              ev.get("name", ""))
        cat = ev.get("cat", "")
        if cat == DEVICE_KERNEL:
            kernels.append(iv)
        elif cat in DEVICE_OTHER:
            copies.append(iv)
        elif cat in HOST_CATS:
            if cat == "user_annotation" and iv[2] == JOB_SPAN:
                jobs.append(iv[:2])
            host.append(iv)
    return Trace(sorted(kernels), sorted(copies), sorted(jobs), host)


def union(intervals) -> list:
    """The union of (start, end, ...) intervals as sorted disjoint
    (start, end) pairs."""
    out = []
    for s, e, *_ in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip(pairs, lo: float, hi: float) -> list:
    return [(max(s, lo), min(e, hi)) for s, e in pairs if e > lo and s < hi]


def busy_us(tr: Trace) -> float:
    """Time within the window in which a kernel, copy or set ran."""
    lo, hi = tr.window
    return sum(e - s for s, e in clip(union(tr.kernels + tr.copies), lo, hi))


def gaps(tr: Trace) -> list:
    """The idle stretches of the window: (start, end) pairs."""
    lo, hi = tr.window
    out, t = [], lo
    for s, e in clip(union(tr.kernels + tr.copies), lo, hi):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def host_names(tr: Trace, times) -> list:
    """Name of the innermost host event open at each of `times` (sorted),
    found in one sweep over the events by start."""
    events = sorted(tr.host)
    names, active, i = [], [], 0
    for t in times:
        while i < len(events) and events[i][0] <= t:
            active.append(events[i])
            i += 1
        active = [ev for ev in active if ev[1] >= t]
        inner = min(active, key=lambda ev: ev[1] - ev[0], default=None)
        names.append(inner[2] if inner else "(between host events)")
    return names


def breakdown(tr: Trace, top: int = 10) -> dict:
    """device_ops: the device operations of most summed time; idle_gaps:
    the window's idle time summed by the host event open at each gap's
    middle. Seconds, at most `top` entries each."""
    lo, hi = tr.window
    ops = {}
    for s, e, name in tr.kernels + tr.copies:
        if lo <= s <= hi:
            ops[name] = ops.get(name, 0.0) + (e - s) / 1e6
    idle = {}
    stretches = gaps(tr)
    mids = [(s + e) / 2 for s, e in stretches]
    for (s, e), name in zip(stretches, host_names(tr, mids)):
        idle[name] = idle.get(name, 0.0) + (e - s) / 1e6

    def ranked(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])][
            :top]

    return dict(device_ops=ranked(ops), idle_gaps=ranked(idle))
