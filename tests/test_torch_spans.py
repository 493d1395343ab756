"""The port's spans and counters inside the three entries the benchmark
calls (`greedy_cuda.greedy_align_cuda`, `leap_cuda.leap_align_cuda`,
`nw_band.nw_penalty_partitioned`).

On the CPU: under `trace_to` each entry records its span `asm.<kind>`,
with its stage spans nested inside; with no profiler running `span`
builds nothing; `nw_band.PAIRS` counts what `required_band` over the
exact penalties predicts. On a card (marked `cuda`, skipped elsewhere;
no jax, so run as `python -m pytest --noconftest -m cuda
tests/test_torch_spans.py`): each kernel starts after the start of the
`.launch` span that issued it and each `.wait` span ends after the
kernels it waited for, on the trace's one clock, within CLOCK_TOL_US.

Tolerance: exact (names, nesting, counts); CLOCK_TOL_US on the card."""

import collections
import json
import os

import numpy as np
import pytest
import torch

from asm_tpu_torch.config import AlignConfig
from asm_tpu_torch.data.generator import generate_dataset_arrays
from asm_tpu_torch.kernels import greedy_cuda, leap_cuda, nw, nw_band
from asm_tpu_torch.utils import profiling
from asm_tpu_torch.utils.profiling import span, trace_to

# the allowed offset of the trace's device records against its host
# records (microseconds): the profiler's clock conversion was seen to
# place kernels 0 to ~60 us early against their launch calls, drifting
# over minutes of one process on an H100, so a kernel may appear to
# start before its `.launch` span by up to that much
CLOCK_TOL_US = 100.0

# the CPU route's stage spans inside each entry
CPU_STAGES = {
    "greedy": {"asm.greedy.prep"},
    "leap": {"asm.leap.prep"},
    "nw": {"asm.nw.take", "asm.nw.band", "asm.nw.band.wait",
           "asm.nw.certificate", "asm.nw.full", "asm.nw.full.wait"},
}


def _corpus(rates=(0.02, 0.1, 0.45), n=16, seed=5):
    """n 100-base pairs at each error rate, max_len 128: the high rate
    leaves pairs no band certifies."""
    parts = [generate_dataset_arrays(n, 100, r, seed=seed + i)
             for i, r in enumerate(rates)]
    return [torch.from_numpy(np.concatenate(a)) for a in zip(*parts)]


def _run(kind, t):
    if kind == "greedy":
        return greedy_cuda.greedy_align_cuda(*t, AlignConfig(),
                                             want_cigar=False)
    if kind == "leap":
        return leap_cuda.leap_align_cuda(*t, AlignConfig())
    return nw_band.nw_penalty_partitioned(*t, bws=nw_band.BWS)


def _spans(path):
    """(start, end, name) of every `asm.*` range of a Chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
            if e.get("cat") == "user_annotation"
            and e.get("name", "").startswith("asm.")]


@pytest.mark.parametrize("kind", ["greedy", "leap", "nw"])
def test_entry_span_holds_its_stages(tmp_path, kind):
    t = _corpus()
    with trace_to(str(tmp_path)):
        _run(kind, t)
    spans = _spans(os.path.join(tmp_path, "trace.json"))
    entry = [s for s in spans if s[2] == f"asm.{kind}"]
    assert len(entry) == 1
    lo, hi, _ = entry[0]
    inner = [s for s in spans if s[2] != f"asm.{kind}"]
    assert {name for _, _, name in inner} == CPU_STAGES[kind]
    assert all(lo <= s and e <= hi for s, e, _ in inner)


def test_untraced_span_builds_nothing(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) built untraced")

    assert not torch.autograd._profiler_enabled()
    assert span("asm.a") is span("asm.b")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    t = _corpus(n=4)
    for kind in ("greedy", "leap", "nw"):
        _run(kind, t)
    with pytest.raises(AssertionError, match="built untraced"):
        with torch.profiler.profile():
            profiling.span("asm.c")


@pytest.mark.parametrize("x,o,e", [(1, 1, 1), (4, 8, 2)])
def test_pairs_counter_follows_required_band(monkeypatch, x, o, e):
    monkeypatch.setattr(nw_band, "PAIRS", collections.Counter())
    t = _corpus()
    got = nw_band.nw_penalty_partitioned(*t, x=x, o=o, e=e, bws=nw_band.BWS)
    exact = nw.nw_penalty(*t, x, o, e).numpy()
    np.testing.assert_array_equal(got, exact)
    need = nw_band.required_band(exact, o, e, nw_band.BWS)
    want = {"in": len(need)}
    left = len(need)
    for bw in nw_band.BWS:
        if left:
            want["band", bw] = left
            want["certified", bw] = int((need == bw).sum())
            left -= want["certified", bw]
    if left:
        want["full"] = left
    assert left == int((need == 0).sum()) > 0
    assert sum(want["certified", bw] > 0 for bw in nw_band.BWS) >= 2
    assert {k: v for k, v in nw_band.PAIRS.items() if v} == \
        {k: v for k, v in want.items() if v}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_launch_and_wait_spans_share_the_kernels_clock(tmp_path, dev):
    """One greedy job and one NW job traced with CUDA activity: every
    kernel issued inside a `.launch` span (matched through the launch
    call's correlation id) starts after that span's start, and every
    `.wait` span ends after the last kernel issued before it ends."""
    from torch.profiler import ProfilerActivity, profile

    t = [a.to(dev) for a in _corpus(n=1024)]

    def jobs():
        _run("greedy", t)
        torch.cuda.synchronize()
        _run("nw", t)

    jobs()  # builds the libraries, warms up
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        jobs()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [ev for ev in json.load(f)["traceEvents"]
                  if ev.get("ph") == "X"]
    spans = _spans(path)
    calls = {ev["args"]["correlation"]: ev["ts"] for ev in events
             if ev.get("cat") in ("cuda_runtime", "cuda_driver")
             and "correlation" in ev.get("args", {})}
    kernels = [(ev["ts"], ev["ts"] + ev["dur"], calls.get(
        ev.get("args", {}).get("correlation"))) for ev in events
        if ev.get("cat") == "kernel"]
    assert kernels and all(c is not None for _, _, c in kernels), \
        "a kernel without its launch call in the trace"

    issuers, margins = set(), []
    for start, _, call in kernels:
        open_ = [s for s in spans if s[0] <= call <= s[1]]
        if not open_:
            continue
        inner = min(open_, key=lambda s: s[1] - s[0])
        if inner[2].endswith(".launch"):
            issuers.add(inner[2])
            margins.append(start - inner[0])
            assert start >= inner[0] - CLOCK_TOL_US, inner
    assert issuers == {"asm.greedy.launch", "asm.nw.stage.launch",
                       "asm.nw.band.launch", "asm.nw.full.launch"}
    waits = [s for s in spans if s[2].endswith(".wait")]
    assert {name for _, _, name in waits} == {"asm.nw.band.wait",
                                               "asm.nw.full.wait"}
    for lo, hi, name in waits:
        ends = [end for _, end, call in kernels if call < lo]
        assert ends and hi >= max(ends) - CLOCK_TOL_US, name
        margins.append(hi - max(ends))
    print(f"clock margins (us): least {min(margins):.3f}, "
          f"{len(margins)} checked")
