"""The readers of the port's own spans and counters
(`metrics/entry_host_us_per_job.py`, `metrics/device_idle_in_entry_pct.py`,
`metrics/nw_band_uncertified_per_pair.py`) on hand-built traces and
counters, with values computed by hand; None where there is nothing to
read."""

from __future__ import annotations

import collections
import itertools
import json

import numpy as np
import pytest

from perfbench import harness, trace
from perfbench.harness import TraceContext
from perfbench.metrics import _spans


def _read(name, tr, kind="nw"):
    return harness._module("metrics", name).read(
        TraceContext(tr, kind, {}, []))


# Two jobs, (0, 100) and (120, 220); kernels (10, 30), (50, 90) and
# (130, 200), so the window is (0, 220) and the device is idle over
# (0, 10), (30, 50), (90, 130) and (200, 220): 90 us. Entry spans (2, 95)
# and (122, 210); the waits (60, 92) and (150, 215), the second reaching
# past its entry. Host work = entries less waits = (2, 60), (92, 95),
# (122, 150): 89 us, 44.5 a job. Idle inside it: (2, 10), (30, 50),
# (92, 95), (122, 130): 39 us. The gap (95, 122) lies outside every
# entry span, and (200, 210) inside one but under its wait.
EVENTS = [
    dict(cat="user_annotation", name=trace.JOB_SPAN, ts=0, dur=100),
    dict(cat="user_annotation", name=trace.JOB_SPAN, ts=120, dur=100),
    dict(cat="kernel", name="k", ts=10, dur=20),
    dict(cat="kernel", name="k", ts=50, dur=40),
    dict(cat="kernel", name="k", ts=130, dur=70),
    dict(cat="user_annotation", name="asm.nw", ts=2, dur=93),
    dict(cat="user_annotation", name="asm.nw.take", ts=3, dur=5),
    dict(cat="user_annotation", name="asm.nw.band", ts=8, dur=52),
    dict(cat="user_annotation", name="asm.nw.band.launch", ts=9, dur=2),
    dict(cat="user_annotation", name="asm.nw.band.wait", ts=60, dur=32),
    dict(cat="cpu_op", name="aten::index_select", ts=4, dur=3),
    dict(cat="cuda_runtime", name="cudaLaunchKernel", ts=9.5, dur=1),
    dict(cat="user_annotation", name="asm.nw", ts=122, dur=88),
    dict(cat="user_annotation", name="asm.nw.full", ts=125, dur=90),
    dict(cat="user_annotation", name="asm.nw.full.wait", ts=150, dur=65),
    # the device's copy of a range: not a host event
    dict(cat="gpu_user_annotation", name="asm.nw", ts=0, dur=220),
]


def _trace(tmp_path, events) -> trace.Trace:
    path = tmp_path / "t.json"
    with open(path, "w") as f:
        json.dump({"traceEvents": [dict(ph="X", **ev) for ev in events]}, f)
    return trace.load(str(path))


def test_entry_host_us_per_job(tmp_path):
    tr = _trace(tmp_path, EVENTS)
    assert tr.window == (0.0, 220.0)
    assert _read("entry_host_us_per_job", tr) == pytest.approx(44.5)


def test_device_idle_in_entry_pct(tmp_path):
    tr = _trace(tmp_path, EVENTS)
    got = _read("device_idle_in_entry_pct", tr)
    assert got == pytest.approx(100.0 * 39 / 220)
    assert got <= _read("device_idle_pct", tr) == pytest.approx(
        100.0 * 90 / 220)


@pytest.mark.parametrize("name", ["entry_host_us_per_job",
                                  "device_idle_in_entry_pct"])
def test_span_readers_without_spans_or_device(tmp_path, name):
    plain = [ev for ev in EVENTS if ev["cat"] == "gpu_user_annotation"
             or not ev["name"].startswith("asm.")]
    assert _read(name, _trace(tmp_path, plain)) is None
    # a run on the CPU: spans but no device record
    host = [ev for ev in EVENTS if ev["cat"] != "kernel"]
    assert _read(name, _trace(tmp_path, host)) is None


def test_nw_band_uncertified_per_pair(monkeypatch, tmp_path):
    from asm_tpu_torch.kernels import nw_band

    tr = _trace(tmp_path, EVENTS)
    pairs = collections.Counter({"in": 10, ("band", 8): 10,
                                 ("certified", 8): 2, ("band", 16): 8,
                                 ("certified", 16): 5, "full": 3})
    monkeypatch.setattr(nw_band, "PAIRS", pairs)
    # (10 + 8 - 2 - 5) / 10
    assert _read("nw_band_uncertified_per_pair", tr) == pytest.approx(1.1)
    assert _read("nw_band_uncertified_per_pair", tr, "greedy") is None
    assert _read("nw_band_uncertified_per_pair", tr, "leap") is None
    # the control: nothing entered the program's entry
    monkeypatch.setattr(nw_band, "PAIRS", collections.Counter())
    assert _read("nw_band_uncertified_per_pair", tr) is None
    # a program without the counter
    monkeypatch.delattr(nw_band, "PAIRS")
    assert _read("nw_band_uncertified_per_pair", tr) is None


def _cover(pairs, n):
    mask = np.zeros(n, bool)
    for s, e in pairs:
        mask[s:e] = True
    return mask


@pytest.mark.parametrize("seed", range(4))
def test_interval_algebra_against_a_mask(seed):
    rng = np.random.default_rng(seed)

    def draw():
        ends = np.sort(rng.choice(60, size=2 * int(rng.integers(0, 8)),
                                  replace=False))
        return [(int(s), int(e)) for s, e in zip(ends[::2], ends[1::2])]

    for a, b in itertools.islice(iter(lambda: (draw(), draw()), None), 50):
        ma, mb = _cover(a, 60), _cover(b, 60)
        np.testing.assert_array_equal(_cover(_spans.intersect(a, b), 60),
                                      ma & mb)
        np.testing.assert_array_equal(_cover(_spans.subtract(a, b), 60),
                                      ma & ~mb)
        assert _spans.length(_spans.intersect(a, b)) == (ma & mb).sum()
