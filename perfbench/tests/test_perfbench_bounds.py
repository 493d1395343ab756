"""The frozen yardstick: roofline counts against brute-force counts on
tiny inputs, and the trace arithmetic on a synthetic Chrome trace."""

from __future__ import annotations

import json

import numpy as np
import pytest

from perfbench import bounds, trace


@pytest.mark.parametrize("bw", [4, 8, 16, 64])
def test_band_cells_brute_force(bw):
    for m in range(0, 12):
        for n in range(0, 12):
            want = sum(1 for i in range(1, m + 1) for j in range(1, n + 1)
                       if 1 - bw // 2 <= i - j <= bw // 2)
            assert bounds.band_cells(m, n, bw) == want


def brute_gap_floor(k, d, o, e):
    """The least gap cost of walking the offset from 0 through k to d by
    single steps (Dijkstra over offset, direction of the run in progress,
    and whether k was reached): a step opens a run (o) unless it goes on
    in the run's direction (min(o, e), as the recurrences charge it)."""
    import heapq

    ext = min(o, e)
    start = (0, 0, k == 0)
    best = {start: 0}
    heap = [(0, start)]
    while heap:
        c, (at, run, seen) = heapq.heappop(heap)
        if c > best[(at, run, seen)]:
            continue
        if seen and at == d:
            return c
        for step in (1, -1):
            nxt = (at + step, step, seen or at + step == k)
            if abs(nxt[0]) > 30:
                continue
            nc = c + (ext if run == step else o)
            if nc < best.get(nxt, 1 << 30):
                best[nxt] = nc
                heapq.heappush(heap, (nc, nxt))
    raise AssertionError("unreachable")


@pytest.mark.parametrize("o,e", [(1, 1), (8, 2), (3, 1), (1, 4)])
def test_gap_floor_brute_force(o, e):
    for d in range(-6, 7):
        for k in range(-9, 10):
            assert bounds.gap_floor(k, d, o, e) == brute_gap_floor(k, d, o, e)


@pytest.mark.parametrize("xoe", [(1, 1, 1), (4, 8, 2), (2, 3, 1)])
def test_nw_cells_are_the_least_band_that_holds_the_penalty(xoe):
    """On tiny pairs: the counted cells are those of the offsets whose gap
    floor is within the exact penalty; a DP over that band alone gets the
    exact penalty; the count never exceeds m x n or the band of a width
    whose certificate holds."""
    from perfbench.generator import make_pool
    from perfbench.reference import nw

    x, o, e = xoe
    p = make_pool(64, 24, [0.20], [1.0], 0.3, 32, "blocks", 5, "cpu")
    ins = [p[k] for k in ("read", "read_len", "ref", "ref_len")]
    pen = nw.penalty(*ins, x, o, e).numpy()
    m, n = ins[1].numpy(), ins[3].numpy()
    got = bounds.nw_cells(m, n, pen, o, e)
    for b in range(64):
        d = int(m[b] - n[b])
        ks = [k for k in range(-40, 41)
              if bounds.gap_floor(k, d, o, e) <= pen[b]]
        lo, hi = min(ks), max(ks)
        assert ks == list(range(lo, hi + 1))
        want = sum(1 for i in range(1, m[b] + 1)
                   for j in range(1, n[b] + 1) if lo <= i - j <= hi)
        assert got[b] == want <= m[b] * n[b]
        one = [t[b:b + 1] for t in ins]
        assert nw.penalty(*one, x, o, e, band=(lo, hi)).item() == pen[b]
        for bw in (8, 16, 32, 64, 128):
            if e <= o and pen[b] < o + (bw // 2 - 1) * e:
                assert got[b] <= bounds.band_cells(m[b], n[b], bw)
                break
    ops, nbytes = bounds.nw_work(m, n, pen, o, e, 32)
    assert ops == 7 * got.sum() and nbytes == 64 * (2 * 32 + 12)


@pytest.mark.parametrize("L", [128, 1024])
def test_greedy_work_brute_force(L):
    steps = np.array([0, 1, 7, 30, 265])
    k = 3
    ops = nbytes = 0
    for s in steps:
        for lane in range(2 * k + 1):
            for w in range(L // 32):
                ops += 8  # hurdle row and denoise, a word
            for step in range(s):
                words = L // 32 if L // 32 <= 16 else 1
                ops += 10 * words + 12
        nbytes += 2 * L + 8 + 8
    assert bounds.greedy_work(steps, k, L) == (ops, nbytes)


def test_leap_work_brute_force():
    passed = np.array([True, True, False, True])
    penalty = np.array([0, 12, 201, 3])
    k, L, af = 3, 128, 200
    rows = sum(1 + (p if ok else af) for ok, p in zip(passed, penalty))
    ops = 4 * (2 * k + 1) * (L // 32) * 4 + rows * (2 * k + 1) * 16
    assert bounds.leap_work(passed, penalty, k, L, af) == (
        ops, 4 * (2 * L + 17))


def test_bound_seconds_takes_the_larger():
    t, by = bounds.bound_seconds(bounds.INT32_OPS_PER_S, 0.0)
    assert t == pytest.approx(1.0) and by == "operations"
    t, by = bounds.bound_seconds(0.0, 2 * bounds.HBM_BYTES_PER_S)
    assert t == pytest.approx(2.0) and by == "bytes"


def synthetic_trace(path):
    ev = [
        dict(ph="X", cat="user_annotation", name=trace.JOB_SPAN, ts=0, dur=100),
        dict(ph="X", cat="cpu_op", name="aten::empty", ts=1, dur=4),
        dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel", ts=5,
             dur=3),
        dict(ph="X", cat="kernel", name="k_a", ts=10, dur=40),
        dict(ph="X", cat="kernel", name="k_b", ts=30, dur=30),
        dict(ph="X", cat="cuda_runtime", name="cudaDeviceSynchronize",
             ts=60, dur=45),
        dict(ph="X", cat="gpu_memcpy", name="Memcpy DtoH", ts=70, dur=10),
        dict(ph="X", cat="user_annotation", name=trace.JOB_SPAN, ts=150,
             dur=50),
        dict(ph="X", cat="kernel", name="k_a", ts=160, dur=20),
        dict(ph="X", cat="kernel", name="outside", ts=120, dur=5),
        dict(ph="X", cat="gpu_user_annotation", name=trace.JOB_SPAN, ts=0,
             dur=200),
        dict(ph="i", cat="kernel", name="instant", ts=3),
    ]
    with open(path, "w") as f:
        json.dump({"traceEvents": ev}, f)


def test_trace_arithmetic(tmp_path):
    path = tmp_path / "t.json"
    synthetic_trace(path)
    tr = trace.load(str(path))
    assert tr.window == (0.0, 200.0)
    assert len(tr.jobs) == 2
    assert [k[2] for k in tr.kernels] == ["k_a", "k_b", "outside", "k_a"]
    # busy: [10, 60] + [70, 80] + [120, 125] + [160, 180]
    assert trace.busy_us(tr) == 50 + 10 + 5 + 20
    assert trace.gaps(tr) == [(0, 10), (60, 70), (80, 120), (125, 160),
                              (180, 200)]
    bd = trace.breakdown(tr)
    assert bd["device_ops"][0] == ["k_a", pytest.approx(60e-6)]
    idle = dict(bd["idle_gaps"])
    # each gap goes to the innermost host event open at its middle
    assert idle == {"cudaDeviceSynchronize": pytest.approx(50e-6),
                    "(between host events)": pytest.approx(35e-6),
                    trace.JOB_SPAN: pytest.approx(20e-6),
                    "cudaLaunchKernel": pytest.approx(10e-6)}


def test_skewed_device_records_still_count(tmp_path):
    """A kernel whose converted timestamp falls outside every job span, or
    past the last one, still belongs to the traced jobs."""
    ev = [dict(ph="X", cat="user_annotation", name=trace.JOB_SPAN, ts=0,
               dur=100),
          dict(ph="X", cat="kernel", name="k", ts=-5, dur=50),
          dict(ph="X", cat="user_annotation", name=trace.JOB_SPAN, ts=110,
               dur=100),
          dict(ph="X", cat="kernel", name="k", ts=190, dur=40)]
    path = tmp_path / "s.json"
    with open(path, "w") as f:
        json.dump({"traceEvents": ev}, f)
    tr = trace.load(str(path))
    assert tr.window == (-5.0, 230.0)
    assert trace.busy_us(tr) == 90
    from perfbench.harness import TraceContext

    ctx = TraceContext(tr, "greedy", {}, [])
    assert ctx.job_kernel_seconds() == pytest.approx(90e-6)
