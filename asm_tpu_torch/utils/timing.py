"""Timing shared by the headlines: one timed region of dispatches (CUDA
events on a card, the host clock elsewhere), the warm-up plus best-of-reps
loop around it, the stderr log and the reference's baseline rate."""

from __future__ import annotations

import sys
import time

import torch


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def nearest_rate(ref_seconds: dict, err: float) -> float:
    """Aligns/s of the reference's single-core seconds per 1M pairs
    (`ref_seconds`, keyed by error rate) at the rate nearest `err`."""
    key = min(ref_seconds, key=lambda r: abs(r - err))
    return 1e6 / ref_seconds[key]


def time_dispatches(fns, device, after=None) -> tuple[list, dict]:
    """Call each of `fns` in order, then `after(outputs)` if given, as one
    timed region, and wait for its end. Returns (the calls' outputs,
    timing): seconds (the region), dispatch_ms (each call to its end) and
    enqueue_ms (the host's time to issue the region, which bounds the
    device's idle time in it)."""
    on_card = torch.device(device).type == "cuda"

    def mark():  # a timestamp in the region's clock
        if not on_card:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def span(a, b):  # seconds between two marks
        return a.elapsed_time(b) / 1e3 if on_card else b - a

    t0 = time.perf_counter()
    marks = [mark()]
    outs = []
    for f in fns:
        outs.append(f())
        marks.append(mark())
    end = marks[-1]
    if after is not None:
        after(outs)
        end = mark()
    enqueue = time.perf_counter() - t0
    if on_card:
        end.synchronize()
    return outs, dict(
        seconds=span(marks[0], end),
        dispatch_ms=[span(a, b) * 1e3 for a, b in zip(marks, marks[1:])],
        enqueue_ms=enqueue * 1e3)


def best_of_reps(rep, reps: int, device) -> tuple[list, dict, object]:
    """A warm-up call of `rep`, then `reps` timed calls on a card (none
    elsewhere). rep() returns (outputs, timing) with timing["seconds"],
    as `time_dispatches` does. Returns (each rep's seconds, the fastest
    rep's timing less its seconds, the last call's outputs)."""
    outs, _ = rep()  # warm-up (the first launch loads the kernel)
    rep_s, best = [], {}
    if torch.device(device).type != "cuda":
        return rep_s, best, outs
    torch.cuda.synchronize(device)
    for r in range(reps):
        outs = None  # release the last rep's outputs before the next
        outs, timing = rep()
        rep_s.append(timing["seconds"])
        log(f"rep {r}: {rep_s[-1]:.6f}s")
        if rep_s[-1] == min(rep_s):
            best = {k: v for k, v in timing.items() if k != "seconds"}
    return rep_s, best, outs


def time_reps(fns, reps: int, device) -> tuple[list, dict, list]:
    """`best_of_reps` of one rep that calls every fn in order."""
    return best_of_reps(lambda: time_dispatches(fns, device), reps, device)
