"""NW dispatch: measured-band partition plan + execute (port of
`asm_tpu.kernels.nw_dispatch`).

`nw_partition_plan` is the untimed corpus prep: band-major order, chunks
per band uploaded to the device. `nw_partition_execute` dispatches every
chunk (band chunks to the band kernel, band-0 chunks to the full kernel),
then pulls one reduced (sum, all-certified) barrier; the time to that
barrier is the measured region. Every band chunk re-proves its
certificate in the run, so a stale or wrong `bands` array raises instead
of returning an uncertified penalty, and the result equals
`nw.nw_penalty`.

The JAX module caps the chunks of wide bands (`_BW_CAPS`) because the TPU
kernel reads precomputed mismatch planes of BW/4 bytes per diagonal per
pair; the CUDA band kernel computes mismatches from the pair's 64 B of
planes, so no band needs a cap. Chunks are not padded either: the TPU
padded them to compile one program per chunk size.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from asm_tpu_torch.kernels.nw_band import (
    band_certified,
    codes_from_planes,
    nw_penalty_banded,
)
from asm_tpu_torch.kernels.nw_cuda import nw_penalty_cuda


@dataclasses.dataclass
class NWPlan:
    chunks: list       # device-resident (read, read_len, ref, ref_len)
    widths: list       # band width per chunk, 0 = the full kernel
    order: np.ndarray  # permutation applied: sorted position -> input row
    n_pairs: int
    partitions: dict   # band width -> pair count
    x: int
    o: int
    e: int
    pre_staged: bool
    # set by nw_partition_execute: the measured region; each chunk's share
    # of it (CUDA events between dispatches); the host time until every
    # dispatch and the barrier were enqueued, which bounds the device's
    # idle time in the region; the pull of the penalties after it
    last_exec_seconds: float = 0.0
    last_dispatch_seconds: list = dataclasses.field(default_factory=list)
    last_enqueue_seconds: float = 0.0
    last_pull_seconds: float = 0.0


def band_major_order(bands) -> np.ndarray:
    """Stable band-major order of `bands` (ascending width, band 0 = the
    full kernel last; the input order is kept within a band)."""
    bands = np.asarray(bands)
    return np.argsort(np.where(bands == 0, 1 << 30, bands.astype(np.int64)),
                      kind="stable")


def nw_partition_plan(read_codes, read_len, ref_codes, ref_len, bands,
                      x=1, o=1, e=1, bws=(8, 16, 32, 64),
                      max_chunk=1 << 20, pre_staged=False,
                      already_sorted=False, device="cuda") -> NWPlan:
    """Build the dispatch plan for a host corpus with known bands.

    bands: int32[B] from `required_band` (0 = the full kernel).
    pre_staged=True: read/ref are `stage_planes_t` planes [L/16, B]
    (pairs on axis 1); else int8 codes [B, L]. already_sorted=True skips
    the band-major reorder (the caller laid the corpus out band-major)."""
    bands = np.asarray(bands)
    B = bands.shape[0]
    ax = 1 if pre_staged else 0
    rc, fc = np.asarray(read_codes), np.asarray(ref_codes)
    rl, fl = np.asarray(read_len), np.asarray(ref_len)
    if already_sorted:
        order = np.arange(B)
    else:
        order = band_major_order(bands)
        rc, fc = np.take(rc, order, axis=ax), np.take(fc, order, axis=ax)
        rl, fl, bands = rl[order], fl[order], bands[order]

    def put(a, lo, hi, axis):
        s = a[:, lo:hi] if axis == 1 else a[lo:hi]
        if s.dtype == np.uint32:
            s = s.view(np.int32)
        return torch.from_numpy(np.ascontiguousarray(s)).to(device)

    chunks, widths, parts = [], [], {}
    for bw in tuple(sorted(bws)) + (0,):
        sel = np.nonzero(bands == bw)[0]
        if sel.size == 0:
            continue
        lo, hi = int(sel[0]), int(sel[-1]) + 1
        if hi - lo != sel.size:
            raise ValueError("bands are not contiguous after the sort")
        parts[bw] = sel.size
        for base in range(lo, hi, max_chunk):
            top = min(base + max_chunk, hi)
            chunks.append((put(rc, base, top, ax), put(rl, base, top, 0),
                           put(fc, base, top, ax), put(fl, base, top, 0)))
            widths.append(bw)
    return NWPlan(chunks=chunks, widths=widths, order=order, n_pairs=B,
                  partitions=parts, x=x, o=o, e=e, pre_staged=pre_staged)


def _run_chunk(plan: NWPlan, bw: int, args):
    """One dispatch: (pen int32[b], its int64 sum, all certified) on the
    chunk's device, nothing synchronised."""
    a, b, c, d = args
    if bw == 0:
        if plan.pre_staged:
            a, c = codes_from_planes(a, b), codes_from_planes(c, d)
        p = nw_penalty_cuda(a, b, c, d, x=plan.x, o=plan.o, e=plan.e)
        ok = torch.ones((), dtype=torch.bool, device=p.device)
    else:
        p = nw_penalty_banded(a, b, c, d, bw=bw, x=plan.x, o=plan.o,
                              e=plan.e, pre_staged=plan.pre_staged)
        ok = band_certified(p, bw, plan.o, plan.e).all()
    return p, p.sum(dtype=torch.int64), ok


def nw_partition_execute(plan: NWPlan) -> np.ndarray:
    """Dispatch every chunk, prove each certificate, and return int32[B]
    penalties in the ORIGINAL corpus order. All chunks are dispatched
    before any result is pulled; the measured region (dispatches + the
    reduced barrier, CUDA events on a card, the host clock on the CPU) is
    recorded in `plan.last_exec_seconds`, its breakdown in the other
    `last_*` fields. Raises ValueError if a band chunk fails its
    certificate."""
    dev = plan.chunks[0][0].device if plan.chunks else torch.device("cpu")
    on_card = dev.type == "cuda"

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
    for bw, args in zip(plan.widths, plan.chunks):
        outs.append(_run_chunk(plan, bw, args))
        marks.append(mark())
    barrier = sum(s + ok.to(torch.int64) for _, s, ok in outs)
    end = mark()
    plan.last_enqueue_seconds = time.perf_counter() - t0
    if on_card:
        end.synchronize()
    else:
        int(barrier)
        end = time.perf_counter()
    plan.last_exec_seconds = span(marks[0], end)
    plan.last_dispatch_seconds = [span(a, b)
                                  for a, b in zip(marks, marks[1:])]

    for _, _, ok in outs:
        if not bool(ok):
            raise ValueError(
                "NW partition failed its band certificate: the bands array "
                "does not match this corpus (stale bands or order?)")
    t0 = time.perf_counter()
    pen_sorted = (torch.cat([p for p, _, _ in outs]).cpu().numpy()
                  if outs else np.zeros(0, np.int32))
    plan.last_pull_seconds = time.perf_counter() - t0
    pen = np.empty_like(pen_sorted)
    pen[plan.order] = pen_sorted
    return pen
