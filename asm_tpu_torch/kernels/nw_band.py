"""Banded NW/Gotoh penalty with an exactness certificate (port of
`asm_tpu.kernels.nw_band`, host half, plus the wrappers of the CUDA band
and staging kernels csrc/nw_band.cu).

Band offsets: position u of a pair's band of BW offsets holds the
diagonal offset k = i - j = u - KB, KB = BW/2 - 1, so k runs over [-KB,
BW/2] (an asymmetric band). Cell (d, k) reads (d-1, k-1) for E, (d-1,
k+1) for F and (d-2, k) for the substitution; INF enters at the band's
edges. A destination with m - n outside the band gives INF.

Exactness: leaving the band needs a gap run costing >= o + KB*e, so a
banded penalty below that threshold is the full NW penalty
(`band_certified`); elsewhere it is an upper bound. `required_band`
turns exact penalties into each pair's smallest certifying band, and
`nw_penalty_partitioned` runs each pair through the bands, forwarding the
uncertified residue, and the last residue to the full kernel.

Parity: cell (d, k) exists only when d + k is even, and an existing cell
reads only existing ones. KB is odd, so the plain version and the kernel
give a pair BW/2 lanes, lane t holding two adjacent offsets: A, k = 2t -
KB (odd k, cells on odd diagonals) and B, k = 2t + 1 - KB (even k, even
diagonals). An odd diagonal computes every A: E from B of lane t-1, F
from the lane's own B, the substitution from its own A two diagonals
back; an even diagonal computes every B: E from the lane's own A, F from
A of lane t+1. No cell of the wrong parity is computed. The destination
(d = m+n, k = m-n) lies in lane (k + KB) // 2, slot A where m+n is odd.
Cells past a pair's lengths never feed its destination, so padding codes
are don't-care.

Staging: the band kernels read 2-bit planes; `stage_planes` turns int8
codes into them (the staging kernel on the card, `stage_plain` on the
CPU), once per call of `nw_penalty_partitioned`.
"""

from __future__ import annotations

import collections
import ctypes
import os

import numpy as np
import torch

from asm_tpu_torch.encoding import PAD_READ, pack_planes_t
from asm_tpu_torch.kernels import nw_cuda
from asm_tpu_torch.kernels.greedy_cuda import check_tensor, codes_from_planes_tiled
from asm_tpu_torch.kernels.nw import INF, pen_closed_form
from asm_tpu_torch.kernels.shapes import BAND_WIDTHS, Plan, band_plan
from asm_tpu_torch.utils.build import PKG_DIR, nvcc_library, ptxas_report_path
from asm_tpu_torch.utils.profiling import span

# band kernel launches since import (or since a caller reset it), in all
# and per library stem
LAUNCHES = 0
LIB_LAUNCHES = collections.Counter()
# staging kernel launches (`stage_planes` on the card), counted apart
STAGE_LAUNCHES = 0
# pairs through nw_penalty_partitioned since import: "in" entered,
# "staged" staged to planes on the card, ("band", bw) taken by a band
# stage, ("certified", bw) certified there, "full" sent to the full kernel
PAIRS = collections.Counter()

SOURCE = os.path.join(PKG_DIR, "csrc", "nw_band.cu")
# the band widths of the partitioned dispatch (the harness's and the
# headline's); the kernel takes shapes.BAND_WIDTHS, 4 too
BWS = (8, 16, 32, 64)
_libs = {}  # library stem -> bound library


def band_certified(pen, bw, o=1, e=1):
    """True where the banded penalty is provably the exact NW penalty."""
    return pen < o + (bw // 2 - 1) * e


def required_band(pen, o=1, e=1, bws=(16, 32, 64)) -> np.ndarray:
    """Smallest certifying band width per pair, from EXACT penalties:
    int32[B] of widths in `bws`, 0 where none certifies (the full kernel
    is needed)."""
    pen = np.asarray(pen)
    out = np.zeros(pen.shape, np.int32)
    for bw in sorted(bws, reverse=True):
        out = np.where(pen < o + (bw // 2 - 1) * e, bw, out).astype(np.int32)
    return out


def codes_from_planes(planes: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Position-major planes [L/16, B] (`stage_planes_t`) -> int8 codes
    [B, L], PAD_READ past each length (staging drops the sentinels' high
    bits; cells past a length never reach a result, so one pad serves
    reads and refs)."""
    return codes_from_planes_tiled(planes[None], lens, PAD_READ)


def stage_plain(codes: torch.Tensor) -> torch.Tensor:
    """The plain version of the staging kernel: int8 codes [B, L] ->
    position-major 2-bit planes int32[2W, B], W = L/32, row w bit 0 and
    row W + w bit 1 of positions 32w..32w+31: `encoding.pack_planes_t`'s
    first two planes (codes above 3 keep their low two bits)."""
    return torch.cat(pack_planes_t(codes)[:2])


def banded_plain(read_codes, read_len, ref_codes, ref_len, bw=32, x=1, o=1,
                 e=1):
    """The plain version of the band kernel on int8 codes [B, L], in its
    layout: BW/2 lanes per pair, lane t holding offsets A (k = 2t - KB,
    cells on odd diagonals) and B (k = 2t + 1 - KB, even diagonals).
    Odd diagonals step A, even ones B; the result is read out at each
    destination and min-folded with the closed form, as the JAX kernel
    does."""
    B, L = read_codes.shape
    dev = read_codes.device
    i32 = torch.int32
    kb = bw // 2 - 1
    k_a = 2 * torch.arange(bw // 2, device=dev, dtype=i32) - kb
    k_b = k_a + 1
    m = read_len.to(i32).clamp(max=L)
    n = ref_len.to(i32).clamp(max=L)
    mn = m + n
    dk = m - n
    in_band = (dk >= -kb) & (dk <= bw - 1 - kb)
    # the destination's lane; its slot is A or B by the parity of m + n
    dest = ((dk + kb) // 2).clamp(0, bw // 2 - 1).to(torch.int64)[:, None]
    d_max = int(mn.max()) if B else 0

    inf = torch.full((B, bw // 2), INF, dtype=i32, device=dev)
    inf_col = inf[:, :1]
    h_a, e_a, f_a = inf, inf, inf
    h_b = torch.where(k_b == 0, 0, inf)  # diagonal 0: only cell (0, 0)
    e_b, f_b = inf, inf
    hit = torch.full((B,), INF, dtype=i32, device=dev)
    rd = read_codes.to(i32)
    rf = ref_codes.to(i32)

    def up(a):  # lane t reads t-1
        return torch.cat([inf_col, a[:, :-1]], dim=1)

    def dn(a):  # lane t reads t+1
        return torch.cat([a[:, 1:], inf_col], dim=1)

    for d in range(1, d_max + 1):
        if d % 2:  # A: E from B of lane t-1, F from its own B
            kk, h2 = k_a, h_a
            e_new = torch.minimum(up(h_b) + o, up(e_b) + e)
            f_new = torch.minimum(h_b + o, f_b + e)
        else:  # B: E from its own A, F from A of lane t+1
            kk, h2 = k_b, h_b
            e_new = torch.minimum(h_a + o, e_a + e)
            f_new = torch.minimum(dn(h_a) + o, dn(f_a) + e)
        # (i, j) of each cell; out-of-range cells are don't-care, their
        # indices only clamped
        ri = ((d + kk) // 2 - 1).clamp(0, L - 1).to(torch.int64)
        rj = ((d - kk) // 2 - 1).clamp(0, L - 1).to(torch.int64)
        mis = (rd[:, ri] != rf[:, rj]).to(i32)
        h_new = torch.minimum(h2 + x * mis, torch.minimum(e_new, f_new))
        # borders inside the band: k == d is the j == 0 column, k == -d
        # the i == 0 row
        bl = kk == d
        bt = kk == -d
        bp = o + (d - 1) * e
        h_new = torch.where(bl | bt, bp, h_new)
        e_new = torch.where(bl, bp, torch.where(bt, INF, e_new))
        f_new = torch.where(bl | bt, INF, f_new)
        at = (mn == d) & in_band
        hit = torch.where(at, torch.gather(h_new, 1, dest)[:, 0], hit)
        if d % 2:
            h_a, e_a, f_a = h_new, e_new, f_new
        else:
            h_b, e_b, f_b = h_new, e_new, f_new
    return torch.minimum(pen_closed_form(m, mn, o, e), hit)


# ---- the CUDA kernel: build, bind, wrapper --------------------------------

def plan(max_len: int = 128, bw: int = 32) -> Plan:
    """The library holding the band kernel at max_len (every BW)."""
    return band_plan(max_len, bw)


def ptxas_report(max_len: int = 128) -> str:
    return ptxas_report_path(plan(max_len).stem, SOURCE)


def build_kernel(max_len: int = 128) -> tuple[str, bool]:
    """nvcc csrc/nw_band.cu -> build/lib<stem>_<hash>.so (sm_90a), the
    library holding max_len (default: the tuned table,
    libnw_band_<hash>.so). Returns (library path, built_now)."""
    p = plan(max_len)
    return nvcc_library(p.stem, SOURCE, p.defines)


def bind(path: str):
    """ctypes handle of a band library at `path`, its entry points typed."""
    lib = ctypes.CDLL(path)
    c = ctypes
    lib.asm_nw_band_launch.restype = c.c_int
    lib.asm_nw_band_launch.argtypes = (
        [c.c_void_p] * 4 + [c.c_int] * 6 + [c.c_void_p, c.c_int, c.c_void_p])
    lib.asm_nw_band_occupancy.restype = c.c_int
    lib.asm_nw_band_occupancy.argtypes = [c.c_int] * 2
    lib.asm_nw_band_wide_np.restype = c.c_int
    lib.asm_nw_band_wide_np.argtypes = [c.c_int] * 2
    lib.asm_nw_stage_planes.restype = c.c_int
    lib.asm_nw_stage_planes.argtypes = (
        [c.c_void_p] * 2 + [c.c_int] * 2 + [c.c_void_p, c.c_int, c.c_void_p])
    return lib


def _load(max_len: int = 128):
    """The bound library holding max_len, built at its first use."""
    p = plan(max_len)
    if p.stem not in _libs:
        _libs[p.stem] = bind(build_kernel(max_len)[0])
    return _libs[p.stem]


def occupancy(bw: int, max_len: int, lib=None) -> int:
    """Resident warps per SM of the wide path (band_wide_kernel: every BW
    above max_len 512, BW 128 at and below it) on the current CUDA device,
    with the shared memory its launch uses; of `lib` (a bound library,
    `bind`) where given."""
    lib = lib or _load(max_len)
    got = lib.asm_nw_band_occupancy(bw, max_len // 32)
    if got < 0:
        raise RuntimeError(f"band occupancy query failed at BW {bw}, "
                           f"max_len {max_len}: cudaError {-got}")
    return got


def stage_planes(read: torch.Tensor,
                 ref: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 codes [B, L] of reads and refs -> their position-major 2-bit
    planes int32[2W, B] (`stage_plain`'s words), the input of
    `nw_penalty_banded(..., pre_staged=True)`.

    CUDA tensors launch the staging kernel (csrc/nw_band.cu stage_kernel)
    once for both sides on the current stream, unsynced, into one
    [2, 2W, B] tensor; their rows must start 16-byte aligned. CPU tensors
    run `stage_plain`."""
    global STAGE_LAUNCHES
    with span("asm.nw.stage"):
        device = read.device
        B, L = read.shape
        check_tensor(read, "read", (torch.int8,), (B, L), device)
        check_tensor(ref, "ref", (torch.int8,), (B, L), device)
        if L % 32:
            raise ValueError(f"max_len must be a multiple of 32, got {L}")
        if device.type == "cpu":
            return stage_plain(read), stage_plain(ref)
        if device.type != "cuda":
            raise NotImplementedError(f"no staging route for device {device}")
        if read.data_ptr() % 16 or ref.data_ptr() % 16:
            raise ValueError("the staging kernel reads codes 16 bytes at a "
                             "time: read and ref must start 16-byte aligned")
        out = torch.empty((2, L // 16, B), dtype=torch.int32, device=device)
        stream = torch.cuda.current_stream(device).cuda_stream
        with span("asm.nw.stage.launch"):
            err = _load(L).asm_nw_stage_planes(
                read.data_ptr(), ref.data_ptr(), B, L // 32, out.data_ptr(),
                device.index, stream)
        if err != 0:
            raise RuntimeError(f"staging kernel launch failed: cudaError {err}")
        if B > 0:
            STAGE_LAUNCHES += 1
        return out[0], out[1]


def nw_penalty_banded(read, read_len, ref, ref_len, bw=32, x=1, o=1, e=1,
                      pre_staged: bool = False) -> torch.Tensor:
    """Banded global-alignment penalty, int32[B]: INF where the
    destination lies off the band; equal to the exact NW penalty wherever
    `band_certified`, an upper bound elsewhere.

    read/ref: int8 codes [B, L] (pre_staged=False; staged to planes by
    `stage_planes` for the kernel), or position-major 2-bit planes
    [L/16, B] of int32 / uint32 words from `stage_planes_t`
    (pre_staged=True). read_len/ref_len: int32[B]. All contiguous; CUDA
    codes must also start 16-byte aligned (`stage_planes`).

    CUDA tensors launch csrc/nw_band.cu on the current stream, unsynced;
    CPU tensors run `banded_plain`."""
    global LAUNCHES
    if bw not in BAND_WIDTHS:
        raise NotImplementedError(f"band width {bw} not in {BAND_WIDTHS}")
    device = read.device
    B = read_len.shape[0]
    if pre_staged:
        W2 = read.shape[0]
        check_tensor(read, "read", (torch.int32, torch.uint32), (W2, B), device)
        check_tensor(ref, "ref", (torch.int32, torch.uint32), (W2, B), device)
        L = 16 * W2
    else:
        L = read.shape[1]
        check_tensor(read, "read", (torch.int8,), (B, L), device)
        check_tensor(ref, "ref", (torch.int8,), (B, L), device)
    if L % 32:
        raise ValueError(f"max_len must be a multiple of 32, got {L}")
    check_tensor(read_len, "read_len", (torch.int32,), (B,), device)
    check_tensor(ref_len, "ref_len", (torch.int32,), (B,), device)

    if device.type == "cpu":
        if pre_staged:
            read = codes_from_planes(read, read_len)
            ref = codes_from_planes(ref, ref_len)
        return banded_plain(read, read_len, ref, ref_len, bw, x, o, e)
    if device.type != "cuda":
        raise NotImplementedError(f"no band route for device {device}")
    W = L // 32
    p = plan(L, bw)  # raises for a max_len the kernel does not take
    if pre_staged:
        rp, fp = read, ref
    else:
        rp, fp = stage_planes(read, ref)
    pen = torch.empty(B, dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    with span("asm.nw.band.launch"):
        err = _load(L).asm_nw_band_launch(
            rp.data_ptr(), fp.data_ptr(), read_len.data_ptr(),
            ref_len.data_ptr(), B, bw, W, x, o, e, pen.data_ptr(),
            device.index, stream)
    if err != 0:
        raise RuntimeError(f"band kernel launch failed: cudaError {err}")
    if B > 0:
        LAUNCHES += 1
        LIB_LAUNCHES[p.stem] += 1
    return pen


# ---- the partitioned dispatch ------------------------------------------------

def nw_penalty_partitioned(read, read_len, ref, ref_len, x=1, o=1, e=1,
                           bws=(16, 32, 64), pre_staged: bool = False,
                           bands=None) -> np.ndarray:
    """Exact NW penalties by host-side band partitioning: stage bw runs
    on the pairs still to do, keeps the certified results and forwards
    the rest; the final residue goes to the full kernel
    (`nw_cuda.nw_penalty_cuda`, on the caller's codes, or on codes rebuilt
    from the caller's planes). CUDA codes are staged to planes once
    (`stage_planes`), before the first band pass that takes a pair, and
    every pass gathers its pairs' planes.

    bands (optional int32[B], from `required_band` over a measuring pass)
    sends each pair straight to its certifying stage (0 = the full
    kernel); a stale too-narrow entry is harmless, its uncertified result
    forwards like in the measuring path.

    Inputs as for `nw_penalty_banded`, all on one device (CUDA codes
    contiguous and 16-byte aligned: `stage_planes` reads them whole); the
    index bookkeeping runs on the host. Returns int32[B] (numpy), equal to
    `nw.nw_penalty`. Counts its pairs in `PAIRS`."""
    with span("asm.nw"):
        device = read.device
        B = read_len.shape[0]
        PAIRS["in"] += B
        pen = np.zeros(B, np.int64)
        todo = np.arange(B)
        bands = None if bands is None else np.asarray(bands)
        # the band passes' planes [2W, B], pairs on axis 1: the caller's,
        # or staged from CUDA codes at the first pass; the CPU route takes
        # codes
        planes = (read, ref) if pre_staged else None

        def take(idx, rd, fd, ax):
            """(read, read_len, ref, ref_len) of the pairs idx, rd and fd
            gathered along axis ax"""
            i = torch.from_numpy(idx).to(device)
            return (torch.index_select(rd, ax, i),
                    torch.index_select(read_len, 0, i),
                    torch.index_select(fd, ax, i),
                    torch.index_select(ref_len, 0, i))

        for bw in sorted(bws):
            if todo.size == 0:
                break
            if bands is not None:
                here = todo[(bands[todo] != 0) & (bands[todo] <= bw)]
            else:
                here = todo
            if here.size == 0:
                continue
            if planes is None and device.type == "cuda":
                planes = stage_planes(read, ref)
                PAIRS["staged"] += B
            with span("asm.nw.take"):
                args = (take(here, read, ref, 0) if planes is None
                        else take(here, *planes, 1))
            with span("asm.nw.band"):
                p = nw_penalty_banded(*args, bw=bw, x=x, o=o, e=e,
                                      pre_staged=planes is not None)
            with span("asm.nw.band.wait"):
                p = p.cpu().numpy()
            with span("asm.nw.certificate"):
                cert = band_certified(p, bw, o, e)
                pen[here[cert]] = p[cert]
                done = np.zeros(B, bool)
                done[here[cert]] = True
                todo = todo[~done[todo]]
            PAIRS["band", bw] += here.size
            PAIRS["certified", bw] += int(cert.sum())
        if todo.size:
            PAIRS["full"] += todo.size
            with span("asm.nw.take"):
                rc, rl, fc, fl = take(todo, read, ref, 1 if pre_staged else 0)
            with span("asm.nw.full"):
                if pre_staged:
                    rc = codes_from_planes(rc, rl)
                    fc = codes_from_planes(fc, fl)
                p = nw_cuda.nw_penalty_cuda(rc, rl, fc, fl, x=x, o=o, e=e)
                with span("asm.nw.full.wait"):
                    pen[todo] = p.cpu().numpy()
        return pen.astype(np.int32)
