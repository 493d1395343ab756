"""Banded NW/Gotoh penalty with an exactness certificate (port of
`asm_tpu.kernels.nw_band`, host half, plus the wrapper of the CUDA band
kernel csrc/nw_band.cu).

Band-offset layout: lane u of a pair's BW-lane band holds the diagonal
offset k = i - j = u - KB, KB = BW/2 - 1, so k runs over [-KB, BW/2] (an
asymmetric band). Cell (d, k) reads (d-1, k-1) for E, (d-1, k+1) for F
and (d-2, k) for the substitution; INF enters at the band's edges. A
destination with m - n outside the band gives INF.

Exactness: leaving the band needs a gap run costing >= o + KB*e, so a
banded penalty below that threshold is the full NW penalty
(`band_certified`); elsewhere it is an upper bound. `required_band`
turns exact penalties into each pair's smallest certifying band, and
`nw_penalty_partitioned` runs each pair through the bands, forwarding the
uncertified residue, and the last residue to the full kernel.

Parity: cell (d, k) exists only when d + k is even. Lanes of the other
parity compute values that no valid cell reads, and the destination
(d = m+n, k = m-n) has valid parity. Cells past a pair's lengths never
feed its destination, so padding codes are don't-care.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from asm_tpu_torch.encoding import PAD_READ, pack_planes_t
from asm_tpu_torch.kernels import nw_cuda
from asm_tpu_torch.kernels.greedy_cuda import check_tensor, codes_from_planes_tiled
from asm_tpu_torch.kernels.nw import INF, pen_closed_form
from asm_tpu_torch.utils.build import PKG_DIR, nvcc_library, ptxas_report_path

# kernel launches since import (or since a caller reset it)
LAUNCHES = 0

SOURCE = os.path.join(PKG_DIR, "csrc", "nw_band.cu")
BWS = (8, 16, 32, 64)  # band widths the kernel is instantiated for
_WS = (4, 8)  # words per plane row (max_len 128, 256)
_lib = None


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


def banded_plain(read_codes, read_len, ref_codes, ref_len, bw=32, x=1, o=1,
                 e=1):
    """The plain version of the band kernel on int8 codes [B, L]: the
    same recurrence over [B, BW] lanes, read out at each destination and
    min-folded with the closed form, as the JAX kernel does."""
    B, L = read_codes.shape
    dev = read_codes.device
    i32 = torch.int32
    kb = bw // 2 - 1
    kk = torch.arange(bw, device=dev, dtype=i32) - kb
    m = read_len.to(i32).clamp(max=L)
    n = ref_len.to(i32).clamp(max=L)
    mn = m + n
    dk = m - n
    in_band = (dk >= -kb) & (dk <= bw - 1 - kb)
    dest = (dk + kb).clamp(0, bw - 1).to(torch.int64)[:, None]
    d_max = int(mn.max()) if B else 0

    inf = torch.full((B, bw), INF, dtype=i32, device=dev)
    inf_col = inf[:, :1]
    h1 = torch.where(kk == 0, 0, inf)  # diagonal 0: only cell (0, 0)
    h2, e1, f1 = inf, inf, inf
    hit = torch.full((B,), INF, dtype=i32, device=dev)
    rd = read_codes.to(i32)
    rf = ref_codes.to(i32)

    def up(a):  # lane u reads u-1 (the k-1 dependency)
        return torch.cat([inf_col, a[:, :-1]], dim=1)

    def dn(a):  # lane u reads u+1 (the k+1 dependency)
        return torch.cat([a[:, 1:], inf_col], dim=1)

    for d in range(1, d_max + 1):
        # (i, j) of each lane; wrong-parity and out-of-range lanes are
        # don't-care, their indices only clamped
        ri = ((d + kk) // 2 - 1).clamp(0, L - 1).to(torch.int64)
        rj = ((d - kk) // 2 - 1).clamp(0, L - 1).to(torch.int64)
        mis = (rd[:, ri] != rf[:, rj]).to(i32)
        e_new = torch.minimum(up(h1) + o, up(e1) + e)
        f_new = torch.minimum(dn(h1) + o, dn(f1) + e)
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
        h2, h1, e1, f1 = h1, h_new, e_new, f_new
    return torch.minimum(pen_closed_form(m, mn, o, e), hit)


# ---- the CUDA kernel: build, bind, wrapper --------------------------------

def ptxas_report() -> str:
    return ptxas_report_path("nw_band", SOURCE)


def build_kernel() -> tuple[str, bool]:
    """nvcc csrc/nw_band.cu -> build/libnw_band_<hash>.so (sm_90a).
    Returns (library path, built_now)."""
    return nvcc_library("nw_band", SOURCE)


def _load():
    global _lib
    if _lib is None:
        path, _ = build_kernel()
        lib = ctypes.CDLL(path)
        c = ctypes
        lib.asm_nw_band_launch.restype = c.c_int
        lib.asm_nw_band_launch.argtypes = (
            [c.c_void_p] * 4 + [c.c_int] * 6 + [c.c_void_p, c.c_int,
                                                 c.c_void_p])
        _lib = lib
    return _lib


def nw_penalty_banded(read, read_len, ref, ref_len, bw=32, x=1, o=1, e=1,
                      pre_staged: bool = False) -> torch.Tensor:
    """Banded global-alignment penalty, int32[B]: INF where the
    destination lies off the band; equal to the exact NW penalty wherever
    `band_certified`, an upper bound elsewhere.

    read/ref: int8 codes [B, L] (pre_staged=False; packed to planes with
    `pack_planes_t` for the kernel), or position-major 2-bit planes
    [L/16, B] of int32 / uint32 words from `stage_planes_t`
    (pre_staged=True). read_len/ref_len: int32[B].

    CUDA tensors launch csrc/nw_band.cu on the current stream, unsynced;
    CPU tensors run `banded_plain`."""
    global LAUNCHES
    if bw not in BWS:
        raise NotImplementedError(f"band width {bw} not in {BWS}")
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
    if W not in _WS:
        raise NotImplementedError(
            f"the band kernel is built for max_len in "
            f"{tuple(32 * w for w in _WS)}; got {L}")
    if pre_staged:
        rp, fp = read, ref
    else:
        rp = torch.cat(pack_planes_t(read)[:2]).contiguous()
        fp = torch.cat(pack_planes_t(ref)[:2]).contiguous()
    pen = torch.empty(B, dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = _load().asm_nw_band_launch(
        rp.data_ptr(), fp.data_ptr(), read_len.data_ptr(), ref_len.data_ptr(),
        B, bw, W, x, o, e, pen.data_ptr(), device.index, stream)
    if err != 0:
        raise RuntimeError(f"band kernel launch failed: cudaError {err}")
    if B > 0:
        LAUNCHES += 1
    return pen


# ---- the partitioned dispatch ------------------------------------------------

def nw_penalty_partitioned(read, read_len, ref, ref_len, x=1, o=1, e=1,
                           bws=(16, 32, 64), pre_staged: bool = False,
                           bands=None) -> np.ndarray:
    """Exact NW penalties by host-side band partitioning: stage bw runs
    on the pairs still to do, keeps the certified results and forwards
    the rest; the final residue goes to the full kernel
    (`nw_cuda.nw_penalty_cuda`, codes rebuilt from planes on the device).

    bands (optional int32[B], from `required_band` over a measuring pass)
    sends each pair straight to its certifying stage (0 = the full
    kernel); a stale too-narrow entry is harmless, its uncertified result
    forwards like in the measuring path.

    Inputs as for `nw_penalty_banded`, all on one device; the index
    bookkeeping runs on the host. Returns int32[B] (numpy), equal to
    `nw.nw_penalty`."""
    device = read.device
    B = read_len.shape[0]
    ax = 1 if pre_staged else 0
    pen = np.zeros(B, np.int64)
    todo = np.arange(B)
    bands = None if bands is None else np.asarray(bands)

    def take(a, idx):
        return torch.index_select(a, ax if a.dim() == 2 else 0,
                                  torch.from_numpy(idx).to(device))

    for bw in sorted(bws):
        if todo.size == 0:
            break
        if bands is not None:
            here = todo[(bands[todo] != 0) & (bands[todo] <= bw)]
        else:
            here = todo
        if here.size == 0:
            continue
        p = nw_penalty_banded(take(read, here), take(read_len, here),
                              take(ref, here), take(ref_len, here), bw=bw,
                              x=x, o=o, e=e, pre_staged=pre_staged)
        p = p.cpu().numpy()
        cert = band_certified(p, bw, o, e)
        pen[here[cert]] = p[cert]
        done = np.zeros(B, bool)
        done[here[cert]] = True
        todo = todo[~done[todo]]
    if todo.size:
        rc, rl = take(read, todo), take(read_len, todo)
        fc, fl = take(ref, todo), take(ref_len, todo)
        if pre_staged:
            rc, fc = codes_from_planes(rc, rl), codes_from_planes(fc, fl)
        pen[todo] = nw_cuda.nw_penalty_cuda(rc, rl, fc, fl, x=x, o=o,
                                            e=e).cpu().numpy()
    return pen.astype(np.int32)
