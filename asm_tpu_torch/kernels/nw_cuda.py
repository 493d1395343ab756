"""Exact NW through the hand-written CUDA kernels of csrc/nw.cu, the port
of `asm_tpu.kernels.nw_pallas`:

  nw_penalty_cuda   full Gotoh penalty (`_nw_kernel`)
  nw_align_cuda     the same sweep with 4 pointer bits per cell, then the
                    traceback and the '='-run match mask
                    (`_nw_trace_kernel`)
  occupancy         resident warps per SM of an instantiation

Both take int8 codes [B, L] and int32 lengths. On a CUDA tensor they
launch the kernel on the current stream (unsynchronised) or raise; on a
CPU tensor they run the plain version (`kernels/nw.py`). `LAUNCHES`
counts launches per kernel, `LIB_LAUNCHES` per (library stem, kernel).
The library is compiled with nvcc for sm_90a at first use into
asm_tpu_torch/build/ and bound with ctypes: max_len 128, 256 and 512 in
one library (the tuned table), every other max_len in a library of its
own built at its first launch (kernels/shapes.py).

Each (kernel, max_len) has one instantiation, its G threads per pair and
the trace kernel's pointer route fixed in csrc/nw.cu (`instance`): at
L = 128 the trace kernel keeps its pointers in shared memory and runs in
one launch; at L = 256 and 512 it keeps them in a global scratch of
L * L / 2 bytes per pair, its launches cut at TRACE_SCRATCH_BYTES
(`shapes.trace_piece`). At
another L, G and the route follow the table's rule
(`shapes.nw_instance`), and the G strips may cover a few rows past L
(`shapes.nw_rows`), which the scratch holds too. Above max_len 512 both
kernels take csrc/nw.cu's long path: one pair a warp, swept in blocks of
up to 1,024 rows (`shapes.nw_long_rows`, `shapes.nw_blocks`); the
penalty from `nw_long_full_kernel` (a 7-slot cell, its step loop in a
head, a steady loop and a tail: `loop_steps`), the trace from
`nw_long_kernel` with its pointer planes in the global scratch and its
walk on shared-memory tiles of them.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import os

import numpy as np
import torch

from asm_tpu_torch.kernels.greedy_cuda import check_tensor
from asm_tpu_torch.kernels.nw import nw_align, nw_penalty
from asm_tpu_torch.kernels.shapes import (
    LONG_W,
    NW_LONG_G,
    ROUTE_GLOBAL,
    ROUTE_NONE,
    ROUTE_SHARED,
    TRACE_SCRATCH_BYTES,
    Plan,
    nw_launch,
    nw_long_rows,
    nw_plan,
    nw_rows,
    trace_piece,
)
from asm_tpu_torch.utils.build import PKG_DIR, nvcc_library, ptxas_report_path
from asm_tpu_torch.utils.profiling import span

# kernel launches since import (or since a caller reset them), per kernel
# and per (library stem, kernel)
LAUNCHES = {"nw": 0, "nw_trace": 0}
LIB_LAUNCHES = collections.Counter()

SOURCE = os.path.join(PKG_DIR, "csrc", "nw.cu")
# ROUTE_*, imported above: csrc/nw.cu's ROUTE, where the trace kernel
# keeps its pointer bits; TRACE_SCRATCH_BYTES, imported above: the global
# route's per-launch scratch, to which its launches are cut (read here at
# each call, so that a caller may set it)
_libs = {}  # library stem -> bound library


@functools.cache
def instance(trace: bool, L: int) -> tuple[int, int]:
    """(G threads per pair, pointer route) of csrc/nw.cu's instantiation
    for the kernel (`trace`) at max_len L, as its library reports it
    (`shapes.nw_instance` says the same without a card)."""
    G, route = ctypes.c_int(), ctypes.c_int()
    err = _load(L).asm_nw_instance(L // 32, int(trace), ctypes.byref(G),
                                   ctypes.byref(route))
    if err != 0:
        raise NotImplementedError(f"no NW kernel is built for max_len {L}")
    return G.value, route.value


def function_name(trace: bool, L: int) -> str:
    """The mangled name of the instantiation: nw_kernel<L/32, G, ROUTE>,
    or above max_len 512 nw_long_full_kernel<L/32> (the penalty) and
    nw_long_kernel<L/32, true> (the trace)."""
    if L // 32 > LONG_W:
        if not trace:
            return f"nw_long_full_kernelILi{L // 32}E"
        return f"nw_long_kernelILi{L // 32}ELb1E"
    G, route = instance(trace, L)
    return f"nw_kernelILi{L // 32}ELi{G}ELi{route}E"


def warp_steps(m, n, L: int, G: int) -> np.ndarray:
    """Column steps each warp of 32 / G pairs (launch order) runs: the
    largest n + (m-1) // R among its pairs, R = shapes.nw_rows(L, G) rows
    per thread, 0 for a pair with an empty side; lengths clamped to L as
    the kernel clamps them. Above max_len 512 (one pair a warp, swept in
    blocks of RB = 32 R rows): n + 31 for each block above the pair's
    last, and n + (m-1 - b RB) // R for that block b."""
    m = np.minimum(np.asarray(m, np.int64), L)
    n = np.minimum(np.asarray(n, np.int64), L)
    live = (m > 0) & (n > 0)
    if L // 32 > LONG_W:
        R = nw_long_rows(L)
        RB = R * NW_LONG_G
        last = np.where(live, (m - 1) // RB, 0)
        return np.where(live, last * (n + NW_LONG_G - 1) + n
                        + (m - 1 - last * RB) // R, 0)
    steps = np.where(live, n + (m - 1) // nw_rows(L, G), 0)
    ppw = 32 // G
    pad = -steps.size % ppw
    return np.concatenate([steps, np.zeros(pad, np.int64)]).reshape(
        -1, ppw).max(1)


def loop_steps(m, n, L: int) -> np.ndarray:
    """The steps the long full kernel's three step loops run over all its
    pairs (one pair a warp; lengths clamped to L): [head, steady, tail].
    In each block of a pair the head runs its first min(31, steps) steps,
    the steady loop steps 32..n and the tail the rest (`warp_steps`
    gives a block's steps); their sum is warp_steps'."""
    m = np.minimum(np.asarray(m, np.int64), L)
    n = np.minimum(np.asarray(n, np.int64), L)
    live = (m > 0) & (n > 0)
    R = nw_long_rows(L)
    RB = R * NW_LONG_G
    last = np.where(live, (m - 1) // RB, 0)
    lag = NW_LONG_G - 1
    # per block: steady n - 31 where n > 31; the head 31 unless the block's
    # steps are fewer; the tail what is left
    blocks = np.where(live, last + 1, 0)
    steady = np.maximum(n - lag, 0) * blocks
    head = np.where(live, last * lag
                    + np.minimum(lag, n + (m - 1 - last * RB) // R), 0)
    total = warp_steps(m, n, L, NW_LONG_G)
    return np.array([head.sum(), steady.sum(), (total - head - steady).sum()],
                    np.int64)


def plan(max_len: int = 128) -> Plan:
    """The library holding both kernels' instantiations at max_len."""
    return nw_plan(max_len)


def ptxas_report(max_len: int = 128) -> str:
    return ptxas_report_path(plan(max_len).stem, SOURCE)


def build_kernel(max_len: int = 128) -> tuple[str, bool]:
    """nvcc csrc/nw.cu -> build/lib<stem>_<hash>.so (sm_90a), the library
    holding max_len (default: the tuned table, libnw_<hash>.so). Returns
    (library path, built_now)."""
    p = plan(max_len)
    return nvcc_library(p.stem, SOURCE, p.defines)


def bind(path: str):
    """The library at `path` (a build of csrc/nw.cu), its functions typed
    for ctypes."""
    lib = ctypes.CDLL(path)
    c = ctypes
    lib.asm_nw_launch.restype = c.c_int
    lib.asm_nw_launch.argtypes = (
        [c.c_void_p] * 4 + [c.c_int] * 7 + [c.c_void_p] * 4
        + [c.c_int, c.c_void_p])
    lib.asm_nw_instance.restype = c.c_int
    lib.asm_nw_instance.argtypes = [c.c_int] * 2 + [c.c_void_p] * 2
    lib.asm_nw_occupancy.restype = c.c_int
    lib.asm_nw_occupancy.argtypes = [c.c_int] * 2
    return lib


def _load(max_len: int = 128):
    """The bound library holding max_len, built at its first use."""
    p = plan(max_len)
    if p.stem not in _libs:
        _libs[p.stem] = bind(build_kernel(max_len)[0])
    return _libs[p.stem]


def occupancy(trace: bool = False, max_len: int = 128) -> int:
    """Resident warps per SM of the instantiation the wrapper launches for
    (trace, max_len) on the current CUDA device, with the shared memory
    its launch uses."""
    got = _load(max_len).asm_nw_occupancy(max_len // 32, int(trace))
    if got < 0:
        raise RuntimeError(f"NW occupancy query failed: cudaError {-got}")
    return got


def _checked(read, read_len, ref, ref_len):
    """Validate the common inputs; returns (device, B, L)."""
    device = read.device
    B = read_len.shape[0]
    L = read.shape[1] if read.dim() == 2 else -1
    check_tensor(read, "read", (torch.int8,), (B, L), device)
    check_tensor(ref, "ref", (torch.int8,), (B, L), device)
    check_tensor(read_len, "read_len", (torch.int32,), (B,), device)
    check_tensor(ref_len, "ref_len", (torch.int32,), (B,), device)
    if device.type == "cuda":
        plan(L)  # raises for a max_len the kernels do not take
        if read.data_ptr() % 4 or ref.data_ptr() % 4:
            raise ValueError("code rows must be 4-byte aligned")
    elif device.type != "cpu":
        raise NotImplementedError(f"no NW route for device {device}")
    return device, B, L


def _launch(read, read_len, ref, ref_len, x, o, e, thr, pen, ops, mask,
            scratch):
    stream = torch.cuda.current_stream(read.device).cuda_stream
    B, L = read.shape
    err = _load(L).asm_nw_launch(
        read.data_ptr(), ref.data_ptr(), read_len.data_ptr(),
        ref_len.data_ptr(), B, L // 32, int(ops is not None), x, o, e, thr,
        pen.data_ptr(), 0 if ops is None else ops.data_ptr(),
        0 if mask is None else mask.data_ptr(),
        0 if scratch is None else scratch.data_ptr(), read.device.index,
        stream)
    if err != 0:
        raise RuntimeError(f"NW kernel launch failed: cudaError {err}")
    LIB_LAUNCHES[plan(L).stem, "nw" if ops is None else "nw_trace"] += 1


def nw_penalty_cuda(read, read_len, ref, ref_len, x=1, o=1,
                    e=1) -> torch.Tensor:
    """Exact global alignment penalty, int32[B] (the full kernel)."""
    device, B, L = _checked(read, read_len, ref, ref_len)
    if device.type == "cpu":
        return nw_penalty(read, read_len, ref, ref_len, x, o, e)
    pen = torch.empty(B, dtype=torch.int32, device=device)
    if B > 0:
        with span("asm.nw.full.launch"):
            _launch(read, read_len, ref, ref_len, x, o, e, -1, pen, None,
                    None, None)
        LAUNCHES["nw"] += 1
    return pen


def nw_align_cuda(read, read_len, ref, ref_len, x=1, o=1, e=1,
                  match_mask_threshold: int | None = None):
    """Exact global alignment with traceback (the trace kernel).

    Returns (penalty int32[B], ops int8[B, 2L]): OP_* codes in REVERSE
    alignment order, OP_NONE-padded, the op of diagonal d in column
    2L - d; with match_mask_threshold also bool[B, L], the read positions
    inside '=' runs of at least that length. Bit-equal to `nw.nw_align`.
    One launch on the shared route; on the global route launches are cut
    into pieces of at most TRACE_SCRATCH_BYTES of pointer scratch
    (`shapes.trace_piece`)."""
    device, B, L = _checked(read, read_len, ref, ref_len)
    want_mask = match_mask_threshold is not None
    if want_mask and match_mask_threshold < 0:
        raise ValueError("match_mask_threshold must be >= 0")
    if device.type == "cpu":
        return nw_align(read, read_len, ref, ref_len, x, o, e,
                        match_mask_threshold)
    thr = match_mask_threshold if want_mask else -1
    pen = torch.empty(B, dtype=torch.int32, device=device)
    ops = torch.empty((B, 2 * L), dtype=torch.int8, device=device)
    mask = torch.empty((B, L), dtype=torch.bool, device=device)
    piece, scratch = max(B, 1), None
    if B and instance(True, L)[1] == ROUTE_GLOBAL:
        per_pair = nw_launch(True, L)["scratch_per_pair"]
        piece = trace_piece(per_pair, TRACE_SCRATCH_BYTES)
        scratch = torch.empty((min(piece, B), per_pair), dtype=torch.uint8,
                              device=device)
    for lo in range(0, B, piece):
        hi = min(lo + piece, B)
        _launch(read[lo:hi], read_len[lo:hi], ref[lo:hi], ref_len[lo:hi],
                x, o, e, thr, pen[lo:hi], ops[lo:hi], mask[lo:hi], scratch)
        LAUNCHES["nw_trace"] += 1
    if want_mask:
        return pen, ops, mask
    return pen, ops
