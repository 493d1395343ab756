"""Exact NW through the hand-written CUDA kernels of csrc/nw.cu, the port
of `asm_tpu.kernels.nw_pallas`:

  nw_penalty_cuda   full anti-diagonal Gotoh penalty (`_nw_kernel`)
  nw_align_cuda     the same forward pass with pointer bytes, then the
                    traceback and the '='-run match mask
                    (`_nw_trace_kernel`)

Both take int8 codes [B, L] and int32 lengths. On a CUDA tensor they
launch the kernel on the current stream (unsynchronised) or raise; on a
CPU tensor they run the plain version (`kernels/nw.py`). `LAUNCHES`
counts launches per kernel. The library is compiled with nvcc for sm_90a
at first use into asm_tpu_torch/build/ and bound with ctypes.
"""

from __future__ import annotations

import ctypes
import os

import torch

from asm_tpu_torch.kernels.greedy_cuda import check_tensor
from asm_tpu_torch.kernels.nw import nw_align, nw_penalty
from asm_tpu_torch.utils.build import PKG_DIR, nvcc_library, ptxas_report_path

# kernel launches since import (or since a caller reset them)
LAUNCHES = {"nw": 0, "nw_trace": 0}

SOURCE = os.path.join(PKG_DIR, "csrc", "nw.cu")
_WS = (4, 8)  # L / 32 the kernels are instantiated for (max_len 128, 256)
# the trace kernel parks 2L * L pointer bytes per pair in a per-launch
# scratch; launches are cut so it stays within this many bytes
TRACE_SCRATCH_BYTES = 256 << 20
_lib = None


def ptxas_report() -> str:
    return ptxas_report_path("nw", SOURCE)


def build_kernel() -> tuple[str, bool]:
    """nvcc csrc/nw.cu -> build/libnw_<hash>.so (sm_90a). Returns
    (library path, built_now)."""
    return nvcc_library("nw", SOURCE)


def _load():
    global _lib
    if _lib is None:
        path, _ = build_kernel()
        lib = ctypes.CDLL(path)
        c = ctypes
        lib.asm_nw_launch.restype = c.c_int
        lib.asm_nw_launch.argtypes = (
            [c.c_void_p] * 4 + [c.c_int] * 6 + [c.c_void_p] * 4
            + [c.c_int, c.c_void_p])
        _lib = lib
    return _lib


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
        if L % 32 or L // 32 not in _WS:
            raise NotImplementedError(
                f"the NW kernels are built for max_len in "
                f"{tuple(32 * w for w in _WS)}; got {L}")
        if read.data_ptr() % 4 or ref.data_ptr() % 4:
            raise ValueError("code rows must be 4-byte aligned")
    elif device.type != "cpu":
        raise NotImplementedError(f"no NW route for device {device}")
    return device, B, L


def _launch(read, read_len, ref, ref_len, x, o, e, thr, pen, ops, mask,
            scratch):
    stream = torch.cuda.current_stream(read.device).cuda_stream
    B, L = read.shape
    err = _load().asm_nw_launch(
        read.data_ptr(), ref.data_ptr(), read_len.data_ptr(),
        ref_len.data_ptr(), B, L // 32, x, o, e, thr, pen.data_ptr(),
        0 if ops is None else ops.data_ptr(),
        0 if mask is None else mask.data_ptr(),
        0 if scratch is None else scratch.data_ptr(), read.device.index,
        stream)
    if err != 0:
        raise RuntimeError(f"NW kernel launch failed: cudaError {err}")


def nw_penalty_cuda(read, read_len, ref, ref_len, x=1, o=1,
                    e=1) -> torch.Tensor:
    """Exact global alignment penalty, int32[B] (the full kernel)."""
    device, B, L = _checked(read, read_len, ref, ref_len)
    if device.type == "cpu":
        return nw_penalty(read, read_len, ref, ref_len, x, o, e)
    pen = torch.empty(B, dtype=torch.int32, device=device)
    if B > 0:
        _launch(read, read_len, ref, ref_len, x, o, e, -1, pen, None, None,
                None)
        LAUNCHES["nw"] += 1
    return pen


def nw_align_cuda(read, read_len, ref, ref_len, x=1, o=1, e=1,
                  match_mask_threshold: int | None = None):
    """Exact global alignment with traceback (the trace kernel).

    Returns (penalty int32[B], ops int8[B, 2L]): OP_* codes in REVERSE
    alignment order, OP_NONE-padded, the op of diagonal d in column
    2L - d; with match_mask_threshold also bool[B, L], the read positions
    inside '=' runs of at least that length. Bit-equal to `nw.nw_align`.
    Launches are cut into pieces of at most TRACE_SCRATCH_BYTES of
    pointer scratch."""
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
    piece = max(1, TRACE_SCRATCH_BYTES // (2 * L * L))
    scratch = torch.empty((min(piece, B), 2 * L, L), dtype=torch.uint8,
                          device=device) if B else None
    for lo in range(0, B, piece):
        hi = min(lo + piece, B)
        _launch(read[lo:hi], read_len[lo:hi], ref[lo:hi], ref_len[lo:hi],
                x, o, e, thr, pen[lo:hi], ops[lo:hi], mask[lo:hi], scratch)
        LAUNCHES["nw_trace"] += 1
    if want_mask:
        return pen, ops, mask
    return pen, ops
