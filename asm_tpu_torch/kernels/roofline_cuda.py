"""The roofline microkernels (csrc/roofline.cu), the port of the Pallas
kernels of tools/roofline.py and tests/test_roofline_counts.py:

  issue_chain   STREAMS dependent chains of v = (v + 1) ^ 12345 per thread,
                UNROLL steps per iteration (`vpu_peak_measure`)
  stream_fold   the xor of every 32-bit word of an array
                (`hbm_stream_measure`)
  probe         load, +1, ^3, a data-dependent loop of +1 (x[0] trips),
                store (the counter test's synthetic kernel)
  op_chain      STREAMS chains per thread of one opcode of a Gotoh cell
                (OPS: DPX add-min, min / max, compare and select,
                multiply-add, add, add-min beside multiply-add, DPX
                three-way min / max, an add of the operand beside a xor),
                each step on its own value and its neighbours'; no TPU
                kernel: the pipe rates the NW kernels are read against
  noop          an empty launch (the dispatch floor; not counted)

Each has a plain PyTorch version beside it. On a CUDA tensor the wrapper
launches the kernel on the current stream (unsynchronised) or raises; on a
CPU tensor it runs the plain version. `LAUNCHES` counts launches per
kernel. The plain versions hold 32-bit words in int64 masked to 32 bits;
inputs and outputs are int32 tensors carrying the uint32 bit patterns.
The library is compiled with nvcc for sm_90a at first use into
asm_tpu_torch/build/ and bound with ctypes.
"""

from __future__ import annotations

import ctypes
import os

import torch

from asm_tpu_torch.kernels.greedy_cuda import check_tensor
from asm_tpu_torch.utils.build import PKG_DIR, nvcc_library, ptxas_report_path

# kernel launches since import (or since a caller reset them)
LAUNCHES = {"issue_chain": 0, "stream_fold": 0, "probe": 0, "op_chain": 0}

SOURCE = os.path.join(PKG_DIR, "csrc", "roofline.cu")
STREAMS = 8  # independent chains per thread (kStreams)
UNROLL = 4  # chain steps per chain and iteration (kUnroll)
THREADS = 256  # threads per block of every kernel (kThreads)
CHAIN_XOR = 12345
MASK32 = 0xFFFFFFFF
# op_chain's operations (csrc/roofline.cu OP_*), in its order, with the
# instructions one step of one chain issues, and the SASS opcodes they are
# meant to compile to (by stem)
OPS = ("viaddmin", "minmax", "setp_sel", "imad", "iadd", "mix", "minmax3",
       "add_xor")
OP_INSTS = {"viaddmin": 1, "minmax": 1, "setp_sel": 2, "imad": 1,
            "iadd": 1, "mix": 1, "minmax3": 1, "add_xor": 1}
OP_SASS = {"viaddmin": ("VIADDMNMX",), "minmax": ("IMNMX", "VIMNMX"),
           "setp_sel": ("ISETP", "SEL"), "imad": ("IMAD",),
           "iadd": ("IADD3", "IMAD", "VIADD"),
           "mix": ("VIADDMNMX", "IMAD"), "minmax3": ("VIMNMX3", "IMNMX3"),
           "add_xor": ("VIADD", "IADD3", "IMAD", "LOP3")}
_lib = None


def ptxas_report() -> str:
    return ptxas_report_path("roofline", SOURCE)


def build_kernel() -> tuple[str, bool]:
    """nvcc csrc/roofline.cu -> build/libroofline_<hash>.so (sm_90a).
    Returns (library path, built_now)."""
    return nvcc_library("roofline", SOURCE)


def _load():
    global _lib
    if _lib is None:
        path, _ = build_kernel()
        lib = ctypes.CDLL(path)
        c = ctypes
        lib.asm_roofline_issue_chain.restype = c.c_int
        lib.asm_roofline_issue_chain.argtypes = (
            [c.c_void_p] * 2 + [c.c_int] * 3 + [c.c_void_p])
        lib.asm_roofline_stream_fold.restype = c.c_int
        lib.asm_roofline_stream_fold.argtypes = [
            c.c_void_p, c.c_longlong, c.c_void_p, c.c_int, c.c_int,
            c.c_void_p]
        lib.asm_roofline_probe.restype = c.c_int
        lib.asm_roofline_probe.argtypes = (
            [c.c_void_p] * 2 + [c.c_int] * 2 + [c.c_void_p])
        lib.asm_roofline_op_chain.restype = c.c_int
        lib.asm_roofline_op_chain.argtypes = (
            [c.c_void_p] * 2 + [c.c_int] * 5 + [c.c_void_p])
        lib.asm_roofline_noop.restype = c.c_int
        lib.asm_roofline_noop.argtypes = [c.c_int, c.c_void_p]
        _lib = lib
    return _lib


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {err}")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _to_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2^32) -> int32 tensors of the same bits."""
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


# ---- issue_chain -----------------------------------------------------------

def issue_chain_ops(threads: int, iters: int) -> int:
    """Integer operations of one issue_chain launch: an add and a xor per
    chain step."""
    return threads * iters * STREAMS * UNROLL * 2


def issue_chain_plain(seed: torch.Tensor, iters: int) -> torch.Tensor:
    """int32[threads, STREAMS] seeds -> int32[threads]: each row's chains
    stepped iters * UNROLL times, xor-folded."""
    v = seed.to(torch.int64) & MASK32
    for _ in range(iters * UNROLL):
        v = ((v + 1) & MASK32) ^ CHAIN_XOR
    out = v[:, 0]
    for s in range(1, STREAMS):
        out = out ^ v[:, s]
    return _to_i32(out)


def issue_chain(seed: torch.Tensor, iters: int) -> torch.Tensor:
    """The issue-rate kernel over int32[threads, STREAMS] seeds, one
    thread per row (threads a multiple of THREADS on a card)."""
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    device = seed.device
    threads = seed.shape[0]
    check_tensor(seed, "seed", (torch.int32,), (threads, STREAMS), device)
    if device.type == "cpu":
        return issue_chain_plain(seed, iters)
    if device.type != "cuda":
        raise NotImplementedError(f"no issue_chain route for {device}")
    if threads == 0 or threads % THREADS:
        raise ValueError(f"threads must be a positive multiple of {THREADS}, "
                         f"got {threads}")
    out = torch.empty(threads, dtype=torch.int32, device=device)
    _raise_on(_load().asm_roofline_issue_chain(
        seed.data_ptr(), out.data_ptr(), threads // THREADS, iters,
        device.index, _stream(device)), "issue_chain")
    LAUNCHES["issue_chain"] += 1
    return out


# ---- op_chain --------------------------------------------------------------

def _signed(v: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2^32) -> their int32 values, as int64."""
    return torch.where(v >= 1 << 31, v - (1 << 32), v)


def op_chain_ops(threads: int, iters: int, op: str) -> int:
    """Instructions one op_chain launch issues in its chains."""
    return threads * iters * STREAMS * UNROLL * OP_INSTS[op]


def _op_step(op: str, v, w, z, a: int, u: int):
    """csrc/roofline.cu op_step on int64 words in [0, 2^32), every chain
    at once (columns: chains; w and z the neighbours' values)."""
    vi, wi, zi = _signed(v), _signed(w), _signed(z)
    if op == "mix":
        half = STREAMS // 2
        return torch.cat([_op_step("viaddmin", v, w, z, a, u)[:, :half],
                          _op_step("imad", v, w, z, a, u)[:, half:]], 1)
    if op == "viaddmin":
        return ((vi + a).minimum(wi)) & MASK32
    if op == "minmax":
        return (vi.maximum(wi) if u % 2 else vi.minimum(wi)) & MASK32
    if op == "setp_sel":
        return torch.where(vi < wi, torch.full_like(v, a & MASK32), w)
    if op == "imad":
        return (v * w + a) & MASK32
    if op == "minmax3":
        f = torch.maximum if u % 2 else torch.minimum
        return f(vi, f(wi, zi)) & MASK32
    if op == "add_xor":
        return w ^ (a & MASK32) if u % 2 else (w + a) & MASK32
    return (v + w) & MASK32


def op_chain_plain(seed: torch.Tensor, iters: int, a: int,
                   op: str) -> torch.Tensor:
    """int32[threads, STREAMS] seeds -> int32[threads]: op_chain's chains
    (the add-min's seeds arithmetic-shifted right by 8) stepped iters *
    UNROLL times, xor-folded."""
    v = seed.to(torch.int64) & MASK32
    if op in ("viaddmin", "mix"):
        v = (_signed(v) >> 8) & MASK32
    for _ in range(iters):
        for u in range(UNROLL):
            v = _op_step(op, v, v.roll(-1, 1), v.roll(-2, 1), a, u)
    out = v[:, 0]
    for s in range(1, STREAMS):
        out = out ^ v[:, s]
    return _to_i32(out)


def op_chain(seed: torch.Tensor, iters: int, op: str,
             a: int = 3) -> torch.Tensor:
    """The chain kernel of `op` (one of OPS) over int32[threads, STREAMS]
    seeds, one thread per row (threads a multiple of THREADS on a card),
    with the operand `a` (a small positive int keeps the add-min exact)."""
    if op not in OPS:
        raise ValueError(f"op must be one of {OPS}, got {op!r}")
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    device = seed.device
    threads = seed.shape[0]
    check_tensor(seed, "seed", (torch.int32,), (threads, STREAMS), device)
    if device.type == "cpu":
        return op_chain_plain(seed, iters, a, op)
    if device.type != "cuda":
        raise NotImplementedError(f"no op_chain route for {device}")
    if threads == 0 or threads % THREADS:
        raise ValueError(f"threads must be a positive multiple of {THREADS}, "
                         f"got {threads}")
    out = torch.empty(threads, dtype=torch.int32, device=device)
    _raise_on(_load().asm_roofline_op_chain(
        seed.data_ptr(), out.data_ptr(), threads // THREADS, iters, a,
        OPS.index(op), device.index, _stream(device)), f"op_chain {op}")
    LAUNCHES["op_chain"] += 1
    return out


# ---- stream_fold -----------------------------------------------------------

def stream_fold_plain(x: torch.Tensor) -> torch.Tensor:
    """int32[n] words -> int32[1], their xor: a halving fold (an odd
    length gets a zero word, the xor identity)."""
    v = x
    while v.numel() > 1:
        if v.numel() % 2:
            v = torch.cat([v, v.new_zeros(1)])
        h = v.numel() // 2
        v = v[:h] ^ v[h:]
    return v.reshape(1) if v.numel() else x.new_zeros(1)


def stream_fold(x: torch.Tensor, blocks: int | None = None) -> torch.Tensor:
    """The stream kernel: int32[n] words (n a multiple of 4, 16-byte
    aligned on a card) -> int32[1], their xor. blocks: the grid (default
    8 per SM)."""
    device = x.device
    check_tensor(x, "x", (torch.int32,), (x.numel(),), device)
    if device.type == "cpu":
        return stream_fold_plain(x)
    if device.type != "cuda":
        raise NotImplementedError(f"no stream_fold route for {device}")
    if x.numel() % 4 or x.data_ptr() % 16:
        raise ValueError("stream_fold needs a 16-byte aligned array of a "
                         "multiple of 4 words")
    if blocks is None:
        blocks = 8 * torch.cuda.get_device_properties(
            device).multi_processor_count
    out = torch.zeros(1, dtype=torch.int32, device=device)
    _raise_on(_load().asm_roofline_stream_fold(
        x.data_ptr(), x.numel() // 4, out.data_ptr(), blocks, device.index,
        _stream(device)), "stream_fold")
    LAUNCHES["stream_fold"] += 1
    return out


# ---- probe -------------------------------------------------------------------

def probe_plain(x: torch.Tensor) -> torch.Tensor:
    """int32[n] -> int32[n]: ((x + 1) ^ 3) + max(x[0], 0), wrapping."""
    v = ((x.to(torch.int64) + 1) & MASK32) ^ 3
    trips = max(int(x[0]), 0) if x.numel() else 0
    return _to_i32((v + trips) & MASK32)


def probe(x: torch.Tensor) -> torch.Tensor:
    """The counter test's probe kernel on int32[n], n >= 1."""
    device = x.device
    n = x.numel()
    check_tensor(x, "x", (torch.int32,), (n,), device)
    if n == 0:
        raise ValueError("probe reads x[0]: needs n >= 1")
    if device.type == "cpu":
        return probe_plain(x)
    if device.type != "cuda":
        raise NotImplementedError(f"no probe route for {device}")
    out = torch.empty_like(x)
    _raise_on(_load().asm_roofline_probe(
        x.data_ptr(), out.data_ptr(), n, device.index, _stream(device)),
        "probe")
    LAUNCHES["probe"] += 1
    return out


def noop(device) -> None:
    """One empty kernel launch on `device`'s current stream."""
    device = torch.device(device)
    if device.type != "cuda":
        raise NotImplementedError("the empty launch needs a CUDA device")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    _raise_on(_load().asm_roofline_noop(device.index, _stream(device)),
              "noop")
