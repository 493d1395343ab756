"""Greedy alignment through the hand-written CUDA kernel (csrc/greedy.cu),
the port of `asm_tpu.kernels.greedy_pallas`.

  stage_planes_t / stage_planes_tiled_t   host staging to 2-bit planes
  greedy_align_cuda                       the wrapper: checks, allocates,
                                          launches (CUDA tensors) or runs
                                          the plain version (CPU tensors)
  expand_records                          packed step records -> (op, run)
                                          CIGAR slots
  step_trips                              the step loop's trips per pair
  occupancy / block_threads               resident warps per SM, threads
                                          per block of an instantiation

The kernel is compiled with nvcc for sm_90a at first use into
asm_tpu_torch/build/ and bound with ctypes: the tuned table (k in {2, 3,
4} x max_len in {128, 256, 512}) in one library, any other (k, max_len)
in a library of its own built at its first launch (kernels/shapes.py).
On a CUDA tensor the wrapper launches it or raises; nothing falls back.
`LAUNCHES` counts launches, `LIB_LAUNCHES` them per library stem.

Pair layout of the tile-major planes: pair i sits at tile i // tile,
column i % tile; row w holds plane 0 (code bit 0) of positions
32w..32w+31, row W + w plane 1. Pad codes lose their high bits there, so
validity always comes from the lengths.
"""

from __future__ import annotations

import collections
import ctypes
import os

import numpy as np
import torch

from asm_tpu_torch.config import AlignConfig, AlignmentType
from asm_tpu_torch.encoding import PAD_READ, PAD_REF
from asm_tpu_torch.kernels.greedy import (
    OP_D,
    OP_I,
    OP_M,
    greedy_align,
    rec_dtype,
)
from asm_tpu_torch.kernels.shapes import Plan, greedy_plan
from asm_tpu_torch.native import load_native
from asm_tpu_torch.utils.build import PKG_DIR, nvcc_library, ptxas_report_path
from asm_tpu_torch.utils.profiling import span

# kernel launches since import (or since a caller reset it), in all and
# per library stem
LAUNCHES = 0
LIB_LAUNCHES = collections.Counter()

SOURCE = os.path.join(PKG_DIR, "csrc", "greedy.cu")
_libs = {}  # library stem -> bound library


# ---- host staging ---------------------------------------------------------

def _codes_and_perm(codes, perm):
    """Validated int8 codes [B, L] (L % 32 == 0) and int64 perm (or None)."""
    arr = np.ascontiguousarray(np.asarray(codes, dtype=np.int8))
    if arr.ndim != 2 or arr.shape[1] % 32:
        raise ValueError(f"codes must be [B, L] with L % 32 == 0, got "
                         f"{arr.shape}")
    if perm is not None:
        perm = np.ascontiguousarray(np.asarray(perm, dtype=np.int64))
        if perm.ndim != 1:
            raise ValueError(f"perm must be 1-D, got {perm.shape}")
    return arr, perm


def stage_planes_t(codes, perm=None) -> np.ndarray:
    """int8 codes [B, L] -> position-major 2-bit planes uint32[L//16, B]:
    row w (w < W = L/32) plane 0, row W + w plane 1; bit p of a plane
    word = that code bit of position 32w + p. perm (int64[M], optional):
    output pair i is packed from input row perm[i], so a permutation (the
    difficulty sort) or a slice of one (a chunk) is fused into staging."""
    arr, perm = _codes_and_perm(codes, perm)
    B, L = arr.shape if perm is None else (perm.shape[0], arr.shape[1])
    W = L // 32
    sw = arr.view(np.uint32)  # [B, L/4], little-endian byte order
    lib = load_native()
    if lib is not None:
        from asm_tpu_torch.utils.hostmem import host_array

        out = host_array((2 * W, B), np.uint32)
        pp = (ctypes.c_void_p(perm.ctypes.data) if perm is not None
              else ctypes.c_void_p(None))
        lib.asm_stage_planes_t(sw, pp, B, W, out, 0)
        return out
    if perm is not None:
        sw = sw[perm]
    # the same carry-free multiply compaction as the native path
    out = np.empty((2 * W, B), np.uint32)
    M1 = np.uint32(0x01010101)
    MM = np.uint32(0x01020408)
    with np.errstate(over="ignore"):
        for w in range(W):
            a0 = np.zeros(B, np.uint32)
            a1 = np.zeros(B, np.uint32)
            for jj in range(8):
                v = sw[:, 8 * w + jj]
                a0 |= (((v & M1) * MM) >> np.uint32(24)) << np.uint32(4 * jj)
                a1 |= ((((v >> np.uint32(1)) & M1) * MM) >> np.uint32(24)) \
                    << np.uint32(4 * jj)
            out[w] = a0
            out[W + w] = a1
    return out


def stage_planes_tiled_t(codes, perm=None, *, tile: int) -> np.ndarray:
    """Tile-major planes uint32[NBT, L//16, tile], NBT = ceil(B / tile),
    the tail tile zero-padded. `tile` must match the one given to
    greedy_align_cuda. perm as in stage_planes_t."""
    if tile <= 0 or tile % 128:
        raise ValueError(f"tile must be a positive multiple of 128, got "
                         f"{tile}")
    arr, perm = _codes_and_perm(codes, perm)
    B, L = arr.shape if perm is None else (perm.shape[0], arr.shape[1])
    W = L // 32
    sw = arr.view(np.uint32)
    NBT = -(-B // tile)
    lib = load_native()
    if lib is not None:
        from asm_tpu_torch.utils.hostmem import host_array

        out = host_array((NBT, 2 * W, tile), np.uint32)  # zeroed
        pp = (ctypes.c_void_p(perm.ctypes.data) if perm is not None
              else ctypes.c_void_p(None))
        lib.asm_stage_planes_tiled_t(sw, pp, B, W, tile, out, 0)
        return out
    flat = stage_planes_t(codes, perm=perm)  # [2W, B]
    out = np.zeros((NBT, 2 * W, tile), np.uint32)
    nfull = B // tile
    out[:nfull] = flat[:, :nfull * tile].reshape(
        2 * W, nfull, tile).transpose(1, 0, 2)
    if B % tile:
        out[nfull, :, :B - nfull * tile] = flat[:, nfull * tile:]
    return out


def codes_from_planes_tiled(planes: torch.Tensor, lengths: torch.Tensor,
                            pad: int) -> torch.Tensor:
    """Tile-major planes [NBT, 2W, tile] -> int8 codes [B, 32W], with
    `pad` at every position past a pair's length (PAD_READ for reads,
    PAD_REF for refs: equal pads would make past-length positions match)."""
    NBT, W2, tile = planes.shape
    W = W2 // 2
    B = lengths.shape[0]
    words = planes.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    words = words.permute(0, 2, 1).reshape(NBT * tile, W2)[:B]  # [B, 2W]
    bits = torch.arange(32, device=planes.device)
    b0 = (words[:, :W, None] >> bits) & 1  # [B, W, 32]
    b1 = (words[:, W:, None] >> bits) & 1
    codes = (b0 | (b1 << 1)).reshape(B, 32 * W)
    pos = torch.arange(32 * W, device=planes.device)
    codes = torch.where(pos[None, :] < lengths.to(torch.int64)[:, None],
                        codes, pad)
    return codes.to(torch.int8)


# ---- build and bind -------------------------------------------------------

def plan(k: int = 3, max_len: int = 128) -> Plan:
    """The library holding the instantiation of (k, max_len)."""
    return greedy_plan(k, max_len)


def ptxas_report(k: int = 3, max_len: int = 128) -> str:
    """Path of the ptxas report (registers, spills) of the library that
    holds (k, max_len) (default: the tuned table's)."""
    return ptxas_report_path(plan(k, max_len).stem, SOURCE)


def build_kernel(k: int = 3, max_len: int = 128) -> tuple[str, bool]:
    """nvcc csrc/greedy.cu -> build/lib<stem>_<hash>.so for sm_90a, the
    library holding (k, max_len) (default: the tuned table,
    libgreedy_<hash>.so); the ptxas report (registers, spills) lands
    beside it as .ptxas.txt. Returns (library path, built_now)."""
    p = plan(k, max_len)
    return nvcc_library(p.stem, SOURCE, p.defines)


def bind(path: str):
    """The library at `path` (a build of csrc/greedy.cu), its functions
    typed for ctypes."""
    lib = ctypes.CDLL(path)
    c = ctypes
    lib.asm_greedy_launch.restype = c.c_int
    lib.asm_greedy_launch.argtypes = (
        [c.c_void_p] * 4 + [c.c_int] * 10 + [c.c_float] * 3
        + [c.c_void_p] * 3 + [c.c_int, c.c_void_p])
    lib.asm_greedy_occupancy.restype = c.c_int
    lib.asm_greedy_occupancy.argtypes = [c.c_int] * 3
    lib.asm_greedy_block_threads.restype = c.c_int
    lib.asm_greedy_block_threads.argtypes = [c.c_int]
    return lib


def _load(k: int = 3, max_len: int = 128):
    """The bound library holding (k, max_len), built at its first use."""
    p = plan(k, max_len)
    if p.stem not in _libs:
        _libs[p.stem] = bind(build_kernel(k, max_len)[0])
    return _libs[p.stem]


def occupancy(k: int = 3, max_len: int = 128, planes: bool = True) -> int:
    """Resident warps per SM of the kernel built for (k, max_len, input
    route) on the current CUDA device, with the block size and shared
    memory its launch uses (cudaOccupancyMaxActiveBlocksPerMultiprocessor
    times the block's warps)."""
    got = _load(k, max_len).asm_greedy_occupancy(k, max_len // 32,
                                                 int(planes))
    if got < 0:
        raise RuntimeError(f"greedy occupancy query failed: cudaError {-got}")
    return got


def block_threads(max_len: int = 128, k: int = 3) -> int:
    """Threads per block of the instantiation of (k, max_len), one pair
    each (above max_len 512 a group of `plan(k, max_len).group` per
    pair), as its library reports it (csrc/greedy.cu's block_threads;
    `plan(k, max_len).threads` says the same without a card)."""
    return _load(k, max_len).asm_greedy_block_threads(max_len // 32)


# ---- the wrapper ----------------------------------------------------------

def check_tensor(t, name, dtypes, shape, device):
    """Raise unless `t` lies on `device` with one of `dtypes`, `shape`
    and a contiguous layout (what a kernel's raw pointer needs)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def expand_records(rec: torch.Tensor, read_len, ref_len,
                   cfg: AlignConfig) -> dict:
    """Packed step records [T+1, B] -> (op, run) slot buffers [B, 2T+2]:
    slot 2t the row's leap (I if it moved down a lane, else D), 2t+1 its
    'M' run; empty slots carry run 0. The final leap's lane delta is not
    stored (it spans +-(L+k)) and is rebuilt as dest_lane minus the
    in-loop deltas."""
    L = cfg.max_len
    B = rec.shape[1]
    r = rec.to(torch.int32)
    if rec.dtype == torch.int16:
        r = r & 0xFFFF  # undo the sign extension, keep the raw bits
    is_final = (r & 1) != 0
    sdist = r >> 8
    sdl = torch.where(is_final | (r == 0), 0, ((r >> 1) & 0x7F) - 64)
    m = read_len.to(torch.int32).clamp(max=L)
    n = ref_len.to(torch.int32).clamp(max=L)
    dl_final = (n - m) - sdl.sum(dim=0, dtype=torch.int32)
    sdl = torch.where(is_final, dl_final[None, :], sdl).T  # [B, T+1]
    sdist = sdist.T
    ops_ = torch.stack([torch.where(sdl < 0, OP_I, OP_D),
                        torch.full_like(sdl, OP_M)], dim=2).reshape(B, -1)
    runs_ = torch.stack([sdl.abs(), sdist], dim=2).reshape(B, -1)
    return dict(
        cigar_ops=ops_.to(torch.int8),
        cigar_runs=runs_,
        cigar_count=(runs_ > 0).sum(dim=1, dtype=torch.int32),
    )


def step_trips(steps: torch.Tensor, rec: torch.Tensor) -> torch.Tensor:
    """int32[B] trips of the step loop each pair ran, read from its steps
    and packed records [T+1, B] (the plain version's `trips`).

    A step's record is never 0, so rows 0 .. steps-1 are nonzero. A walk
    that stopped on an empty highway ran one trip more: that trip wrote 0
    at row `steps` and the final leap follows at row steps + 1. That leap
    is never 0 once a step was taken (an unneeded leap means the last step
    reached the destination, which ends the walk without the empty trip),
    while rows past a walk's final leap are 0. A pair with no step stopped
    on its first trip. A walk cut at the bound T ran T trips."""
    T = rec.shape[0] - 1
    s = steps.to(torch.int64)
    row = s.clamp(max=max(T - 1, 0))[None, :]
    at = rec.gather(0, row)[0]
    after = rec.gather(0, (row + 1).clamp(max=T))[0]
    empty = (s < T) & ((s == 0) | ((at == 0) & (after != 0)))
    return (s + empty.to(torch.int64)).to(torch.int32)


def greedy_align_cuda(read, read_len, ref, ref_len, cfg: AlignConfig, *,
                      pre_staged=False, tile: int = 2048,
                      want_cigar: bool = True) -> dict:
    """Greedy alignment of a batch through the CUDA kernel.

    read/ref: int8 codes [B, L] (pre_staged=False), or tile-major planes
      [ceil(B / tile), L // 16, tile] of int32 / uint32 words from
      `stage_planes_tiled_t(..., tile=tile)` (pre_staged="planes_tiled").
    read_len/ref_len: int32[B].

    Returns cost, steps and step_rec (the packed records [T+1, B]); with
    want_cigar also the (op, run) slots of `expand_records`. For tensors on
    the CPU the plain version (kernels/greedy.py) computes the same dict;
    on a CUDA device the kernel runs on the current stream, unsynchronised.
    """
    global LAUNCHES
    with span("asm.greedy"):
        with span("asm.greedy.prep"):
            if cfg.flip_threshold != 1:
                raise NotImplementedError(
                    "the greedy kernel implements flip_threshold=1 (the "
                    "reference's value); use kernels.greedy.greedy_align "
                    "otherwise")
            if cfg.exact_floats:
                raise NotImplementedError(
                    "the greedy kernel computes the heuristic in float32; "
                    "use kernels.greedy.greedy_align for exact_floats")
            if pre_staged not in (False, "planes_tiled"):
                raise NotImplementedError(f"pre_staged={pre_staged!r}")
            L = cfg.max_len
            if L % 32:
                raise ValueError(f"max_len must be a multiple of 32, got {L}")
            W = L // 32
            T = cfg.steps_bound
            device = read.device
            B = read_len.shape[0]
            if pre_staged == "planes_tiled":
                code_dtypes = (torch.int32, torch.uint32)
                code_shape = (-(-B // tile), 2 * W, tile)
            else:
                code_dtypes = (torch.int8,)
                code_shape = (B, L)
            check_tensor(read, "read", code_dtypes, code_shape, device)
            check_tensor(ref, "ref", code_dtypes, code_shape, device)
            check_tensor(read_len, "read_len", (torch.int32,), (B,), device)
            check_tensor(ref_len, "ref_len", (torch.int32,), (B,), device)
            if device.type == "cuda":
                p = plan(cfg.k, L)  # raises for a shape the card cannot hold
                if read.data_ptr() % 4 or ref.data_ptr() % 4:
                    raise ValueError("code rows must be 4-byte aligned")
                cost = torch.empty(B, dtype=torch.int32, device=device)
                steps = torch.empty(B, dtype=torch.int32, device=device)
                rec = torch.empty((T + 1, B), dtype=rec_dtype(cfg),
                                  device=device)
                sig = [np.float32(s) for s in cfg.significance]
                stream = torch.cuda.current_stream(device).cuda_stream

        if device.type == "cpu":
            if pre_staged == "planes_tiled":
                read = codes_from_planes_tiled(read, read_len, PAD_READ)
                ref = codes_from_planes_tiled(ref, ref_len, PAD_REF)
            g = greedy_align(read, read_len, ref, ref_len, cfg, records=True)
            cost, steps, rec = g["cost"], g["steps"], g["step_rec"]
        elif device.type == "cuda":
            with span("asm.greedy.launch"):
                err = _load(cfg.k, L).asm_greedy_launch(
                    read.data_ptr(), ref.data_ptr(), read_len.data_ptr(),
                    ref_len.data_ptr(), B, tile,
                    int(pre_staged == "planes_tiled"), cfg.k, W, T, cfg.x,
                    cfg.o, cfg.e,
                    int(cfg.alignment_type == AlignmentType.GLOBAL), *sig,
                    cost.data_ptr(), steps.data_ptr(), rec.data_ptr(),
                    device.index, stream)
            if err != 0:
                raise RuntimeError(
                    f"greedy kernel launch failed: cudaError {err}")
            if B > 0:
                LAUNCHES += 1
                LIB_LAUNCHES[p.stem] += 1
        else:
            raise NotImplementedError(f"no greedy route for device {device}")

        out = dict(cost=cost, steps=steps, step_rec=rec)
        if want_cigar:
            out.update(expand_records(rec, read_len, ref_len, cfg))
        return out
