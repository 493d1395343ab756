"""LEAP through the hand-written CUDA kernel (csrc/leap.cu), the port of
`asm_tpu.kernels.leap_pallas`:

  leap_align_cuda     the wrapper, in its three modes: the penalty pass,
                      the SHD-gated SIMD_ED filter, the fused CIGAR
                      backtrack (`edit_rec`)
  leap_cigar_decode   packed edit records -> edit lists and CIGARs (numpy)
  cigar_pass_config   the CIGAR pass's record bound E from a penalty pass
  leap_cigar_auto     the two-pass CIGAR: a penalty pass, then the CIGAR
                      pass at that bound

Inputs are int8 codes [B, L] or tile-major 2-bit planes from
`greedy_cuda.stage_planes_tiled_t` (pre_staged="planes_tiled"). On a CUDA
tensor the wrapper launches the kernel on the current stream
(unsynchronised) or raises; on a CPU tensor it runs the plain version
(`kernels/leap.py`, and `leap_backtrack.leap_edit_records` for the
records). `LAUNCHES` counts launches, `LIB_LAUNCHES` them per library
stem. The library is compiled with nvcc for sm_90a at first use into
asm_tpu_torch/build/ and bound with ctypes: the tuned table (k in {2, 3,
4} x max_len in {128, 256, 512} x (x, o, e) in {(1, 1, 1), (2, 3, 1)})
in one library, any other shape in a library of its own built at its
first launch (kernels/shapes.py).

The fused CIGAR parks each pair's energy history in a per-launch global
scratch; launches are cut so that it stays within CIGAR_SCRATCH_BYTES.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import os

import numpy as np
import torch

from asm_tpu_torch.config import AlignConfig, LeapMode
from asm_tpu_torch.encoding import PAD_READ, PAD_REF
from asm_tpu_torch.kernels.greedy_cuda import check_tensor, codes_from_planes_tiled
from asm_tpu_torch.kernels.leap import check_options, leap_align
from asm_tpu_torch.kernels.leap_backtrack import edits_to_cigar, leap_edit_records
from asm_tpu_torch.kernels.shapes import LEAP_PENALTIES, Plan, leap_plan
from asm_tpu_torch.utils.build import PKG_DIR, nvcc_library, ptxas_report_path
from asm_tpu_torch.utils.profiling import span

# kernel launches since import (or since a caller reset it), in all and
# per library stem
LAUNCHES = 0
LIB_LAUNCHES = collections.Counter()

SOURCE = os.path.join(PKG_DIR, "csrc", "leap.cu")
_SEMANTICS = {"lv_bag": 0, "simd_ed_lev": 1, "simd_ed_affine": 2}
# the fused CIGAR's per-launch history scratch (pairs per launch are cut
# to fit; 1,372 B per pair at E = 48, k = 3, L = 128)
CIGAR_SCRATCH_BYTES = 1 << 30
ENERGY_BUCKET = 16
_libs = {}  # library stem -> bound library


def plan(k: int = 3, max_len: int = 128, pens=(1, 1, 1)) -> Plan:
    """The library holding the instantiations of (k, max_len, (x, o, e))."""
    return leap_plan(k, max_len, *pens)


def ptxas_report(k: int = 3, max_len: int = 128, pens=(1, 1, 1)) -> str:
    """Path of the ptxas report of the library that holds the shape
    (default: the tuned table's)."""
    return ptxas_report_path(plan(k, max_len, pens).stem, SOURCE)


def build_kernel(k: int = 3, max_len: int = 128,
                 pens=(1, 1, 1)) -> tuple[str, bool]:
    """nvcc csrc/leap.cu -> build/lib<stem>_<hash>.so (sm_90a), the
    library holding the shape (default: the tuned table,
    libleap_<hash>.so). Returns (library path, built_now)."""
    p = plan(k, max_len, pens)
    return nvcc_library(p.stem, SOURCE, p.defines)


def bind(path: str):
    """The library at `path` (a build of csrc/leap.cu), its functions
    typed for ctypes."""
    lib = ctypes.CDLL(path)
    c = ctypes
    lib.asm_leap_launch.restype = c.c_int
    lib.asm_leap_launch.argtypes = (
        [c.c_void_p] * 4 + [c.c_int] * 14 + [c.c_void_p] * 5
        + [c.c_int, c.c_void_p])
    lib.asm_leap_occupancy.restype = c.c_int
    lib.asm_leap_occupancy.argtypes = [c.c_int] * 3
    return lib


def _load(k: int = 3, max_len: int = 128, pens=(1, 1, 1)):
    """The bound library holding the shape, built at its first use."""
    p = plan(k, max_len, pens)
    if p.stem not in _libs:
        _libs[p.stem] = bind(build_kernel(k, max_len, pens)[0])
    return _libs[p.stem]


def occupancy(k: int = 3, max_len: int = 128, cigar: bool = False,
              pens=(1, 1, 1)) -> int:
    """Resident blocks per SM of the lv_bag kernel built for (k, max_len,
    pens), in CIGAR mode or not, on the current CUDA device, with the
    shared memory its launch uses
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor); each block holds
    `plan(k, max_len, pens).threads` threads (128 in the tuned table)."""
    got = _load(k, max_len, pens).asm_leap_occupancy(k, max_len // 32,
                                                     int(cigar))
    if got < 0:
        raise RuntimeError(f"LEAP occupancy query failed: cudaError {-got}")
    return got


def history_words(cfg: AlignConfig) -> int:
    """uint32 words of parked history per pair in CIGAR mode: (E+1)
    levels x 2k+1 interior lanes (on the long-row path the group's G x
    lanes-a-thread slots, padding lanes included) x 1 word (8-bit cells,
    L <= 253) or 2 (16-bit cells)."""
    cw = 2 if cfg.max_len > 253 else 1
    G = plan(cfg.k, cfg.max_len, (cfg.x, cfg.o, cfg.e)).group
    return (cfg.leap_energy_bound + 1) * -(-(2 * cfg.k + 1) // G) * G * cw


def _launch(read, read_len, ref, ref_len, cfg: AlignConfig, planes: bool,
            tile: int, semantics: str, use_shd_gate: bool, outs: tuple) -> int:
    """Launch the kernel over the batch, in pieces whose CIGAR scratch
    fits CIGAR_SCRATCH_BYTES; outs = (passed, penalty, lane_shift, edit_rec
    or None). Returns the number of launches."""
    B = read_len.shape[0]
    passed, pen, shift, rec = outs
    pens = (cfg.x, cfg.o, cfg.e)
    p = plan(cfg.k, cfg.max_len, pens)
    piece, hist = B, None
    if rec is not None:  # whole blocks of the shape's threads a piece
        piece = max(p.threads, CIGAR_SCRATCH_BYTES // (4 * history_words(cfg))
                    // p.threads * p.threads)
        hist = torch.empty((history_words(cfg), min(piece, B)),
                           dtype=torch.int32, device=read.device)
    stream = torch.cuda.current_stream(read.device).cuda_stream
    n_launches = 0
    with span("asm.leap.launch"):
        for lo in range(0, B, piece):
            # the tuned library's penalty index; a shape's own library
            # holds one penalty set and ignores it
            err = _load(cfg.k, cfg.max_len, pens).asm_leap_launch(
                read.data_ptr(), ref.data_ptr(), read_len.data_ptr(),
                ref_len.data_ptr(), min(piece, B - lo), lo, B, tile,
                int(planes), cfg.k, cfg.max_len // 32,
                LEAP_PENALTIES.index(pens) if p.tuned else 0,
                _SEMANTICS[semantics], int(use_shd_gate), int(cfg.leap_mode),
                cfg.leap_af_threshold, cfg.leap_energy_bound,
                int(rec is not None), passed.data_ptr(), pen.data_ptr(),
                shift.data_ptr(), 0 if rec is None else rec.data_ptr(),
                0 if hist is None else hist.data_ptr(), read.device.index,
                stream)
            if err != 0:
                raise RuntimeError(
                    f"LEAP kernel launch failed: cudaError {err}")
            n_launches += 1
    LIB_LAUNCHES[p.stem] += n_launches
    return n_launches


def leap_align_cuda(read, read_len, ref, ref_len, cfg: AlignConfig, *,
                    pre_staged=False, tile: int = 2048,
                    want_cigar: bool = False, semantics: str = "lv_bag",
                    use_shd_gate: bool = False,
                    rec_out: torch.Tensor | None = None) -> dict:
    """LEAP on a batch through the CUDA kernel.

    read/ref: int8 codes [B, L] (pre_staged=False), or tile-major planes
      [ceil(B / tile), L // 16, tile] of int32 / uint32 words
      (pre_staged="planes_tiled"); read_len/ref_len: int32[B].
    Returns passed bool[B], penalty and lane_shift int32[B], as
    `leap.leap_align` with the same semantics / use_shd_gate. want_cigar
    (lv_bag only) adds edit_rec int32[E+1, B], E = cfg.leap_energy_bound,
    in `leap_backtrack.leap_edit_records`' layout (decode with
    `leap_cigar_decode`); pairs must pass within E: check max(penalty *
    passed) <= E. rec_out, an int32[E+1, B] tensor on the device, is
    written in place of a new one.
    """
    global LAUNCHES
    with span("asm.leap"):
        with span("asm.leap.prep"):
            check_options(cfg, semantics, use_shd_gate, lv_bag_only=want_cigar)
            if pre_staged not in (False, "planes_tiled"):
                raise NotImplementedError(f"pre_staged={pre_staged!r}")
            L = cfg.max_len
            if L % 32:
                raise ValueError(f"max_len must be a multiple of 32, got {L}")
            W = L // 32
            E = cfg.leap_energy_bound
            device = read.device
            B = read_len.shape[0]
            planes = pre_staged == "planes_tiled"
            if planes:
                if tile <= 0 or tile % 128:
                    raise ValueError(f"tile must be a positive multiple of "
                                     f"128, got {tile}")
                code_dtypes = (torch.int32, torch.uint32)
                code_shape = (-(-B // tile), 2 * W, tile)
            else:
                code_dtypes = (torch.int8,)
                code_shape = (B, L)
            check_tensor(read, "read", code_dtypes, code_shape, device)
            check_tensor(ref, "ref", code_dtypes, code_shape, device)
            check_tensor(read_len, "read_len", (torch.int32,), (B,), device)
            check_tensor(ref_len, "ref_len", (torch.int32,), (B,), device)
            if rec_out is not None:
                if not want_cigar:
                    raise ValueError("rec_out needs want_cigar=True")
                check_tensor(rec_out, "rec_out", (torch.int32,), (E + 1, B),
                             device)
            if device.type == "cuda":
                # raises for a shape the card cannot hold
                plan(cfg.k, L, (cfg.x, cfg.o, cfg.e))
                if read.data_ptr() % 4 or ref.data_ptr() % 4:
                    raise ValueError("code rows must be 4-byte aligned")
                passed = torch.empty(B, dtype=torch.bool, device=device)
                pen = torch.empty(B, dtype=torch.int32, device=device)
                shift = torch.empty(B, dtype=torch.int32, device=device)
                rec = None
                if want_cigar:
                    rec = rec_out if rec_out is not None else torch.empty(
                        (E + 1, B), dtype=torch.int32, device=device)

        if device.type == "cpu":
            if planes:
                read = codes_from_planes_tiled(read, read_len, PAD_READ)
                ref = codes_from_planes_tiled(ref, ref_len, PAD_REF)
            out = leap_align(read, read_len, ref, ref_len, cfg,
                             want_history=want_cigar, semantics=semantics,
                             use_shd_gate=use_shd_gate)
            res = dict(passed=out["passed"], penalty=out["penalty"],
                       lane_shift=out["lane_shift"])
            if want_cigar:
                rec = torch.from_numpy(leap_edit_records(out, cfg, E))
                if rec_out is not None:
                    rec = rec_out.copy_(rec)
                res["edit_rec"] = rec
            return res
        if device.type != "cuda":
            raise NotImplementedError(f"no LEAP route for device {device}")
        if B > 0:
            LAUNCHES += _launch(read, read_len, ref, ref_len, cfg, planes,
                                tile, semantics, use_shd_gate,
                                (passed, pen, shift, rec))
        res = dict(passed=passed, penalty=pen, lane_shift=shift)
        if want_cigar:
            res["edit_rec"] = rec
        return res


_OPCHAR = np.array(["", "M", "I", "D"])


def leap_cigar_decode(result: dict, cfg: AlignConfig):
    """Decode edit records into `leap_backtrack_batch`'s format: per pair
    (edits, cigar), edits = [(op, id_length, is_open), ...] in backtrack
    order ending with the terminal ('', run, False), or None for a pair
    that did not pass. The GLOBAL / SEMI_FREE_BEGIN lane-correction gaps
    (LV_BAG.cpp:254-264) are prepended from lane_shift."""
    rec = result["edit_rec"].cpu().numpy()  # [E+1, B]
    passed = result["passed"].cpu().numpy()
    shift = result["lane_shift"].cpu().numpy()
    corrected = cfg.leap_mode in (LeapMode.GLOBAL, LeapMode.SEMI_FREE_BEGIN)
    body = rec[:0:-1].T  # [B, E]: rows E .. 1, the walk's order
    ops = _OPCHAR[body & 3].tolist()
    runs = (body >> 3).tolist()
    opens = ((body & 4) != 0).tolist()
    term = rec[0].tolist()
    out = []
    for b in range(rec.shape[1]):
        if not passed[b]:
            out.append(None)
            continue
        edits = []
        if corrected:
            d = abs(int(shift[b]))
            gap = "D" if shift[b] > 0 else "I"
            edits += [(gap, 0, i == d - 1) for i in range(d)]
        ob, rb, fb = ops[b], runs[b], opens[b]
        edits += [(ob[i], rb[i], fb[i]) for i in range(len(ob)) if ob[i]]
        edits.append(("", term[b], False))
        out.append((edits, edits_to_cigar(edits)))
    return out


def max_passed_energy(penalty, passed) -> int:
    """The largest penalty of a passed pair (an lv_bag penalty is the
    pass energy), 0 when none passed."""
    pen = torch.where(passed, penalty, torch.zeros_like(penalty))
    return int(pen.max()) if pen.numel() else 0


def energy_bound(maxe: int, af: int) -> int:
    """The CIGAR pass's record bound for a largest passed energy `maxe`:
    rounded up to a multiple of ENERGY_BUCKET (at least one), at most af;
    the bucket bounds how many record shapes a corpus needs."""
    return min(af, max(ENERGY_BUCKET, -(-maxe // ENERGY_BUCKET)
                       * ENERGY_BUCKET))


def cigar_pass_config(cfg: AlignConfig, out: dict) -> AlignConfig:
    """The CIGAR pass's configuration after a penalty pass `out` of `cfg`
    over the same pairs: its record bound E is the pass's largest passed
    energy, sized by `energy_bound`."""
    E = energy_bound(max_passed_energy(out["penalty"], out["passed"]),
                     cfg.leap_af_threshold)
    return dataclasses.replace(cfg, leap_max_energy=E)


def leap_cigar_auto(read, read_len, ref, ref_len, cfg: AlignConfig) -> dict:
    """The fused CIGAR at any af_threshold by two passes over int8 codes: a
    penalty pass sets the CIGAR pass's record bound E
    (`cigar_pass_config`). Returns the CIGAR pass's dict plus
    "energy_bound" and "cigars" (`leap_cigar_decode`)."""
    if cfg.leap_max_energy is not None:
        raise ValueError("leap_cigar_auto sizes the energy bound itself; "
                         "leave leap_max_energy unset")
    args = (read, read_len, ref, ref_len)
    ccfg = cigar_pass_config(cfg, leap_align_cuda(*args, cfg))
    out = leap_align_cuda(*args, ccfg, want_cigar=True)
    out["energy_bound"] = ccfg.leap_energy_bound
    out["cigars"] = leap_cigar_decode(out, ccfg)
    return out
