"""Batched LEAP / Landau-Vishkin banded affine alignment — the plain
PyTorch version (port of `asm_tpu.kernels.leap.leap_align`).

Mirrors the reference's LV kernel (GASMA/benchmark/LEAP_SIMD/LV_BAG.cpp)
and SIMD_ED's two runs (SIMD_ED.cpp:269-353, 488-616). The wavefront
state start/end/I_pos/D_pos is [B, TL] per energy level e (TL = 2k+3
lanes, two of them sentinel borders, LV_BAG.cpp:78); one loop iteration
advances every pair one energy level. Lane shifts replace the l±1 reads,
and count_ID_length (LV_BAG.cpp:9-23) is a first-set-bit query on the
bit-packed hurdle rows. A ring of the last R = max(o, e, x)+1 levels
holds what the recurrence reads; want_history=True keeps every level for
`leap_backtrack`.

This is the reference the CUDA kernel (`leap_cuda.py`) is held against;
it runs on any device.
"""

from __future__ import annotations

import torch

from asm_tpu_torch.config import AlignConfig, LeapMode
from asm_tpu_torch.kernels.shd import shd_gate_masks
from asm_tpu_torch.ops.hurdles import build_leap_lanes
from asm_tpu_torch.ops.packed import first_set_from, pack_rows

UNREACHED = -2
BIG = 1 << 29
SEMANTICS = ("lv_bag", "simd_ed_lev", "simd_ed_affine")


def check_options(cfg: AlignConfig, semantics: str, use_shd_gate: bool,
                  lv_bag_only: bool = False) -> None:
    """Raise on a combination the reference does not define.

    simd_ed_lev is init_levenshtein(ED_t): unit penalties and af == k; the
    SHD gate exists for it alone (the affine gate is undefined behaviour,
    SIMD_ED.cpp:489); histories and CIGARs mirror LV_BAG (lv_bag_only)."""
    if semantics not in SEMANTICS:
        raise ValueError(f"semantics must be one of {SEMANTICS}, got "
                         f"{semantics!r}")
    if lv_bag_only and semantics != "lv_bag":
        raise ValueError("histories and CIGARs mirror LV_BAG; SIMD_ED CIGARs "
                         "come from its scalar reference")
    if semantics == "simd_ed_lev" and ((cfg.x, cfg.o, cfg.e) != (1, 1, 1)
                                       or cfg.leap_af_threshold != cfg.k):
        raise ValueError("simd_ed_lev is init_levenshtein(ED_t): unit "
                         "penalties and leap_af_threshold == k")
    if use_shd_gate and semantics != "simd_ed_lev":
        raise ValueError("the reference gates run_levenshtein only")


def e0_penalties(cfg: AlignConfig, semantics: str) -> tuple[int, int]:
    """(penalty of an e = 0 convergence, penalty of a pair that never
    stops). An e = 0 convergence bypasses every correction, so all
    semantics pass it; a fresh SIMD_ED reports its reset values."""
    corrected = cfg.leap_mode in (LeapMode.GLOBAL, LeapMode.SEMI_FREE_BEGIN)
    if semantics == "simd_ed_affine" and corrected:
        return 1000000, 1000000  # reset_affine converge_ED
    if corrected or semantics == "lv_bag":
        return 0, cfg.leap_af_threshold + 1
    return 0, 0  # a fresh SIMD_ED's final_ED in LOCAL / SEMI_FREE_END


def shd_gate(read_codes, ref_codes, buflen, k: int) -> torch.Tensor:
    """The in-run SHD gate of SIMD_ED::run_levenshtein (SIMD_ED.cpp:270 ->
    SHD.cpp:335-385) on the pair's 2k+1 interior lane masks, bool[B].

    As in the reference, which zero-pads the shorter string to the buffer
    length, a position past a string's end compares as code 0 ('A'), as
    `asm_tpu.kernels.leap` does (the Pallas kernel counts it a hurdle
    instead). The error==0 lane's out-of-bounds BEG row has bit 255 clear
    (shd_ref.DEFAULT_OOB_ROW), which matters at L = 256 for a 256-long
    buffer only: cleared here as the Pallas kernel does (the XLA path
    keeps it)."""
    L = read_codes.shape[1]
    rc0 = torch.where(read_codes < 4, read_codes, 0).to(read_codes.dtype)
    fc0 = torch.where(ref_codes < 4, ref_codes, 0).to(ref_codes.dtype)
    lanes = build_leap_lanes(rc0, fc0, k)[:, 1:-1, :]
    if L == 256:
        lanes[:, k, 255] = 0
    return shd_gate_masks(lanes, buflen, k)


def _last(mask: torch.Tensor) -> torch.Tensor:
    """Index of the last True along dim 1 (0 where none)."""
    n = mask.shape[1]
    first_rev = torch.argmax(torch.flip(mask, dims=(1,)).to(torch.int8), dim=1)
    return (n - 1 - first_rev).to(torch.int32)


def _first(mask: torch.Tensor) -> torch.Tensor:
    return torch.argmax(mask.to(torch.int8), dim=1).to(torch.int32)


def leap_align(read_codes, read_len, ref_codes, ref_len, cfg: AlignConfig,
               want_history: bool = False, semantics: str = "lv_bag",
               use_shd_gate: bool = False, want_levels: bool = False) -> dict:
    """LEAP on a batch of int8 codes [B, L] with int32 lengths [B].

    Returns passed bool[B], penalty int32[B] and lane_shift int32[B] (the
    final lane minus mid). With want_history also the per-level tables
    start / end / i_pos / d_pos int32[B, af+1, TL] and final_lane_idx, the
    input of `leap_backtrack`.

    semantics, as in the JAX function:
      * "lv_bag": LV_BAG.cpp. GLOBAL / SEMI_FREE_BEGIN take the least
        corrected energy among lanes converging at one e (ties to the
        first lane) and report the uncorrected e; other modes take the
        last converged lane.
      * "simd_ed_lev": SIMD_ED::run_levenshtein. The run stops at the
        first converged lane of SIMD_ED's scan order, which is mirrored
        against this lane axis (our last), and GLOBAL / SEMI_FREE_BEGIN
        report e + |lane - mid|, passing iff that is <= k.
      * "simd_ed_affine": SIMD_ED::run_affine. As lv_bag, but ties keep
        our last lane and the corrected converge_ED is reported.
    use_shd_gate (simd_ed_lev only): the in-run SHD gate; a gated-out
    pair stops before e = 0 with passed False, penalty 0.
    want_levels adds levels int32[B]: the energy levels past e = 0 each
    pair ran before it stopped (what `utils.bounds.leap_levels` reads from
    the outputs).
    """
    check_options(cfg, semantics, use_shd_gate, lv_bag_only=want_history)
    B, L = read_codes.shape
    dev = read_codes.device
    k = cfg.k
    TL = cfg.leap_total_lanes
    mid = k + 1
    ms, go, ge = cfg.x, cfg.o, cfg.e
    af = cfg.leap_af_threshold
    mode = cfg.leap_mode
    corrected = mode in (LeapMode.GLOBAL, LeapMode.SEMI_FREE_BEGIN)
    R = (af + 1) if want_history else max(go, ge, ms) + 1

    i32 = dict(dtype=torch.int32, device=dev)
    buflen = torch.maximum(read_len.to(torch.int32).clamp(max=L),
                           ref_len.to(torch.int32).clamp(max=L))[:, None]
    lanes = pack_rows(build_leap_lanes(read_codes, ref_codes, k) != 0)

    lane_ids = torch.arange(TL, **i32)
    interior = ((lane_ids >= 1) & (lane_ids <= TL - 2))[None, :]
    top = (lane_ids >= mid).to(torch.int32)[None, :]  # LV_BAG.cpp:153-157
    bot = (lane_ids <= mid).to(torch.int32)[None, :]
    lane_diff = (lane_ids - mid).abs()
    unreached = torch.full((B, TL), UNREACHED, **i32)

    def count_id(start):  # LV_BAG.cpp:9-23 as a first-mismatch query
        g = first_set_from(lanes, start.clamp(min=0)).to(torch.int32)
        return torch.where(start >= buflen, start, torch.minimum(g, buflen))

    def reached(v, out):
        return torch.where(v >= 0, out, unreached)

    # ---- e = 0 row (LV::init :95-105 + LV::run :131-147) ----
    if mode in (LeapMode.LOCAL, LeapMode.SEMI_FREE_BEGIN):
        start0 = lane_diff[None, :].expand(B, TL)
    else:
        start0 = torch.where(lane_diff == 0, 0, UNREACHED).to(
            torch.int32)[None, :].expand(B, TL)
    start0 = torch.where(interior, start0, unreached)
    end0 = reached(start0, count_id(start0))
    conv0 = (end0 == buflen) & (start0 >= 0) & interior
    conv0_any = conv0.any(dim=1)
    lane0 = _first(conv0) if semantics == "lv_bag" else _last(conv0)

    pen0, default_pen = e0_penalties(cfg, semantics)
    passed = conv0_any
    stop = conv0_any
    final_ed = torch.where(conv0_any, pen0, default_pen).to(torch.int32)
    if use_shd_gate:
        # the reference gates BEFORE the e = 0 row (SIMD_ED.cpp:270)
        gate_ok = shd_gate(read_codes, ref_codes, buflen[:, 0], k)
        passed = passed & gate_ok
        stop = stop | ~gate_ok
        final_ed = torch.where(gate_ok, final_ed, 0).to(torch.int32)
    final_lane = torch.where(conv0_any, lane0, mid).to(torch.int32)

    # ring rows: slot r holds energy level e with e % R == r
    end_h = [end0] + [unreached] * (R - 1)
    i_h = [unreached] * R
    d_h = [unreached] * R
    start_h = [start0] + [unreached] * (R - 1)

    def shift_up(a):  # value at lane l-1 (sentinel at l = 0)
        return torch.cat([unreached[:, :1], a[:, :-1]], dim=1)

    def shift_dn(a):  # value at lane l+1
        return torch.cat([a[:, 1:], unreached[:, :1]], dim=1)

    levels = torch.zeros(B, **i32)
    e = 1
    while e <= af and not bool(stop.all()):
        end_go = end_h[(e - go) % R] if e >= go else unreached
        i_ge = i_h[(e - ge) % R] if e >= ge else unreached
        d_ge = d_h[(e - ge) % R] if e >= ge else unreached
        end_ms = end_h[(e - ms) % R] if e >= ms else unreached

        end_up, i_up = shift_up(end_go), shift_up(i_ge)
        i_new = torch.where((end_up >= 0) & (end_up > i_up), end_up + top,
                            reached(i_up, i_up + top))
        end_dn, d_dn = shift_dn(end_go), shift_dn(d_ge)
        d_new = torch.where((end_dn >= 0) & (end_dn > d_dn), end_dn + bot,
                            reached(d_dn, d_dn + bot))
        s_ms = reached(end_ms, end_ms + 1)
        start_new = torch.maximum(s_ms, torch.maximum(i_new, d_new))
        # border lanes are never written (LV_BAG.cpp:131 loops 1..TL-2)
        i_new = torch.where(interior, i_new, unreached)
        d_new = torch.where(interior, d_new, unreached)
        start_new = torch.where(interior, start_new, unreached)
        end_new = reached(start_new, count_id(start_new))

        conv = (end_new == buflen) & (start_new >= 0) & interior
        if semantics == "simd_ed_lev":
            # run_levenshtein stops at its first converged lane (our last)
            # whether or not the converge correction passes it
            # (SIMD_ED.cpp:333-352)
            stop_now = conv.any(dim=1)
            lane_now = _last(conv)
            if corrected:
                pen_now = e + lane_diff[lane_now.long()]  # converge_ED
                pass_now = stop_now & (pen_now <= af)
            else:
                pen_now = torch.full_like(lane_now, e)
                pass_now = stop_now
        elif corrected:
            t = e + torch.where(lane_diff == 0, 0, go + (lane_diff - 1) * ge)
            tt = torch.where(conv & (t[None, :] <= af), t[None, :], BIG)
            tmin = tt.min(dim=1).values
            pass_now = tmin < BIG
            stop_now = pass_now
            if semantics == "simd_ed_affine":
                # strict `t < converge_ED` keeps the earliest lane of
                # SIMD_ED's scan order on ties (SIMD_ED.cpp:596): our last
                lane_now = _last(tt == tmin[:, None])
                pen_now = tmin
            else:
                lane_now = _first(tt == tmin[:, None])
                # LV_BAG reports the uncorrected energy
                pen_now = torch.full_like(lane_now, e)
        else:
            pass_now = conv.any(dim=1)
            stop_now = pass_now
            # LV_BAG.cpp:233-237 overwrites per lane: the last one wins
            lane_now = _last(conv)
            pen_now = torch.full_like(lane_now, e)

        act = ~stop
        levels += act.to(torch.int32)
        fresh = stop_now & act
        passed = passed | (pass_now & act)
        final_ed = torch.where(fresh, pen_now, final_ed).to(torch.int32)
        final_lane = torch.where(fresh, lane_now, final_lane)
        stop = stop | stop_now

        # rows of stopped pairs are frozen (they stop evolving)
        r = e % R
        keep = act[:, None]
        end_h[r] = torch.where(keep, end_new, end_h[r])
        i_h[r] = torch.where(keep, i_new, i_h[r])
        d_h[r] = torch.where(keep, d_new, d_h[r])
        if want_history:
            start_h[r] = torch.where(keep, start_new, start_h[r])
        e += 1

    out = dict(passed=passed, penalty=final_ed, lane_shift=final_lane - mid)
    if want_levels:
        out["levels"] = levels
    if want_history:
        out.update(start=torch.stack(start_h, dim=1),
                   end=torch.stack(end_h, dim=1),
                   i_pos=torch.stack(i_h, dim=1),
                   d_pos=torch.stack(d_h, dim=1),
                   final_lane_idx=final_lane)
    return out
