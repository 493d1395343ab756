"""Batched GASMA greedy hurdle-matrix highway alignment — the plain
PyTorch version (port of `asm_tpu.kernels.greedy.greedy_align`).

The whole batch advances in lockstep: hurdle rows [B, NL, L] are built by
shifted compare (_construct_hurdles, hurdle_matrix.h:441-455), denoised
(flip_short_hurdles), bit-packed into 32-bit words, and every step answers
the reference's tzcnt/popcount queries with masked word arithmetic over
[B, NL, W]. The reference's order-dependent lane scans
(_update_highway_list, _choose_best_highway) are replayed as loops over
the NL lanes, vectorized over the batch, with its exact tie-breaking.
Finished pairs are frozen by a done-mask until every pair converges or
cfg.steps_bound is reached.

This is the reference the CUDA kernel (`greedy_cuda.py`) is held against,
and the only route for `exact_floats` (float64 heuristic) and
`flip_threshold != 1`, which the kernel refuses. It runs on any device.
"""

from __future__ import annotations

import torch

from asm_tpu_torch.config import AlignConfig, AlignmentType
from asm_tpu_torch.ops.bitops import flip_short_hurdles
from asm_tpu_torch.ops.hurdles import (
    build_greedy_lanes,
    lane_destination,
    switch_forward_column as sfc,
    switch_lane_penalty,
)
from asm_tpu_torch.ops.packed import count_range, first_set_from, pack_rows

OP_M = 5  # greedy emits merged match-or-mismatch runs ('M')
OP_I = 3
OP_D = 4

_NEG_INF32 = -(2**31) + 1


def rec_dtype(cfg: AlignConfig) -> torch.dtype:
    """dtype of the packed step records: int16 when the fields fit (flag
    1 bit, in-loop lane delta + 64 in 7 bits, advance in 8), else int32."""
    if cfg.max_len <= 255 and 2 * cfg.k <= 62:
        return torch.int16
    return torch.int32


def pack_records(rec: torch.Tensor, cfg: AlignConfig) -> torch.Tensor:
    """int64 packed records -> rec_dtype(cfg), keeping the low bits (the
    int16 form wraps like a C cast)."""
    if rec_dtype(cfg) == torch.int16:
        rec = rec & 0xFFFF
        rec = torch.where(rec >= 0x8000, rec - 0x10000, rec)
        return rec.to(torch.int16)
    return rec.to(torch.int32)


def _pick(arr, li):
    """arr[b, li[b]] for [B, NL] arrays."""
    return torch.gather(arr, 1, li[:, None]).squeeze(1)


def _take_lane(arr, li):
    """arr[b, li[b], :] for [B, NL, W] arrays."""
    idx = li[:, None, None].expand(-1, 1, arr.shape[2])
    return torch.gather(arr, 1, idx).squeeze(1)


def greedy_align(read_codes, read_len, ref_codes, ref_len, cfg: AlignConfig,
                 records: bool = False):
    """Greedy highway alignment over a batch.

    Args:
      read_codes/ref_codes: int8[B, L] sentinel-padded 2-bit codes.
      read_len/ref_len: int[B].
      cfg: AlignConfig.
      records: also return `step_rec`, the packed step records in the
        CUDA kernel's layout (see greedy_cuda), equal to the kernel's.

    Returns dict with:
      cost: int32[B] total penalty (hurdle_matrix.h get_cost :677)
      cigar_ops / cigar_runs: int8 / int32 [B, 2T+2] (op, run) slots —
        slot 2t the step's leap (I/D), 2t+1 its 'M' run, the final leap
        in the last two; slots with run 0 are empty
      cigar_count: int32[B] non-empty slots
      steps: int32[B] highway steps taken
      trips: int32[B] trips of the step loop the pair ran: its steps, plus
        one where the walk stopped on an empty highway
      final_lane / final_col: int32[B] cursor before the final leap
    """
    B, L = read_codes.shape
    dev = read_codes.device
    k = cfg.k
    NL = cfg.num_lanes
    x, o, e = cfg.x, cfg.o, cfg.e
    is_global = cfg.alignment_type == AlignmentType.GLOBAL
    fdt = torch.float64 if cfg.exact_floats else torch.float32
    # the constants rounded to the heuristic's float type first, as a
    # weak-typed Python float multiplies a float32 array in JAX
    match_sig, mismatch_sig, indel_sig = (
        torch.tensor(s, dtype=fdt, device=dev) for s in cfg.significance)
    i64 = torch.int64

    def slp(l1, l2):
        return switch_lane_penalty(l1, l2, o, e)

    m = read_len.to(dev, i64).clamp(max=L)
    n = ref_len.to(dev, i64).clamp(max=L)
    lanes = torch.arange(-k, k + 1, dtype=i64, device=dev)  # [NL]
    lane_ids = torch.arange(NL, dtype=i64, device=dev)

    # setup: hurdle rows, denoise, pack
    orig_b = build_greedy_lanes(read_codes, ref_codes, k) != 0  # [B, NL, L]
    den_b = flip_short_hurdles(orig_b.to(torch.int8), cfg.flip_threshold) != 0
    orig = pack_rows(orig_b)  # [B, NL, W]
    den = pack_rows(den_b)
    den_zero = pack_rows(~den_b)

    dest = lane_destination(m[:, None], n[:, None], lanes[None, :])  # [B, NL]
    dest_lane = n - m
    in_band = dest_lane.abs() <= k

    T = cfg.steps_bound
    zeros = torch.zeros(B, dtype=i64, device=dev)
    cur_lane, cur_col, cost, steps, iters = (zeros.clone() for _ in range(5))
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    sp = torch.full((B, NL), -1, dtype=i64, device=dev)
    hlen = torch.zeros((B, NL), dtype=i64, device=dev)
    nsw = torch.full((B, NL), L, dtype=i64, device=dev)
    step_dl = torch.zeros((T, B), dtype=i64, device=dev)
    step_dist = torch.zeros((T, B), dtype=i64, device=dev)
    rec = torch.zeros((T + 1, B), dtype=i64, device=dev)

    it = 0
    while it < T and not bool(done.all()):
        act = ~done

        # ---- _update_highway_list (hurdle_matrix.h:285-362) ----
        start_col = cur_col[:, None] + sfc(cur_lane[:, None], lanes[None, :])
        recomp = (sp < start_col) & act[:, None]
        fz = first_set_from(den_zero, start_col)
        sp_new = torch.where(start_col > L, start_col, fz)
        no_g = first_set_from(den, sp_new)
        # register-width semantics: an empty scan returns L
        raw_len = torch.where((sp_new >= L) | (no_g >= L),
                              torch.full_like(no_g, L), no_g - sp_new)
        clamp = sp_new + raw_len > dest
        len_new = torch.where(clamp, (dest - sp_new).clamp(min=0), raw_len)
        sp = torch.where(recomp, sp_new, sp)
        hlen = torch.where(recomp, len_new, hlen)
        nsw = torch.where(recomp, (lanes[None, :] - cur_lane[:, None]).abs(),
                          nsw)
        reaching = (recomp & clamp).any(dim=1)

        swc = slp(cur_lane[:, None], lanes[None, :])
        if not is_global and it == 0:
            swc = torch.zeros_like(swc)
        nhur = count_range(orig, start_col, sp + hlen)  # [B, NL]
        hc = x * nhur

        # ---- selection scan (hurdle_matrix.h:325-352) ----
        sig = (match_sig * hlen.to(fdt)
               + mismatch_sig * nhur.to(fdt)) + indel_sig * nsw.to(fdt)
        fsc = (slp(lanes[None, :], dest_lane[:, None]) if is_global
               else torch.zeros_like(swc))
        h_reach = (-(swc + hc) - fsc - x * (dest - sp - hlen)).to(fdt)
        h_all = torch.where(reaching[:, None], h_reach, sig)
        lh_all = -swc - torch.where(reaching[:, None], fsc,
                                    torch.zeros_like(fsc))

        best_h = torch.full((B,), -float("inf"), dtype=fdt, device=dev)
        best_lh = torch.full((B,), _NEG_INF32, dtype=i64, device=dev)
        best_li = zeros.clone()
        for li in range(NL):
            h = h_all[:, li]
            lh = lh_all[:, li]
            better = (h > best_h) | ((h == best_h) & (lh > best_lh))
            best_h = torch.where(better, h, best_h)
            best_lh = torch.where(better, lh, best_lh)
            best_li = torch.where(better, li, best_li)
        valid = _pick(hlen, best_li) > 0  # else: stop without a step

        # ---- _choose_best_highway (hurdle_matrix.h:368-401) ----
        best_lane_v = best_li - k
        sp_b = _pick(sp, best_li)
        row_b = _take_lane(orig, best_li)[:, None, :]  # [B, 1, W]
        # the reference adds the RAW popcount here (hurdle_matrix.h:389);
        # its window [start_col, sp + hlen) is exactly nhur's
        ic_all = swc + nhur
        fwd_lb = sfc(lanes[None, :], best_lane_v[:, None])
        cross = count_range(row_b, fwd_lb + sp + hlen, sp_b[:, None])
        tc_all = (ic_all + slp(lanes[None, :], best_lane_v[:, None])
                  + (x * cross).clamp(min=0))
        skip_all = ((lane_ids[None, :] == best_li[:, None])
                    | (sp + fwd_lb > sp_b[:, None]))
        stc = _pick(swc, best_li) + _pick(hc, best_li)
        sic = stc
        bil = best_li
        for li in range(NL):
            tc = tc_all[:, li]
            ic = ic_all[:, li]
            upd = ~skip_all[:, li] & (tc <= stc) & (ic <= sic)
            stc = torch.where(upd, tc, stc)
            sic = torch.where(upd, ic, sic)
            bil = torch.where(upd, li, bil)

        # ---- commit the step (_step, hurdle_matrix.h:407-434) ----
        bl_lane = bil - k
        sp_c = _pick(sp, bil)
        len_c = _pick(hlen, bil)
        move = act & valid
        cost = cost + torch.where(move, _pick(swc, bil) + _pick(hc, bil), 0)
        distance = sp_c + len_c - (cur_col + sfc(cur_lane, bl_lane))
        dl = bl_lane - cur_lane
        step_dl[it] = torch.where(move, dl, 0)
        step_dist[it] = torch.where(move, distance, 0)
        # kernel record: bit 0 final-leap flag (0 here), bits 1-7 the lane
        # delta + 64, bits 8+ the match advance
        rec[it] = torch.where(move, ((dl + 64) << 1) | (distance << 8), 0)

        new_lane = torch.where(move, bl_lane, cur_lane)
        new_col = torch.where(move, sp_c + len_c, cur_col)
        dest_new = _pick(dest, new_lane + k)
        done = done | (act & ~valid) | (move & (new_col >= dest_new))
        cur_lane, cur_col = new_lane, new_col
        steps = steps + move.to(i64)
        iters = iters + act.to(i64)
        it += 1

    # ---- final leap to the destination (run(), hurdle_matrix.h:574-590) ----
    dl_c = dest_lane.clamp(-k, k)
    dest_col = _pick(dest, dl_c + k)
    row_dl = _take_lane(orig, dl_c + k)  # [B, W]
    lo = cur_col + sfc(cur_lane, dest_lane)
    distance = count_range(row_dl, lo, dest_col)
    distance = torch.where(in_band, distance, 0)  # out-of-band: stale dest
    moved_off = cur_lane != dest_lane
    needs = torch.where(in_band, moved_off | (cur_col < dest_col), moved_off)
    sc = slp(cur_lane, dest_lane) if is_global else 0
    cost = cost + torch.where(needs, sc + (x * distance).clamp(min=0), 0)

    dl = dest_lane - cur_lane
    leap_run_f = torch.where(needs & (dl != 0), dl.abs(), 0)
    m_run_f = torch.where(needs & (distance > 0), distance, 0)

    # ---- (op, run) slots: 2t the leap (I if it moved down a lane, else
    # D), 2t+1 the merged 'M' run; the final leap takes the last two ----
    sdl = step_dl.T
    ops_steps = torch.stack(
        [torch.where(sdl < 0, OP_I, OP_D), torch.full_like(sdl, OP_M)],
        dim=2).reshape(B, 2 * T)
    runs_steps = torch.stack([sdl.abs(), step_dist.T], dim=2).reshape(B, 2 * T)
    op_leap_f = torch.where(dl < 0, OP_I, OP_D)
    ops_ = torch.cat([ops_steps, op_leap_f[:, None],
                      torch.full_like(op_leap_f[:, None], OP_M)], dim=1)
    runs_ = torch.cat([runs_steps, leap_run_f[:, None], m_run_f[:, None]],
                      dim=1)

    out = dict(
        cost=cost.to(torch.int32),
        cigar_ops=ops_.to(torch.int8),
        cigar_runs=runs_.to(torch.int32),
        cigar_count=(runs_ > 0).sum(dim=1, dtype=torch.int32),
        steps=steps.to(torch.int32),
        trips=iters.to(torch.int32),
        final_lane=cur_lane.to(torch.int32),
        final_col=cur_col.to(torch.int32),
    )
    if records:
        # the kernel exits per pair, so its final-leap record lands at the
        # pair's own trip count (iterations it was active)
        final = torch.where(needs, 1 | (distance.clamp(min=0) << 8), 0)
        rec.scatter_(0, iters[None, :], final[None, :])
        out["step_rec"] = pack_records(rec, cfg)
    return out
