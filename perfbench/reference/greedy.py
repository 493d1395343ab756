"""Plain GASMA greedy hurdle-matrix alignment, the reference of the
`greedy` job: cost and steps of each pair (GASMA/hurdle_matrix.h).

A frozen, self-contained copy of the port's plain version: the batch
advances in lockstep over bit-packed hurdle rows [B, 2k+1, L/32] (32-bit
words held in int64), the reference's order-dependent lane scans replayed
as loops over the lanes with its tie-breaking. Only GLOBAL alignment and
flip threshold 1 (the reference's value) are kept. `float_dtype` is the
type of the significance heuristic: the configuration's `heuristic_float`;
a lower one is the control of a run (PERF.md), never the reference.

Codes: int8 [B, L], 0-3 the bases, PAD_READ (4) past a read's length and
PAD_REF (5) past a reference's; lanes shifted past either end take
PAD_SHIFT (6), so every such position is a hurdle.

Imports torch only.
"""

from __future__ import annotations

import math

import torch

PAD_SHIFT = 6
FULL = 0xFFFFFFFF
_NEG_INF32 = -(2**31) + 1


# ---- bit-packed rows --------------------------------------------------------

def _pack(rows: torch.Tensor) -> torch.Tensor:
    """bool[..., L] -> int64[..., L/32] words, bit p of word w = 32w + p."""
    W = rows.shape[-1] // 32
    b = rows.to(torch.int64).reshape(rows.shape[:-1] + (W, 32))
    weights = torch.ones(32, dtype=torch.int64, device=b.device) << \
        torch.arange(32, device=b.device)
    return (b * weights).sum(dim=-1)


def _mask_ge(c: torch.Tensor, W: int) -> torch.Tensor:
    starts = 32 * torch.arange(W, dtype=torch.int64, device=c.device)
    low = (c.to(torch.int64)[..., None] - starts).clamp(0, 32)
    shifted = (FULL << low.clamp(max=31)) & FULL
    return torch.where(low >= 32, torch.zeros_like(shifted), shifted)


def _popcount(w: torch.Tensor) -> torch.Tensor:
    w = w - ((w >> 1) & 0x55555555)
    w = (w & 0x33333333) + ((w >> 2) & 0x33333333)
    w = (w + (w >> 4)) & 0x0F0F0F0F
    return ((w * 0x01010101) & FULL) >> 24


def _first_set_from(packed: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """First position >= c holding a set bit, else L (tzcnt of an empty
    register returns its width)."""
    W = packed.shape[-1]
    masked = packed & _mask_ge(c, W)
    low = masked & -masked
    starts = 32 * torch.arange(W, dtype=torch.int64, device=packed.device)
    idx = starts + _popcount((low - 1) & FULL)
    idx = torch.where(masked == 0, torch.full_like(idx, 32 * W), idx)
    return idx.min(dim=-1).values


def _count_range(packed: torch.Tensor, lo, hi) -> torch.Tensor:
    """Set bits at positions [lo, hi); an inverted window counts 0."""
    W = packed.shape[-1]
    m = _mask_ge(lo, W) & (_mask_ge(hi, W) ^ FULL)
    return _popcount(packed & m).sum(dim=-1)


# ---- lane geometry (GASMA/utils.h, hurdle_matrix.h) ---------------------------

def _switch_penalty(l1, l2, o: int, e: int):
    d = torch.abs(l1 - l2)
    return torch.where(d == 0, torch.zeros_like(d), o + e * (d - 1))


def _forward_column(l1, l2):
    a1, a2 = torch.abs(l1), torch.abs(l2)
    return torch.where(l1 * l2 >= 0, torch.clamp(a1 - a2, min=0), a1)


def _destination(m, n, lane):
    m, n, lane = torch.broadcast_tensors(m, n, lane)
    dest_ge = torch.where(lane > 0, n - lane,
                          torch.where(lane >= n - m, n, m + lane))
    dest_lt = torch.where(lane < 0, m + lane,
                          torch.where(lane <= n - m, m, n - lane))
    return torch.where(m >= n, dest_ge, dest_lt)


def _shift_toward_0(x: torch.Tensor, s: int, fill: int) -> torch.Tensor:
    """out[p] = x[p + s], `fill` past the end."""
    if s == 0:
        return x
    pad = torch.full(x.shape[:-1] + (s,), fill, dtype=x.dtype, device=x.device)
    return torch.cat([x[..., s:], pad], dim=-1)


def _shift_away_0(x: torch.Tensor, s: int, fill: int = 0) -> torch.Tensor:
    """out[p] = x[p - s], `fill` before 0."""
    if s == 0:
        return x
    pad = torch.full(x.shape[:-1] + (s,), fill, dtype=x.dtype, device=x.device)
    return torch.cat([pad, x[..., :-s]], dim=-1)


def _hurdle_rows(read, ref, k: int) -> torch.Tensor:
    """bool[B, 2k+1, L]: lane s >= 0 compares read[c] with ref[c + s],
    lane s < 0 read[c - s] with ref[c] (_construct_hurdles)."""
    rows = []
    for lane in range(-k, k + 1):
        if lane < 0:
            a, b = _shift_toward_0(read, -lane, PAD_SHIFT), ref
        else:
            a, b = read, _shift_toward_0(ref, lane, PAD_SHIFT)
        rows.append(a != b)
    return torch.stack(rows, dim=-2)


def _denoise(h: torch.Tensor) -> torch.Tensor:
    """flip_short_hurdles at threshold 1: a hurdle survives only beside
    another."""
    return h & (_shift_toward_0(h, 1, 0) | _shift_away_0(h, 1))


def _pick(arr, li):
    return torch.gather(arr, 1, li[:, None]).squeeze(1)


def _take_lane(arr, li):
    idx = li[:, None, None].expand(-1, 1, arr.shape[2])
    return torch.gather(arr, 1, idx).squeeze(1)


def significance(match_prob=0.80, mismatch_prob=0.20 / 3,
                 indel_prob=0.40 / 3) -> tuple[float, float, float]:
    """(match, mismatch, indel) significance (hurdle_matrix.h:536-538)."""
    return (math.log(match_prob / 0.25), math.log(mismatch_prob / 0.25),
            math.log(indel_prob / 2 / 0.25))


def align(read, read_len, ref, ref_len, *, x=1, o=1, e=1, k=3,
          max_steps=None, float_dtype=torch.float32) -> dict:
    """cost and steps int32[B] of GLOBAL greedy alignment of int8 code rows
    read/ref [B, L] (L a multiple of 32) with int32 lengths; max_steps
    bounds the walk (default L)."""
    B, L = read.shape
    dev = read.device
    NL = 2 * k + 1
    fdt = float_dtype
    match_sig, mismatch_sig, indel_sig = (
        torch.tensor(s, dtype=fdt, device=dev) for s in significance())
    i64 = torch.int64

    def slp(l1, l2):
        return _switch_penalty(l1, l2, o, e)

    m = read_len.to(dev, i64).clamp(max=L)
    n = ref_len.to(dev, i64).clamp(max=L)
    lanes = torch.arange(-k, k + 1, dtype=i64, device=dev)
    lane_ids = torch.arange(NL, dtype=i64, device=dev)

    orig_b = _hurdle_rows(read, ref, k)
    den_b = _denoise(orig_b)
    orig, den, den_zero = _pack(orig_b), _pack(den_b), _pack(~den_b)
    del orig_b, den_b

    dest = _destination(m[:, None], n[:, None], lanes[None, :])
    dest_lane = n - m
    in_band = dest_lane.abs() <= k

    T = L if max_steps is None else max_steps
    zeros = torch.zeros(B, dtype=i64, device=dev)
    cur_lane, cur_col, cost, steps = (zeros.clone() for _ in range(4))
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    sp = torch.full((B, NL), -1, dtype=i64, device=dev)
    hlen = torch.zeros((B, NL), dtype=i64, device=dev)
    nsw = torch.full((B, NL), L, dtype=i64, device=dev)

    it = 0
    while it < T and not bool(done.all()):
        act = ~done
        # _update_highway_list (hurdle_matrix.h:285-362)
        start_col = cur_col[:, None] + _forward_column(cur_lane[:, None],
                                                       lanes[None, :])
        recomp = (sp < start_col) & act[:, None]
        fz = _first_set_from(den_zero, start_col)
        sp_new = torch.where(start_col > L, start_col, fz)
        no_g = _first_set_from(den, sp_new)
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
        nhur = _count_range(orig, start_col, sp + hlen)
        hc = x * nhur

        # selection scan (hurdle_matrix.h:325-352)
        sig = (match_sig * hlen.to(fdt)
               + mismatch_sig * nhur.to(fdt)) + indel_sig * nsw.to(fdt)
        fsc = slp(lanes[None, :], dest_lane[:, None])
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
        valid = _pick(hlen, best_li) > 0

        # _choose_best_highway (hurdle_matrix.h:368-401)
        best_lane_v = best_li - k
        sp_b = _pick(sp, best_li)
        row_b = _take_lane(orig, best_li)[:, None, :]
        ic_all = swc + nhur
        fwd_lb = _forward_column(lanes[None, :], best_lane_v[:, None])
        cross = _count_range(row_b, fwd_lb + sp + hlen, sp_b[:, None])
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

        # _step (hurdle_matrix.h:407-434)
        bl_lane = bil - k
        sp_c = _pick(sp, bil)
        len_c = _pick(hlen, bil)
        move = act & valid
        cost = cost + torch.where(move, _pick(swc, bil) + _pick(hc, bil), 0)
        new_lane = torch.where(move, bl_lane, cur_lane)
        new_col = torch.where(move, sp_c + len_c, cur_col)
        dest_new = _pick(dest, new_lane + k)
        done = done | (act & ~valid) | (move & (new_col >= dest_new))
        cur_lane, cur_col = new_lane, new_col
        steps = steps + move.to(i64)
        it += 1

    # the final leap to the destination (hurdle_matrix.h:574-590)
    dl_c = dest_lane.clamp(-k, k)
    dest_col = _pick(dest, dl_c + k)
    row_dl = _take_lane(orig, dl_c + k)
    lo = cur_col + _forward_column(cur_lane, dest_lane)
    distance = _count_range(row_dl, lo, dest_col)
    distance = torch.where(in_band, distance, 0)
    moved_off = cur_lane != dest_lane
    needs = torch.where(in_band, moved_off | (cur_col < dest_col), moved_off)
    cost = cost + torch.where(
        needs, slp(cur_lane, dest_lane) + (x * distance).clamp(min=0), 0)
    return dict(cost=cost.to(torch.int32), steps=steps.to(torch.int32))


# the type of the significance heuristic a configuration may state, and
# the nearest one below it (the control's)
FLOATS = {"float64": (torch.float64, torch.float32),
          "float32": (torch.float32, torch.bfloat16)}


def float_types(config: dict) -> tuple[torch.dtype, torch.dtype]:
    """(stated, one below) for the configuration's `heuristic_float`."""
    name = config["heuristic_float"]
    if name not in FLOATS:
        raise ValueError(f"heuristic_float must be one of {sorted(FLOATS)}, "
                         f"got {name!r}")
    return FLOATS[name]


def reference(read, read_len, ref, ref_len, config: dict) -> dict:
    """The answers the configuration states: the heuristic in the type of
    its `heuristic_float`."""
    return align(read, read_len, ref, ref_len, x=config["x"], o=config["o"],
                 e=config["e"], k=config["k"], max_steps=config["max_steps"],
                 float_dtype=float_types(config)[0])


def control(read, read_len, ref, ref_len, config: dict) -> dict:
    """The reference one precision down: the heuristic in the type below
    the stated one (bfloat16 for float32)."""
    return align(read, read_len, ref, ref_len, x=config["x"], o=config["o"],
                 e=config["e"], k=config["k"], max_steps=config["max_steps"],
                 float_dtype=float_types(config)[1])
