"""Plain LEAP (Landau-Vishkin over 2k+3 lanes, LV_BAG semantics), the
reference of the `leap` job: passed, penalty and lane_shift of each pair
(GASMA/benchmark/LEAP_SIMD/LV_BAG.cpp).

A frozen, self-contained copy of the port's plain version, kept to what
the benchmark's configurations state: lv_bag in GLOBAL mode. The
wavefront state is [B, 2k+3] per energy level e, two lanes of it sentinel
borders; one loop iteration advances every pair one level; a ring of the
last max(x, o, e) + 1 levels holds what the recurrence reads;
count_ID_length (LV_BAG.cpp:9-23) is a first-set-bit query on the
bit-packed hurdle rows. At each level a pair takes the least corrected
energy e + (the gap to the middle lane) among its converged lanes, ties
to the first lane, passes if it is at most af, and reports the
uncorrected e; a pair that never passes reports af + 1.

Imports torch only.
"""

from __future__ import annotations

import torch

from perfbench.reference.greedy import PAD_SHIFT, _first_set_from, _pack, _shift_away_0

UNREACHED = -2
BIG = 1 << 29


def _lane_rows(read, ref, k: int) -> torch.Tensor:
    """bool[B, 2k+3, L]: lane l < mid compares read[p - (mid - l)] with
    ref[p], lane l > mid read[p] with ref[p - (l - mid)], mid = k + 1;
    the two border lanes are all hurdles."""
    mid = k + 1
    rows = []
    for lane in range(2 * k + 3):
        if lane in (0, 2 * k + 2):
            rows.append(torch.ones_like(read, dtype=torch.bool))
            continue
        a = _shift_away_0(read, max(mid - lane, 0), PAD_SHIFT)
        b = _shift_away_0(ref, max(lane - mid, 0), PAD_SHIFT)
        rows.append(a != b)
    return torch.stack(rows, dim=-2)


def _first(mask: torch.Tensor) -> torch.Tensor:
    return torch.argmax(mask.to(torch.int8), dim=1).to(torch.int32)


def align(read, read_len, ref, ref_len, *, x=1, o=1, e=1, k=3,
          af=200) -> dict:
    """passed bool[B], penalty and lane_shift int32[B] of lv_bag in GLOBAL
    mode on int8 code rows read/ref [B, L] (L a multiple of 32) with
    int32 lengths."""
    B, L = read.shape
    dev = read.device
    TL = 2 * k + 3
    mid = k + 1
    ms, go, ge = x, o, e
    R = max(go, ge, ms) + 1
    i32 = dict(dtype=torch.int32, device=dev)
    buflen = torch.maximum(read_len.to(dev, torch.int32).clamp(max=L),
                           ref_len.to(dev, torch.int32).clamp(max=L))[:, None]
    lanes = _pack(_lane_rows(read, ref, k))

    lane_ids = torch.arange(TL, **i32)
    interior = ((lane_ids >= 1) & (lane_ids <= TL - 2))[None, :]
    top = (lane_ids >= mid).to(torch.int32)[None, :]
    bot = (lane_ids <= mid).to(torch.int32)[None, :]
    lane_diff = (lane_ids - mid).abs()
    unreached = torch.full((B, TL), UNREACHED, **i32)

    def count_id(start):
        g = _first_set_from(lanes, start.clamp(min=0)).to(torch.int32)
        return torch.where(start >= buflen, start, torch.minimum(g, buflen))

    def reached(v, out):
        return torch.where(v >= 0, out, unreached)

    # the e = 0 row: only the middle lane starts
    start0 = torch.where(lane_diff == 0, 0, UNREACHED).to(
        torch.int32)[None, :].expand(B, TL)
    start0 = torch.where(interior, start0, unreached)
    end0 = reached(start0, count_id(start0))
    conv0 = (end0 == buflen) & (start0 >= 0) & interior
    passed = conv0.any(dim=1)
    stop = passed.clone()
    final_ed = torch.where(passed, 0, af + 1).to(torch.int32)
    final_lane = torch.where(passed, _first(conv0), mid).to(torch.int32)

    end_h = [end0] + [unreached] * (R - 1)
    i_h = [unreached] * R
    d_h = [unreached] * R

    def shift_up(a):  # lane l reads l - 1
        return torch.cat([unreached[:, :1], a[:, :-1]], dim=1)

    def shift_dn(a):  # lane l reads l + 1
        return torch.cat([a[:, 1:], unreached[:, :1]], dim=1)

    lev = 1
    while lev <= af and not bool(stop.all()):
        end_go = end_h[(lev - go) % R] if lev >= go else unreached
        i_ge = i_h[(lev - ge) % R] if lev >= ge else unreached
        d_ge = d_h[(lev - ge) % R] if lev >= ge else unreached
        end_ms = end_h[(lev - ms) % R] if lev >= ms else unreached

        end_up, i_up = shift_up(end_go), shift_up(i_ge)
        i_new = torch.where((end_up >= 0) & (end_up > i_up), end_up + top,
                            reached(i_up, i_up + top))
        end_dn, d_dn = shift_dn(end_go), shift_dn(d_ge)
        d_new = torch.where((end_dn >= 0) & (end_dn > d_dn), end_dn + bot,
                            reached(d_dn, d_dn + bot))
        s_ms = reached(end_ms, end_ms + 1)
        start_new = torch.maximum(s_ms, torch.maximum(i_new, d_new))
        i_new = torch.where(interior, i_new, unreached)
        d_new = torch.where(interior, d_new, unreached)
        start_new = torch.where(interior, start_new, unreached)
        end_new = reached(start_new, count_id(start_new))

        conv = (end_new == buflen) & (start_new >= 0) & interior
        t = lev + torch.where(lane_diff == 0, 0, go + (lane_diff - 1) * ge)
        tt = torch.where(conv & (t[None, :] <= af), t[None, :], BIG)
        tmin = tt.min(dim=1).values
        pass_now = tmin < BIG
        lane_now = _first(tt == tmin[:, None])

        act = ~stop
        fresh = pass_now & act
        passed = passed | fresh
        final_ed = torch.where(fresh, lev, final_ed).to(torch.int32)
        final_lane = torch.where(fresh, lane_now, final_lane)
        stop = stop | pass_now

        r = lev % R
        keep = act[:, None]
        end_h[r] = torch.where(keep, end_new, end_h[r])
        i_h[r] = torch.where(keep, i_new, i_h[r])
        d_h[r] = torch.where(keep, d_new, d_h[r])
        lev += 1

    return dict(passed=passed, penalty=final_ed, lane_shift=final_lane - mid)


def reference(read, read_len, ref, ref_len, config: dict) -> dict:
    """lv_bag at the configuration's band k and threshold af."""
    if config["leap_mode"] != "GLOBAL":
        raise NotImplementedError("the reference keeps GLOBAL mode only")
    return align(read, read_len, ref, ref_len, x=config["x"], o=config["o"],
                 e=config["e"], k=config["k"], af=config["leap_af_threshold"])


def control(read, read_len, ref, ref_len, config: dict) -> dict:
    """The configuration's band broken: lv_bag over k - 1, two lanes
    fewer."""
    return reference(read, read_len, ref, ref_len,
                     dict(config, k=config["k"] - 1))
