"""Host-side LEAP backtrack: energy-history tables -> edit list + CIGAR
(a copy of `asm_tpu.kernels.leap_backtrack`, plus `leap_edit_records`).

Mirrors LV::backtrack (GASMA/benchmark/LEAP_SIMD/LV_BAG.cpp:250-354):
walk (lane, energy) from (final_lane, final_ED) down to energy 0, at each
probe deciding whether the wavefront start came from an insertion chain
(I_pos), a deletion chain (D_pos) or a mismatch, emitting one edit and
the match run consumed before it. In ED_GLOBAL / ED_SEMI_FREE_BEGIN the
|mid - final_lane| lane-correction gaps are prepended (LV_BAG.cpp:254-264).

Deviation kept from the JAX package: the reference's get_CIGAR
(LV_BAG.cpp:360-383) prints ED_info[0].id_length for every run and stores
the terminal run at the wrong index; this module renders the CIGAR the
edit list describes (per-edit runs, terminal run included). The edit
list (types in order) matches the reference exactly.

`leap_edit_records` writes the same walk in the CUDA kernel's packed
record layout, so the card compares raw records exactly. numpy only.
"""

from __future__ import annotations

import numpy as np

from asm_tpu_torch.config import AlignConfig, LeapMode

MISMATCH = "M"
A_INS = "I"
B_INS = "D"
UNREACHED = -2


def leap_backtrack_one(
    start: np.ndarray,  # int32[af+1, TL] (energy-major)
    end: np.ndarray,
    i_pos: np.ndarray,
    d_pos: np.ndarray,
    final_ed: int,
    final_lane_idx: int,
    cfg: AlignConfig,
) -> list[tuple[str, int, bool]]:
    """One pair's edit list [(op, id_length, is_open), ...] in backtrack
    order. id_length is the match run consumed after this edit (reading
    forward); is_open marks the gap-opening step of an affine chain (cost
    o) against an extension (cost e). The list ends with the terminal run
    as ('', n, False), like ED_info[0]."""
    mid = cfg.k + 1
    go, ge, ms = cfg.o, cfg.e, cfg.x
    edits: list[tuple[str, int, bool]] = []

    if cfg.leap_mode in (LeapMode.GLOBAL, LeapMode.SEMI_FREE_BEGIN):
        gap = B_INS if final_lane_idx > mid else A_INS
        for i in range(abs(mid - final_lane_idx)):
            edits.append((gap, 0, i == abs(mid - final_lane_idx) - 1))

    lane = int(final_lane_idx)
    e = int(final_ed)
    while e != 0:
        match_count = int(end[e, lane] - start[e, lane])
        pending = match_count
        if start[e, lane] == i_pos[e, lane]:
            # insertion chain: extends while the previous I_pos links up
            while True:
                top = 1 if lane >= mid else 0
                if (
                    e - ge >= 0
                    and i_pos[e - ge, lane - 1] != UNREACHED
                    and i_pos[e - ge, lane - 1] + top == i_pos[e, lane]
                ):
                    edits.append((A_INS, pending, False))  # extension (e)
                    pending = 0
                    lane -= 1
                    e -= ge
                else:
                    break
            edits.append((A_INS, pending, True))  # chain opener (o)
            lane -= 1
            e -= go
        elif start[e, lane] == d_pos[e, lane]:
            while True:
                bot = 1 if lane <= mid else 0
                if (
                    e - ge >= 0
                    and d_pos[e - ge, lane + 1] != UNREACHED
                    and d_pos[e - ge, lane + 1] + bot == d_pos[e, lane]
                ):
                    edits.append((B_INS, pending, False))  # extension (e)
                    pending = 0
                    lane += 1
                    e -= ge
                else:
                    break
            edits.append((B_INS, pending, True))  # chain opener (o)
            lane += 1
            e -= go
        else:
            edits.append((MISMATCH, pending, False))
            e -= ms
    # terminal match run at energy 0
    edits.append(("", int(end[0, lane] - start[0, lane]), False))
    return edits


def edits_to_cigar(edits: list[tuple[str, int, bool]]) -> str:
    """The edit list in get_CIGAR's structure: "<first-run>" then
    "<op><run>" per edit in emission (reverse-alignment) order, each edit
    with its own id_length."""
    out = [str(edits[-1][1])]  # first match run (== ED_info[0].id_length)
    for op, run, _ in edits[:-1]:
        out.append(f"{op}{run}")
    return "".join(out)


def _host(result: dict, key: str) -> np.ndarray:
    v = result[key]
    return v.cpu().numpy() if hasattr(v, "cpu") else np.asarray(v)


def leap_backtrack_batch(result: dict, cfg: AlignConfig):
    """Backtrack every passed pair of a want_history leap_align result.
    Returns (edits, cigar) per pair; None for pairs that did not pass."""
    start, end, i_pos, d_pos = (_host(result, k) for k in
                                ("start", "end", "i_pos", "d_pos"))
    passed = _host(result, "passed")
    final_ed = _host(result, "penalty")
    final_lane = _host(result, "final_lane_idx")
    out = []
    for b in range(start.shape[0]):
        if not passed[b]:
            out.append(None)
            continue
        edits = leap_backtrack_one(
            start[b], end[b], i_pos[b], d_pos[b],
            int(final_ed[b]), int(final_lane[b]), cfg,
        )
        out.append((edits, edits_to_cigar(edits)))
    return out


def leap_edit_records(history: dict, cfg: AlignConfig, E: int) -> np.ndarray:
    """The backtrack of every passed pair as packed edit records
    int32[E+1, B], the fused CIGAR kernel's `edit_rec` layout: row ev
    holds the edit emitted at energy ev (op in bits 0-1: 0 none, 1 M,
    2 I, 3 D; is_open in bit 2; its match run in bits 3 and up), row 0 the
    terminal match run; a pair that did not pass has all-zero rows. The
    lane-correction prefix is not recorded (the decode rebuilds it from
    lane_shift). A pair passing above energy E is not walked either (its
    rows stay 0), as in the kernel: the caller checks max(penalty *
    passed) <= E.

    The walk of `leap_backtrack_one`, all pairs at once: an edit lowers
    the pair's energy by o, e or x, so no row is written twice. A lane
    outside the table reads the border lane (UNREACHED), as the kernel
    does."""
    start, end, i_pos, d_pos = (_host(history, k).astype(np.int64) for k in
                                ("start", "end", "i_pos", "d_pos"))
    pen = _host(history, "penalty").astype(np.int64)
    passed = _host(history, "passed").astype(bool) & (pen <= E)
    B, _, TL = start.shape
    mid = cfg.k + 1
    go, ge, ms = cfg.o, cfg.e, cfg.x
    rec = np.zeros((E + 1, B), np.int32)
    b = np.arange(B)
    cur = np.where(passed, pen, 0)
    lane = _host(history, "final_lane_idx").astype(np.int64)
    mode = np.zeros(B, np.int64)  # 0 fresh arrival, 1 I chain, 2 D chain

    def cell(table, ev, ln):
        ok = (ln >= 0) & (ln < TL)
        return table[b, ev, np.where(ok, ln, 0)]

    for _ in range(E + 1):
        act = cur > 0
        if not act.any():
            break
        ev = cur
        s, en = cell(start, ev, lane), cell(end, ev, lane)
        i_cur, d_cur = cell(i_pos, ev, lane), cell(d_pos, ev, lane)
        evg = np.maximum(ev - ge, 0)
        ok_ge = ev - ge >= 0
        i_prev = cell(i_pos, evg, lane - 1)
        d_prev = cell(d_pos, evg, lane + 1)
        fresh = mode == 0
        run = np.where(fresh, en - s, 0)
        is_i = (fresh & (s == i_cur)) | (mode == 1)
        is_d = (fresh & (s != i_cur) & (s == d_cur)) | (mode == 2)
        ext_i = ok_ge & (i_prev != UNREACHED) & (
            i_prev + (lane >= mid) == i_cur)
        ext_d = ok_ge & (d_prev != UNREACHED) & (
            d_prev + (lane <= mid) == d_cur)
        op = np.where(is_i, 2, np.where(is_d, 3, 1))
        is_open = (is_i & ~ext_i) | (is_d & ~ext_d)
        rec[ev[act], b[act]] = (op | (is_open << 2) | (run << 3))[act]
        de = np.where(is_i, np.where(ext_i, ge, go),
                      np.where(is_d, np.where(ext_d, ge, go), ms))
        cur = np.where(act, np.maximum(ev - de, 0), cur)
        lane = np.where(act, lane + np.where(is_i, -1, np.where(is_d, 1, 0)),
                        lane)
        mode = np.where(act, np.where(is_i & ext_i, 1,
                                      np.where(is_d & ext_d, 2, 0)), mode)
    term = cell(end, np.zeros(B, np.int64), lane) - cell(
        start, np.zeros(B, np.int64), lane)
    rec[0] = np.where(passed, term, 0)
    return rec
