"""Batched exact Needleman-Wunsch/Gotoh affine-gap global alignment: the
plain PyTorch version (port of `asm_tpu.kernels.nw`).

Penalty convention: a mismatch costs x, a gap of length L costs
o + (L-1)*e, the penalty is the minimised total (-parasail score with
matrix ("ACGT", 0, -x), GASMA/benchmark/benchmark_utils.h:104-150).

The DP runs as an anti-diagonal wavefront over [B, L] tensors, one torch
step per diagonal d = i + j: every cell of a diagonal depends only on the
two before it. Only cells i in [1, L] are stored (index q = i-1); the
i == 0 top border has the closed form o + (d-1)*e and enters as the fill
of the one-cell shift. Each pair's result is read at its own final
diagonal d == m+n. It is the CPU route of the CUDA kernels' wrappers
(`kernels/nw_cuda.py`) and the version they are held against on the card.

Traceback parks one pointer byte per cell per diagonal in the forward
pass (bits 0-1 H source: 0 diagonal, 1 E, 2 F; bit 2 E opened; bit 3 F
opened; bit 4 mismatch), then replays the diagonals in reverse: a pair
whose cursor sits on diagonal d takes one move. Ops come out in REVERSE
alignment order, the op of diagonal d in column 2L - d, OP_NONE
elsewhere.
"""

from __future__ import annotations

import torch

INF = 1 << 29

# traceback op codes
OP_NONE = 0
OP_EQ = 1  # '='
OP_X = 2  # 'X'
OP_I = 3  # 'I' consumes the read
OP_D = 4  # 'D' consumes the ref


def pen_closed_form(m, mn, o, e):
    """Penalty of pairs with an empty read (m == 0): they end on the
    virtual top border. INF marks pairs the DP must compute."""
    return torch.where(mn == 0, 0,
                       torch.where(m == 0, o + (mn - 1) * e, INF)).to(
                           torch.int32)


def _h_top(dd: int, o: int, e: int) -> int:
    """Closed-form H at the virtual top-border cell (0, dd)."""
    if dd <= 0:
        return 0 if dd == 0 else INF
    return o + (dd - 1) * e


def _wavefront(read_codes, ref_codes, read_len, ref_len, x, o, e,
               want_trace):
    """Shared forward pass. Returns (penalty int32[B], pointer bytes
    uint8[d_max, B, L] or None, d_max): diagonal d at index d-1, d_max the
    batch's largest m+n (no cell past it reaches a result)."""
    B, L = read_codes.shape
    dev = read_codes.device
    i32 = torch.int32
    ii = torch.arange(1, L + 1, device=dev, dtype=i32)[None, :]
    aa = read_codes.to(i32)
    # cell i of diagonal d compares ref[d-i-1] = b_rev_pad[2L+1-d + q]
    sent = torch.full((B, L), -2, dtype=i32, device=dev)
    b_rev_pad = torch.cat([sent, torch.flip(ref_codes.to(i32), dims=[1]),
                           sent], dim=1)
    m = read_len.to(i32)
    mn = m + ref_len.to(i32)
    d_max = int(mn.max()) if B else 0

    inf = torch.full((B, L), INF, dtype=i32, device=dev)
    h1, h2, e1, f1 = inf, inf, inf, inf
    pen = pen_closed_form(m, mn, o, e)
    ptrs = (torch.empty((d_max, B, L), dtype=torch.uint8, device=dev)
            if want_trace else None)

    def shift_i(arr, fill):
        """value at cell i-1; cell i == 1 reads `fill` (the virtual
        i == 0 border cell)."""
        return torch.cat([torch.full((B, 1), fill, dtype=i32, device=dev),
                          arr[:, :-1]], dim=1)

    for d in range(1, d_max + 1):
        # gap-state recurrences (open preferred on ties)
        e_open = shift_i(h1, _h_top(d - 1, o, e)) + o
        e_ext = shift_i(e1, INF) + e
        e_new = torch.minimum(e_open, e_ext)
        f_open = h1 + o
        f_ext = f1 + e
        f_new = torch.minimum(f_open, f_ext)

        bb = b_rev_pad[:, 2 * L + 1 - d:3 * L + 1 - d]
        mis = (aa != bb).to(i32)
        sub = shift_i(h2, _h_top(d - 2, o, e)) + x * mis
        h_new = torch.minimum(sub, torch.minimum(e_new, f_new))

        # left-border cell of this diagonal: i == d (j = 0)
        border_pen = o + (d - 1) * e
        at_left = ii == d
        h_new = torch.where(at_left, border_pen, h_new)
        e_new = torch.where(at_left, border_pen, e_new)
        f_new = torch.where(at_left, INF, f_new)

        val = torch.where(ii == m[:, None], h_new, 0).sum(dim=1, dtype=i32)
        pen = torch.where((mn == d) & (m > 0), val, pen)

        if want_trace:
            ptr_h = torch.where(h_new == sub, 0,
                                torch.where(h_new == e_new, 1, 2))
            ptr_h = torch.where(at_left, 1, ptr_h)
            e_is_open = torch.where(at_left, d == 1, e_open <= e_ext)
            f_is_open = f_open <= f_ext
            ptrs[d - 1] = (ptr_h | (e_is_open.to(i32) << 2)
                           | (f_is_open.to(i32) << 3) | (mis << 4)).to(
                               torch.uint8)

        h2, h1, e1, f1 = h1, h_new, e_new, f_new
    return pen, ptrs, d_max


def nw_penalty(read_codes, read_len, ref_codes, ref_len, x=1, o=1, e=1):
    """Exact global alignment penalty, no traceback. int32[B]."""
    pen, _, _ = _wavefront(read_codes, ref_codes, read_len, ref_len, x, o,
                           e, False)
    return pen


def nw_align(read_codes, read_len, ref_codes, ref_len, x=1, o=1, e=1,
             match_mask_threshold: int | None = None):
    """Exact global alignment with traceback.

    Returns (penalty int32[B], ops int8[B, 2L]): OP_* codes in REVERSE
    alignment order, OP_NONE-padded (`ops.cigar.ops_to_cigar` renders
    them). With match_mask_threshold also bool[B, L]: READ positions
    inside '=' runs of length >= threshold, the positions the reference's
    LCM string collects (benchmark_coverage.h:26-67)."""
    B, L = read_codes.shape
    dev = read_codes.device
    i32 = torch.int32
    penalty, ptrs, d_max = _wavefront(read_codes, ref_codes, read_len,
                                      ref_len, x, o, e, True)
    ww0 = torch.arange(L, device=dev, dtype=i32)[None, :]
    want_mask = match_mask_threshold is not None
    thr = match_mask_threshold

    i = read_len.to(i32).clone()
    j = ref_len.to(i32).clone()
    st = torch.zeros(B, dtype=i32, device=dev)
    run = torch.zeros(B, dtype=i32, device=dev)
    mask = torch.zeros((B, L), dtype=torch.bool, device=dev)
    ops = torch.zeros((B, 2 * L), dtype=torch.int8, device=dev)

    def span(cond, lo, n):
        return cond[:, None] & (ww0 >= lo[:, None]) & (ww0 < (lo + n)[:, None])

    # diagonals above d_max hold no cursor
    for d in range(d_max, 0, -1):
        active = (i + j == d) & ((i > 0) | (j > 0))
        fetched = torch.gather(ptrs[d - 1], 1,
                               (i - 1).clamp(0, L - 1).to(torch.int64)[:, None]
                               )[:, 0].to(i32)
        top_byte = 2 | (8 if d == 1 else 0)  # virtual i == 0 cell
        byte = torch.where(i == 0, top_byte, fetched)
        ptr_h = byte & 3
        e_open = (byte >> 2) & 1
        f_open = (byte >> 3) & 1
        mis = (byte >> 4) & 1

        # state: 0 = H, 1 = E (read-gap run), 2 = F (ref-gap run)
        go_diag = (st == 0) & (ptr_h == 0)
        go_e = ((st == 0) & (ptr_h == 1)) | (st == 1)
        go_f = ((st == 0) & (ptr_h == 2)) | (st == 2)
        op = torch.where(go_diag, torch.where(mis == 1, OP_X, OP_EQ),
                         torch.where(go_e, OP_I, OP_D))
        ops[:, 2 * L - d] = torch.where(active, op, OP_NONE).to(torch.int8)

        new_st = torch.where(go_diag, 0,
                             torch.where(go_e, torch.where(e_open == 1, 0, 1),
                                         torch.where(f_open == 1, 0, 2)))
        if want_mask:
            # a '=' run ending at read cursor i covered [i, i + run)
            is_eq = active & go_diag & (mis == 0)
            ends = active & ~is_eq
            mask |= span((run > 0) & ends & (run >= thr), i, run)
            run = torch.where(is_eq, run + 1, torch.where(ends, 0, run))

        i = torch.where(active, i - (go_diag | go_e).to(i32), i)
        j = torch.where(active, j - (go_diag | go_f).to(i32), j)
        st = torch.where(active, new_st, st)

    if want_mask:
        # flush a run still open at the start of the alignment
        mask |= span((run >= thr) & (run > 0), i, run)
        return penalty, ops, mask
    return penalty, ops
