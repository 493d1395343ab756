"""Batched profile-profile alignment (MSA step): the plain PyTorch version
(port of `asm_tpu.kernels.msa`).

The profile contraction is hoisted out of the DP — `p2s = S @ p2[j]` once
per batch, so each wavefront step needs only an elementwise dot over the
5-channel axis — and the maximising DP runs as the same anti-diagonal
[B, L] wavefront as the NW kernel: 2L diagonal steps, cells i in [1, L]
stored, the virtual top border read from running cumulative gap scores.
There is no hand-written kernel behind it: these eager tensor ops are its
route on the card too.

Score convention (pymatch/algorithms/MSA.py:30-38): match +1, mismatch -2,
gap-vs-gap 0; linear gap scores psp(column, '-'). Ties break match >
insert ('|', consumes profile 1) > delete ('-'), MSA.py:89-97.

Ties are decided by exact float32 equality, so every sum here is written
as explicit float32 operations in the order XLA:CPU computes the JAX
version's (jax 0.9, x86-64 with FMA, read from its object code), and the
pointers, and so the traceback, come out equal to it:

  * the contractions with the score matrix (its [B*L, 5] x [5, 5] dots):
    left to right up to 80 rows (B * L), emitted inline; ((t0 + t1) +
    (t2 + t3)) + t4 beyond, through its dot library;
  * the per-cell profile dot `psp` (a fused multiply and reduce): a chain
    of fused multiply-adds below L = 128, a scalar loop; from 128 up a
    8-wide vector loop, left to right and not fused, whose scalar tail
    (the last L % 8 positions of a row) fuses again;
  * the border cumsums: XLA's two-level scan, sequential within blocks
    of 16 positions, the block totals scanned the same way and added.

Every other step is one rounding. Products with the score matrix and the
gap vector (entries 1, -2 and 0) are exact, so a contraction with the gap
vector is its last channel. A fused multiply-add is computed exactly in
float64 (`_fma32`), so the result is the same on every device; each
eager op is its own kernel, so nothing else is contracted, and no matmul
(or TF32) is used.
"""

from __future__ import annotations

import numpy as np
import torch

# copies of asm_tpu/reference_impl/msa_ref.py:15-40
GAP_VEC = np.array([0, 0, 0, 0, 1], dtype=np.float64)
_SYMBOLS = "ACGT-"
_SYMBOL_INDEX = np.full(256, 255, dtype=np.uint8)
for _i, _ch in enumerate(_SYMBOLS):
    _SYMBOL_INDEX[ord(_ch)] = _i

NEG = -1e30

OP_M = 1
OP_I = 3  # consumes profile 1 (prototype '|')
OP_D = 4  # consumes profile 2 (prototype '-')

_SCAN_BLOCK = 16  # XLA:CPU's cumsum block (its reduce-window rewrite)
_SMALL_DOT_ROWS = 80  # XLA:CPU emits a [B*L, 5] x [5, 5] dot inline up to
# this many rows (a left-to-right sum), and through its library beyond
_VECTORISED_FROM = 128  # XLA:CPU vectorises the per-cell dot from this L
_VECTOR = 8  # floats per vector of that loop


def score_matrix(match: float = 1.0, mismatch: float = -2.0) -> np.ndarray:
    s = np.full((5, 5), mismatch)
    for i in range(4):
        s[i, i] = match
    s[4, 4] = 0.0
    return s


def create_pssm(alignment: list[str]) -> np.ndarray:
    """Column frequency profile float64[L, 5] (MSA.py:47-57): the symbol
    counts of each column over its rows, divided by the column's sum."""
    L = len(alignment[0])
    rows = np.stack([np.frombuffer(r[:L].encode("ascii"), np.uint8)
                     for r in alignment])  # a shorter row raises here
    idx = _SYMBOL_INDEX[rows]
    if (idx == 255).any():
        bad = sorted({chr(c) for c in rows[idx == 255].tolist()})
        raise KeyError(f"symbols outside {_SYMBOLS!r}: {bad}")
    counts = (idx[:, :, None] == np.arange(5)).sum(axis=0).astype(np.float64)
    return counts / counts.sum(axis=1, keepdims=True)


def profiles_from_alignments(alignments: list[list[str]], max_len: int):
    """Host-side: list of alignments (rows of equal length) -> batched
    PSSM arrays float32[B, max_len, 5] + lengths int32[B]."""
    B = len(alignments)
    out = np.zeros((B, max_len, 5), np.float32)
    lens = np.zeros(B, np.int32)
    for b, al in enumerate(alignments):
        p = create_pssm(al)
        n = min(p.shape[0], max_len)
        out[b, :n] = p[:n]
        lens[b] = n
    return out, lens


def _sum5(t: torch.Tensor, pairwise: bool) -> torch.Tensor:
    """Sum over the last axis (5 entries): ((t0 + t1) + (t2 + t3)) + t4,
    or left to right."""
    if pairwise:
        return ((t[..., 0] + t[..., 1]) + (t[..., 2] + t[..., 3])) + t[..., 4]
    acc = t[..., 0] + t[..., 1]
    for c in range(2, 5):
        acc = acc + t[..., c]
    return acc


def _fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 fma(a, b, c), a * b + c rounded once, on any device: the
    product is exact in float64, the sum is rounded to odd there (TwoSum
    gives its exact error), and rounding that to float32 is then correct
    (53 >= 24 + 2 bits)."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def _psp(a: torch.Tensor, b: torch.Tensor, fused: torch.Tensor | None):
    """sum_c a[..., c] b[..., c] over [B, L, 5]: left to right, and at
    the positions where `fused` [L] is set a chain of fused multiply-adds
    from a0 * b0 instead (None: nowhere)."""
    t = a * b
    plain = _sum5(t, pairwise=False)
    if fused is None:
        return plain
    acc = t[..., 0]
    for c in range(1, 5):
        acc = _fma32(a[..., c], b[..., c], acc)
    return torch.where(fused, acc, plain)


def _psp_fused(L: int, device) -> torch.Tensor | None:
    """Positions whose per-cell dot XLA:CPU contracts into fused
    multiply-adds: every position below L = 128 (a scalar loop), from 128
    up only the last L % 8 of a row (the scalar tail of its 8-wide
    vector loop); None where there are none."""
    q = torch.arange(L, device=device)
    fused = q >= (L - L % _VECTOR) if L >= _VECTORISED_FROM else q >= 0
    return fused if bool(fused.any()) else None


def _cumsum_blocked(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum over the last axis of [B, N] float32, added in
    XLA:CPU's order: sequential within blocks of 16, plus the exclusive
    scan of the block totals (itself computed the same way)."""
    B, N = x.shape
    nb = -(-N // _SCAN_BLOCK)
    blk = torch.zeros((B, nb * _SCAN_BLOCK), dtype=x.dtype, device=x.device)
    blk[:, :N] = x
    blk = blk.reshape(B, nb, _SCAN_BLOCK)
    cols = [blk[..., 0]]
    for k in range(1, _SCAN_BLOCK):
        cols.append(cols[-1] + blk[..., k])
    inner = torch.stack(cols, dim=-1)  # [B, nb, 16]
    if nb > 1:
        inc = _cumsum_blocked(inner[..., -1])  # the block totals' scan
        inner[:, 1:] = inner[:, 1:] + inc[:, :-1, None]
    return inner.reshape(B, nb * _SCAN_BLOCK)[:, :N]


def _gather_or_zero(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[b, idx[b]] where 0 <= idx < table.shape[1], else 0."""
    n = table.shape[1]
    ok = (idx >= 0) & (idx < n)
    got = table.gather(1, idx.clamp(0, n - 1)[:, None])[:, 0]
    return torch.where(ok, got, torch.zeros_like(got))


def profile_align(p1, len1, p2, len2, match: float = 1.0,
                  mismatch: float = -2.0) -> dict:
    """Batched profile-profile alignment.

    Args: p1/p2 float32[B, L, 5] PSSMs (zero rows past len), len1/len2
    int32[B], all on one device. Returns dict(score float32[B], ops
    int8[B, 2L] traceback in reverse order — codes OP_M/OP_I/OP_D,
    0-padded)."""
    B, L, _ = p1.shape
    dev = p1.device
    f32, i32 = torch.float32, torch.int32
    p1 = p1.to(f32)
    p2 = p2.to(f32)
    len1 = len1.to(i32)
    len2 = len2.to(i32)
    S = torch.tensor(score_matrix(match, mismatch), dtype=f32, device=dev)

    # p2s[b, j, d] = sum_c S[d, c] p2[b, j, c]; gap1[b, i] = sum_c p1[b,
    # i, c] S[c, 4] (the gap vector picks channel 4); gap2 = p2s[..., 4]
    pairwise = B * L > _SMALL_DOT_ROWS
    p2s = _sum5(p2[:, :, None, :] * S, pairwise)
    gap1 = _sum5(p1 * S[:, 4], pairwise)
    gap2 = p2s[..., 4]

    ii = torch.arange(1, L + 1, dtype=i32, device=dev)[None, :]
    # cell i of diag d pairs p1[i-1] with p2s[d-i-1]: reverse + pad p2s
    zeros = torch.zeros((B, L, 5), dtype=f32, device=dev)
    p2s_pad = torch.cat([zeros, torch.flip(p2s, dims=[1]), zeros], dim=1)
    zcol = torch.zeros((B, 1), dtype=f32, device=dev)
    cum1 = torch.cat([zcol, _cumsum_blocked(gap1)], dim=1)  # [B, L+1]
    cum2 = torch.cat([zcol, _cumsum_blocked(gap2)], dim=1)

    mn = len1 + len2
    valid1 = ii <= len1[:, None]
    neg = torch.tensor(NEG, dtype=f32, device=dev)
    fneg = torch.full((B, L), NEG, dtype=f32, device=dev)

    def top_border(dd):
        """D[0, dd] per pair (0 outside [0, L])."""
        if not torch.is_tensor(dd):
            dd = torch.full((B,), dd, dtype=torch.int64, device=dev)
        return _gather_or_zero(cum2, dd.to(torch.int64))

    def shift_i(arr, fill):
        return torch.cat([fill[:, None], arr[:, :-1]], dim=1)

    fused = _psp_fused(L, dev)
    h1 = h2 = fneg
    score = torch.where(mn == 0, torch.zeros((), dtype=f32, device=dev),
                        torch.where(len1 == 0, top_border(mn), neg))
    last = (len1 - 1).clamp(min=0).to(torch.int64)[:, None]
    ptrs = torch.empty((2 * L, B, L), dtype=torch.int8, device=dev)
    for d in range(1, 2 * L + 1):
        sl = p2s_pad[:, 2 * L + 1 - d:3 * L + 1 - d]  # [B, L, 5]
        psp_d = _psp(p1, sl, fused)
        m = shift_i(h2, top_border(d - 2)) + psp_d
        ins = shift_i(h1, top_border(d - 1)) + gap1  # consumes p1 row i
        dele = h1 + sl[..., 4]  # gap2 cost of column j-1 = d-i-1
        h_new = torch.maximum(m, torch.maximum(ins, dele))
        at_left = ii == d  # left border cell i == d: D[i, 0]
        if d <= L:
            h_new = torch.where(at_left, cum1[:, d:d + 1], h_new)
        h_new = torch.where(valid1, h_new, neg)
        ptr = torch.where(h_new == m, OP_M,
                          torch.where(h_new == ins, OP_I, OP_D))
        ptrs[d - 1] = torch.where(at_left, OP_I, ptr).to(torch.int8)
        val = h_new.gather(1, last)[:, 0]
        score = torch.where((mn == d) & (len1 > 0), val, score)
        h1, h2 = h_new, h1

    # traceback: replay the diagonals in reverse, one move per pair whose
    # cursor (i, j) sits on diagonal d
    i = len1.clone()
    j = len2.clone()
    ops = torch.zeros((B, 2 * L), dtype=torch.int8, device=dev)
    for col, d in enumerate(range(2 * L, 0, -1)):
        active = (i + j == d) & ((i > 0) | (j > 0))
        fetched = ptrs[d - 1].gather(
            1, (i - 1).clamp(min=0).to(torch.int64)[:, None])[:, 0].to(i32)
        op = torch.where(i == 0, OP_D, fetched)
        di = ((op == OP_M) | (op == OP_I)).to(i32)
        dj = ((op == OP_M) | (op == OP_D)).to(i32)
        ops[:, col] = torch.where(active, op, 0).to(torch.int8)
        i = torch.where(active, i - di, i)
        j = torch.where(active, j - dj, j)
    return dict(score=score, ops=ops)
