"""Bit-packed lane rows: 32-bit words + popcount/ctz queries (port of
`asm_tpu.ops.packed`).

A lane row of L positions is W = L/32 words, bit p of word w = position
32*w + p (LSB-first, the reference's little-endian bit order). torch has
no unsigned 32-bit arithmetic on every device and no popcount, so each
word is held in an int64 with values in [0, 2**32) — every result is
masked back to 32 bits — and popcount is SWAR bit arithmetic.
"""

from __future__ import annotations

import torch

FULL = 0xFFFFFFFF


def pack_rows(rows_bool: torch.Tensor) -> torch.Tensor:
    """{0,1}/bool[..., L] -> int64[..., L//32] 32-bit words."""
    L = rows_bool.shape[-1]
    assert L % 32 == 0, f"packed rows need L % 32 == 0, got {L}"
    W = L // 32
    b = rows_bool.to(torch.int64).reshape(rows_bool.shape[:-1] + (W, 32))
    weights = torch.ones(32, dtype=torch.int64, device=b.device) << torch.arange(
        32, device=b.device)
    return (b * weights).sum(dim=-1)


def _word_starts(W: int, device) -> torch.Tensor:
    return 32 * torch.arange(W, dtype=torch.int64, device=device)


def mask_ge(c: torch.Tensor, W: int) -> torch.Tensor:
    """int64[.., W] words with bits set at positions >= c (c may be < 0
    or > L)."""
    low = (c.to(torch.int64)[..., None] - _word_starts(W, c.device)).clamp(0, 32)
    shifted = (FULL << low.clamp(max=31)) & FULL
    return torch.where(low >= 32, torch.zeros_like(shifted), shifted)


def mask_lt(c: torch.Tensor, W: int) -> torch.Tensor:
    """int64[.., W] words with bits set at positions < c."""
    return mask_ge(c, W) ^ FULL


def popcount32(w: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word (held in int64), SWAR."""
    w = w - ((w >> 1) & 0x55555555)
    w = (w & 0x33333333) + ((w >> 2) & 0x33333333)
    w = (w + (w >> 4)) & 0x0F0F0F0F
    return ((w * 0x01010101) & FULL) >> 24


def ctz32(w: torch.Tensor) -> torch.Tensor:
    """Trailing zeros of each 32-bit word; 32 for zero words:
    popcount((w & -w) - 1), the lowest set bit 2^t minus one is t ones,
    and a zero word wraps to all 32 ones."""
    low = w & -w
    return popcount32((low - 1) & FULL)


def first_set_from(packed: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """First position >= c with a set bit, else L (tzcnt of an empty
    register returns its width, utils.h:168-182). packed: [.., W]."""
    W = packed.shape[-1]
    L = 32 * W
    masked = packed & mask_ge(c, W)
    idx = _word_starts(W, packed.device) + ctz32(masked)
    idx = torch.where(masked == 0, torch.full_like(idx, L), idx)
    return idx.min(dim=-1).values


def count_range(packed: torch.Tensor, lo: torch.Tensor,
                hi: torch.Tensor) -> torch.Tensor:
    """popcount of positions in [lo, hi) — pop_count_between semantics
    (utils.h:263-270): inverted or out-of-range windows count 0."""
    W = packed.shape[-1]
    m = mask_ge(lo, W) & mask_lt(hi, W)
    return popcount32(packed & m).sum(dim=-1)
