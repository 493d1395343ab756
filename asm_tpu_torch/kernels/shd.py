"""Batched Shifted-Hamming-Distance (SHD) pre-filter (port of
`asm_tpu.kernels.shd`).

The cheap gate bit_vec_filter_sse/avx (GASMA/benchmark/LEAP_SIMD/
SHD.cpp:157-385) that rejects pairs whose edit distance certainly exceeds
max_error; SIMD_ED::run_levenshtein calls it before its wavefront
(SIMD_ED.cpp:270). Semantics, as in the JAX module:

  * the pair length is the buffer length max(|read|, |ref|); padding
    codes (>= 4) compare as code 0 ('A', the reference's zeroed buffer);
  * per shift j in 1..max_error (both directions) the Hamming mask is
    ANDed after clearing the low j positions and everything past length;
  * "flip false zeros" fills interior 0-runs of length <= 2 flanked by
    1s, except near the register top (SHD.cpp:21-88);
  * the count is POPCOUNT_SHD (popcount.cpp:41-73): 1-run starts per
    4-bit nibble, plus one for the irregular nibble value 6 (0b0110).

`shd_gate_masks` is the variant SIMD_ED actually calls (SHD.cpp:335-385
on the lane masks), which performs no speckle removal. Rows are [.., L]
{0,1} int8 tensors; every function runs on any device.
"""

from __future__ import annotations

import torch

from asm_tpu_torch.ops.bitops import shift_away_0, shift_toward_0


def _positions(v: torch.Tensor) -> torch.Tensor:
    return torch.arange(v.shape[-1], device=v.device)


def _flip_false_zeros(v: torch.Tensor) -> torch.Tensor:
    """Fill interior 0-runs of length <= 2 bounded by 1s (flip_false_zero,
    SHD.cpp:21-88), one simultaneous pass; the cascade's sliding windows
    never reach a run whose last zero sits at bit >= L-2."""
    L = v.shape[-1]
    pos = _positions(v)
    l1 = shift_toward_0(v, 1)
    r1 = shift_away_0(v, 1)
    l2 = shift_toward_0(v, 2)
    r2 = shift_away_0(v, 2)
    single = ((r1 & l1) == 1) & (pos <= L - 3)  # 1 0 1
    dleft = ((r1 & l2) == 1) & (pos <= L - 4)   # left zero of 1 0 0 1
    dright = ((r2 & l1) == 1) & (pos <= L - 3)  # right zero of 1 0 0 1
    return torch.where((v == 0) & (single | dleft | dright),
                       torch.ones_like(v), v)


def _popcount_shd(v: torch.Tensor) -> torch.Tensor:
    """POPCOUNT_SHD (popcount.cpp:41-73): per 4-bit nibble, 1-run starts
    (a run spanning a nibble boundary counts once per nibble) plus one for
    nibble value 6 (0b0110). int32[..]."""
    L = v.shape[-1]
    assert L % 4 == 0
    prev = shift_away_0(v, 1)
    pos = _positions(v)
    starts = (v == 1) & ((prev == 0) | (pos % 4 == 0))
    nib = v.reshape(v.shape[:-1] + (L // 4, 4))
    is6 = ((nib[..., 0] == 0) & (nib[..., 1] == 1) & (nib[..., 2] == 1)
           & (nib[..., 3] == 0))
    return (starts.sum(dim=-1) + is6.sum(dim=-1)).to(torch.int32)


def shd_filter(read_codes, read_len, ref_codes, ref_len,
               max_error: int = 3) -> torch.Tensor:
    """bool[B]: True = the pair may be within max_error (keep), False =
    certainly rejected (bit_vec_filter_sse, SHD.cpp:157-239)."""
    B, L = read_codes.shape
    pos = torch.arange(L, device=read_codes.device)
    length = torch.minimum(torch.maximum(read_len.to(torch.int32),
                                         ref_len.to(torch.int32)),
                           torch.tensor(L, dtype=torch.int32,
                                        device=read_codes.device))
    len_mask = (pos[None, :] < length[:, None]).to(torch.int8)
    rc = torch.where(read_codes < 4, read_codes, torch.zeros_like(read_codes))
    fc = torch.where(ref_codes < 4, ref_codes, torch.zeros_like(ref_codes))

    def ham(a, b):
        return (a != b).to(torch.int8)

    diff = _flip_false_zeros(ham(rc, fc) & len_mask)
    for j in range(1, max_error + 1):
        beg_mask = (pos >= j).to(torch.int8)[None, :] & len_mask
        # "right shift read": position p compares read[p-j] vs ref[p]
        d1 = ham(shift_away_0(rc, j), fc) & beg_mask
        d2 = ham(shift_away_0(fc, j), rc) & beg_mask
        diff = diff & _flip_false_zeros(d1) & _flip_false_zeros(d2)
    return _popcount_shd(diff) <= max_error


def shd_gate_masks(lane_masks: torch.Tensor, length: torch.Tensor,
                   max_error: int) -> torch.Tensor:
    """The gate SIMD_ED's run calls (bit_vec_filter_avx(xor_masks, ...),
    SHD.cpp:335-385): AND of the 2*max_error+1 lane masks, each cleared
    below |j - max_error| and past `length`, no speckle removal; then the
    POPCOUNT_SHD count <= max_error. lane_masks: {0,1} int8[B, 2*max_error
    + 1, L]; length: int32[B]. bool[B]."""
    B, NLANES, L = lane_masks.shape
    assert NLANES == 2 * max_error + 1
    pos = torch.arange(L, device=lane_masks.device)
    len_mask = (pos[None, :] < length.clamp(max=L)[:, None]).to(torch.int8)
    diff = torch.ones((B, L), dtype=torch.int8, device=lane_masks.device)
    for j in range(NLANES):
        tm = (pos >= abs(j - max_error)).to(torch.int8)[None, :] & len_mask
        diff = diff & lane_masks[:, j, :].to(torch.int8) & tm
    return _popcount_shd(diff) <= max_error
