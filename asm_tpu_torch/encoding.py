"""DNA sequence encoding, host half (copy of `asm_tpu.encoding`).

A corpus of B read/ref pairs is

  codes: int8[B, L]    2-bit base codes 0..3 (A, C, G, T), padded
  length: int32[B]     true lengths (<= L)

Reads are padded with PAD_READ (4) and refs with PAD_REF (5) past their
true length, so a comparison that touches padding always mismatches.
"""

from __future__ import annotations

import numpy as np
import torch

CODE_A = 0
CODE_C = 1
CODE_G = 2
CODE_T = 3
PAD_READ = 4  # sentinel for read padding
PAD_REF = 5  # sentinel for ref padding
PAD_SHIFT = 6  # sentinel shifted in by lane-shift ops (mismatches everything)

_BASE_TO_CODE = np.full(256, CODE_A, dtype=np.int8)  # non-ACGT behaves like 'A'
for _ch, _code in (("A", CODE_A), ("C", CODE_C), ("G", CODE_G), ("T", CODE_T),
                   ("a", CODE_A), ("c", CODE_C), ("g", CODE_G), ("t", CODE_T)):
    _BASE_TO_CODE[ord(_ch)] = _code
_CODE_TO_BASE = np.array(list("ACGT") + ["N"] * 4, dtype="U1")


def encode_string(s: str, max_len: int, pad: int = PAD_READ) -> np.ndarray:
    """Encode one ASCII DNA string to int8 codes, truncated/padded to max_len."""
    raw = np.frombuffer(s[:max_len].encode("ascii"), dtype=np.uint8)
    out = np.full(max_len, pad, dtype=np.int8)
    out[: raw.size] = _BASE_TO_CODE[raw]
    return out


def decode_string(codes: np.ndarray, length: int | None = None) -> str:
    codes = np.asarray(codes)
    if length is not None:
        codes = codes[:length]
    else:
        codes = codes[codes < 4]
    return "".join(_CODE_TO_BASE[codes])


def encode_batch(
    reads: list[str],
    refs: list[str],
    max_len: int = 128,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Host-side batch encode: returns (read_codes, read_len, ref_codes, ref_len).

    Sequences longer than max_len are truncated, mirroring the reference
    (hurdle_matrix.h:487-488, SIMD_ED.cpp:141-142).
    """
    b = len(reads)
    assert len(refs) == b
    read_codes = np.full((b, max_len), PAD_READ, dtype=np.int8)
    ref_codes = np.full((b, max_len), PAD_REF, dtype=np.int8)
    read_len = np.empty(b, dtype=np.int32)
    ref_len = np.empty(b, dtype=np.int32)
    for i, (a, bb) in enumerate(zip(reads, refs)):
        m = min(len(a), max_len)
        n = min(len(bb), max_len)
        read_codes[i, :m] = _BASE_TO_CODE[
            np.frombuffer(a[:m].encode("ascii"), dtype=np.uint8)
        ]
        ref_codes[i, :n] = _BASE_TO_CODE[
            np.frombuffer(bb[:n].encode("ascii"), dtype=np.uint8)
        ]
        read_len[i] = m
        ref_len[i] = n
    return read_codes, read_len, ref_codes, ref_len


def pack_planes_t(codes: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """(bit0, bit1, valid) planes, WORD-MAJOR [L/32, B], from int8 codes
    [B, L] (port of `asm_tpu.encoding.pack_planes_t`). Bit p of word w
    holds that bit of code 32w + p; valid is set iff the code is a real
    base (< 4: every sentinel has bit 2 set). Words are int32 tensors
    holding the uint32 bit patterns, on the codes' device."""
    B, L = codes.shape
    if L % 32:
        raise ValueError(f"bitplane packing requires L % 32 == 0, got {L}")
    c = (codes.to(torch.int64) & 0xFFFFFFFF).reshape(B, L // 32, 32)
    weights = torch.ones(32, dtype=torch.int64, device=codes.device) \
        << torch.arange(32, device=codes.device)

    def pack(bits):
        w = (bits * weights).sum(dim=2).T  # [W, B], < 2**32
        return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)

    return pack(c & 1), pack((c >> 1) & 1), pack((~c >> 2) & 1)
