"""DNA sequence encoding (port of `asm_tpu.encoding`).

A corpus of B read/ref pairs is

  codes: int8[B, L]    2-bit base codes 0..3 (A, C, G, T), padded
  length: int32[B]     true lengths (<= L)

Reads are padded with PAD_READ (4) and refs with PAD_REF (5) past their
true length, so a comparison that touches padding always mismatches.
The host half encodes strings with numpy; `encode_ascii_device` encodes
ASCII bytes on a tensor's own device, and `pack_bitplanes` /
`pack_planes_t` pack codes into 32-bit bit-plane words.
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


def decode_batch(codes: np.ndarray, lens: np.ndarray) -> list[str]:
    """`decode_string` over a whole [N, L] batch: one table gather, then a
    per-row tobytes().decode() (codes above 3 decode as 'N')."""
    codes = np.asarray(codes)
    lut = np.frombuffer(b"ACGTN", dtype=np.uint8)
    ch = lut[np.clip(codes, 0, 4)]
    return [ch[i, : int(lens[i])].tobytes().decode()
            for i in range(codes.shape[0])]


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


def encode_ascii_device(ascii_bytes: torch.Tensor, length: torch.Tensor,
                        pad: int) -> torch.Tensor:
    """uint8 ASCII [B, L] -> int8 codes [B, L] on the bytes' device (the
    reference's sse3_convert2bit1, GASMA/bit_convert.cpp:248, as one
    elementwise map): C/c -> 1, G/g -> 2, T/t -> 3, anything else -> A;
    positions at or past `length` [B] get `pad`."""
    b = ascii_bytes
    codes = torch.where(
        (b == ord("C")) | (b == ord("c")), CODE_C,
        torch.where(
            (b == ord("G")) | (b == ord("g")), CODE_G,
            torch.where((b == ord("T")) | (b == ord("t")), CODE_T, CODE_A),
        ),
    ).to(torch.int8)
    pos = torch.arange(b.shape[-1], device=b.device)
    return torch.where(pos < length[..., None].to(b.device), codes,
                       torch.tensor(pad, dtype=torch.int8, device=b.device))


def pack_bitplanes(codes: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Pack int8 codes [.., L] into 2 bit-planes [.., L/32]: plane 0 holds
    bit 0 of each code, plane 1 bit 1, bit p of word w for code 32w + p
    (the reference's two-register form, GASMA/bit_convert.h:17-21).
    Padding codes (>= 4) are not representable. Words are int64 tensors
    holding the uint32 values (CPU torch has no uint32 shifts)."""
    L = codes.shape[-1]
    if L % 32:
        raise ValueError(f"bitplane packing requires L % 32 == 0, got {L}")
    c = (codes.to(torch.int64) & 0xFFFFFFFF).reshape(
        codes.shape[:-1] + (L // 32, 32))
    return _pack_words(c & 1), _pack_words((c >> 1) & 1)


def _pack_words(bits: torch.Tensor) -> torch.Tensor:
    """[.., W, 32] bits (int64, 0 / 1) -> [.., W] int64 words, bit p of
    a word from entry p."""
    weights = torch.ones(32, dtype=torch.int64, device=bits.device) \
        << torch.arange(32, device=bits.device)
    return (bits * weights).sum(dim=-1)


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

    def pack(bits):
        w = _pack_words(bits).T  # [W, B], < 2**32
        return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)

    return pack(c & 1), pack((c >> 1) & 1), pack((~c >> 2) & 1)
