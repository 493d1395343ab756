"""Seeded WFA-style simulated read-pair generator (copy of
`asm_tpu.data.generator`: the string-list generator and the array
generators).

Random ACGT patterns; the text is a copy with ceil(len * error_rate)
errors (exact mode) or a uniform 0..ceil count, each error a mismatch with
probability `mismatch_rate`, else an insertion or a deletion (50/50),
applied sequentially at random positions of the evolving text
(GASMA/benchmark/benchmark_dataset.h:61-254). The error count is the
reference's float32 ceil, so rate .15 at length 100 injects 16 errors.

The only randomness of the system lives here: `np.random.default_rng(seed)`
in the numpy generators, the native mt19937_64 stream in
`generate_dataset_native`. The two streams differ; the headline checksum
holds for the native one.
"""

from __future__ import annotations

import math

import numpy as np


def nominal_errors(length: int, error_rate: float) -> int:
    """ceil(length * rate) in float32 — the reference's exact expression
    (benchmark_dataset.h:153-156: uint64 * float promotes to float)."""
    return math.ceil(np.float32(length) * np.float32(error_rate))


_ALPHABET = np.array(list("ACGT"))


def generate_dataset(
    num_reads: int,
    length: int,
    error_rate: float,
    mismatch_rate: float = 0.96,
    exact_error_rate: bool = True,
    seed: int = 0,
) -> tuple[list[str], list[str]]:
    """Return (patterns, texts) — `num_reads` read/ref pairs, one pair at
    a time from the seeded stream (the same strings as asm_tpu's)."""
    if not 0 <= error_rate <= 0.7:
        raise ValueError(f"error rate {error_rate} out of [0, 0.7]")
    if not 0 <= mismatch_rate <= 1:
        raise ValueError(f"mismatch rate {mismatch_rate} out of [0, 1]")
    rng = np.random.default_rng(seed)
    patterns: list[str] = []
    texts: list[str] = []
    max_errors = nominal_errors(length, error_rate)
    for _ in range(num_reads):
        pattern = rng.integers(0, 4, size=length)
        num_errors = (
            max_errors
            if exact_error_rate
            else int(rng.integers(0, max_errors + 1))
        )
        text = list(pattern)
        for _ in range(num_errors):
            r = rng.random()
            if r <= mismatch_rate:
                pos = int(rng.integers(0, len(text)))
                text[pos] = int(rng.integers(0, 4))
            elif rng.integers(1, 3) == 1:  # deletion
                pos = int(rng.integers(0, len(text)))
                del text[pos]
            else:  # insertion
                pos = int(rng.integers(0, len(text)))
                text.insert(pos, int(rng.integers(0, 4)))
        patterns.append("".join(_ALPHABET[pattern]))
        texts.append("".join(_ALPHABET[np.array(text, dtype=np.int64)])
                     if text else "")
    return patterns, texts


def generate_dataset_arrays(
    num_reads: int,
    length: int,
    error_rate: float,
    mismatch_rate: float = 0.96,
    exact_error_rate: bool = True,
    seed: int = 0,
    max_len: int = 128,
    pad_read: int = 4,
    pad_ref: int = 5,
    length_range: tuple[int, int] | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized generator emitting encoded arrays directly.

    Each error step is a batched gather/scatter over [N, L] arrays.
    length_range=(lo, hi) draws each pair's read length uniformly in
    [lo, hi]; the per-pair error count uses the same float32 ceil on the
    pair's own length.

    Returns (read_codes int8[N, max_len], read_len int32[N],
             ref_codes int8[N, max_len], ref_len int32[N]).
    """
    if not 0 <= error_rate <= 0.7:
        raise ValueError(f"error rate {error_rate} out of [0, 0.7]")
    if not 0 <= mismatch_rate <= 1:
        raise ValueError(f"mismatch rate {mismatch_rate} out of [0, 1]")
    rng = np.random.default_rng(seed)
    N = num_reads
    if length_range is not None:
        lo, hi = length_range
        if not 1 <= lo <= hi:
            raise ValueError(f"bad length_range {length_range}")
        lens = rng.integers(lo, hi + 1, size=N).astype(np.int32)
        length = hi
        err_cap = np.ceil(
            lens.astype(np.float32) * np.float32(error_rate)
        ).astype(np.int32)  # per-pair float32 ceil (see nominal_errors)
        max_errors = int(err_cap.max(initial=0))
    else:
        lens = np.full(N, length, dtype=np.int32)
        max_errors = nominal_errors(length, error_rate)
        err_cap = np.full(N, max_errors, dtype=np.int32)
    W = length + max_errors  # worst-case text length (all insertions)

    pattern = rng.integers(0, 4, size=(N, length), dtype=np.int8)
    text = np.full((N, W), 0, dtype=np.int8)
    text[:, :length] = pattern
    if length_range is not None:
        # bases past each pair's own length are don't-care in the text
        # evolution (all ops index < tlen) but must not leak into reads
        text[:, :length][np.arange(length)[None, :] >= lens[:, None]] = 0
    tlen = lens.copy()

    if exact_error_rate:
        nerr = err_cap.copy()
    elif length_range is None:  # the original draw order
        nerr = rng.integers(0, max_errors + 1, size=N).astype(np.int32)
    else:
        nerr = (rng.random(N) * (err_cap + 1)).astype(np.int32)

    cols = np.arange(W, dtype=np.int32)[None, :]  # [1, W]
    for step in range(max_errors):
        live = step < nerr  # pairs still receiving errors
        r = rng.random(N)
        is_mis = r <= mismatch_rate
        is_del = (~is_mis) & (rng.integers(1, 3, size=N) == 1)
        is_ins = (~is_mis) & (~is_del)
        pos = (rng.random(N) * tlen).astype(np.int32)  # uniform in [0, tlen)
        base = rng.integers(0, 4, size=N, dtype=np.int8)

        # gather index per row: deletion shifts the tail left, insertion
        # shifts it right; mismatch rows gather identity then scatter `base`
        posc = pos[:, None]
        gather = np.where(
            (is_del & live)[:, None],
            cols + (cols >= posc),
            np.where((is_ins & live)[:, None], cols - (cols > posc), cols),
        )
        np.clip(gather, 0, W - 1, out=gather)
        text = np.take_along_axis(text, gather, axis=1)
        put = live & (is_mis | is_ins)
        rows = np.nonzero(put)[0]
        text[rows, pos[rows]] = base[rows]
        tlen = tlen + live * (is_ins.astype(np.int32) - is_del.astype(np.int32))

    read_codes = np.full((N, max_len), pad_read, dtype=np.int8)
    m = min(length, max_len)
    read_codes[:, :m] = pattern[:, :m]
    read_len = np.minimum(lens, max_len).astype(np.int32)
    # positions past each read's true length must stay sentinel
    rmask = np.arange(max_len)[None, :] >= read_len[:, None]
    read_codes[rmask] = pad_read

    ref_codes = np.full((N, max_len), pad_ref, dtype=np.int8)
    w = min(W, max_len)
    ref_codes[:, :w] = text[:, :w]
    mask = np.arange(max_len)[None, :] >= np.minimum(tlen, max_len)[:, None]
    ref_codes[mask] = pad_ref
    ref_len = np.minimum(tlen, max_len).astype(np.int32)
    return read_codes, read_len, ref_codes, ref_len


def generate_real_profile_arrays(
    num_reads: int,
    length: int = 100,
    mismatch_frac: float = 0.02452309963366200179,
    insert_frac: float = 0.00046834182131581764,
    delete_frac: float = 0.00055319598705419218,
    seed: int = 0,
    max_len: int = 128,
    pad_read: int = 4,
    pad_ref: int = 5,
    length_range: tuple[int, int] | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Synthetic stand-in for the reference's real-data corpus.

    The reference benchmarks a corpus derived from Illumina run SRR611076
    (benchmark.cpp:28-30) and publishes only its error profile: ~2.452%
    mismatches, ~0.047% insertions, ~0.055% deletions per base
    (README.md:70-76). This generator reproduces the profile: per-base
    independent substitutions to one of the three other bases and per-base
    indels at the published rates, applied sequentially to the evolving
    text like `generate_dataset_arrays`. Same draws, in the same order, as
    `asm_tpu.data.generator.generate_real_profile_arrays`.
    """
    rng = np.random.default_rng(seed)
    N = num_reads
    if length_range is not None:
        lo, hi = length_range
        if not 1 <= lo <= hi:
            raise ValueError(f"bad length_range {length_range}")
        lens = rng.integers(lo, hi + 1, size=N).astype(np.int32)
        length = hi
    else:
        lens = np.full(N, length, dtype=np.int32)
    pattern = rng.integers(0, 4, size=(N, length), dtype=np.int8)
    if length_range is not None:
        pattern[np.arange(length)[None, :] >= lens[:, None]] = 0

    # realized substitutions: flip to one of the other three bases
    mis = rng.random((N, length)) < mismatch_frac
    delta = rng.integers(1, 4, size=(N, length), dtype=np.int8)
    text_base = np.where(mis, (pattern + delta) % 4, pattern).astype(np.int8)

    n_ins = rng.binomial(lens, insert_frac).astype(np.int32)
    n_del = rng.binomial(lens, delete_frac).astype(np.int32)
    max_ev = int(max((n_ins + n_del).max(initial=0), 0))
    Wt = length + (int(n_ins.max(initial=0)) if N else 0)
    text = np.full((N, max(Wt, length)), 0, dtype=np.int8)
    text[:, :length] = text_base
    tlen = lens.copy()
    Wt = text.shape[1]
    cols = np.arange(Wt, dtype=np.int32)[None, :]
    for step in range(max_ev):
        do_ins = step < n_ins
        do_del = (step >= n_ins) & (step < n_ins + n_del)
        live = do_ins | do_del
        pos = (rng.random(N) * tlen).astype(np.int32)
        base = rng.integers(0, 4, size=N, dtype=np.int8)
        posc = pos[:, None]
        gather = np.where(
            (do_del & live)[:, None],
            cols + (cols >= posc),
            np.where((do_ins & live)[:, None], cols - (cols > posc), cols),
        )
        np.clip(gather, 0, Wt - 1, out=gather)
        text = np.take_along_axis(text, gather, axis=1)
        rows = np.nonzero(do_ins)[0]
        text[rows, pos[rows]] = base[rows]
        tlen = tlen + live * (do_ins.astype(np.int32) - do_del.astype(np.int32))

    read_codes = np.full((N, max_len), pad_read, dtype=np.int8)
    m = min(length, max_len)
    read_codes[:, :m] = pattern[:, :m]
    read_len = np.minimum(lens, max_len).astype(np.int32)
    rmask = np.arange(max_len)[None, :] >= read_len[:, None]
    read_codes[rmask] = pad_read
    ref_codes = np.full((N, max_len), pad_ref, dtype=np.int8)
    w = min(Wt, max_len)
    ref_codes[:, :w] = text[:, :w]
    mask = np.arange(max_len)[None, :] >= np.minimum(tlen, max_len)[:, None]
    ref_codes[mask] = pad_ref
    ref_len = np.minimum(tlen, max_len).astype(np.int32)
    return read_codes, read_len, ref_codes, ref_len


def dataset_filename(
    num_reads: int, length: int, error_rate: float, exact: bool = True
) -> str:
    """Reference naming convention (benchmark_dataset.h:242-253)."""
    suffix = "eq" if exact else "lt_eq"
    return f"simulated_{num_reads}_{length}_{error_rate:.6f}_{suffix}.seq"


def generate_dataset_native(num_reads, length, error_rate, mismatch_rate=0.96,
                            exact_error_rate=True, seed=0, max_len=128):
    """C++ corpus generator (same error process, its own seeded
    mt19937_64 stream); raises when the native library is unavailable."""
    from asm_tpu_torch.native import load_native
    from asm_tpu_torch.utils.hostmem import host_array

    lib = load_native(required=True)
    rc = host_array((num_reads, max_len), np.int8)
    fc = host_array((num_reads, max_len), np.int8)
    rl = host_array(num_reads, np.int32)
    fl = host_array(num_reads, np.int32)
    lib.asm_generate_dataset(
        num_reads, length, error_rate, mismatch_rate, int(exact_error_rate),
        seed, max_len, rc, rl, fc, fl,
    )
    return rc, rl, fc, fl
