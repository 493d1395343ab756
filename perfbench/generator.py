"""Seeded simulated read pairs, made on the device (the benchmark's frozen
copy of the WFA-derived generator, GASMA/benchmark/benchmark_dataset.h:
61-254).

Each read is `length` random bases; its reference is a copy that takes
ceil(length x rate) errors (the float32 ceil the source computes, so
rate 0.15 at length 100 gives 16), one after another at uniform positions
of the evolving text: a mismatch with probability `mismatch_rate` (a
fresh random base, which may equal the old one), else a deletion or an
insertion, half and half. The draws come from one `torch.Generator` on
the pool's device, in a fixed order, so a seed gives the same pool on
every run on one kind of device. The pool is made in chunks, so that the
temporaries stay near a gigabyte however large it is.

Codes: int8 [N, max_len], 0-3 the bases, PAD_READ (4) past a read's
length and PAD_REF (5) past a reference's; lengths int32 (a reference
longer than max_len is cut to it).
"""

from __future__ import annotations

import math

import numpy as np
import torch

PAD_READ = 4
PAD_REF = 5
CHUNK_ELEMENTS = 1 << 27  # pairs x text columns per chunk


def nominal_errors(length: int, rate: float) -> int:
    """ceil(length x rate) in float32, as the source computes it."""
    return math.ceil(np.float32(length) * np.float32(rate))


def rate_labels(n: int, shares, order: str, gen: torch.Generator,
                device) -> torch.Tensor:
    """int64[n]: the index into `shares` (fractions summing to 1) of each
    pair's error rate; whole blocks in the shares' order ("blocks"), or
    shuffled by a permutation drawn from `gen` ("interleaved")."""
    counts = [int(round(s * n)) for s in shares]
    counts[-1] = n - sum(counts[:-1])
    if min(counts) < 0:
        raise ValueError(f"shares {shares} do not split {n} pairs")
    labels = torch.repeat_interleave(
        torch.arange(len(counts), device=device),
        torch.tensor(counts, device=device))
    if order == "interleaved":
        labels = labels[torch.randperm(n, generator=gen, device=device)]
    elif order != "blocks":
        raise ValueError(f"order must be 'interleaved' or 'blocks', got "
                         f"{order!r}")
    return labels


def _chunk(nerr: torch.Tensor, length: int, mismatch_rate: float,
           max_len: int, gen: torch.Generator):
    """Pairs of one chunk, nerr int32[N] errors each. Returns the four
    arrays and int32[N] events applied."""
    device = nerr.device
    N = nerr.shape[0]
    max_errors = int(nerr.max()) if N else 0
    W = length + max_errors  # the longest text: every error an insertion
    read = torch.randint(0, 4, (N, length), generator=gen, device=device,
                         dtype=torch.int8)
    text = torch.zeros((N, W), dtype=torch.int8, device=device)
    text[:, :length] = read
    tlen = torch.full((N,), length, dtype=torch.int64, device=device)
    cols = torch.arange(W, device=device)[None, :]
    events = torch.zeros(N, dtype=torch.int32, device=device)
    for step in range(max_errors):
        live = step < nerr
        r = torch.rand(N, generator=gen, device=device, dtype=torch.float64)
        coin = torch.randint(1, 3, (N,), generator=gen, device=device)
        u = torch.rand(N, generator=gen, device=device, dtype=torch.float64)
        base = torch.randint(0, 4, (N,), generator=gen, device=device,
                             dtype=torch.int8)
        is_mis = r <= mismatch_rate
        is_del = ~is_mis & (coin == 1) & live
        is_ins = ~is_mis & ~is_del & live
        pos = (u * tlen).to(torch.int64).clamp(min=0)
        p = pos[:, None]
        gather = torch.where(is_del[:, None], cols + (cols >= p).long(),
                             torch.where(is_ins[:, None],
                                         cols - (cols > p).long(), cols))
        gather.clamp_(0, W - 1)
        text = torch.gather(text, 1, gather)
        put = live & (is_mis | is_ins)
        rows = torch.nonzero(put)[:, 0]
        text[rows, pos[rows].clamp(max=W - 1)] = base[rows]
        tlen = tlen + is_ins.to(torch.int64) - is_del.to(torch.int64)
        events += live.to(torch.int32)

    m = min(length, max_len)
    read_codes = torch.full((N, max_len), PAD_READ, dtype=torch.int8,
                            device=device)
    read_codes[:, :m] = read[:, :m]
    read_len = torch.full((N,), m, dtype=torch.int32, device=device)
    w = min(W, max_len)
    ref_codes = torch.full((N, max_len), PAD_REF, dtype=torch.int8,
                           device=device)
    ref_codes[:, :w] = text[:, :w]
    ref_len = tlen.clamp(max=max_len).to(torch.int32)
    past = torch.arange(max_len, device=device)[None, :] >= ref_len[:, None]
    ref_codes[past] = PAD_REF
    return read_codes, read_len, ref_codes, ref_len, events


def make_pool(n: int, length: int, rates, shares, mismatch_rate: float,
              max_len: int, order: str, seed: int, device) -> dict:
    """The pool of a run: read, read_len, ref, ref_len (on `device`), the
    error-rate index of each pair (`label`) and the events each pair took
    (`events`, int32), all from `seed`."""
    if not 0 < length <= max_len:
        raise ValueError(f"read length {length} not in (0, {max_len}]")
    if not 0 <= mismatch_rate <= 1:
        raise ValueError(f"mismatch rate {mismatch_rate} out of [0, 1]")
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    labels = rate_labels(n, shares, order, gen, device)
    per_rate = torch.tensor([nominal_errors(length, r) for r in rates],
                            dtype=torch.int32, device=device)
    nerr = per_rate[labels]
    W = length + int(per_rate.max())
    step = max(1, CHUNK_ELEMENTS // W)
    parts = [_chunk(nerr[lo:lo + step], length, mismatch_rate, max_len, gen)
             for lo in range(0, n, step)]
    read, read_len, ref, ref_len, events = (torch.cat(a) for a in zip(*parts))
    return dict(read=read, read_len=read_len, ref=ref, ref_len=ref_len,
                label=labels, events=events)
