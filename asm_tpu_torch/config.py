"""Typed configuration for the alignment kernels (PyTorch port).

A copy of `asm_tpu.config` — same fields, defaults, enums and derived
properties — so the port never imports the JAX package.
`config_from_jax` turns an `asm_tpu.config.AlignConfig` into this one.
"""

from __future__ import annotations

import dataclasses
import enum
import math


class AlignmentType(enum.IntEnum):
    """cf. GASMA/utils.h:554-558 (alignment_type_t)."""

    GLOBAL = 0
    SEMI_GLOBAL = 1
    LOCAL = 2


class GapPenalty(enum.IntEnum):
    """cf. GASMA/utils.h:563-566 (gap_penalty_t)."""

    LEVENSHTEIN = 0
    AFFINE = 1


class LeapMode(enum.IntEnum):
    """cf. GASMA/benchmark/LEAP_SIMD/LV_BAG.h:38 (ED_modes)."""

    LOCAL = 0
    GLOBAL = 1
    SEMI_FREE_BEGIN = 2
    SEMI_FREE_END = 3


@dataclasses.dataclass(frozen=True)
class AlignConfig:
    """Shared alignment configuration; field meanings as in
    `asm_tpu.config.AlignConfig`.

    x / o / e: mismatch, gap-open (first gap character) and gap-extension
    penalties; k: band half-width (greedy lanes -k..k); max_len: sequence
    length L (a multiple of 32 for the packed kernels); alignment_type:
    GLOBAL / SEMI_GLOBAL; match_prob / mismatch_prob / indel_prob: priors
    of greedy's significance heuristic; flip_threshold: denoise threshold
    (the reference uses 1); exact_floats: float64 heuristic (plain path
    only); max_steps: greedy loop bound (default max_len);
    max_cigar_ops: CIGAR slot count (default 2 * steps + 2).
    """

    x: int = 1
    o: int = 1
    e: int = 1
    k: int = 3
    max_len: int = 128
    alignment_type: AlignmentType = AlignmentType.GLOBAL
    match_prob: float = 0.80
    mismatch_prob: float = 0.20 / 3
    indel_prob: float = 0.40 / 3
    leap_af_threshold: int = 200
    leap_mode: LeapMode = LeapMode.GLOBAL
    flip_threshold: int = 1
    exact_floats: bool = False
    leap_max_energy: int | None = None
    max_steps: int | None = None
    max_cigar_ops: int | None = None

    @property
    def num_lanes(self) -> int:
        """Greedy lane count: lanes -k..k (hurdle_matrix.h:509-512)."""
        return 2 * self.k + 1

    @property
    def leap_total_lanes(self) -> int:
        """LEAP lane count incl. sentinel border lanes (LV_BAG.cpp:78)."""
        return 2 * self.k + 3

    @property
    def steps_bound(self) -> int:
        return self.max_steps if self.max_steps is not None else self.max_len

    @property
    def leap_energy_bound(self) -> int:
        if self.leap_max_energy is not None:
            return self.leap_max_energy
        return min(self.leap_af_threshold, 48)

    @property
    def cigar_ops_bound(self) -> int:
        if self.max_cigar_ops is not None:
            return self.max_cigar_ops
        return 2 * self.steps_bound + 2

    @property
    def significance(self) -> tuple[float, float, float]:
        """(match_sig, mismatch_sig, indel_sig), hurdle_matrix.h:536-538."""
        return (
            math.log(self.match_prob / 0.25),
            math.log(self.mismatch_prob / 0.25),
            math.log(self.indel_prob / 2 / 0.25),
        )

    def __post_init__(self):
        if self.k < 0:
            raise ValueError(f"band half-width k must be >= 0, got {self.k}")
        if self.max_len <= 0:
            raise ValueError(f"max_len must be positive, got {self.max_len}")
        if min(self.x, self.o, self.e) < 0:
            raise ValueError("penalties must be non-negative")


DEFAULT_CONFIG = AlignConfig()

# The configuration of the reference's headline benchmark:
# benchmark bench(1, 1, 1, 3, 1000000, true)  (GASMA/benchmark/benchmark.cpp:22)
BENCHMARK_CONFIG = AlignConfig(x=1, o=1, e=1, k=3)

_ENUM_FIELDS = {
    "alignment_type": AlignmentType,
    "leap_mode": LeapMode,
}


def config_from_jax(cfg) -> AlignConfig:
    """The port's AlignConfig with every field of `cfg` (an
    `asm_tpu.config.AlignConfig`, or anything with the same attributes);
    enums are mapped by value."""
    kw = {}
    for f in dataclasses.fields(AlignConfig):
        v = getattr(cfg, f.name)
        if f.name in _ENUM_FIELDS:
            v = _ENUM_FIELDS[f.name](int(v))
        kw[f.name] = v
    return AlignConfig(**kw)
