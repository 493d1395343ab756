"""Three-way benchmark harness: NW oracle vs LEAP vs Greedy (port of
`asm_tpu.bench.harness`).

Mirrors the reference's `benchmark` class (GASMA/benchmark/
benchmark_utils.h:28-417) as batched GPU passes:

  * the 1M-iteration per-pair loop (:373-385) -> chunked kernel launches
    over a corpus staged on the device up-front, so the timed region
    holds only the aligner;
  * per-algorithm `times()` accounting (:84-89) -> one timed region per
    algorithm (`utils.timing.time_dispatches`: CUDA events on a card, the
    host clock elsewhere), after one untimed warm-up launch;
  * accuracy = penalty equals the NW optimum (:249-255);
  * coverage = the greedy CIGAR covers the NW CIGAR's long consecutive
    matches with thresholds (1, 3) (:256-258), on every pair or a prefix
    (`metrics.coverage_device.coverage_counts`).

impl="cuda" runs the hand-written kernels: NW through the measured-band
partitioned dispatch (a measuring pass, `required_band`, the band-major
plan; the timed region is `nw_partition_execute`, whose result must equal
the measuring pass), greedy and LEAP on the corpus staged as tile-major
2-bit planes. impl="torch" runs the plain versions on int8 codes, as the
JAX harness's impl="xla" runs the XLA kernels. On CPU tensors the
kernels' wrappers run their plain versions too, so both impls run here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from asm_tpu_torch.config import AlignConfig
from asm_tpu_torch.kernels.greedy import greedy_align
from asm_tpu_torch.kernels.greedy_cuda import (
    greedy_align_cuda,
    stage_planes_tiled_t,
)
from asm_tpu_torch.kernels.leap import leap_align
from asm_tpu_torch.kernels.leap_cuda import leap_align_cuda
from asm_tpu_torch.kernels.nw import nw_penalty
from asm_tpu_torch.kernels.nw_band import (
    BWS,
    nw_penalty_partitioned,
    required_band,
)
from asm_tpu_torch.kernels.nw_dispatch import (
    nw_partition_execute,
    nw_partition_plan,
)
from asm_tpu_torch.metrics.coverage_device import coverage_counts
from asm_tpu_torch.utils.timing import time_dispatches

TILE = 4096  # pairs per tile of the staged planes


@dataclasses.dataclass
class BenchmarkResult:
    """Everything benchmark::print reports (benchmark_utils.h:390-402)."""

    total: int
    nw_time: float
    leap_time: float
    greedy_time: float
    nw_accuracy: float  # 1.0 by construction (NW is the oracle)
    leap_accuracy: float
    greedy_accuracy: float
    greedy_coverage: float
    coverage_checked: int
    # derived throughputs (alignments / second)
    nw_aligns_per_sec: float = 0.0
    leap_aligns_per_sec: float = 0.0
    greedy_aligns_per_sec: float = 0.0
    # where the times were taken: the card's name, or "cpu"
    device: str = ""


def _device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def run_benchmark(
    read_codes: np.ndarray,
    read_len: np.ndarray,
    ref_codes: np.ndarray,
    ref_len: np.ndarray,
    cfg: AlignConfig | None = None,
    chunk: int = 1 << 17,
    coverage_sample: int | None = None,
    want_coverage: bool = True,
    impl: str = "cuda",
    device="cuda",
) -> BenchmarkResult:
    """Run the three-way benchmark over a host corpus (int8 codes [B, L],
    int32 lengths).

    `chunk` bounds the pairs per launch; the tail chunk is padded with the
    corpus's first pairs to a full chunk, and only the true pairs are
    scored. `coverage_sample=None` checks coverage on the full corpus, like
    the reference; an int caps the checked prefix; 0 or
    want_coverage=False skips it. impl: "cuda" (the kernels) or "torch"
    (the plain versions)."""
    if impl not in ("cuda", "torch"):
        raise ValueError(f"impl must be 'cuda' or 'torch', got {impl!r}")
    cfg = cfg or AlignConfig()
    device = torch.device(device)
    B = read_codes.shape[0]
    chunk = min(chunk, B)

    slices = [slice(i, min(i + chunk, B)) for i in range(0, B, chunk)]
    sizes = [sl.stop - sl.start for sl in slices]

    def chunk_args(sl):
        n = sl.stop - sl.start
        if n == chunk:
            return (read_codes[sl], read_len[sl], ref_codes[sl], ref_len[sl])
        pad = chunk - n
        return (
            np.concatenate([read_codes[sl], read_codes[:pad]]),
            np.concatenate([read_len[sl], read_len[:pad]]),
            np.concatenate([ref_codes[sl], ref_codes[:pad]]),
            np.concatenate([ref_len[sl], ref_len[:pad]]),
        )

    def upload(arrays):
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                     for a in arrays)

    def timed_pass(fn, args_list):
        """One untimed warm-up launch, then every chunk and the reduction
        of the outputs as one timed region; returns (seconds, the outputs
        of the true pairs as numpy)."""
        fn(*args_list[0])
        outs, timing = time_dispatches(
            [lambda a=a: fn(*a) for a in args_list], device,
            after=lambda outs: sum(o.sum(dtype=torch.int64) for o in outs))
        return timing["seconds"], np.concatenate(
            [o[:n].cpu().numpy() for o, n in zip(outs, sizes)])

    if impl == "cuda":
        corpus = upload((read_codes, read_len, ref_codes, ref_len))
        pen0 = nw_penalty_partitioned(*corpus, x=cfg.x, o=cfg.o, e=cfg.e,
                                      bws=BWS)
        del corpus
        bands = required_band(pen0, o=cfg.o, e=cfg.e, bws=BWS)
        plan = nw_partition_plan(read_codes, read_len, ref_codes, ref_len,
                                 bands, x=cfg.x, o=cfg.o, e=cfg.e, bws=BWS,
                                 max_chunk=chunk, device=device)
        nw_partition_execute(plan)  # warm-up
        nw_pen = nw_partition_execute(plan)
        nw_time = plan.last_exec_seconds
        if not np.array_equal(nw_pen, pen0):
            raise AssertionError("partitioned NW != measuring pass")
        del plan

        def stage(args):
            rc, rl, fc, fl = args
            return upload((stage_planes_tiled_t(rc, tile=TILE).view(np.int32),
                           rl,
                           stage_planes_tiled_t(fc, tile=TILE).view(np.int32),
                           fl))

        staged = [stage(chunk_args(sl)) for sl in slices]
        greedy_time, g_cost = timed_pass(
            lambda *a: greedy_align_cuda(*a, cfg, pre_staged="planes_tiled",
                                         tile=TILE, want_cigar=False)["cost"],
            staged)
        leap_time, l_pen = timed_pass(
            lambda *a: leap_align_cuda(*a, cfg, pre_staged="planes_tiled",
                                       tile=TILE)["penalty"], staged)
    else:
        staged = [upload(chunk_args(sl)) for sl in slices]
        nw_time, nw_pen = timed_pass(
            lambda *a: nw_penalty(*a, cfg.x, cfg.o, cfg.e), staged)
        greedy_time, g_cost = timed_pass(
            lambda *a: greedy_align(*a, cfg)["cost"], staged)
        leap_time, l_pen = timed_pass(
            lambda *a: leap_align(*a, cfg)["penalty"], staged)
    del staged

    leap_acc = float((l_pen == nw_pen).mean())
    greedy_acc = float((g_cost == nw_pen).mean())

    coverage = 0.0
    checked = 0
    if want_coverage and (coverage_sample is None or coverage_sample > 0):
        cov = coverage_counts(read_codes, read_len, ref_codes, ref_len, cfg,
                              coverage_sample=coverage_sample, chunk=chunk,
                              device=device, impl=impl)
        checked = cov["checked"]
        coverage = cov["covered"] / max(checked, 1)

    return BenchmarkResult(
        total=B,
        nw_time=nw_time,
        leap_time=leap_time,
        greedy_time=greedy_time,
        nw_accuracy=1.0,
        leap_accuracy=leap_acc,
        greedy_accuracy=greedy_acc,
        greedy_coverage=coverage,
        coverage_checked=checked,
        nw_aligns_per_sec=B / nw_time if nw_time else 0.0,
        leap_aligns_per_sec=B / leap_time if leap_time else 0.0,
        greedy_aligns_per_sec=B / greedy_time if greedy_time else 0.0,
        device=_device_name(device),
    )


def format_report(r: BenchmarkResult) -> str:
    """The reference's report block (benchmark_utils.h:390-402), plus
    throughput lines that name the device the times were taken on."""
    on = f" on {r.device}" if r.device else ""
    lines = [
        "===================== Benchmark Results =====================",
        f"Total number of alignments: {r.total}",
        "[Time]",
        f"=> Needleman-Wunsch | {r.nw_time:.3f} s"
        f"  ({r.nw_aligns_per_sec / 1e6:.3f}M aligns/s{on})",
        f"=> LEAP             | {r.leap_time:.3f} s"
        f"  ({r.leap_aligns_per_sec / 1e6:.3f}M aligns/s{on})",
        f"=> Greedy           | {r.greedy_time:.3f} s"
        f"  ({r.greedy_aligns_per_sec / 1e6:.3f}M aligns/s{on})",
        "[Accuracy] (percentage of alignments matching optimal penalty)",
        f"=> Needleman-Wunsch | {r.nw_accuracy * 100:.3f} %",
        f"=> LEAP             | {r.leap_accuracy * 100:.3f} %",
        f"=> Greedy           | {r.greedy_accuracy * 100:.3f} %",
        "[Coverage] (percentage of alignments covering all long consecutive matches)",
        f"=> Greedy           | {r.greedy_coverage * 100:.3f} %"
        f"  (checked on {r.coverage_checked} pairs)",
    ]
    return "\n".join(lines)
