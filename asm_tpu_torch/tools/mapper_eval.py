"""Mapper quality and throughput at chromosome scale (port of
tools/mapper_eval.py).

Generates a synthetic genome (default 50 Mbp, human-chromosome order),
samples reads at known origins with the real-profile error process
(SRR611076 rates: ~2.45% mismatch, ~0.05% insert, ~0.055% delete,
reference README.md:73-76), runs index -> pigeonhole seeds -> batched
rescoring on the card's greedy kernel (asm_tpu_torch.mapper), and reports:

  * recall: reads whose best placement is within TOL of the true origin;
    eligible recall over the reads with <= max_errors injected errors;
  * MAPQ sanity (mapq == 60 + cost, the main.cpp:96 quirk), unmapped
    reads and the cost distribution;
  * end-to-end reads/s of a cold and a steady pass (after an 8-read
    warm-up that builds and loads the kernel), the steady pass's stage
    profile, kernel_ms (the summed CUDA-event time of the rescoring
    launches) and its share of the wall, the greedy kernel's launches and
    their bound (utils.bounds.greedy_work, codes route);
  * with --trace DIR, one more steady pass inside `utils.profiling.
    trace_to(DIR)`: the card's busy and idle share over that call (the
    union of its kernel and copy records in the trace, over the call's
    wall) and the Chrome trace in DIR.

Usage: python -m asm_tpu_torch.tools.mapper_eval [--genome-mbp 50]
       [--reads 20000] [--read-len 100] [--batch 8192] [--seed 7]
       [--device cuda|cpu] [--trace DIR]
--device cpu runs the plain PyTorch version on the CPU. The last line is
one JSON object; on a card it names the card and its power limit
(nvidia-smi).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from asm_tpu_torch.kernels import greedy_cuda
from asm_tpu_torch.mapper.core import MapperConfig, build_index, map_reads
from asm_tpu_torch.mapper.simulate import sample_reads


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--genome-mbp", type=float, default=50.0)
    ap.add_argument("--reads", type=int, default=20000)
    ap.add_argument("--read-len", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--max-errors", type=int, default=3)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--tol", type=int, default=5)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (the kernel, default) or cpu (plain version)")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="trace one more steady pass into DIR and report "
                         "the card's busy share over it")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu for the plain "
                         "version")
    if args.trace and args.device != "cuda":
        raise SystemExit("--trace reads the card's activity; it needs "
                         "--device cuda")

    rng = np.random.default_rng(args.seed)
    n = int(args.genome_mbp * 1e6)
    t0 = time.perf_counter()
    genome = rng.integers(0, 4, size=n, dtype=np.int8)
    print(f"genome: {n / 1e6:.0f} Mbp ({time.perf_counter() - t0:.1f}s)",
          file=sys.stderr)

    t0 = time.perf_counter()
    idx = build_index(genome)
    t_index = time.perf_counter() - t0
    print(f"index build: {t_index:.1f}s ({n / t_index / 1e6:.2f} Mbp/s)",
          file=sys.stderr)

    t0 = time.perf_counter()
    reads, lens, origins, nerr = sample_reads(genome, args.reads,
                                              args.read_len, rng)
    print(f"read sampling: {time.perf_counter() - t0:.1f}s "
          f"(errors/read mean {nerr.mean():.2f}, "
          f"{(nerr <= args.max_errors).mean():.3f} within the pigeonhole "
          f"budget)", file=sys.stderr)

    mcfg = MapperConfig(max_errors=args.max_errors, batch=args.batch)
    # the warm-up builds and loads the kernel outside the measured passes
    map_reads(idx, genome, reads[:8], lens[:8], mcfg=mcfg, device=args.device)

    walls = {}
    prof = {}
    for label in ("cold", "steady"):
        prof = {}
        greedy_cuda.LAUNCHES = 0
        t0 = time.perf_counter()
        best, sam = map_reads(idx, genome, reads, lens, mcfg=mcfg,
                              profile=prof, device=args.device)
        walls[label] = time.perf_counter() - t0
        staged = sum(v for k, v in prof.items() if k.endswith("_s"))
        print(f"[{label}] stage profile (s): " + "  ".join(
            f"{k[:-2]}={v:.4f}" for k, v in prof.items() if k.endswith("_s"))
            + f"  [stages {staged:.3f} / wall {walls[label]:.3f}]  "
            f"jobs={prof.get('n_jobs')} two_phase={prof.get('two_phase')} "
            f"kernel_ms={prof.get('kernel_ms')}", file=sys.stderr)
    kernel_launches = greedy_cuda.LAUNCHES
    traced = None
    if args.trace:
        from asm_tpu_torch.utils.profiling import device_activity, trace_to

        with trace_to(args.trace) as tprof:
            t0 = time.perf_counter()
            map_reads(idx, genome, reads, lens, mcfg=mcfg,
                      device=args.device)
            wall_us = (time.perf_counter() - t0) * 1e6
        act = device_activity(tprof)
        traced = dict(wall_s=wall_us / 1e6, **act,
                      busy_share=act["busy_us"] / wall_us,
                      kernel_share=act["kernel_us"] / wall_us,
                      idle_share=1 - act["busy_us"] / wall_us)
        print(f"[traced] {json.dumps(traced)}", file=sys.stderr)

    hit = sum(b is not None for b in best)
    ok = np.array([b is not None and abs(b["pos"] - int(o)) <= args.tol
                   for b, o in zip(best, origins)])
    mapq_ok = all(b is None or b["mapq"] == 60 + b["cost"] for b in best)
    costs = np.array([b["cost"] for b in best if b is not None])
    elig = nerr <= args.max_errors
    t_map = walls["steady"]
    kernel_ms = prof.get("kernel_ms")
    line = {
        "metric": "mapper_reads_per_sec",
        "value": args.reads / t_map,
        "unit": "reads/s",
        "device": (torch.cuda.get_device_name(0) if args.device == "cuda"
                   else "cpu"),
        "genome_mbp": args.genome_mbp,
        "reads": args.reads,
        "batch": args.batch,
        "recall": float(ok.mean()),
        "recall_eligible": float(ok[elig].mean()),
        "unmapped": args.reads - hit,
        "cost_sum": int(costs.sum()),
        "mapq_quirk_ok": mapq_ok,
        "index_build_s": t_index,
        "cold_map_s": walls["cold"],
        "cold_reads_per_sec": args.reads / walls["cold"],
        "map_s": t_map,
        "stage_profile_s": {k[:-2]: v for k, v in prof.items()
                            if k.endswith("_s")},
        "n_jobs": prof.get("n_jobs"),
        "two_phase": prof.get("two_phase"),
        "batches": prof.get("p1_batches", 0) + prof.get("p2_batches", 0),
        "kernel_ms": kernel_ms,
        "kernel_share_of_wall": (None if kernel_ms is None
                                 else kernel_ms / 1e3 / t_map),
        "kernel_launches": kernel_launches,
        "bound_ms": prof.get("bound_ms"),
        "bound_by": prof.get("bound_by"),
        "traced": traced,
    }
    print(f"mapped {hit}/{args.reads}  recall(|pos-origin|<={args.tol}) "
          f"{line['recall']:.4f} (eligible {line['recall_eligible']:.4f})  "
          f"mapq_quirk_ok {mapq_ok}  cost mean {costs.mean():.2f} "
          f"p50 {np.median(costs):.0f} max {costs.max()}  map wall "
          f"{t_map:.3f}s (cold {walls['cold']:.3f}s) = "
          f"{line['value']:,.0f} reads/s", file=sys.stderr)
    if args.device == "cuda":
        from asm_tpu_torch.tools.roofline import card_line

        line["card"] = card_line()
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
