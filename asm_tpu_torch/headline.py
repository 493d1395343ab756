"""Headline benchmark of the port: greedy alignment throughput on one GPU.

The reference's flagship measurement — simulated ~100 bp read/ref pairs
at error rate 0.05, x=1, o=1, e=1, k=3 (GASMA/benchmark/benchmark.cpp:
14-26) — through the CUDA greedy kernel:

  1. the native generator builds the corpus (seed 42, mismatch rate 0.96,
     max_len 128);
  2. the difficulty sort orders the pairs;
  3. each chunk is staged on the host as tile-major 2-bit planes, the
     permutation fused into staging, and uploaded;
  4. the kernel runs on every chunk; CUDA events time each rep of all
     chunks, after a warm-up rep;
  5. the measured per-pair step counts give the exact easy -> hard order
     and pow2 per-chunk step bounds, and a second pass runs in that order.
The total-cost checksum must agree between the passes and every chunk's
max step count must stay below its bound (no walk was truncated). Corpus
generation, sorting and staging are outside the timed region, as in the
reference (benchmark_utils.h:185-201 times only the aligner).

    python -m asm_tpu_torch.headline [--pairs N] [--chunk N] [--reps N]

prints one JSON line {"metric": "greedy_alignments_per_sec", ...}, with
the best rep's per-dispatch ms and enqueue ms and the kernel's bound
(`bound_ms`, `bound_by`: utils.bounds). With
the defaults (67,108,864 pairs) the checksum is 256177757 and the
per-chunk max steps are [1, 27].
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from asm_tpu_torch.config import AlignConfig
from asm_tpu_torch.data.generator import generate_dataset_native
from asm_tpu_torch.kernels.greedy_cuda import stage_planes_tiled_t
from asm_tpu_torch.parallel.runner import make_greedy_step
from asm_tpu_torch.parallel.schedule import (
    difficulty_order,
    quantized_step_bounds,
)
from asm_tpu_torch.utils.build import REPO_DIR
from asm_tpu_torch.utils.bounds import bound_entry, greedy_work
from asm_tpu_torch.utils.hostmem import take_rows
from asm_tpu_torch.utils.timing import log, time_reps

# reference: 1M pairs in 0.85 s on one CPU core (README.md:14, BASELINE.md)
BASELINE_ALIGNS_PER_SEC = 1_000_000 / 0.85


def headline_config(max_steps: int = 32) -> AlignConfig:
    return AlignConfig(x=1, o=1, e=1, k=3, max_len=128, max_steps=max_steps)


def native_corpus(n_pairs: int, err: float, seed: int = 42,
                  max_len: int = 128, cache: bool = False):
    """The headline corpus from the native generator (its checksum holds
    only for that stream; no numpy fallback). cache=True keeps it in
    bench_cache/ for later runs."""
    params = dict(n=n_pairs, err=err, mr=0.96, seed=seed, length=100,
                  gen="native")
    path = os.path.join(REPO_DIR, "bench_cache",
                        f"torch_corpus_{n_pairs}_{err}_{seed}.npz")
    if cache:
        from asm_tpu_torch.utils.corpus_cache import load_corpus

        got = load_corpus(path, **params)
        if got is not None:
            return got
    got = generate_dataset_native(n_pairs, 100, err, mismatch_rate=0.96,
                                  seed=seed, max_len=max_len)
    if cache:
        from asm_tpu_torch.utils.corpus_cache import save_corpus

        save_corpus(path, *got, **params)
    return got


def stage_chunks(corpus, perm, chunk: int, tile: int, device) -> list:
    """(read planes, read lengths, ref planes, ref lengths) of each chunk of
    `perm` (corpus rows), staged tile-major and uploaded to `device`."""
    rc, rl, fc, fl = corpus
    chunks = []
    for lo in range(0, perm.shape[0], chunk):
        p = perm[lo:lo + chunk]
        arrays = (stage_planes_tiled_t(rc, perm=p, tile=tile).view(np.int32),
                  take_rows(rl, p),
                  stage_planes_tiled_t(fc, perm=p, tile=tile).view(np.int32),
                  take_rows(fl, p))
        chunks.append(tuple(torch.from_numpy(a).to(device) for a in arrays))
    return chunks


def run_pass(corpus, perm, bounds, cfg: AlignConfig, chunk: int, tile: int,
             device, impl: str = "cuda", reps: int = 1) -> dict:
    """Stage, upload and align the corpus in `perm` order, chunk by chunk
    (chunk i with steps bound bounds[i]).

    Returns checksum (total cost), chunk_max (max steps per chunk),
    cost and steps (int32 per pair, in `perm` order) and, on a CUDA
    device, the CUDA-event seconds of each timed rep over all chunks
    (`rep_s`) and the fastest rep's dispatch_ms and enqueue_ms (`best`).
    """
    device = torch.device(device)
    n = perm.shape[0]
    n_chunks = -(-n // chunk)
    if len(bounds) != n_chunks:
        raise ValueError(f"{len(bounds)} bounds for {n_chunks} chunks")
    t0 = time.perf_counter()
    chunks = stage_chunks(corpus, perm, chunk, tile, device)
    log(f"staging + upload: {time.perf_counter() - t0:.1f}s")
    steps_fns = [
        make_greedy_step(dataclasses.replace(cfg, max_steps=b), device,
                         impl=impl, pre_staged="planes_tiled", tile=tile)
        for b in bounds]
    fns = [lambda f=f, c=c: f(*c) for f, c in zip(steps_fns, chunks)]
    rep_s, best, outs = time_reps(fns, reps, device)
    return dict(
        checksum=sum(int(o["cost"].sum(dtype=torch.int64)) for o in outs),
        chunk_max=[int(o["steps"].max()) for o in outs],
        cost=np.concatenate([o["cost"].cpu().numpy() for o in outs]),
        steps=np.concatenate([o["steps"].cpu().numpy() for o in outs]),
        rep_s=rep_s,
        best=best,
    )


def run(n_pairs: int = 1 << 26, chunk: int = 1 << 25, err: float = 0.05,
        seed: int = 42, max_steps: int = 32, tile: int = 4096,
        device="cuda", impl: str = "cuda", reps: int = 5,
        cache: bool = False) -> dict:
    """The headline flow; returns the measured-order pass's checksum,
    chunk_max, bounds, rep_s, best, per-pair cost and steps, and its perm,
    the corpus, the heuristic pass's results (`first`) and the kernel's
    bound for one rep (`bound`: utils.bounds.greedy_work). Raises if the two
    passes disagree or a bound truncated a walk."""
    cfg = headline_config(max_steps)
    n_pairs = max(chunk, (n_pairs // chunk) * chunk)
    n_chunks = n_pairs // chunk
    t0 = time.perf_counter()
    corpus = native_corpus(n_pairs, err, seed, cfg.max_len, cache=cache)
    log(f"corpus: {n_pairs} pairs err={err} "
        f"({time.perf_counter() - t0:.1f}s)")
    t0 = time.perf_counter()
    perm = difficulty_order(*corpus)
    log(f"difficulty sort: {time.perf_counter() - t0:.1f}s")

    bounds = [cfg.steps_bound] * n_chunks
    first = run_pass(corpus, perm, bounds, cfg, chunk, tile, device, impl,
                     reps)
    _check_bounds(first["chunk_max"], bounds)
    # the measured step counts give the exact order the heuristic sort
    # approximates, and each chunk its own pow2 bound
    order = np.argsort(first["steps"], kind="stable")
    perm = perm[order]
    bounds = quantized_step_bounds(first["steps"][order], chunk)
    log(f"measured-steps order: per-chunk bounds {bounds}")
    second = run_pass(corpus, perm, bounds, cfg, chunk, tile, device, impl,
                      reps)
    _check_bounds(second["chunk_max"], bounds)
    if second["checksum"] != first["checksum"]:
        raise AssertionError(
            f"checksum changed with the order: {first['checksum']} -> "
            f"{second['checksum']}")
    log(f"total-cost checksum: {second['checksum']}")
    log(f"max greedy steps per chunk: {second['chunk_max']} "
        f"(bounds {bounds})")
    return dict(second, n_pairs=n_pairs, bounds=bounds, perm=perm,
                corpus=corpus, first=first,
                bound=bound_entry(*greedy_work(second["steps"], bounds, chunk,
                                               cfg.k, cfg.max_len)))


def _check_bounds(chunk_max, bounds) -> None:
    for got, bound in zip(chunk_max, bounds):
        if got >= bound:
            raise AssertionError(
                f"steps bound too tight for corpus: max {got} >= {bound}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=1 << 26)
    ap.add_argument("--chunk", type=int, default=1 << 25)
    ap.add_argument("--err", type=float, default=0.05)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--max-steps", type=int, default=32)
    ap.add_argument("--tile", type=int, default=4096)
    ap.add_argument("--cache", action="store_true",
                    help="keep the corpus in bench_cache/ for later runs")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("the headline measures the GPU; no CUDA device")
    res = run(args.pairs, args.chunk, args.err, max_steps=args.max_steps,
              tile=args.tile, reps=args.reps, cache=args.cache)
    rate = res["n_pairs"] / min(res["rep_s"])
    print(json.dumps({
        "metric": "greedy_alignments_per_sec",
        "value": round(rate, 1),
        "unit": "aligns/s",
        "vs_baseline": round(rate / BASELINE_ALIGNS_PER_SEC, 3),
        "device": torch.cuda.get_device_name(0),
        "checksum": res["checksum"],
        "chunk_max_steps": res["chunk_max"],
        **res["best"],
        "bound_ms": res["bound"]["bound_ms"],
        "bound_by": res["bound"]["bound_by"],
    }))


if __name__ == "__main__":
    main()
