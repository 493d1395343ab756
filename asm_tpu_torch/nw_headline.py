"""NW headline of the port: exact Needleman-Wunsch/Gotoh penalty
throughput on one GPU through the measured-band partitioned dispatch
(port of tools/headline_kernels.py's "nw" section, 346-445).

  1. the native generator builds the corpus (seed 42, mismatch rate 0.96,
     length 100, max_len 128; x = o = e = 1);
  2. the difficulty sort orders it, and it is staged as position-major
     2-bit planes;
  3. an untimed measuring pass (`nw_penalty_partitioned`, bands 8, 16,
     32, 64, residue to the full kernel) gives every pair's exact penalty,
     and `required_band` its smallest certifying band;
  4. the corpus is restaged band-major (stable: the difficulty order is
     kept within a band) and `nw_partition_plan` uploads it in chunks;
  5. `nw_partition_execute` runs a warm-up rep, then `--reps` timed reps
     (CUDA events; best rep reported). Every band chunk re-proves its
     certificate in the run, and the penalties must equal the measuring
     pass's pair by pair; either failure raises.
Corpus generation, sort, staging, the measuring pass and uploads are
outside the timed region, as in the reference (benchmark_utils.h:185-201
times only the aligner).

    python -m asm_tpu_torch.nw_headline [--pairs N] [--chunk N] [--err R] [--reps N]

prints one JSON line {"metric": "nw_alignments_per_sec", ...}, with the
best rep's breakdown: each dispatch's band width, pairs and ms (CUDA
events), the host's enqueue time (a bound on the device's idle time in
the rep), the pull of the penalties after it and the kernels' bound
(`bound_ms`, `bound_by`: utils.bounds). With the
defaults (67,108,864 pairs, err 0.05) the checksum is 249930000 with
partitions {8: 25367126, 16: 41741738}; at --err 0.20 it is 924929469
with {8: 41, 16: 94414, 32: 53645952, 64: 13368457}.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from asm_tpu_torch.headline import native_corpus
from asm_tpu_torch.kernels.greedy_cuda import stage_planes_t
from asm_tpu_torch.kernels.nw_band import (
    nw_penalty_partitioned,
    required_band,
)
from asm_tpu_torch.kernels.nw_dispatch import (
    band_major_order,
    nw_partition_execute,
    nw_partition_plan,
)
from asm_tpu_torch.parallel.schedule import difficulty_order
from asm_tpu_torch.utils.bounds import bound_entry, nw_band_work, nw_full_work
from asm_tpu_torch.utils.hostmem import take_rows
from asm_tpu_torch.utils.timing import best_of_reps, log, nearest_rate

BWS = (8, 16, 32, 64)
# reference single-core seconds per 1M NW alignments at each simulated
# error rate (the reference README's table; the nearest rate is used)
REF_SECONDS = {0.05: 36.22, 0.10: 34.26, 0.15: 32.33, 0.20: 31.55}


def baseline_rate(err: float) -> float:
    return nearest_rate(REF_SECONDS, err)


def _planes(codes, perm, device):
    return torch.from_numpy(stage_planes_t(codes, perm=perm).view(
        np.int32)).to(device)


def run(n_pairs: int = 1 << 26, chunk: int = 1 << 25, err: float = 0.05,
        seed: int = 42, device="cuda", reps: int = 5,
        corpus=None) -> dict:
    """The NW headline flow. Returns checksum, partitions, dispatches,
    rep_s (CUDA-event seconds per timed rep; empty on the CPU), best (the
    fastest rep's dispatch_ms, enqueue_ms and pull_ms), pen (the
    exact penalty per pair, in `perm` order), perm (difficulty order of
    the corpus rows), order (band-major order of `perm`'s positions),
    plan, corpus and n_pairs. `corpus` (read codes, read lengths, ref
    codes, ref lengths) replaces the native corpus when given."""
    device = torch.device(device)
    if corpus is None:
        t0 = time.perf_counter()
        corpus = native_corpus(n_pairs, err, seed, 128)
        log(f"corpus: {n_pairs} pairs err={err} "
            f"({time.perf_counter() - t0:.1f}s)")
    rc, rl, fc, fl = corpus
    n_pairs = rl.shape[0]
    t0 = time.perf_counter()
    perm = difficulty_order(*corpus)
    rl_p, fl_p = take_rows(rl, perm), take_rows(fl, perm)
    log(f"difficulty sort: {time.perf_counter() - t0:.1f}s")

    # measuring pass (untimed): exact penalties -> each pair's band
    t0 = time.perf_counter()
    rp, fp = _planes(rc, perm, device), _planes(fc, perm, device)
    rl_d = torch.from_numpy(rl_p).to(device)
    fl_d = torch.from_numpy(fl_p).to(device)
    pen0 = np.concatenate([
        nw_penalty_partitioned(rp[:, i:i + chunk], rl_d[i:i + chunk],
                               fp[:, i:i + chunk], fl_d[i:i + chunk],
                               bws=BWS, pre_staged=True)
        for i in range(0, n_pairs, chunk)]) if n_pairs else np.zeros(
            0, np.int32)
    del rp, fp, rl_d, fl_d
    bands = required_band(pen0, bws=BWS)
    log(f"measuring pass: {time.perf_counter() - t0:.1f}s, bands "
        f"{dict(zip(*[v.tolist() for v in np.unique(bands, return_counts=True)]))}")

    # band-major restage (stable: the difficulty order within a band)
    t0 = time.perf_counter()
    order = band_major_order(bands)
    perm2 = perm[order]
    plan = nw_partition_plan(
        stage_planes_t(rc, perm=perm2), rl_p[order],
        stage_planes_t(fc, perm=perm2), fl_p[order], bands[order],
        bws=BWS, max_chunk=chunk, pre_staged=True, already_sorted=True,
        device=device)
    log(f"band restage + upload: {time.perf_counter() - t0:.1f}s; "
        f"partitions {plan.partitions} -> {len(plan.chunks)} dispatches")

    def rep():
        pen = nw_partition_execute(plan)
        return pen, dict(
            seconds=plan.last_exec_seconds,
            dispatch_ms=[s * 1e3 for s in plan.last_dispatch_seconds],
            enqueue_ms=plan.last_enqueue_seconds * 1e3,
            pull_ms=plan.last_pull_seconds * 1e3)

    rep_s, best, pen = best_of_reps(rep, reps, device)
    if not np.array_equal(pen, pen0[order]):
        raise AssertionError("partitioned NW disagrees with the measuring "
                             "pass")
    checksum = int(pen.sum(dtype=np.int64))
    log(f"total-penalty checksum: {checksum}")
    return dict(checksum=checksum, partitions=plan.partitions,
                dispatches=len(plan.chunks), rep_s=rep_s, best=best, pen=pen0,
                perm=perm, order=order, plan=plan, corpus=corpus,
                n_pairs=n_pairs, bound=kernel_bound(rl_p, fl_p, bands))


def kernel_bound(read_len, ref_len, bands) -> dict:
    """bound_ms / bound_by of one rep (utils.bounds): the band cells of
    every band pair and the full DP of the band-0 residue."""
    m, n = np.minimum(read_len, 128), np.minimum(ref_len, 128)
    ops, nbytes = nw_band_work(m, n, bands)
    res = bands == 0
    if res.any():
        ops += nw_full_work(m[res], n[res])[0]
    return bound_entry(ops, nbytes)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=1 << 26)
    ap.add_argument("--chunk", type=int, default=1 << 25)
    ap.add_argument("--err", type=float, default=0.05)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("the NW headline measures the GPU; no CUDA device")
    if args.reps < 1:
        raise SystemExit("--reps must be >= 1")
    res = run(args.pairs, args.chunk, args.err, reps=args.reps)
    rate = res["n_pairs"] / min(res["rep_s"])
    print(json.dumps({
        "metric": "nw_alignments_per_sec",
        "value": round(rate, 1),
        "unit": "aligns/s",
        "vs_baseline": round(rate / baseline_rate(args.err), 3),
        "device": torch.cuda.get_device_name(0),
        "checksum": res["checksum"],
        "partitions": {str(k): v for k, v in res["partitions"].items()},
        "dispatches": res["dispatches"],
        "dispatch_widths": res["plan"].widths,
        "dispatch_pairs": [c[1].shape[0] for c in res["plan"].chunks],
        **res["best"],
        "bound_ms": res["bound"]["bound_ms"],
        "bound_by": res["bound"]["bound_by"],
    }))


if __name__ == "__main__":
    main()
