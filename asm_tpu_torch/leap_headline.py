"""LEAP headline of the port: LEAP throughput on one GPU in its three modes
(port of the leap, leap_cigar and leap_gated sections of
tools/headline_kernels.py:134-343, in one process):

  1. the native generator builds the corpus (seed 42, mismatch rate 0.96,
     length 100, max_len 128);
  2. the difficulty sort orders it; it is staged as tile-major 2-bit planes
     and uploaded in chunks;
  3. an untimed penalty pass (lv_bag, x = o = e = 1, k = 3, af = 200,
     GLOBAL) gives every pair's pass energy; its stable argsort is the
     measured-energy order, and the corpus is restaged in it;
  4. the metrics, each a warm-up rep and then `--reps` timed reps (CUDA
     events; the best rep is reported):
       leap        the penalty pass again (lv_bag, af = 200);
       leap_cigar  the fused CIGAR, each chunk with its own record bound
                   E (its largest passed energy, rounded up to 16) from
                   an untimed penalty pass of the CIGAR configuration
                   (unit, or --cigar-cfg affine: x = 2, o = 3, e = 1, the
                   reference LEAP driver's init_affine, main.cpp:97);
                   after the reps every chunk's largest passed energy must
                   be within its bound; one record buffer serves every
                   chunk;
       leap_gated  SIMD_ED levenshtein (af = k = 3) with the SHD gate in
                   the kernel.
Corpus generation, sorting, staging, the untimed passes and uploads are
outside the timed region, as in the reference (benchmark_utils.h:185-201
times only the aligner).

    python -m asm_tpu_torch.leap_headline [leap leap_cigar leap_gated]
        [--pairs N] [--chunk N] [--err R] [--reps N] [--cigar-cfg unit|affine]

prints one JSON line per metric under the JAX tool's names
({name}_alignments_per_sec), with vs_baseline against the reference's
single-core LEAP time at the nearest error rate, the checksum (the
penalty total; for leap_gated plus the passed count), the per-chunk
largest passed energies and energy bounds, the best rep's per-dispatch ms
and enqueue ms, and the kernel's bound (`kernel_bound`). --check-plain N
holds the kernel against the plain version on N pairs of the corpus.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import time

import numpy as np
import torch

from asm_tpu_torch.config import AlignConfig
from asm_tpu_torch.headline import native_corpus, stage_chunks
from asm_tpu_torch.kernels.leap_cuda import (
    cigar_pass_config,
    energy_bound,
    leap_align_cuda,
    leap_cigar_decode,
    max_passed_energy,
)
from asm_tpu_torch.parallel.schedule import difficulty_order
from asm_tpu_torch.utils.bounds import bound_entry, leap_levels, leap_work
from asm_tpu_torch.utils.timing import log, nearest_rate, time_reps

METRICS = ("leap", "leap_cigar", "leap_gated")
# reference single-core seconds per 1M LEAP alignments at each simulated
# error rate (tools/headline_kernels.py:50-53; the CIGAR and gated rows
# use the same baseline)
REF_SECONDS = {0.05: 1.55, 0.10: 2.89, 0.15: 3.85, 0.20: 4.47}


def baseline_rate(err: float) -> float:
    return nearest_rate(REF_SECONDS, err)


def leap_config() -> AlignConfig:
    """lv_bag at the benchmark's af_threshold = 200 (benchmark_utils.h:289)."""
    return AlignConfig(x=1, o=1, e=1, k=3, max_len=128)


def cigar_config(kind: str = "unit") -> AlignConfig:
    if kind == "unit":
        return leap_config()
    if kind == "affine":
        return AlignConfig(x=2, o=3, e=1, k=3, max_len=128)
    raise ValueError(f"cigar config must be 'unit' or 'affine', got {kind!r}")


def gated_config() -> AlignConfig:
    """init_levenshtein(k = 3): unit penalties, af == k."""
    return AlignConfig(x=1, o=1, e=1, k=3, leap_af_threshold=3, max_len=128)


def penalty_pass(chunks, cfg: AlignConfig, tile: int) -> list[dict]:
    return [leap_align_cuda(*c, cfg, pre_staged="planes_tiled", tile=tile)
            for c in chunks]


def chunk_energies(outs) -> list[int]:
    """Largest passed energy of each chunk's output."""
    return [max_passed_energy(o["penalty"], o["passed"]) for o in outs]


def _totals(outs) -> tuple[int, int]:
    pen = sum(int(o["penalty"].sum(dtype=torch.int64)) for o in outs)
    passed = sum(int(o["passed"].sum(dtype=torch.int64)) for o in outs)
    return pen, passed


def kernel_bound(name: str, outs, cfg: AlignConfig, bounds=None) -> dict:
    """bound_ms / bound_by of one rep of metric `name` whose per-chunk
    outputs are `outs` (utils.bounds.leap_work): the e = 0 row of every
    pair and the levels each ran (`utils.bounds.leap_levels`); leap_cigar
    adds its record rows (`bounds`: the E of each chunk) and walk steps."""
    cat = {k: torch.cat([o[k] for o in outs]).cpu().numpy()
           for k in ("passed", "penalty", "lane_shift")}
    n = cat["penalty"].size
    sem = "simd_ed_lev" if name == "leap_gated" else "lv_bag"
    levels = leap_levels(cat["passed"], cat["penalty"], cat["lane_shift"],
                         cfg.leap_af_threshold, sem)
    walk = rows = 0
    if name == "leap_cigar":
        walk = int(np.where(cat["passed"], cat["penalty"], 0).sum())
        rows = sum((E + 1) * o["penalty"].numel()
                   for E, o in zip(bounds, outs))
    return bound_entry(*leap_work(n, n + int(levels.sum()), cfg.k,
                                  cfg.max_len, rows, walk,
                                  gate=name == "leap_gated"))


def cigar_digest(cigars) -> tuple[str, int]:
    """sha256 of the newline-joined CIGARs of passed pairs (None entries
    skipped) in the given order, and their count."""
    got = [c for c in cigars if c is not None]
    return hashlib.sha256("\n".join(got).encode()).hexdigest(), len(got)


def run(n_pairs: int = 1 << 26, chunk: int = 1 << 25, err: float = 0.05,
        tile: int = 4096, device="cuda", reps: int = 5, which=METRICS,
        cigar_cfg: str = "unit", digest: bool = False) -> dict:
    """The LEAP headline flow. Returns n_pairs, corpus, perm (the
    measured-energy order of the corpus rows), chunks (the staged chunks
    in that order), chunk_max_energy and energy_bounds (per chunk, the
    largest passed energy of the untimed lv_bag pass and the record bound
    E it gives), and per metric in `which` a dict: checksum, rep_s (empty
    on the CPU), best, outs (the last rep's per-chunk outputs) and, for
    leap and leap_gated, passed; for leap_cigar its own energy_bounds,
    chunk_max_energy and, with digest, the CIGAR digest of passed pairs in
    corpus order (`cigar_digest`)."""
    device = torch.device(device)
    for name in which:
        if name not in METRICS:
            raise ValueError(f"unknown metric {name!r}; one of {METRICS}")
    t0 = time.perf_counter()
    corpus = native_corpus(n_pairs, err)
    log(f"corpus: {n_pairs} pairs err={err} "
        f"({time.perf_counter() - t0:.1f}s)")
    t0 = time.perf_counter()
    perm = difficulty_order(*corpus)
    chunks = stage_chunks(corpus, perm, chunk, tile, device)
    log(f"difficulty sort + staging: {time.perf_counter() - t0:.1f}s")

    # untimed penalty pass -> the measured-energy order, restaged
    t0 = time.perf_counter()
    cfg = leap_config()
    first = penalty_pass(chunks, cfg, tile)
    pen0 = torch.cat([o["penalty"] for o in first]).cpu()
    passed0 = torch.cat([o["passed"] for o in first]).cpu()
    order = np.argsort(pen0.numpy(), kind="stable")
    perm = perm[order]
    del chunks, first
    chunks = stage_chunks(corpus, perm, chunk, tile, device)
    idx = torch.from_numpy(order)
    energies = [max_passed_energy(p, ok) for p, ok in zip(
        pen0[idx].split(chunk), passed0[idx].split(chunk))]
    bounds = [energy_bound(e, cfg.leap_af_threshold)
              for e in energies]
    log(f"energy pass + restage: {time.perf_counter() - t0:.1f}s; "
        f"per-chunk max passed energy {energies}, bounds {bounds}")

    res = dict(n_pairs=n_pairs, corpus=corpus, perm=perm, chunks=chunks,
               chunk_max_energy=energies, energy_bounds=bounds)
    if "leap" in which:
        rep_s, best, outs = time_reps(
            [lambda c=c: leap_align_cuda(*c, cfg, pre_staged="planes_tiled",
                                         tile=tile) for c in chunks],
            reps, device)
        pen = torch.cat([o["penalty"] for o in outs]).cpu()
        if not torch.equal(pen, pen0[idx]):
            raise AssertionError("leap penalties changed with the order")
        checksum, passed = _totals(outs)
        log(f"leap checksum {checksum}, passed {passed}")
        res["leap"] = dict(checksum=checksum, passed=passed, rep_s=rep_s,
                           best=best, outs=outs,
                           bound=kernel_bound("leap", outs, cfg))

    if "leap_cigar" in which:
        pcfg = cigar_config(cigar_cfg)
        # each chunk's record bound from an untimed penalty pass
        ccfgs = [cigar_pass_config(pcfg, o)
                 for o in penalty_pass(chunks, pcfg, tile)]
        bounds = [c.leap_energy_bound for c in ccfgs]
        log(f"leap_cigar energy pass: per-chunk bounds {bounds}")
        sizes = [(E + 1) * c[1].shape[0] for E, c in zip(bounds, chunks)]
        buf = torch.empty(max(sizes), dtype=torch.int32, device=device)
        recs = [buf[:s].view(E + 1, -1) for s, E in zip(sizes, bounds)]

        def cigar_fn(c, ccfg, rec):
            return lambda: leap_align_cuda(*c, ccfg, pre_staged="planes_tiled",
                                           tile=tile, want_cigar=True,
                                           rec_out=rec)

        fns = [cigar_fn(*a) for a in zip(chunks, ccfgs, recs)]
        rep_s, best, outs = time_reps(fns, reps, device)
        chunk_max = chunk_energies(outs)
        log(f"leap_cigar max passed energy per chunk: {chunk_max} "
            f"(bounds {bounds})")
        for got, E in zip(chunk_max, bounds):
            if got > E:
                raise AssertionError(f"energy bound too tight for corpus: "
                                     f"{chunk_max} > {bounds}")
        checksum, _ = _totals(outs)
        res["leap_cigar"] = dict(
            checksum=checksum, rep_s=rep_s, best=best, outs=outs,
            chunk_max_energy=chunk_max, energy_bounds=bounds,
            bound=kernel_bound("leap_cigar", outs, pcfg, bounds))
        if digest:
            # the records buffer holds one chunk at a time: rerun and
            # decode chunk by chunk (untimed)
            cigars = [None] * n_pairs
            lo = 0
            for f, ccfg in zip(fns, ccfgs):
                dec = leap_cigar_decode(f(), ccfg)
                for i, d in zip(perm[lo:lo + len(dec)].tolist(), dec):
                    cigars[i] = None if d is None else d[1]
                lo += len(dec)
            res["leap_cigar"]["digest"] = cigar_digest(cigars)
        del buf, recs

    if "leap_gated" in which:
        gcfg = gated_config()
        rep_s, best, outs = time_reps(
            [lambda c=c: leap_align_cuda(*c, gcfg, pre_staged="planes_tiled",
                                         tile=tile, semantics="simd_ed_lev",
                                         use_shd_gate=True) for c in chunks],
            reps, device)
        pen, passed = _totals(outs)
        log(f"leap_gated checksum {pen + passed} (penalties {pen}, "
            f"passed {passed})")
        res["leap_gated"] = dict(checksum=pen + passed, passed=passed,
                                 rep_s=rep_s, best=best, outs=outs,
                                 bound=kernel_bound("leap_gated", outs, gcfg))
    return res


def check_plain(res: dict, n_sample: int) -> dict:
    """The plain version (`kernels.leap.leap_align`) on n_sample pairs
    spread evenly over the measured-energy order, against the kernel's
    leap and leap_gated outputs of `res`; raises on any difference.
    Returns, per metric, the pairs compared and the plain version's
    seconds on them."""
    from asm_tpu_torch.kernels.leap import leap_align

    dev = res["chunks"][0][0].device
    stride = max(1, res["n_pairs"] // n_sample)
    idx = np.arange(0, res["n_pairs"], stride)[:n_sample]
    rows = res["perm"][idx]
    args = [torch.from_numpy(np.ascontiguousarray(a[rows])).to(dev)
            for a in res["corpus"]]
    at = torch.from_numpy(idx).to(dev)
    runs = {"leap": (leap_config(), {}),
            "leap_gated": (gated_config(), dict(semantics="simd_ed_lev",
                                                use_shd_gate=True))}
    out = {}
    for name, (cfg, kw) in runs.items():
        if name not in res:
            continue
        t0 = time.perf_counter()
        want = leap_align(*args, cfg, **kw)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        secs = time.perf_counter() - t0
        for key in ("passed", "penalty", "lane_shift"):
            got = torch.cat([o[key] for o in res[name]["outs"]])[at]
            if not torch.equal(got, want[key]):
                raise AssertionError(f"{name}: the kernel's {key} differs "
                                     f"from the plain version's")
        out[name] = dict(pairs=len(idx), plain_s=secs)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("metrics", nargs="*", default=list(METRICS))
    ap.add_argument("--pairs", type=int, default=1 << 26)
    ap.add_argument("--chunk", type=int, default=1 << 25)
    ap.add_argument("--err", type=float, default=0.05)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--cigar-cfg", choices=("unit", "affine"),
                    default="unit")
    ap.add_argument("--check-plain", type=int, default=0, metavar="N",
                    help="compare the kernel with the plain version on N "
                         "pairs spread over the corpus (leap, leap_gated)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("the LEAP headline measures the GPU; no CUDA device")
    if args.reps < 1:
        raise SystemExit("--reps must be >= 1")
    res = run(args.pairs, args.chunk, args.err, reps=args.reps,
              which=args.metrics, cigar_cfg=args.cigar_cfg)
    plain = check_plain(res, args.check_plain) if args.check_plain else {}
    for name in args.metrics:
        m = res[name]
        rate = res["n_pairs"] / min(m["rep_s"])
        metric = name if name != "leap_cigar" or args.cigar_cfg == "unit" \
            else "leap_cigar_affine"
        line = {
            "metric": f"{metric}_alignments_per_sec",
            "value": round(rate, 1),
            "unit": "aligns/s",
            "vs_baseline": round(rate / baseline_rate(args.err), 3),
            "device": torch.cuda.get_device_name(0),
            "checksum": m["checksum"],
            "chunk_max_energy": m.get("chunk_max_energy",
                                      res["chunk_max_energy"]),
            "energy_bounds": m.get("energy_bounds", res["energy_bounds"]),
            **m["best"],
            "bound_ms": m["bound"]["bound_ms"],
            "bound_by": m["bound"]["bound_by"],
        }
        if "passed" in m:
            line["passed"] = m["passed"]
        if name in plain:
            line["plain_check"] = plain[name]
        print(json.dumps(line))


if __name__ == "__main__":
    main()
