"""GPU smoke test of the PyTorch / CUDA port (asm_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card, nvcc, cuobjdump and g++. Phases, each printing one
line:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: the greedy, NW, NW band, LEAP and roofline kernels (nvcc,
     sm_90a) and the native host runtime, all at once, from this
     checkout's sources;
  3. kernel vs plain: greedy_align_cuda on CUDA tensors against the plain
     PyTorch greedy_align on the same device, on the corpora of the
     kernel's conformance tests, both input forms — cost, steps, raw step
     records and decoded CIGARs must be exactly equal;
  4. main path: the headline flow (native corpus -> difficulty sort ->
     tile-major planes -> kernel, then the measured-order pass) at
     1,000,000 pairs, the reference's own benchmark size; the checksum
     must equal the pinned value, every chunk's max steps must stay below
     its bound, and the kernel must have been launched; then the plain
     version runs on the same pairs and must agree pair by pair.
  5. NW kernels vs plain: the band kernel at BW 8/16/32/64 in both input
     forms, the full kernel and the trace kernel (penalties, ops, match
     mask) against their plain PyTorch versions on the card, on the NW
     conformance corpora (three error profiles, variable lengths, edge
     pairs, L = 256, three x/o/e sets, partial tail blocks): exactly equal;
  6. NW main path: the NW headline flow (measuring pass, bands, band-major
     plan, timed partitioned dispatch) at 1,000,000 pairs, err 0.05 — the
     checksum and partitions must equal the pinned values and the band
     kernel must have launched, and the plain version must agree pair by
     pair; then the same flow on a 262,144-pair mixed-error corpus, whose
     band-0 residue must launch the full kernel and whose penalties must
     equal the plain full NW on every pair;
  7. coverage: the harness's coverage loop (trace kernel + greedy kernel +
     positional certificate + native fallback) on 65,536 native pairs at
     err 0.10; both counts must equal the pinned values and the trace
     kernel must have launched.
  8. LEAP kernel vs plain: leap_align_cuda in both input forms against the
     plain PyTorch leap_align on the card — passed, penalty, lane_shift
     and, in CIGAR mode, the raw edit records and decoded CIGARs exactly
     equal — on the LEAP conformance corpora (three error profiles,
     unequal lengths, edge pairs, L = 256 with full-length buffers), every
     LeapMode, unit and affine penalties, lv_bag / simd_ed_lev with and
     without the SHD gate / simd_ed_affine, k = 2 and 4, a tight
     threshold, odd batch sizes;
  9. LEAP main path: the LEAP headline flow (leap_headline.run: penalty
     pass, measured-energy order, leap / leap_cigar / leap_gated) on the
     1,000,000-pair headline corpus; the checksums, the passed count, the
     CIGAR pass's per-chunk energy bounds and the CIGAR digest must equal
     the pinned values, the kernel must have launched, and the plain
     version must agree pair by pair;
 10. the LEAP filter CLI (apps.leap_filter) on a 20,000-pair file written
     to a temporary directory, levenshtein + SHD gate and affine: both
     pass counts must equal the pinned values.
 11. harness main path: the three-way harness (bench.harness.
     run_benchmark, impl="cuda": the NW partitioned dispatch, the greedy
     and LEAP kernels on tile-major planes, coverage on every pair) on the
     1,000,000-pair headline corpus; the pairs whose greedy cost and whose
     LEAP penalty equal the NW penalty and the covered pairs must equal
     the pinned values, and the greedy, band, trace and LEAP kernels must
     have launched; then impl="torch" (the plain versions) on the first
     65,536 pairs must give the counts impl="cuda" gives there. Prints the
     reference-format report.
 12. roofline: each roofline kernel against its plain version (issue
     chain, stream fold on 256 MiB, probe with x[0] = 7), exactly equal;
     the SASS counter on the probe's real SASS (the loop body charged at
     the given weight) and on issue_chain's (its loop body holds
     STREAMS x UNROLL x 2 integer instructions besides its trip control);
     then the measured issue rate, stream rate and dispatch floor, none
     above 105% of its published limit, and the greedy and LEAP roofline
     lines of phases 4 and 9's runs.
Prints a JSON line of per-kernel results (time, plain version's time,
bound, launches), the card line, and last {"ok": true, "device": {...}}.
Any failure raises (exit code != 0).
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

# Total cost of the 1,000,000-pair headline corpus (native generator, seed
# 42, err 0.05, mismatch rate 0.96, length 100, max_len 128; x=o=e=1,
# k=3). Computed with the JAX reference, asm_tpu.kernels.greedy.
# greedy_align on the CPU, over the same native corpus in 65,536-pair
# chunks (max steps per pair there: 13).
CHECKSUM_1M = 3817504
MAIN_PAIRS = 1_000_000
MAIN_CHUNK = 500_000
MAIN_TILE = 4096

# NW penalty total and measured-band partitions of the same 1,000,000-pair
# corpus (x=o=e=1): computed with the JAX reference, asm_tpu.kernels.nw.
# nw_penalty (XLA) on the CPU in 65,536-pair chunks, bands from
# asm_tpu.kernels.nw_band.required_band(bws=(8, 16, 32, 64)).
NW_CHECKSUM_1M = 3724944
NW_PARTITIONS_1M = {8: 377356, 16: 622644}
MIXED_PAIRS = 262_144
# Coverage of 65,536 native pairs (seed 42, err 0.10, mismatch rate 0.96,
# length 100, max_len 128; AlignConfig() defaults): computed with the JAX
# package on the CPU — XLA greedy_align + nw_align(match_mask_threshold=3)
# through the harness's coverage loop (asm_tpu/bench/harness.py:247-334)
# with the native fallback — and the count of pairs whose greedy cost
# equals the NW penalty over the same pairs.
COV_PAIRS = 65_536
COV_COVERED = 61833
COV_GREEDY_EQ_NW = 51290
# LEAP on the same 1,000,000-pair headline corpus, computed with the JAX
# reference on the CPU: asm_tpu.kernels.leap.leap_align (XLA) in 65,536-pair
# chunks — lv_bag, x=o=e=1, k=3, af=200, GLOBAL: penalty total 3722582 and
# 1000000 pairs passed (max passed energy 24); simd_ed_lev, af=k=3, SHD
# gate: penalty total 3559819 + 327984 passed. The CIGAR pass's bounds are
# the largest passed energy of each 500,000-pair chunk of the stable
# energy order, rounded up to 16 (the penalties sorted, chunked: 16, 32).
# The digest is sha256 of the newline-joined CIGARs of all passed pairs in
# corpus order, from leap_align(want_history=True) + leap_backtrack_batch
# in 8,192-pair chunks.
LEAP_CHECKSUM_1M = 3722582
LEAP_PASSED_1M = 1_000_000
LEAP_GATED_CHECKSUM_1M = 3887803
LEAP_CIGAR_BOUNDS_1M = [16, 32]
LEAP_CIGAR_DIGEST_1M = (
    "d361c472d57fe024a6e13afec9a51a31808a43156afdf50dedc459acaf521872",
    1_000_000)
# The filter CLI's pass counts on write_pair_file's pairs, computed with
# the JAX package's CLI on the CPU (python -m asm_tpu.apps.leap_filter 3
# --file ..., and with "3 0 0": affine, no gate).
FILTER_PAIRS = 20_000
FILTER_PASSED = {"levenshtein+shd": 12358, "affine": 14820}
# The harness on the same 1,000,000-pair headline corpus (x=o=e=1, k=3,
# max_len 128), computed with the JAX package on the CPU:
# asm_tpu.bench.harness.run_benchmark(impl="xla", chunk=65536) over the
# native corpus, coverage on every pair: pairs whose greedy cost equals the
# NW penalty, pairs whose LEAP penalty equals it, covered pairs.
HARNESS_GREEDY_EQ = 931265
HARNESS_LEAP_EQ = 997619
HARNESS_COVERED = 975809
HARNESS_PREFIX = 65_536
# phase 12: the check's issue_chain iterations and stream size (the
# measurement takes tools/roofline.micro's) and the probe's loop trips
ISSUE_CHECK_ITERS = 16
STREAM_CHECK_MIB = 256
PROBE_TRIPS = 7


def phase(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _instance_name(ln: str) -> str | None:
    """Kernel instantiation of a ptxas "Compiling entry function" line."""
    m = re.search(r"greedy_kernelILi(\d+)ELi(\d+)ELb(\d)", ln)
    if m:
        return f"greedy k{m[1]}/W{m[2]}/{'planes' if m[3] == '1' else 'codes'}"
    m = re.search(r"band_kernelILi(\d+)ELi(\d+)E", ln)
    if m:
        return f"nw_band BW{m[1]}/W{m[2]}"
    m = re.search(r"nw_kernelILi(\d+)ELb(\d)", ln)
    if m:
        return f"{'nw_trace' if m[2] == '1' else 'nw'} W{m[1]}"
    m = re.search(r"leap_kernelILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)ELb(\d)",
                  ln)
    if m:
        return (f"leap k{m[1]}/W{m[2]}/x{m[3]}o{m[4]}e{m[5]}"
                f"{'/cigar' if m[6] == '1' else ''}")
    m = re.search(r"(issue_chain|stream_fold|probe_kernel|noop_kernel)", ln)
    if m:
        return m[1]
    return None


def ptxas_summary(path: str) -> str:
    """Registers and spill bytes per kernel instantiation from nvcc's
    -Xptxas -v report."""
    out, name, spill = [], "?", "?"
    with open(path) as f:
        for ln in f:
            if "Compiling entry function" in ln:
                name = _instance_name(ln) or "?"
            m = re.search(r"(\d+) bytes spill stores", ln)
            if m:
                spill = m[1]
            m = re.search(r"Used (\d+) registers", ln)
            if m:
                out.append(f"{name} {m[1]} regs {spill} B spill")
    return "; ".join(out)


def conformance_cases():
    from asm_tpu_torch.config import AlignConfig, AlignmentType
    from asm_tpu_torch.data.generator import generate_dataset_arrays

    G, S = AlignmentType.GLOBAL, AlignmentType.SEMI_GLOBAL
    cases = []
    for err, mr in [(0.05, 0.96), (0.2, 0.96), (0.4, 0.5)]:
        for at in (G, S):
            cases.append((f"err{err}/mr{mr}/{at.name}",
                          AlignConfig(max_steps=24, alignment_type=at),
                          generate_dataset_arrays(5000, 100, err, mr,
                                                  seed=int(err * 100))))
    cases.append(("x2o3e1k2", AlignConfig(x=2, o=3, e=1, k=2, max_steps=24),
                  generate_dataset_arrays(5000, 80, 0.1, 0.8, seed=5)))
    for bound in (1, 2):
        for at in (G, S):
            cases.append((f"max_steps{bound}/{at.name}",
                          AlignConfig(max_steps=bound, alignment_type=at),
                          generate_dataset_arrays(3000, 100, 0.1, 0.9,
                                                  seed=17)))
    cases.append(("length_range60-120", AlignConfig(max_steps=24),
                  generate_dataset_arrays(5000, 100, 0.15, 0.96, seed=44,
                                          length_range=(60, 120))))
    cases.append(("max_len256", AlignConfig(max_len=256, max_steps=64),
                  generate_dataset_arrays(3000, 200, 0.1, 0.9, seed=3,
                                          max_len=256)))
    cases.append(("max_len256/k2/err0.3",
                  AlignConfig(max_len=256, k=2, max_steps=64),
                  generate_dataset_arrays(3000, 230, 0.3, 0.6, seed=4,
                                          max_len=256)))
    return cases


def nw_conformance_cases():
    """(label, corpus) pairs of the NW kernels' conformance check."""
    from asm_tpu_torch.data.generator import generate_dataset_arrays
    from asm_tpu_torch.encoding import encode_batch

    # empty, one-base and full-length (128) sequences on both sides
    reads = ["A", "ACGT" * 32, "ACGTACGT", "", "ACGT" * 25, "AC"]
    refs = ["ACGT" * 32, "A", "ACGTACGT", "ACG", "ACGT" * 25, "TGCA" * 20]
    # odd sizes: every kernel's last block is partly empty
    return [
        ("err0.05", generate_dataset_arrays(3001, 100, 0.05, 0.96, seed=11)),
        ("err0.2", generate_dataset_arrays(3001, 100, 0.2, 0.96, seed=12)),
        ("err0.4/mr0.5", generate_dataset_arrays(3001, 100, 0.4, 0.5,
                                                 seed=13)),
        ("length_range40-120", generate_dataset_arrays(
            2001, 100, 0.12, 0.8, seed=95, length_range=(40, 120))),
        ("edges", encode_batch(reads, refs, 128)),
        ("max_len256", generate_dataset_arrays(1001, 200, 0.1, 0.9, seed=3,
                                               max_len=256)),
    ]


def mixed_corpus():
    """262,144 native pairs whose certifying bands span 8 to 64 and the
    full kernel: errors 0.02 / 0.10 / 0.20 (mismatch rate 0.96) and an
    indel-heavy err 0.45 / mismatch rate 0.10 block (the shape of
    tests/test_nw_band.py's _mixed_corpus at 2,979x its size)."""
    from asm_tpu_torch.data.generator import generate_dataset_native

    blocks = [generate_dataset_native(n, 100, err, mismatch_rate=mr,
                                      seed=70 + i, max_len=128)
              for i, (n, err, mr) in enumerate([
                  (71_680, 0.02, 0.96), (71_680, 0.10, 0.96),
                  (71_680, 0.20, 0.96), (47_104, 0.45, 0.10)])]
    return tuple(np.concatenate([b[i] for b in blocks]) for i in range(4))


def write_pair_file(path: str) -> None:
    """The filter CLI's input: FILTER_PAIRS read/ref line pairs from the
    native generator (mismatch rate 0.9, max_len 256), half with 150-base
    reads at err 0.01 (seed 77), half with 230-base reads at err 0.02
    (seed 78)."""
    from asm_tpu_torch.data.generator import generate_dataset_native
    from asm_tpu_torch.encoding import decode_string

    half = FILTER_PAIRS // 2
    with open(path, "w") as f:
        for length, err, seed in ((150, 0.01, 77), (230, 0.02, 78)):
            rc, rl, fc, fl = generate_dataset_native(
                half, length, err, mismatch_rate=0.9, seed=seed, max_len=256)
            for i in range(half):
                f.write(f"{decode_string(rc[i], rl[i])}\n"
                        f"{decode_string(fc[i], fl[i])}\n")


def cuda_ms(fn, reps: int) -> tuple[float, object]:
    """Best CUDA-event milliseconds of fn() over `reps` runs after one
    warm-up run, and the last run's result."""
    out = fn()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best, out


def max_diff(got, want, what: str) -> int:
    """Max abs difference of two integer / bool tensors; raises unless 0."""
    torch.cuda.synchronize()
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    d = int((got.to(torch.int64) - want.to(torch.int64)).abs().max().item()
            ) if got.numel() else 0
    if d:
        raise AssertionError(f"{what} differs from the plain version "
                             f"(max abs diff {d})")
    return d


def greedy_phases(dev, name, card) -> dict:
    """Phases 3 and 4 (greedy); returns the kernel's JSON entry and the
    main path's roofline inputs."""
    from asm_tpu_torch import headline
    from asm_tpu_torch.kernels import greedy_cuda
    from asm_tpu_torch.kernels.greedy import greedy_align
    from asm_tpu_torch.ops.cigar import runs_to_cigars_batch
    from asm_tpu_torch.utils.bounds import greedy_work

    # ---- 3: kernel vs plain on the card ----
    max_err = 0
    n_cmp = 0
    for label, cfg, (rc, rl, fc, fl) in conformance_cases():
        lens = [torch.from_numpy(a).to(dev) for a in (rl, fl)]
        plain = greedy_align(torch.from_numpy(rc).to(dev), lens[0],
                             torch.from_numpy(fc).to(dev), lens[1], cfg,
                             records=True)
        want = runs_to_cigars_batch(plain["cigar_ops"].cpu().numpy(),
                                    plain["cigar_runs"].cpu().numpy())
        tile = 256  # B is no multiple of it: a partial tail tile
        forms = {
            "codes": (torch.from_numpy(rc).to(dev),
                      torch.from_numpy(fc).to(dev), False),
            "planes_tiled": (
                torch.from_numpy(greedy_cuda.stage_planes_tiled_t(
                    rc, tile=tile).view(np.int32)).to(dev),
                torch.from_numpy(greedy_cuda.stage_planes_tiled_t(
                    fc, tile=tile).view(np.int32)).to(dev),
                "planes_tiled"),
        }
        for form, (a, b, pre) in forms.items():
            got = greedy_cuda.greedy_align_cuda(
                a, lens[0], b, lens[1], cfg, pre_staged=pre, tile=tile)
            torch.cuda.synchronize()
            got["trips"] = greedy_cuda.step_trips(got["steps"],
                                                  got["step_rec"])
            for key in ("cost", "steps", "step_rec", "trips"):
                d = (got[key].to(torch.int64)
                     - plain[key].to(torch.int64)).abs().max().item()
                max_err = max(max_err, d)
                if d != 0:
                    raise AssertionError(f"{label}/{form}: {key} differs "
                                         f"from the plain version (max {d})")
            cig = runs_to_cigars_batch(got["cigar_ops"].cpu().numpy(),
                                       got["cigar_runs"].cpu().numpy())
            bad = sum(x != y for x, y in zip(cig, want))
            if bad:
                raise AssertionError(f"{label}/{form}: {bad} CIGARs differ")
            n_cmp += 1
    phase(f"[3 kernel vs plain] {n_cmp} corpus/form cases on {name}: cost, "
          f"steps, step records, the step loop's trips read from them and "
          f"CIGARs exactly equal (max abs err {max_err})")

    # ---- 4: the main path ----
    greedy_cuda.LAUNCHES = 0
    res = headline.run(n_pairs=MAIN_PAIRS, chunk=MAIN_CHUNK, err=0.05,
                       tile=MAIN_TILE, device=dev, impl="cuda", reps=5)
    launches = greedy_cuda.LAUNCHES
    if launches <= 0:
        raise AssertionError("the main path never launched the kernel")
    if res["checksum"] != CHECKSUM_1M:
        raise AssertionError(f"checksum {res['checksum']} != pinned "
                             f"{CHECKSUM_1M}")
    for got, bound in zip(res["chunk_max"], res["bounds"]):
        if got >= bound:
            raise AssertionError(f"steps {res['chunk_max']} reach bounds "
                                 f"{res['bounds']}")
    kernel_ms = min(res["rep_s"]) * 1e3
    plain = headline.run_pass(res["corpus"], res["perm"], res["bounds"],
                              headline.headline_config(), MAIN_CHUNK,
                              MAIN_TILE, dev, impl="torch", reps=2)
    plain_ms = min(plain["rep_s"]) * 1e3
    d = int(np.abs(plain["cost"].astype(np.int64)
                   - res["cost"].astype(np.int64)).max())
    if d or not (np.array_equal(plain["steps"], res["steps"])
                 and np.array_equal(plain["trips"], res["trips"])):
        raise AssertionError("plain version disagrees on the main path")
    max_err = max(max_err, d)
    phase(f"[4 main path] {res['n_pairs']} pairs: checksum "
          f"{res['checksum']} (pinned), per-chunk max steps "
          f"{res['chunk_max']} < bounds {res['bounds']}, {launches} kernel "
          f"launches; kernel {kernel_ms:.3f} ms "
          f"({res['n_pairs'] / kernel_ms / 1e3:.1f}M aligns/s), plain "
          f"version {plain_ms:.3f} ms, both on {card}")
    entry = dict(name="greedy", route="cuda",
                 source="asm_tpu_torch/csrc/greedy.cu",
                 replaces="asm_tpu/kernels/greedy_pallas.py:91",
                 launches=launches, max_abs_err=float(max_err),
                 ms=kernel_ms, plain_ms=plain_ms, **res["bound"])
    # phase 12's roofline line: the step loop's trips in launch order
    rows = dict(trips=res["trips"], seconds=kernel_ms / 1e3,
                n=res["n_pairs"], bound_ms=res["bound"]["bound_ms"],
                bytes=greedy_work(res["steps"], res["bounds"],
                                  MAIN_CHUNK)[1])
    return entry, rows


def nw_conformance(dev, name) -> dict:
    """Phase 5; returns the max abs error per NW kernel (all 0)."""
    from asm_tpu_torch.kernels import nw
    from asm_tpu_torch.kernels.greedy_cuda import stage_planes_t
    from asm_tpu_torch.kernels.nw_band import BWS, banded_plain, \
        nw_penalty_banded
    from asm_tpu_torch.kernels.nw_cuda import nw_align_cuda, nw_penalty_cuda

    err = {"nw_band": 0, "nw": 0, "nw_trace": 0}
    n_cmp = 0
    for label, (rc, rl, fc, fl) in nw_conformance_cases():
        t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
             for a in (rc, rl, fc, fl)]
        planes = [torch.from_numpy(stage_planes_t(a).view(np.int32)).to(dev)
                  for a in (rc, fc)]
        for x, o, e in [(1, 1, 1), (2, 3, 1), (1, 4, 2)]:
            what = f"{label}/x{x}o{o}e{e}"
            for bw in BWS:
                want = banded_plain(*t, bw, x, o, e)
                for pre, (a, b) in ((False, (t[0], t[2])), (True, planes)):
                    got = nw_penalty_banded(a, t[1], b, t[3], bw=bw, x=x,
                                            o=o, e=e, pre_staged=pre)
                    err["nw_band"] = max(err["nw_band"], max_diff(
                        got, want, f"{what}/BW{bw}/pre_staged={pre}: pen"))
                    n_cmp += 1
            pen, ops, mask = nw.nw_align(*t, x, o, e, match_mask_threshold=3)
            err["nw"] = max(err["nw"], max_diff(
                nw_penalty_cuda(*t, x, o, e), pen, f"{what}/nw: pen"))
            got = nw_align_cuda(*t, x, o, e, match_mask_threshold=3)
            for g, w, key in zip(got, (pen, ops, mask), ("pen", "ops",
                                                          "mask")):
                err["nw_trace"] = max(err["nw_trace"], max_diff(
                    g, w, f"{what}/nw_trace: {key}"))
            n_cmp += 2
    phase(f"[5 NW kernels vs plain] {n_cmp} cases on {name}: band "
          f"penalties (BW {BWS}, codes and planes), full penalties, trace "
          f"penalties, ops and match masks exactly equal (max abs err "
          f"{max(err.values())})")
    return err


def nw_main_path(dev, card, err) -> list[dict]:
    """Phase 6; returns the band and full kernels' JSON entries."""
    from asm_tpu_torch import nw_headline
    from asm_tpu_torch.kernels import nw, nw_band, nw_cuda
    from asm_tpu_torch.kernels.nw_band import banded_plain, codes_from_planes
    from asm_tpu_torch.utils.bounds import bound_entry, nw_full_work

    nw_band.LAUNCHES = 0
    nw_cuda.LAUNCHES.update(nw=0, nw_trace=0)
    res = nw_headline.run(MAIN_PAIRS, err=0.05, device=dev, reps=5)
    band_launches = nw_band.LAUNCHES
    if band_launches <= 0:
        raise AssertionError("the NW main path never launched the band "
                             "kernel")
    if res["checksum"] != NW_CHECKSUM_1M:
        raise AssertionError(f"NW checksum {res['checksum']} != pinned "
                             f"{NW_CHECKSUM_1M}")
    if res["partitions"] != NW_PARTITIONS_1M:
        raise AssertionError(f"NW partitions {res['partitions']} != pinned "
                             f"{NW_PARTITIONS_1M}")
    band_ms = min(res["rep_s"]) * 1e3
    band_bound = res["bound"]
    plan = res["plan"]

    def plain_chunks():
        outs = []
        for bw, (a, b, c, d) in zip(plan.widths, plan.chunks):
            rc, fc = codes_from_planes(a, b), codes_from_planes(c, d)
            outs.append(banded_plain(rc, b, fc, d, bw) if bw
                        else nw.nw_penalty(rc, b, fc, d))
        return torch.cat(outs)

    band_plain_ms, plain_pen = cuda_ms(plain_chunks, 2)
    want = torch.from_numpy(res["pen"][res["order"]]).to(dev)
    err["nw_band"] = max(err["nw_band"], max_diff(
        want, plain_pen, "NW main path: pen"))
    phase(f"[6a NW main path] {res['n_pairs']} pairs err 0.05: checksum "
          f"{res['checksum']} and partitions {res['partitions']} (pinned), "
          f"{res['dispatches']} dispatches, {band_launches} band kernel "
          f"launches; kernel {band_ms:.3f} ms "
          f"({res['n_pairs'] / band_ms / 1e3:.1f}M aligns/s), plain version "
          f"{band_plain_ms:.3f} ms, equal on every pair, both on {card}")

    mixed = mixed_corpus()
    nw_band.LAUNCHES = 0
    nw_cuda.LAUNCHES.update(nw=0, nw_trace=0)
    res = nw_headline.run(corpus=mixed, device=dev, reps=2)
    full_launches = nw_cuda.LAUNCHES["nw"]
    if full_launches <= 0 or 0 not in res["partitions"]:
        raise AssertionError("the mixed corpus never launched the full "
                             "kernel on a band-0 residue")
    args = [torch.from_numpy(a).to(dev) for a in mixed]
    plain_pen = nw.nw_penalty(*args)[torch.from_numpy(res["perm"]).to(dev)]
    err["nw"] = max(err["nw"], max_diff(
        torch.from_numpy(res["pen"]).to(dev), plain_pen,
        "mixed corpus: pen vs plain full NW"))
    plan = res["plan"]
    a, b, c, d = plan.chunks[plan.widths.index(0)]
    rc, fc = codes_from_planes(a, b), codes_from_planes(c, d)
    full_ms, got = cuda_ms(lambda: nw_cuda.nw_penalty_cuda(rc, b, fc, d), 5)
    full_bound = bound_entry(*nw_full_work(b.clamp(max=128).cpu().numpy(),
                                           d.clamp(max=128).cpu().numpy()))
    full_plain_ms, want = cuda_ms(lambda: nw.nw_penalty(rc, b, fc, d), 2)
    err["nw"] = max(err["nw"], max_diff(got, want, "band-0 residue: pen"))
    phase(f"[6b NW mixed corpus] {res['n_pairs']} pairs: partitions "
          f"{res['partitions']}, {full_launches} full kernel launches, "
          f"penalties equal to the plain full NW on every pair; full kernel "
          f"on the {b.shape[0]}-pair residue {full_ms:.3f} ms, plain "
          f"version {full_plain_ms:.3f} ms, both on {card}")
    return [
        dict(name="nw_band", route="cuda",
             source="asm_tpu_torch/csrc/nw_band.cu",
             replaces="asm_tpu/kernels/nw_band.py:174",
             launches=band_launches, max_abs_err=float(err["nw_band"]),
             ms=band_ms, plain_ms=band_plain_ms, **band_bound),
        dict(name="nw", route="cuda", source="asm_tpu_torch/csrc/nw.cu",
             replaces="asm_tpu/kernels/nw_pallas.py:88",
             launches=full_launches, max_abs_err=float(err["nw"]),
             ms=full_ms, plain_ms=full_plain_ms, **full_bound),
    ]


def coverage_path(dev, card, err) -> dict:
    """Phase 7; returns the trace kernel's JSON entry."""
    from asm_tpu_torch import headline
    from asm_tpu_torch.config import AlignConfig
    from asm_tpu_torch.kernels import greedy_cuda, nw, nw_cuda
    from asm_tpu_torch.metrics.coverage_device import coverage_counts
    from asm_tpu_torch.utils.bounds import bound_entry, nw_full_work

    corpus = headline.native_corpus(COV_PAIRS, 0.10)
    greedy_cuda.LAUNCHES = 0
    nw_cuda.LAUNCHES.update(nw=0, nw_trace=0)
    t0 = time.perf_counter()
    cov = coverage_counts(*corpus, AlignConfig(), device=dev)
    wall = time.perf_counter() - t0
    trace_launches = nw_cuda.LAUNCHES["nw_trace"]
    if trace_launches <= 0 or greedy_cuda.LAUNCHES <= 0:
        raise AssertionError("coverage never launched the trace and greedy "
                             "kernels")
    if (cov["covered"], cov["greedy_equal_nw"]) != (COV_COVERED,
                                                    COV_GREEDY_EQ_NW):
        raise AssertionError(f"coverage {cov} != pinned covered "
                             f"{COV_COVERED}, greedy == NW "
                             f"{COV_GREEDY_EQ_NW}")
    args = [torch.from_numpy(np.ascontiguousarray(a[:1 << 13])).to(dev)
            for a in corpus]
    trace_ms, got = cuda_ms(
        lambda: nw_cuda.nw_align_cuda(*args, match_mask_threshold=3), 3)
    plain_ms, want = cuda_ms(
        lambda: nw.nw_align(*args, match_mask_threshold=3), 1)
    for g, w, key in zip(got, want, ("pen", "ops", "mask")):
        err["nw_trace"] = max(err["nw_trace"], max_diff(
            g, w, f"coverage chunk: {key}"))
    phase(f"[7 coverage] {cov['checked']} pairs err 0.10: covered "
          f"{cov['covered']} ({cov['certified']} by the positional "
          f"certificate), greedy cost == NW penalty {cov['greedy_equal_nw']} "
          f"(both pinned), {trace_launches} trace kernel launches, "
          f"{wall:.2f} s wall; trace kernel on 8192 pairs {trace_ms:.3f} ms, "
          f"plain version {plain_ms:.3f} ms, both on {card}")
    return dict(name="nw_trace", route="cuda",
                source="asm_tpu_torch/csrc/nw.cu",
                replaces="asm_tpu/kernels/nw_pallas.py:218",
                launches=trace_launches, max_abs_err=float(err["nw_trace"]),
                ms=trace_ms, plain_ms=plain_ms,
                **bound_entry(*nw_full_work(
                    args[1].clamp(max=128).cpu().numpy(),
                    args[3].clamp(max=128).cpu().numpy(), trace=True)))


def leap_conformance_cases():
    """(label, corpus) pairs of the LEAP kernel's conformance check; odd
    sizes, so every launch's last block is partly empty."""
    from asm_tpu_torch.data.generator import generate_dataset_arrays
    from asm_tpu_torch.encoding import encode_batch

    # empty, one-base and full-length (128) sequences on both sides
    reads = ["A", "ACGT" * 32, "ACGTACGT", "", "ACGT" * 25, "AC", ""]
    refs = ["ACGT" * 32, "A", "ACGTACGT", "ACG", "ACGT" * 25, "TGCA" * 20, ""]
    return [
        ("err0.05", generate_dataset_arrays(3001, 100, 0.05, 0.96, seed=21)),
        ("err0.2", generate_dataset_arrays(2001, 100, 0.2, 0.96, seed=22)),
        ("err0.4/mr0.5", generate_dataset_arrays(2001, 100, 0.4, 0.5,
                                                 seed=23)),
        ("length_range60-120", generate_dataset_arrays(
            2001, 100, 0.12, 0.8, seed=95, length_range=(60, 120))),
        ("edges", encode_batch(reads, refs, 128)),
        ("max_len256", generate_dataset_arrays(1001, 200, 0.1, 0.9, seed=3,
                                               max_len=256)),
        ("max_len256/full", generate_dataset_arrays(501, 256, 0.01, 0.9,
                                                    seed=4, max_len=256)),
    ]


# (semantics, use_shd_gate, (x, o, e)); simd_ed_lev is unit-cost, af == k
LEAP_VARIANTS = [
    ("lv_bag", False, (1, 1, 1)),
    ("lv_bag", False, (2, 3, 1)),
    ("simd_ed_lev", False, (1, 1, 1)),
    ("simd_ed_lev", True, (1, 1, 1)),
    ("simd_ed_affine", False, (1, 1, 1)),
    ("simd_ed_affine", False, (2, 3, 1)),
]


def leap_cfg(sem, pens, mode, max_len, k=3, af=40):
    from asm_tpu_torch.config import AlignConfig, LeapMode

    if sem == "simd_ed_lev":
        return AlignConfig(k=k, leap_af_threshold=k, max_len=max_len,
                           leap_mode=LeapMode(mode))
    return AlignConfig(x=pens[0], o=pens[1], e=pens[2], k=k,
                       leap_af_threshold=af, leap_max_energy=min(af, 40),
                       max_len=max_len, leap_mode=LeapMode(mode))


def leap_check(dev, corpus, cfg, sem, gate, what, tile=256) -> int:
    """The LEAP kernel against its plain version on one corpus and
    configuration, both input forms (lv_bag: in CIGAR mode, records and
    decoded CIGARs too); returns the max abs error (0) or raises."""
    from asm_tpu_torch.kernels.greedy_cuda import stage_planes_tiled_t
    from asm_tpu_torch.kernels.leap import leap_align
    from asm_tpu_torch.kernels.leap_backtrack import (
        leap_backtrack_batch,
        leap_edit_records,
    )
    from asm_tpu_torch.kernels.leap_cuda import (
        leap_align_cuda,
        leap_cigar_decode,
    )

    t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in corpus]
    cigar = sem == "lv_bag"
    want = leap_align(*t, cfg, semantics=sem, use_shd_gate=gate,
                      want_history=cigar)
    if cigar:
        rec = torch.from_numpy(leap_edit_records(
            want, cfg, cfg.leap_energy_bound)).to(dev)
        want_cig = [x and x[1] for x in leap_backtrack_batch(want, cfg)]
    planes = [torch.from_numpy(stage_planes_tiled_t(
        np.ascontiguousarray(a), tile=tile).view(np.int32)).to(dev)
        for a in (corpus[0], corpus[2])]
    err = 0
    for pre, (a, b) in ((False, (t[0], t[2])), ("planes_tiled", planes)):
        got = leap_align_cuda(a, t[1], b, t[3], cfg, pre_staged=pre,
                              tile=tile, semantics=sem, use_shd_gate=gate,
                              want_cigar=cigar)
        for key in ("passed", "penalty", "lane_shift"):
            err = max(err, max_diff(got[key], want[key],
                                    f"{what}/{pre}: {key}"))
        if cigar:
            err = max(err, max_diff(got["edit_rec"], rec,
                                    f"{what}/{pre}: edit_rec"))
            cig = [x and x[1] for x in leap_cigar_decode(got, cfg)]
            if cig != want_cig:
                raise AssertionError(f"{what}/{pre}: decoded CIGARs differ")
    return err


def leap_conformance(dev, name) -> int:
    """Phase 8; returns the max abs error (0)."""
    err, n_cmp = 0, 0
    cases = leap_conformance_cases()
    for label, corpus in cases:
        L = corpus[0].shape[1]
        for sem, gate, pens in LEAP_VARIANTS:
            for mode in range(4):  # LOCAL, GLOBAL, SEMI_FREE_BEGIN / _END
                what = f"{label}/{sem}/gate{int(gate)}/{pens}/mode{mode}"
                err = max(err, leap_check(dev, corpus,
                                          leap_cfg(sem, pens, mode, L), sem,
                                          gate, what))
                n_cmp += 2
    corpus = cases[0][1]
    for k in (2, 4):
        for sem, gate, pens in LEAP_VARIANTS:
            err = max(err, leap_check(dev, corpus, leap_cfg(sem, pens, 1, 128,
                                                            k=k),
                                      sem, gate, f"k{k}/{sem}/gate{gate}"))
            n_cmp += 2
    err = max(err, leap_check(dev, cases[1][1],
                              leap_cfg("lv_bag", (1, 1, 1), 1, 128, af=2),
                              "lv_bag", False, "tight af=2"))
    n_cmp += 2
    phase(f"[8 LEAP kernel vs plain] {n_cmp} cases on {name}: passed, "
          f"penalty, lane_shift, edit records and decoded CIGARs exactly "
          f"equal, codes and tile-major planes (max abs err {err})")
    return err


def leap_main_path(dev, card, err) -> dict:
    """Phase 9; returns the LEAP kernel's JSON entry and the main path's
    roofline inputs."""
    import dataclasses

    from asm_tpu_torch import leap_headline
    from asm_tpu_torch.encoding import PAD_READ, PAD_REF
    from asm_tpu_torch.kernels import leap_cuda
    from asm_tpu_torch.kernels.greedy_cuda import codes_from_planes_tiled
    from asm_tpu_torch.kernels.leap import leap_align
    from asm_tpu_torch.kernels.leap_backtrack import leap_edit_records
    from asm_tpu_torch.utils.bounds import leap_levels, leap_work

    leap_cuda.LAUNCHES = 0
    res = leap_headline.run(MAIN_PAIRS, chunk=MAIN_CHUNK, err=0.05,
                            tile=MAIN_TILE, device=dev, reps=5, digest=True)
    launches = leap_cuda.LAUNCHES
    if launches <= 0:
        raise AssertionError("the LEAP main path never launched the kernel")
    lp, lc, lg = res["leap"], res["leap_cigar"], res["leap_gated"]
    got = (lp["checksum"], lp["passed"], lg["checksum"],
           lc["energy_bounds"], lc["digest"])
    want = (LEAP_CHECKSUM_1M, LEAP_PASSED_1M, LEAP_GATED_CHECKSUM_1M,
            LEAP_CIGAR_BOUNDS_1M, LEAP_CIGAR_DIGEST_1M)
    for g, w, what in zip(got, want, ("leap checksum", "leap passed",
                                      "leap_gated checksum",
                                      "leap_cigar energy bounds",
                                      "leap_cigar CIGAR digest")):
        if g != w:
            raise AssertionError(f"{what} {g} != pinned {w}")
    ms = {k: min(res[k]["rep_s"]) * 1e3 for k in leap_headline.METRICS}

    # the plain version on the same staged pairs, pair by pair
    codes = [(codes_from_planes_tiled(a, b, PAD_READ), b,
              codes_from_planes_tiled(c, d, PAD_REF), d)
             for a, b, c, d in res["chunks"]]
    cfg, gcfg = leap_headline.leap_config(), leap_headline.gated_config()
    plain_ms, plain = cuda_ms(lambda: [leap_align(*c, cfg) for c in codes], 1)
    gated = [leap_align(*c, gcfg, semantics="simd_ed_lev", use_shd_gate=True)
             for c in codes]
    for outs, wants, what in ((lp["outs"], plain, "leap"),
                              (lg["outs"], gated, "leap_gated")):
        for o, w in zip(outs, wants):
            for key in ("passed", "penalty", "lane_shift"):
                err = max(err, max_diff(o[key], w[key],
                                        f"{what} main path: {key}"))
    # CIGAR records of the first 65,536 pairs against the plain walk
    n = 1 << 16
    a, b, c, d = res["chunks"][0]
    ccfg = dataclasses.replace(cfg, leap_max_energy=lc["energy_bounds"][0])
    rec = leap_cuda.leap_align_cuda(
        a[:n // MAIN_TILE], b[:n], c[:n // MAIN_TILE], d[:n], ccfg,
        pre_staged="planes_tiled", tile=MAIN_TILE, want_cigar=True)["edit_rec"]
    hist = leap_align(codes[0][0][:n], b[:n], codes[0][2][:n], d[:n], ccfg,
                      want_history=True)
    err = max(err, max_diff(rec, torch.from_numpy(leap_edit_records(
        hist, ccfg, ccfg.leap_energy_bound)).to(dev), "leap_cigar records"))
    rates = {k: MAIN_PAIRS / v / 1e3 for k, v in ms.items()}
    bounds = ", ".join(f"{res[k]['bound']['bound_ms']:.4f}" for k in ms)
    phase(f"[9 LEAP main path] {res['n_pairs']} pairs err 0.05: leap "
          f"checksum {lp['checksum']}, {lp['passed']} passed, leap_gated "
          f"checksum {lg['checksum']}, leap_cigar bounds "
          f"{lc['energy_bounds']} (max passed energy "
          f"{lc['chunk_max_energy']}) and CIGAR digest {lc['digest'][0][:12]}"
          f"... of {lc['digest'][1]} (all pinned), {launches} kernel "
          f"launches; leap {ms['leap']:.3f} ms ({rates['leap']:.1f}M "
          f"aligns/s), leap_cigar {ms['leap_cigar']:.3f} ms "
          f"({rates['leap_cigar']:.1f}M), leap_gated {ms['leap_gated']:.3f} "
          f"ms ({rates['leap_gated']:.1f}M); bounds {bounds} ms; "
          f"plain version (leap) "
          f"{plain_ms:.3f} ms, equal on every pair (leap and leap_gated; "
          f"records on 65,536 pairs), all on {card}")
    entry = dict(name="leap", route="cuda",
                 source="asm_tpu_torch/csrc/leap.cu",
                 replaces="asm_tpu/kernels/leap_pallas.py:49",
                 launches=launches, max_abs_err=float(err), ms=ms["leap"],
                 plain_ms=plain_ms, **lp["bound"])
    # phase 12's roofline line: the energy loop's trips in launch order
    cat = {k: torch.cat([o[k] for o in lp["outs"]]).cpu().numpy()
           for k in ("passed", "penalty", "lane_shift")}
    levels = leap_levels(cat["passed"], cat["penalty"], cat["lane_shift"],
                         cfg.leap_af_threshold)
    n = res["n_pairs"]
    rows = dict(trips=levels, seconds=ms["leap"] / 1e3, n=n,
                bound_ms=lp["bound"]["bound_ms"],
                bytes=leap_work(n, n + int(levels.sum()))[1])
    return entry, rows


def filter_cli(card) -> None:
    """Phase 10: the LEAP filter CLI on a pair file in a temporary
    directory; the pass counts must equal the JAX CLI's."""
    import contextlib
    import io
    import os
    import tempfile

    from asm_tpu_torch.apps import leap_filter
    from asm_tpu_torch.kernels import leap_cuda

    got = {}
    before = leap_cuda.LAUNCHES
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "pairs.seq")
        write_pair_file(path)
        for label, argv in (("levenshtein+shd", ["3"]),
                            ("affine", ["3", "0", "0"])):
            with contextlib.redirect_stdout(io.StringIO()):
                got[label] = leap_filter.main(argv + ["--file", path])
    launches = leap_cuda.LAUNCHES - before
    counts = {k: v["passed"] for k, v in got.items()}
    if counts != FILTER_PASSED or launches <= 0:
        raise AssertionError(f"filter CLI passed {counts} (pinned "
                             f"{FILTER_PASSED}), {launches} launches")
    times = ", ".join(f"{k} {v['align_s'] * 1e3:.3f} ms"
                      for k, v in got.items())
    phase(f"[10 LEAP filter CLI] {FILTER_PAIRS} pairs, max_len 256: passNum "
          f"{counts} (pinned), {launches} kernel launches, align time "
          f"{times} on {card}")


def harness_counts(r) -> tuple[int, int, int]:
    """(greedy == NW, LEAP == NW, covered) pair counts of a
    BenchmarkResult."""
    return (round(r.greedy_accuracy * r.total),
            round(r.leap_accuracy * r.total),
            round(r.greedy_coverage * r.coverage_checked))


def harness_path(dev, card) -> None:
    """Phase 11: the three-way harness on the 1M headline corpus."""
    from asm_tpu_torch import headline
    from asm_tpu_torch.bench.harness import format_report, run_benchmark
    from asm_tpu_torch.config import AlignConfig
    from asm_tpu_torch.kernels import greedy_cuda, leap_cuda, nw_band, nw_cuda
    from asm_tpu_torch.parallel.runner import make_pipeline_step, unpack_stats

    corpus = headline.native_corpus(MAIN_PAIRS, 0.05)
    cfg = AlignConfig(x=1, o=1, e=1, k=3, max_len=128)
    greedy_cuda.LAUNCHES = nw_band.LAUNCHES = leap_cuda.LAUNCHES = 0
    nw_cuda.LAUNCHES.update(nw=0, nw_trace=0)
    t0 = time.perf_counter()
    r = run_benchmark(*corpus, cfg, chunk=1 << 20, impl="cuda", device=dev)
    wall = time.perf_counter() - t0
    launches = dict(greedy=greedy_cuda.LAUNCHES, nw_band=nw_band.LAUNCHES,
                    nw=nw_cuda.LAUNCHES["nw"],
                    nw_trace=nw_cuda.LAUNCHES["nw_trace"],
                    leap=leap_cuda.LAUNCHES)
    missing = [k for k in ("greedy", "nw_band", "nw_trace", "leap")
               if launches[k] <= 0]
    if missing:
        raise AssertionError(f"the harness never launched {missing}")
    got = harness_counts(r)
    want = (HARNESS_GREEDY_EQ, HARNESS_LEAP_EQ, HARNESS_COVERED)
    if r.coverage_checked != r.total or got != want:
        raise AssertionError(f"harness (greedy == NW, LEAP == NW, covered) "
                             f"{got} on {r.coverage_checked} checked != "
                             f"pinned {want} on {r.total}")
    for ln in format_report(r).splitlines():
        phase(ln)
    prefix = tuple(a[:HARNESS_PREFIX] for a in corpus)
    pc = run_benchmark(*prefix, cfg, chunk=HARNESS_PREFIX, impl="cuda",
                       device=dev)
    pt = run_benchmark(*prefix, cfg, chunk=HARNESS_PREFIX, impl="torch",
                       device=dev)
    if (harness_counts(pc), pc.coverage_checked) != (harness_counts(pt),
                                                     pt.coverage_checked):
        raise AssertionError(f"harness on {HARNESS_PREFIX} pairs: cuda "
                             f"{harness_counts(pc)} != torch "
                             f"{harness_counts(pt)}")
    # the pipeline step (the evaluation step of the multi-device runner)
    # on the same prefix: both routes, counters against the harness's
    args = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in prefix)
    before = (greedy_cuda.LAUNCHES, nw_band.LAUNCHES, leap_cuda.LAUNCHES)
    stats = {impl: unpack_stats(make_pipeline_step(cfg, dev, impl)(*args)[3])
             for impl in ("cuda", "torch")}
    if min(a - b for a, b in zip((greedy_cuda.LAUNCHES, nw_band.LAUNCHES,
                                  leap_cuda.LAUNCHES), before)) <= 0:
        raise AssertionError("the pipeline step's cuda route launched no "
                             "greedy, band or LEAP kernel")
    want = (HARNESS_PREFIX,) + harness_counts(pc)[:2]
    for impl, st in stats.items():
        got_p = (st.pairs, st.greedy_correct, st.leap_correct)
        if got_p != want or st != stats["cuda"]:
            raise AssertionError(f"pipeline step ({impl}) {st} != the "
                                 f"harness's {want} or the cuda route's")
    phase(f"[11 harness] {r.total} pairs err 0.05: greedy == NW "
          f"{got[0]}, LEAP == NW {got[1]}, covered {got[2]} of "
          f"{r.coverage_checked} (all pinned); launches {launches}; NW "
          f"{r.nw_aligns_per_sec / 1e6:.1f}M, LEAP "
          f"{r.leap_aligns_per_sec / 1e6:.1f}M, greedy "
          f"{r.greedy_aligns_per_sec / 1e6:.1f}M aligns/s ({r.nw_time * 1e3:.3f}"
          f" / {r.leap_time * 1e3:.3f} / {r.greedy_time * 1e3:.3f} ms), "
          f"{wall:.1f} s wall with coverage; first {HARNESS_PREFIX} pairs: "
          f"cuda {harness_counts(pc)} == torch {harness_counts(pt)} == the "
          f"pipeline step's counters on both routes (NW / "
          f"LEAP / greedy plain {pt.nw_time * 1e3:.3f} / "
          f"{pt.leap_time * 1e3:.3f} / {pt.greedy_time * 1e3:.3f} ms); all on "
          f"{card}")


INT_CATEGORIES = ("arith", "shift", "popcount", "selcmp")


def roofline_counter_checks(lib: str) -> str:
    """Phase 12's counter checks on the built roofline library; returns
    the opcodes of issue_chain's loop body."""
    from asm_tpu_torch.kernels import roofline_cuda as rc
    from asm_tpu_torch.tools import roofline as rl

    # the probe: one loop, its body charged at the given weight
    sass = rl.sass_listing(lib, "probe_kernel")
    c0 = rl.count_sass(sass, [0])
    cw = rl.count_sass(sass, [PROBE_TRIPS])
    loops = cw["loops"]
    if len(loops) != 1 or not loops[0]["weighted"]:
        raise AssertionError(f"probe: expected one weighted loop, got {loops}")
    body = loops[0]["body"]
    for cat in rl.CATEGORIES:
        if cw["counts"][cat] - c0["counts"][cat] != PROBE_TRIPS * body[cat]:
            raise AssertionError(f"probe: {cat} not charged at weight "
                                 f"{PROBE_TRIPS}: {cw['counts']} vs "
                                 f"{c0['counts']}, body {body}")
    if body["mem"] < 2:
        raise AssertionError(f"probe: the loop lost the volatile load and "
                             f"store: {loops[0]['opcodes']}")
    # issue_chain: the loop body holds the chain ops the slope divides by
    sass = rl.sass_listing(lib, "issue_chain")
    loops = rl.count_sass(sass)["loops"]
    top = [lp for lp in loops if lp["depth"] == 0]
    if len(top) != 1:
        raise AssertionError(f"issue_chain: expected one loop, got {loops}")
    lp = top[0]
    control = rl.loop_control(sass, lp)
    n_int = sum(lp["body"][c] for c in INT_CATEGORIES)
    n_control = sum(rl.category(op) in INT_CATEGORIES for _, op in control)
    want = rc.STREAMS * rc.UNROLL * 2
    if n_int - n_control != want:
        raise AssertionError(
            f"issue_chain: {n_int} integer instructions in the loop body, "
            f"{n_control} of them trip control, != {want}: {lp['opcodes']}")
    return (f"probe loop body {dict((k, v) for k, v in body.items() if v)} "
            f"charged x{PROBE_TRIPS}; issue_chain loop body "
            f"{n_int - n_control} chain + {n_control} control integer "
            f"instructions, opcodes {lp['opcodes']}")


def roofline_phase(dev, card, greedy_rows, leap_rows) -> list[dict]:
    """Phase 12; returns the three roofline kernels' JSON entries."""
    import contextlib
    import io

    from asm_tpu_torch.kernels import roofline_cuda as rc
    from asm_tpu_torch.tools import roofline as rl
    from asm_tpu_torch.utils.bounds import (
        HBM_BYTES_PER_S,
        INT32_OPS_PER_S,
        bound_entry,
    )

    # ---- each kernel against its plain version ----
    err = {}
    seeds = rl.issue_seeds(dev)
    err["issue_chain"] = max_diff(
        rc.issue_chain(seeds, ISSUE_CHECK_ITERS),
        rc.issue_chain_plain(seeds, ISSUE_CHECK_ITERS), "issue_chain")
    small = rl.seeded_words(STREAM_CHECK_MIB << 18, dev, seed=2)
    err["stream_fold"] = max_diff(rc.stream_fold(small),
                                  rc.stream_fold_plain(small),
                                  f"stream_fold {STREAM_CHECK_MIB} MiB")
    del small
    x = rl.seeded_words(1024, dev, seed=3)
    x[0] = PROBE_TRIPS
    err["probe"] = max_diff(rc.probe(x), rc.probe_plain(x), "probe")
    counter = roofline_counter_checks(rc.build_kernel()[0])

    # ---- the measurement: the phase's main path, the CLI's own ----
    for k in rc.LAUNCHES:
        rc.LAUNCHES[k] = 0
    line, raw = rl.micro(dev, keep_words=True)
    probe_ms, _ = cuda_ms(lambda: rc.probe(x), 10)
    launches = dict(rc.LAUNCHES)
    if min(launches.values()) <= 0:
        raise AssertionError(f"the roofline never launched a kernel: "
                             f"{launches}")
    issue, stream, words = raw["issue"], raw["stream"], raw["words"]
    iters, mib = line["issue_iters"], line["stream_mib"]
    limit = line["issue_limit_ops_per_sec"]
    if issue["rate"] > 1.05 * limit:
        raise AssertionError(f"issue rate {issue['rate']:.4g} above 105% of "
                             f"the issue limit {limit:.4g}")
    if stream["rate"] > 1.05 * HBM_BYTES_PER_S:
        raise AssertionError(f"stream rate {stream['rate']:.4g} above 105% "
                             f"of {HBM_BYTES_PER_S:.4g} B/s")

    # the plain versions at the measurement's shapes (not counted)
    seeds = raw["seeds"]
    issue_plain_ms, want = cuda_ms(
        lambda: rc.issue_chain_plain(seeds, iters), 1)
    err["issue_chain"] = max(err["issue_chain"], max_diff(
        issue["out"], want, f"issue_chain at {iters} iterations"))
    stream_plain_ms, want = cuda_ms(lambda: rc.stream_fold_plain(words), 1)
    err["stream_fold"] = max(err["stream_fold"], max_diff(
        stream["out"], want, f"stream_fold {mib[1]} MiB"))
    n_words = words.numel()
    del words, want, raw
    probe_plain_ms, _ = cuda_ms(lambda: rc.probe_plain(x), 3)

    phase(f"[12a roofline kernels] issue chain ({ISSUE_CHECK_ITERS} and "
          f"{iters} iterations), stream fold ({STREAM_CHECK_MIB} and "
          f"{mib[1]} MiB), probe (x[0] = {PROBE_TRIPS}) exactly equal "
          f"to their plain versions; counter: {counter}")
    phase(f"[12b roofline rates] issue {issue['rate'] / 1e12:.3f} T int ops/s"
          f" (walls {[round(w * 1e3, 4) for w in issue['walls']]} ms at "
          f"{iters}/{2 * iters} iterations, "
          f"{seeds.shape[0]} threads) = {issue['rate'] / limit:.1%} of the "
          f"issue limit at the sampled {line['sm_clock_mhz']:.0f} MHz, "
          f"{issue['rate'] / INT32_OPS_PER_S:.1%} of utils.bounds' "
          f"{INT32_OPS_PER_S / 1e12:.2f} T; stream "
          f"{stream['rate'] / 1e12:.3f} TB/s (walls "
          f"{[round(w * 1e3, 4) for w in stream['walls']]} ms at "
          f"{mib[0]}/{mib[1]} MiB) = "
          f"{stream['rate'] / HBM_BYTES_PER_S:.1%} of 3.35 TB/s; dispatch "
          f"floor {line['dispatch_floor_us']:.2f} us; launches {launches}; "
          f"on {card}")
    for name, rows, counts, is_bound in (
            ("greedy", greedy_rows, rl.greedy_counts, True),
            ("leap", leap_rows, rl.leap_counts, False)):
        with contextlib.redirect_stdout(io.StringIO()):
            got = rl.report(name, counts(rows["trips"]),
                            rows["bytes"] / rows["n"], rows["seconds"],
                            rows["n"], issue["rate"], stream["rate"],
                            rows["bound_ms"], issue_is_bound=is_bound)
        phase(f"[12c roofline {name}] {json.dumps(got)}")

    threads = seeds.shape[0]
    common = dict(route="cuda", source="asm_tpu_torch/csrc/roofline.cu")
    return [
        dict(name="issue_chain", replaces="tools/roofline.py:49",
             launches=launches["issue_chain"],
             max_abs_err=float(err["issue_chain"]),
             ms=issue["walls"][0] * 1e3, plain_ms=issue_plain_ms,
             **common, **bound_entry(
                 rc.issue_chain_ops(threads, iters),
                 4 * threads * (rc.STREAMS + 1))),
        dict(name="stream_fold", replaces="tools/roofline.py:119",
             launches=launches["stream_fold"],
             max_abs_err=float(err["stream_fold"]),
             ms=stream["walls"][1] * 1e3, plain_ms=stream_plain_ms,
             **common, **bound_entry(n_words, 4 * n_words + 4)),
        dict(name="probe", replaces="tests/test_roofline_counts.py:37",
             launches=launches["probe"], max_abs_err=float(err["probe"]),
             ms=probe_ms, plain_ms=probe_plain_ms, **common,
             **bound_entry(x.numel() * (2 + PROBE_TRIPS), 8 * x.numel())),
    ]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs only on a GPU",
              file=sys.stderr)
        return 1
    from concurrent.futures import ThreadPoolExecutor

    from asm_tpu_torch.kernels import (
        greedy_cuda,
        leap_cuda,
        nw_band,
        nw_cuda,
        roofline_cuda,
    )
    from asm_tpu_torch.native import build_native

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    card = card_line()
    phase(f"[1 device] {name}; nvidia-smi: {card}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")

    # every build at once: one nvcc per kernel source, and make
    t0 = time.perf_counter()
    kernels = (greedy_cuda, nw_cuda, nw_band, leap_cuda, roofline_cuda)
    with ThreadPoolExecutor(len(kernels) + 1) as ex:
        builds = [ex.submit(k.build_kernel) for k in kernels]
        native = ex.submit(build_native)
        built = [f.result()[1] for f in builds]
        native.result()
    ptxas = "; ".join(ptxas_summary(k.ptxas_report()) for k in kernels)
    phase(f"[2 build] {len(kernels)} kernel libraries + native library in "
          f"{time.perf_counter() - t0:.1f}s (built now: {built}); "
          f"ptxas: {ptxas}")

    entry, greedy_rows = greedy_phases(dev, name, card)
    entries = [entry]
    err = nw_conformance(dev, name)
    entries += nw_main_path(dev, card, err)
    entries.append(coverage_path(dev, card, err))
    leap_err = leap_conformance(dev, name)
    entry, leap_rows = leap_main_path(dev, card, leap_err)
    entries.append(entry)
    filter_cli(card)
    harness_path(dev, card)
    entries += roofline_phase(dev, card, greedy_rows, leap_rows)

    print(json.dumps({"kernels": entries}))
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
