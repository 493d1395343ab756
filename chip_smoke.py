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
     version runs on the same pairs and must agree pair by pair. The line
     carries the count: the main-path instantiation's registers and spill
     bytes (ptxas), its warps per SM (the occupancy query) and the rate
     it issued its SASS instructions at (warp weight x pairs / time).
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
     kernel must have launched; then (7b) the full and trace kernels at
     max_len 256 on 8,192 pairs of 200 bases, exactly equal to the plain
     version, timed against their bound.
  8. LEAP kernel vs plain: leap_align_cuda in both input forms against the
     plain PyTorch leap_align on the card — passed, penalty, lane_shift
     and, in CIGAR mode, the raw edit records and decoded CIGARs exactly
     equal — on the LEAP conformance corpora (three error profiles,
     unequal lengths, edge pairs, L = 256 with full-length buffers, match
     runs ending on word boundaries), every
     LeapMode, unit and affine penalties, lv_bag / simd_ed_lev with and
     without the SHD gate / simd_ed_affine, k = 2 and 4, a tight
     threshold, odd batch sizes;
  9. LEAP main path: the LEAP headline flow (leap_headline.run: penalty
     pass, measured-energy order, leap / leap_cigar / leap_gated) on the
     1,000,000-pair headline corpus; the checksums, the passed count, the
     CIGAR pass's per-chunk energy bounds and the CIGAR digest must equal
     the pinned values, the kernel must have launched, and the plain
     version must agree pair by pair. The line carries the count, as
     phase 4's does;
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
     above 105% of its published limit, the greedy and LEAP roofline
     lines of phases 4 and 9's runs, and the NW band kernel's diagonal
     loop (SASS instructions per existing cell, the warp maximum of m+n
     against its mean) per band width of phase 6's 1M run; the NW full
     and trace kernels' lines (tools/roofline.nw_line: the step loop's
     SASS per step, per cell slot and per existing cell, the share of
     slots that are existing cells, the walk's SASS per step, registers,
     spills, warps per SM, time against the bound) from phase 6b's
     residue and phase 7's chunk.
 13. mapper main path: tools/mapper_eval's corpus (a 50 Mbp genome, seed
     7; 100,000 reads of 100 bp at the real-profile error rates) through
     the FM-index and `mapper.map_reads(impl="cuda")` at batch 8192,
     after an 8-read warm-up; the greedy kernel must have launched at
     least once per batch, the plain version (impl="torch", on the card)
     must write the same SAM text and best hits, and recall, eligible
     recall, unmapped reads, the cost sum and the SAM digest must equal
     the pinned values. The line carries reads/s, the stage profile,
     kernel_ms, the launches and their bound.
 14. long sequences (max_len 512, W = 16): (a) each kernel against its
     plain version, exactly, on corpora of lengths 0, 1, 31, 32, 33, 496,
     511 and 512 at err 0.05 and 0.15 and on generated 496-base corpora:
     greedy at k = 2, 3 and 4 in both input forms with records and CIGARs
     (k = 4 also at max_len 128 and 256), LEAP in its three modes (the
     penalty pass, the SHD-gated filter, the fused CIGAR) with both
     penalty sets where the semantics allow, at k = 2, 3 and 4, the NW
     band kernel at BW 8-64 in both forms, the full kernel and the trace
     kernel with ops and mask; (b) the main path: the long-sequence flow
     (tools/longseq_headline.run_length: greedy steps probe, measured
     order, LEAP energy probe, measured-energy order, the fused CIGAR) on
     1,048,576 pairs at max_len 256 and 524,288 at 512, its greedy cost
     total, LEAP penalty total and passed count and the CIGAR digest of
     the first 65,536 pairs equal to the pinned values, the plain
     versions equal on every pair; then the harness (run_benchmark,
     impl cuda and torch) on 8,192 pairs of 496 bases at max_len 512,
     its greedy == NW, LEAP == NW and covered counts pinned, and the
     harness's NW partition on 8,192 pairs at err 0.15, whose residue
     launches the full kernel, equal to the plain full NW; the greedy,
     LEAP, band, full and trace kernels must each have launched at
     max_len 512 in (b). The line carries each W = 16 kernel's time,
     bound and plain version's time.
 15. MSA: `kernels.msa.profile_align` (eager tensor ops, no kernel of its
     own) on 65,536 profile pairs at max_len 128 from seeded alignments;
     the exact sum of the scores and the digest of the traceback ops must
     equal the values asm_tpu computes on the CPU, and the first 1,024
     pairs the same code's on the CPU; the demo (apps.demo) must print on
     the card, through the greedy kernel, what it prints on the CPU.
 16. the multi-device path: the 1,000,000-pair headline corpus through
     `parallel.make_sharded_pipeline(impl="cuda")`, (a) in this process
     at NCCL world size 1, (b) in two spawned processes on gloo, both on
     the one card, 500,000 pairs each; every rank's summed counters must
     equal the pins of phases 4, 6, 9 and 11, the greedy, band and LEAP
     kernels must have launched in each, and (b)'s per-pair outputs,
     gathered, must equal (a)'s.
Prints a JSON line of per-kernel results (time, plain version's time,
bound, launches; the W = 16 instantiations as entries of their own), the
card line, and last {"ok": true, "device": {...}}. Any failure raises
(exit code != 0).
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
# The mapper on tools/mapper_eval's corpus (rng = default_rng(7); a
# 50,000,000-base genome rng.integers(0, 4, dtype=int8); 100,000 reads of
# 100 bp from sample_reads(genome, 100000, 100, rng) at its default
# rates; MapperConfig(max_errors=3, batch=8192)), computed with the JAX
# package on the CPU: asm_tpu.mapper.map_reads. Reads within 5 bases of
# their origin, reads with <= 3 injected errors and those of them placed
# so, unmapped reads, the sum of best costs, and sha256 of the SAM text
# with its @PG line removed.
MAPPER_GENOME = 50_000_000
MAPPER_READS = 100_000
MAPPER_PINS = dict(
    n_ok=94922, n_elig=74901, n_elig_ok=74901, unmapped=5078,
    cost_sum=328650, n_jobs=96998, sam_sha256=(
        "1333a86748d6960cd3fdca76074e3f394c66a2822fe7e9516f1e176f5eb7ac81"))
# Phase 14, the long-sequence flow at reduced depth on the JAX tool's
# generator arguments (tools/longseq_headline.py: native generator, reads
# of L - 6 - L // 50 bases, err 0.05, mismatch rate 0.96, seed 7; x = o =
# e = 1, k = 3, GLOBAL, af = 200). Computed with the JAX package on the
# CPU, in 32,768-pair chunks of
#   rc, rl, fc, fl = asm_tpu.native.generate_dataset_native(
#       pairs, L - 6 - L // 50, 0.05, 0.96, seed=7, max_len=L)
# greedy: sum of asm_tpu.kernels.greedy.greedy_align(..., AlignConfig(x=1,
# o=1, e=1, k=3, max_len=L, max_steps=128))["cost"] (max steps 54 at
# L = 256, 119 at 512: no walk cut); LEAP: sum and passed count of
# asm_tpu.kernels.leap.leap_align(..., AlignConfig(x=1, o=1, e=1, k=3,
# max_len=L))["penalty"] / ["passed"]; the digest: sha256 of the
# newline-joined CIGARs of the passed pairs among the first 65,536, in
# corpus order, from leap_align(..., leap_max_energy=E, want_history=True)
# + asm_tpu.kernels.leap_backtrack.leap_backtrack_batch in 4,096-pair
# chunks (E = their largest passed energy: 38 at L = 256, 174 at 512).
LONG_FLOW = {
    256: dict(pairs=1_048_576, greedy_cost=10489962, leap_penalty=10099511,
              leap_passed=1_048_576, digest=(
                  "2b1c2fc60b95d239dc728381580fb05a"
                  "43bd39a0a8d62be67e5b54ab8a6f4f7e", 65_536)),
    512: dict(pairs=524_288, greedy_cost=10180115, leap_penalty=9769482,
              leap_passed=524_282, digest=(
                  "ac20a4284ada6f1cea1c27bfc6adc97c"
                  "85f572899b53eb370e4d4ef24110f0ca", 65_535)),
}
LONG_DIGEST_PAIRS = 65_536
# The harness at max_len 512: 8,192 native pairs of 496 bases, err 0.05,
# seed 42, x = o = e = 1, k = 3; the counts `python -m asm_tpu.bench
# --pairs 8192 --length 496 --max-len 512 --err 0.05` (the JAX harness,
# XLA kernels) prints on the CPU: greedy 59.424 %, LEAP 97.876 %,
# coverage 84.387 % of 8,192 pairs.
LONG_HARNESS_PAIRS = 8192
LONG_HARNESS = (4868, 8018, 6913)  # greedy == NW, LEAP == NW, covered
# Phase 15, profile-profile alignment: 65,536 pairs of profiles at max_len
# 128 from msa_alignments(2 * MSA_PAIRS) (the first half against the
# second), the exact float64 sum of the float32 scores (math.fsum) and
# sha256 of the ops bytes (int8 [65536, 256], C order). Computed with the
# JAX package on the CPU, in 4,096-pair chunks of
#   p1, n1 = asm_tpu.kernels.msa.profiles_from_alignments(als[:N], 128)
#   p2, n2 = ... (als[N:], 128)
#   asm_tpu.kernels.msa.profile_align(p1, n1, p2, n2)  # match 1, mismatch -2
MSA_PAIRS = 65_536
MSA_LEN = 128
MSA_SCORE_SUM = -4431405.58830452
MSA_OPS_DIGEST = (
    "8772fac0e055dff1f14c0d6395b43f41b2d356469b81a6bae1e479aae542fd87")
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


# csrc/leap.cu's SEM template parameter
LEAP_SEMANTICS = ("lv_bag", "simd_ed_lev", "simd_ed_affine",
                  "simd_ed_lev_gated")


def _instance_name(name: str) -> str | None:
    """Short name of the kernel instantiation a mangled name stands for."""
    m = re.search(r"greedy_kernelILi(\d+)ELi(\d+)ELb(\d)", name)
    if m:
        return f"greedy k{m[1]}/W{m[2]}/{'planes' if m[3] == '1' else 'codes'}"
    m = re.search(r"band_kernelILi(\d+)ELi(\d+)E", name)
    if m:
        return f"nw_band BW{m[1]}/W{m[2]}"
    m = re.search(r"nw_kernelILi(\d+)ELi(\d+)ELi(\d)E", name)
    if m:
        route = ("", "/global", "/shared")[int(m[3])]
        return f"{'nw_trace' if route else 'nw'} W{m[1]}/G{m[2]}{route}"
    m = re.search(r"leap_kernelILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)ELi"
                  r"(\d)ELb(\d)ELb(\d)", name)
    if m:
        return (f"leap k{m[1]}/W{m[2]}/x{m[3]}o{m[4]}e{m[5]}/"
                f"{LEAP_SEMANTICS[int(m[6])]}"
                f"{'/cigar' if m[7] == '1' else ''}/"
                f"{'planes' if m[8] == '1' else 'codes'}")
    m = re.search(r"(issue_chain|stream_fold|probe_kernel|noop_kernel)", name)
    if m:
        return m[1]
    return None


def ptxas_summary(path: str) -> str:
    """Registers and spill bytes per kernel instantiation from nvcc's
    -Xptxas -v report."""
    from asm_tpu_torch.utils.build import ptxas_usage

    with open(path) as f:
        usage = ptxas_usage(f.read())
    return "; ".join(f"{_instance_name(k) or '?'} {u['registers']} regs "
                     f"{u['spill_stores']} B spill" for k, u in usage.items())


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


def queued_ms(fn, launches: int, reps: int = 3) -> float:
    """Best device milliseconds per call of fn() over `launches` calls
    queued behind a spin of the card (torch.cuda._sleep), so that the
    host's enqueue time does not show between them; after one warm-up
    call."""
    fn()
    best = float("inf")
    for _ in range(reps):
        torch.cuda._sleep(40_000_000)  # ~20 ms at 1.98 GHz
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / launches)
    return best


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


def greedy_check(dev, corpus, cfg, label, tile=256) -> int:
    """greedy_align_cuda against the plain greedy_align on one corpus and
    configuration, both input forms (tile: B need be no multiple of it):
    cost, steps, step records, the trips read from them and the decoded
    CIGARs; returns the max abs error (0) or raises."""
    from asm_tpu_torch.kernels import greedy_cuda
    from asm_tpu_torch.kernels.greedy import greedy_align
    from asm_tpu_torch.ops.cigar import runs_to_cigars_batch

    rc, rl, fc, fl = corpus
    lens = [torch.from_numpy(a).to(dev) for a in (rl, fl)]
    plain = greedy_align(torch.from_numpy(rc).to(dev), lens[0],
                         torch.from_numpy(fc).to(dev), lens[1], cfg,
                         records=True)
    want = runs_to_cigars_batch(plain["cigar_ops"].cpu().numpy(),
                                plain["cigar_runs"].cpu().numpy())
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
    max_err = 0
    for form, (a, b, pre) in forms.items():
        got = greedy_cuda.greedy_align_cuda(
            a, lens[0], b, lens[1], cfg, pre_staged=pre, tile=tile)
        torch.cuda.synchronize()
        got["trips"] = greedy_cuda.step_trips(got["steps"], got["step_rec"])
        for key in ("cost", "steps", "step_rec", "trips"):
            max_err = max(max_err, max_diff(got[key], plain[key],
                                            f"{label}/{form}: {key}"))
        cig = runs_to_cigars_batch(got["cigar_ops"].cpu().numpy(),
                                   got["cigar_runs"].cpu().numpy())
        bad = sum(x != y for x, y in zip(cig, want))
        if bad:
            raise AssertionError(f"{label}/{form}: {bad} CIGARs differ")
    return max_err


def greedy_phases(dev, name, card) -> dict:
    """Phases 3 and 4 (greedy); returns the kernel's JSON entry and the
    main path's roofline inputs."""
    from asm_tpu_torch import headline
    from asm_tpu_torch.kernels import greedy_cuda
    from asm_tpu_torch.tools import roofline
    from asm_tpu_torch.utils.bounds import greedy_work

    # ---- 3: kernel vs plain on the card ----
    max_err = 0
    n_cmp = 0
    for label, cfg, corpus in conformance_cases():
        max_err = max(max_err, greedy_check(dev, corpus, cfg, label))
        n_cmp += 2
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
    # the count: registers, spills and warps per SM of the main-path
    # instantiation, and the rate it issued its SASS on the warp weight
    counts = roofline.greedy_counts(res["trips"])
    use = roofline.greedy_resources()
    insts = sum(counts["counts"]["warp"]["counts"].values())
    phase(f"[4 main path] {res['n_pairs']} pairs: checksum "
          f"{res['checksum']} (pinned), per-chunk max steps "
          f"{res['chunk_max']} < bounds {res['bounds']}, {launches} kernel "
          f"launches; kernel {kernel_ms:.3f} ms "
          f"({res['n_pairs'] / kernel_ms / 1e3:.1f}M aligns/s), plain "
          f"version {plain_ms:.3f} ms, both on {card}; {use['registers']} "
          f"registers, {use['spill_stores']} B spill stores, "
          f"{use['warps_per_sm']} warps per SM, {insts:.1f} SASS thread "
          f"instructions per pair (warp weight) issued at "
          f"{insts * res['n_pairs'] / kernel_ms / 1e9:.2f} T/s")
    entry = dict(name="greedy", route="cuda",
                 source="asm_tpu_torch/csrc/greedy.cu",
                 replaces="asm_tpu/kernels/greedy_pallas.py:91",
                 launches=launches, max_abs_err=float(max_err),
                 ms=kernel_ms, plain_ms=plain_ms, **res["bound"])
    # phase 12's roofline line: the SASS count, the step loop weighted by
    # the trips of the pairs in launch order
    rows = dict(counts=counts, resources=use, seconds=kernel_ms / 1e3,
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


def nw_instance(trace: bool, L: int = 128) -> str:
    """Short name of the NW instantiation the wrapper launches at L."""
    from asm_tpu_torch.kernels import nw_cuda

    return _instance_name(nw_cuda.function_name(trace, L))


def nw_main_path(dev, card, err) -> tuple[list[dict], dict, dict]:
    """Phase 6; returns the band and full kernels' JSON entries, the 1M
    run (`nw_headline.run`'s result) and the full kernel's residue run
    for the roofline."""
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
    main_res = res

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
             instantiation=nw_instance(False),
             launches=full_launches, max_abs_err=float(err["nw"]),
             ms=full_ms, plain_ms=full_plain_ms, **full_bound),
    ], main_res, dict(m=b.cpu().numpy(), n=d.cpu().numpy(), ms=full_ms,
                      bound=full_bound)


def coverage_path(dev, card, err) -> tuple[dict, dict]:
    """Phase 7; returns the trace kernel's JSON entry and its chunk's run
    for the roofline."""
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
    bound = bound_entry(*nw_full_work(args[1].clamp(max=128).cpu().numpy(),
                                      args[3].clamp(max=128).cpu().numpy(),
                                      trace=True))
    nw_at_256(dev, card, err)
    return dict(name="nw_trace", route="cuda",
                source="asm_tpu_torch/csrc/nw.cu",
                replaces="asm_tpu/kernels/nw_pallas.py:218",
                instantiation=nw_instance(True),
                launches=trace_launches, max_abs_err=float(err["nw_trace"]),
                ms=trace_ms, plain_ms=plain_ms, **bound), dict(
        m=args[1].cpu().numpy(), n=args[3].cpu().numpy(), ms=trace_ms,
        bound=bound, ops=got[1].cpu().numpy())


def nw_at_256(dev, card, err) -> None:
    """Phase 7b: the full and trace kernels at max_len 256 (the harness's
    and the NW headline's other width) on 8,192 pairs of 200 bases at err
    0.10, exactly equal to the plain version, timed against their bound."""
    from asm_tpu_torch.data.generator import generate_dataset_native
    from asm_tpu_torch.kernels import nw, nw_cuda
    from asm_tpu_torch.utils.bounds import bound_entry, nw_full_work

    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in
            generate_dataset_native(1 << 13, 200, 0.10, seed=7, max_len=256)]
    want = nw.nw_align(*args, match_mask_threshold=3)
    nw_ms, pen = cuda_ms(lambda: nw_cuda.nw_penalty_cuda(*args), 3)
    trace_ms, got = cuda_ms(
        lambda: nw_cuda.nw_align_cuda(*args, match_mask_threshold=3), 3)
    err["nw"] = max(err["nw"], max_diff(pen, want[0], "L = 256 chunk: nw"))
    for g, w, key in zip(got, want, ("pen", "ops", "mask")):
        err["nw_trace"] = max(err["nw_trace"], max_diff(
            g, w, f"L = 256 chunk: nw_trace {key}"))
    m, n = (args[i].cpu().numpy() for i in (1, 3))
    parts = []
    for name, trace, ms in (("nw", False, nw_ms),
                            ("nw_trace", True, trace_ms)):
        bound = bound_entry(*nw_full_work(m, n, 256, trace=trace))
        parts.append(f"{name} ({nw_instance(trace, 256)}) {ms:.4f} ms, "
                     f"bound {bound['bound_ms']:.4f} ({bound['bound_by']}, "
                     f"{100 * bound['bound_ms'] / ms:.1f}%)")
    phase(f"[7b nw L=256] 8192 pairs of 200 bases err 0.10, equal to the "
          f"plain version: {'; '.join(parts)}; on {card}")


def leap_conformance_cases():
    """(label, corpus) pairs of the LEAP kernel's conformance check; odd
    sizes, so every launch's last block is partly empty."""
    from asm_tpu_torch.data.generator import generate_dataset_arrays
    from asm_tpu_torch.encoding import encode_batch

    # empty, one-base and full-length (128) sequences on both sides
    reads = ["A", "ACGT" * 32, "ACGTACGT", "", "ACGT" * 25, "AC", ""]
    refs = ["ACGT" * 32, "A", "ACGTACGT", "ACG", "ACGT" * 25, "TGCA" * 20, ""]
    # match runs that start inside a word, end on a word boundary or reach
    # the buffer's end: lengths at L = 128's word boundaries, error 0, 0.01
    parts = [generate_dataset_arrays(17, n, err, seed=n + int(100 * err))
             for n in (31, 32, 33, 63, 64, 65, 127, 128)
             for err in (0.0, 0.01)]
    runs = tuple(np.concatenate([p[i] for p in parts]) for i in range(4))
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
        ("runs", runs),
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
                       leap_af_threshold=af, leap_max_energy=af,
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
    from asm_tpu_torch.tools import roofline as rl
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
    # the count: registers, spills and warps per SM of the main-path
    # instantiation, and the rate it issued its SASS at, the energy loop
    # weighted by the levels each pair ran, in launch order
    cat = {k: torch.cat([o[k] for o in lp["outs"]]).cpu().numpy()
           for k in ("passed", "penalty", "lane_shift")}
    levels = leap_levels(cat["passed"], cat["penalty"], cat["lane_shift"],
                         cfg.leap_af_threshold)
    counts = rl.leap_counts(levels)
    use = rl.leap_resources()
    insts = sum(counts["counts"]["warp"]["counts"].values())
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
          f"records on 65,536 pairs), all on {card}; leap: "
          f"{use['registers']} registers, {use['spill_stores']} B spill "
          f"stores, {use['warps_per_sm']} warps per SM, {insts:.1f} SASS "
          f"thread instructions per pair (warp weight) issued at "
          f"{insts * res['n_pairs'] / ms['leap'] / 1e9:.2f} T/s")
    entry = dict(name="leap", route="cuda",
                 source="asm_tpu_torch/csrc/leap.cu",
                 replaces="asm_tpu/kernels/leap_pallas.py:49",
                 launches=launches, max_abs_err=float(err), ms=ms["leap"],
                 plain_ms=plain_ms, **lp["bound"])
    # phase 12's roofline line
    n = res["n_pairs"]
    rows = dict(counts=counts, resources=use, seconds=ms["leap"] / 1e3, n=n,
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


def msa_alignments(n: int, seed: int = 12) -> list[list[str]]:
    """n alignments of 2-4 rows over 64-120 columns: copies of one random
    ACGT base row, each cell replaced with probability 0.10 by a random
    symbol of ACGT- (a substitution or a gap)."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(2, 5, size=n)
    cols = rng.integers(64, 121, size=n)
    sym = np.frombuffer(b"ACGT-", np.uint8)
    out = []
    for r, c in zip(rows.tolist(), cols.tolist()):
        al = np.repeat(rng.integers(0, 4, size=(1, c)), r, axis=0)
        hit = rng.random((r, c)) < 0.10
        al[hit] = rng.integers(0, 5, size=int(hit.sum()))
        out.append([sym[row].tobytes().decode() for row in al])
    return out


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


def sam_digest(sam: str) -> str:
    """sha256 of a SAM text without its @PG line (which names the
    package)."""
    import hashlib

    body = "\n".join(ln for ln in sam.split("\n") if not ln.startswith("@PG"))
    return hashlib.sha256(body.encode()).hexdigest()


def mapper_path(dev, card) -> dict:
    """Phase 13: the read mapper on mapper_eval's 50 Mbp corpus. Returns
    the greedy kernel's numbers on this path."""
    from asm_tpu_torch.kernels import greedy_cuda
    from asm_tpu_torch.mapper import MapperConfig, build_index, map_reads
    from asm_tpu_torch.mapper.simulate import sample_reads

    t0 = time.perf_counter()
    rng = np.random.default_rng(7)
    genome = rng.integers(0, 4, size=MAPPER_GENOME, dtype=np.int8)
    idx = build_index(genome)
    t_index = time.perf_counter() - t0
    reads, lens, origins, nerr = sample_reads(genome, MAPPER_READS, 100, rng)
    t_setup = time.perf_counter() - t0
    mcfg = MapperConfig(max_errors=3, batch=8192)
    map_reads(idx, genome, reads[:8], lens[:8], mcfg=mcfg, device=dev)

    greedy_cuda.LAUNCHES = 0
    prof = {}
    t0 = time.perf_counter()
    best, sam = map_reads(idx, genome, reads, lens, mcfg=mcfg, profile=prof,
                          device=dev, impl="cuda")
    wall = time.perf_counter() - t0
    launches = greedy_cuda.LAUNCHES
    batches = prof["p1_batches"] + prof.get("p2_batches", 0)
    if launches < batches:
        raise AssertionError(f"the mapper launched the greedy kernel "
                             f"{launches} times for {batches} batches")
    plain = {}
    t0 = time.perf_counter()
    pbest, psam = map_reads(idx, genome, reads, lens, mcfg=mcfg,
                            profile=plain, device=dev, impl="torch")
    plain_wall = time.perf_counter() - t0
    if psam != sam or pbest != best:
        raise AssertionError("mapper: impl torch and cuda write different "
                             "SAM text or best hits")
    ok = np.array([b is not None and abs(b["pos"] - int(o)) <= 5
                   for b, o in zip(best, origins)])
    elig = nerr <= mcfg.max_errors
    pins = dict(n_ok=int(ok.sum()), n_elig=int(elig.sum()),
                n_elig_ok=int(ok[elig].sum()),
                unmapped=sum(b is None for b in best),
                cost_sum=sum(b["cost"] for b in best if b is not None),
                n_jobs=prof["n_jobs"], sam_sha256=sam_digest(sam))
    if pins != MAPPER_PINS:
        raise AssertionError(f"mapper {pins} != pinned {MAPPER_PINS}")
    # one batch of the mapper's shape, the first 8,192 reads at their
    # origins, timed apart from the host and held against the plain
    # version
    from asm_tpu_torch.kernels.greedy import greedy_align
    from asm_tpu_torch.mapper.core import stage_reads, window_batch
    from asm_tpu_torch.utils.bounds import bound_entry, greedy_work

    cfg, B = mcfg.align, mcfg.batch
    reads_d, lens_d = stage_reads(reads, lens, dev)
    args = window_batch(torch.from_numpy(genome).to(dev), reads_d, lens_d,
                        torch.arange(B, device=dev),
                        torch.from_numpy(origins[:B]).to(dev), cfg.max_len)
    launch_ms = queued_ms(lambda: greedy_cuda.greedy_align_cuda(
        *args, cfg, want_cigar=False), launches=20)
    got = greedy_cuda.greedy_align_cuda(*args, cfg, want_cigar=False)
    plain_ms, want = cuda_ms(lambda: greedy_align(*args, cfg, records=True),
                             reps=2)
    err = max(max_diff(got[k], want[k], f"mapper batch {k}")
              for k in ("cost", "steps", "step_rec"))
    launch_bound = bound_entry(*greedy_work(
        got["steps"].cpu().numpy(), [cfg.steps_bound], B, codes=True))
    stages = {k[:-2]: round(v, 4) for k, v in prof.items()
              if k.endswith("_s")}
    phase(f"[13 mapper] {MAPPER_READS} reads on a {MAPPER_GENOME / 1e6:.0f} "
          f"Mbp genome (index {t_index:.1f} s, with sampling "
          f"{t_setup:.1f} s): recall {pins['n_ok'] / MAPPER_READS:.5f}, "
          f"eligible {pins['n_elig_ok'] / pins['n_elig']:.5f}, unmapped "
          f"{pins['unmapped']}, cost sum {pins['cost_sum']}, SAM digest "
          f"{pins['sam_sha256'][:8]}... (all pinned); impl torch writes the "
          f"same SAM; {MAPPER_READS / wall:.1f} reads/s ({wall:.3f} s wall; "
          f"plain version {MAPPER_READS / plain_wall:.1f} reads/s); "
          f"{prof['n_jobs']} jobs in {batches} batches, two_phase "
          f"{prof['two_phase']}; stages (s) {json.dumps(stages)}; kernel_ms "
          f"{prof['kernel_ms']:.4f} ({prof['kernel_ms'] / 1e3 / wall:.2%} of "
          f"the wall) over {launches} launches, bound {prof['bound_ms']:.5f} "
          f"ms ({prof['bound_by']}); plain rescoring {plain['kernel_ms']:.3f}"
          f" ms; one {B}-pair batch queued: kernel {launch_ms:.4f} ms, bound "
          f"{launch_bound['bound_ms']:.5f} ms ({launch_bound['bound_by']}), "
          f"plain {plain_ms:.3f} ms, equal to it (max abs err {err}); all "
          f"on {card}")
    return dict(reads=MAPPER_READS, genome=MAPPER_GENOME, batch=B,
                launches=launches, kernel_ms=prof["kernel_ms"],
                run_bound_ms=prof["bound_ms"], ms=launch_ms,
                plain_ms=plain_ms, bound_ms=launch_bound["bound_ms"],
                bound_by=launch_bound["bound_by"], max_abs_err=float(err),
                reads_per_sec=MAPPER_READS / wall)


def long_corpora():
    """(label, corpus) pairs of phase 14a at max_len 512, for err 0.05 and
    0.15: every pair of lengths from 0, 1, 31, 32, 33, 496, 511 and 512,
    three times (reads random, refs a copy with substitutions, cut or
    extended to their length), beside 17 generated pairs (with indels)
    at each of those lengths but 0; and 501 generated pairs of 496
    bases."""
    from asm_tpu_torch.data.generator import generate_dataset_arrays
    from asm_tpu_torch.encoding import encode_batch

    lens = (0, 1, 31, 32, 33, 496, 511, 512)
    out = []
    for i, err in enumerate((0.05, 0.15)):
        rng = np.random.default_rng(140 + i)
        reads, refs = [], []
        for a in lens * 3:
            for b in lens:
                read, ref = rng.integers(0, 4, a), rng.integers(0, 4, b)
                n = min(a, b)
                ref[:n] = np.where(rng.random(n) < err,
                                   rng.integers(0, 4, n), read[:n])
                reads.append("".join("ACGT"[c] for c in read))
                refs.append("".join("ACGT"[c] for c in ref))
        parts = [encode_batch(reads, refs, 512)] + [
            generate_dataset_arrays(17, n, err, 0.9, seed=n + i, max_len=512)
            for n in lens[1:]]
        out.append((f"lengths/err{err}", tuple(
            np.concatenate([p[j] for p in parts]) for j in range(4))))
        out.append((f"err{err}", generate_dataset_arrays(
            501, 496, err, 0.9, seed=142 + i, max_len=512)))
    return out


def long_kernels_vs_plain(dev, name) -> dict:
    """Phase 14a; returns the max abs error per kernel (all 0)."""
    from asm_tpu_torch.config import AlignConfig
    from asm_tpu_torch.data.generator import generate_dataset_arrays
    from asm_tpu_torch.kernels import nw
    from asm_tpu_torch.kernels.greedy_cuda import stage_planes_t
    from asm_tpu_torch.kernels.nw_band import (
        BWS,
        banded_plain,
        nw_penalty_banded,
    )
    from asm_tpu_torch.kernels.nw_cuda import nw_align_cuda, nw_penalty_cuda

    err = dict(greedy=0, leap=0, nw_band=0, nw=0, nw_trace=0)
    n = dict(err)
    corpora = long_corpora()
    # greedy: k = 2, 3, 4 at max_len 512; k = 4 at 128 and 256
    cases = [(f"{label}/k{k}", AlignConfig(k=k, max_len=512, max_steps=128),
              c) for label, c in corpora for k in (2, 3, 4)]
    cases += [("k4/L128", AlignConfig(k=4, max_steps=32),
               generate_dataset_arrays(2001, 100, 0.1, 0.9, seed=146)),
              ("k4/L256", AlignConfig(k=4, max_len=256, max_steps=64),
               generate_dataset_arrays(2001, 200, 0.1, 0.9, seed=147,
                                       max_len=256))]
    for label, cfg, corpus in cases:
        err["greedy"] = max(err["greedy"], greedy_check(dev, corpus, cfg,
                                                        label))
        n["greedy"] += 2
    # LEAP: every variant (the penalty pass; lv_bag also the fused CIGAR;
    # simd_ed_lev also the SHD-gated filter) at k = 3 on every corpus,
    # k = 2 and 4 on the lengths corpora, every LeapMode on the first
    for ci, (label, corpus) in enumerate(corpora):
        for k in ((2, 3, 4) if label.startswith("lengths") else (3,)):
            for mode in (range(4) if ci == 0 and k == 3 else (1,)):
                for sem, gate, pens in LEAP_VARIANTS:
                    cfg = leap_cfg(sem, pens, mode, 512, k=k, af=120)
                    err["leap"] = max(err["leap"], leap_check(
                        dev, corpus, cfg, sem, gate,
                        f"{label}/k{k}/{sem}/gate{int(gate)}/{pens}/"
                        f"mode{mode}"))
                    n["leap"] += 2
    # NW: the band kernel (both forms), the full and the trace kernel
    for ci, (label, corpus) in enumerate(corpora):
        t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
             for a in corpus]
        planes = [torch.from_numpy(stage_planes_t(a).view(np.int32)).to(dev)
                  for a in (corpus[0], corpus[2])]
        for x, o, e in ([(1, 1, 1), (2, 3, 1)] if ci < 2 else [(1, 1, 1)]):
            what = f"{label}/x{x}o{o}e{e}"
            for bw in BWS:
                want = banded_plain(*t, bw, x, o, e)
                for pre, (a, b) in ((False, (t[0], t[2])), (True, planes)):
                    err["nw_band"] = max(err["nw_band"], max_diff(
                        nw_penalty_banded(a, t[1], b, t[3], bw=bw, x=x, o=o,
                                          e=e, pre_staged=pre), want,
                        f"{what}/BW{bw}/pre_staged={pre}: pen"))
                    n["nw_band"] += 1
            pen, ops, mask = nw.nw_align(*t, x, o, e, match_mask_threshold=3)
            err["nw"] = max(err["nw"], max_diff(
                nw_penalty_cuda(*t, x, o, e), pen, f"{what}/nw: pen"))
            got = nw_align_cuda(*t, x, o, e, match_mask_threshold=3)
            for g, w, key in zip(got, (pen, ops, mask),
                                 ("pen", "ops", "mask")):
                err["nw_trace"] = max(err["nw_trace"], max_diff(
                    g, w, f"{what}/nw_trace: {key}"))
            n["nw"] += 1
            n["nw_trace"] += 1
    phase(f"[14a long kernels vs plain] max_len 512 on {name}: cases {n} "
          f"(greedy k = 2, 3, 4 and k = 4 at max_len 128 / 256, both forms, "
          f"records and CIGARs; LEAP penalty, gated filter and fused CIGAR, "
          f"both penalty sets, k = 2, 3, 4; NW band BW {BWS} in both forms, "
          f"full, trace with ops and mask) exactly equal (max abs err "
          f"{max(err.values())})")
    return err


def long_flow(dev, card, err) -> list[dict]:
    """Phase 14b: the long-sequence flow at max_len 256 and 512; returns
    the greedy and LEAP kernels' W = 16 JSON entries."""
    from asm_tpu_torch.kernels import greedy_cuda, leap_cuda
    from asm_tpu_torch.kernels.greedy import greedy_align
    from asm_tpu_torch.kernels.leap import leap_align
    from asm_tpu_torch.tools import longseq_headline as lh

    entries = []
    for L, pin in LONG_FLOW.items():
        corpus = lh.long_corpus(L, pin["pairs"])
        greedy_cuda.LAUNCHES = leap_cuda.LAUNCHES = 0
        t0 = time.perf_counter()
        res = lh.run_length(L, reps=3, device=dev, digest=LONG_DIGEST_PAIRS,
                            corpus=corpus)
        wall = time.perf_counter() - t0
        launches = dict(greedy=greedy_cuda.LAUNCHES, leap=leap_cuda.LAUNCHES)
        if min(launches.values()) <= 0:
            raise AssertionError(f"the L = {L} flow launched {launches}")
        rows = {r["kernel"]: r for r in res["rows"]}
        got = dict(pairs=res["pairs"], greedy_cost=rows["greedy"]["checksum"],
                   leap_penalty=rows["leap_penalty"]["checksum"],
                   leap_passed=rows["leap_penalty"]["passed"],
                   digest=res["digest"])
        if got != pin:
            raise AssertionError(f"long flow L = {L}: {got} != pinned {pin}")
        # the plain versions on every pair, on the card
        args = [torch.from_numpy(a).to(dev) for a in corpus]
        g = res["by_row"]["greedy"]
        gcfg = lh.greedy_config(L, g["bound"])
        plain_g_ms, want = cuda_ms(lambda: greedy_align(*args, gcfg), 1)
        for key in ("cost", "steps"):
            err["greedy"] = max(err["greedy"], max_diff(
                torch.from_numpy(g[key]).to(dev), want[key],
                f"long flow L = {L}: greedy {key}"))
        plain_l_ms, want = cuda_ms(
            lambda: leap_align(*args, lh.leap_config(L)), 1)
        for key, v in res["by_row"]["leap"].items():
            err["leap"] = max(err["leap"], max_diff(
                torch.from_numpy(v).to(dev), want[key],
                f"long flow L = {L}: leap {key}"))
        del args, want
        parts = "; ".join(
            f"{k} {r['ms']:.3f} ms ({r['aligns_per_sec'] / 1e6:.1f}M "
            f"aligns/s), bound {r['bound_ms']:.4f} ({r['bound_by']}, "
            f"{100 * r['bound_share']:.1f}%), {r.get('warps_per_sm')} warps "
            f"per SM, {r.get('registers')} registers, "
            f"{r.get('spill_stores')} B spill" for k, r in rows.items())
        phase(f"[14b long flow L={L}] {res['pairs']} pairs of "
              f"{lh.read_length(L)} bases: greedy cost {got['greedy_cost']}, "
              f"LEAP penalty {got['leap_penalty']} with {got['leap_passed']} "
              f"passed, CIGAR digest {got['digest'][0][:12]}... of "
              f"{got['digest'][1]} (all pinned); greedy steps max "
              f"{rows['greedy']['steps_max']}, bounds "
              f"{rows['greedy']['chunk_bounds']}; energy max "
              f"{rows['leap_cigar']['energy_max']}, CIGAR bounds "
              f"{rows['leap_cigar']['chunk_bounds']}; launches {launches}; "
              f"{parts}; plain greedy {plain_g_ms:.3f} ms, LEAP "
              f"{plain_l_ms:.3f} ms, equal on every pair; {wall:.1f} s "
              f"wall; on {card}")
        if L != 512:
            continue
        for kernel, row, source, replaces, plain_ms in (
                ("greedy", rows["greedy"], "greedy.cu",
                 "greedy_pallas.py:91", plain_g_ms),
                ("leap", rows["leap_penalty"], "leap.cu", "leap_pallas.py:49",
                 plain_l_ms)):
            entries.append(dict(
                name=f"{kernel}_L512", route="cuda",
                source=f"asm_tpu_torch/csrc/{source}",
                replaces=f"asm_tpu/kernels/{replaces}",
                launches=launches[kernel], max_abs_err=float(err[kernel]),
                ms=row["ms"], plain_ms=plain_ms, bound_ms=row["bound_ms"],
                bound_by=row["bound_by"], library_ms=None,
                warps_per_sm=row.get("warps_per_sm")))
    return entries


def long_harness(dev, card, err) -> list[dict]:
    """Phase 14b's harness at max_len 512; returns the NW band, full and
    trace kernels' W = 16 JSON entries."""
    from asm_tpu_torch.bench.harness import run_benchmark
    from asm_tpu_torch.config import AlignConfig
    from asm_tpu_torch.data.generator import generate_dataset_native
    from asm_tpu_torch.kernels import greedy_cuda, leap_cuda, nw, nw_band, \
        nw_cuda
    from asm_tpu_torch.kernels.greedy_cuda import stage_planes_t
    from asm_tpu_torch.utils.bounds import bound_entry, nw_band_work, \
        nw_full_work

    corpus = generate_dataset_native(LONG_HARNESS_PAIRS, 496, 0.05, 0.96,
                                     seed=42, max_len=512)
    cfg = AlignConfig(x=1, o=1, e=1, k=3, max_len=512)
    greedy_cuda.LAUNCHES = nw_band.LAUNCHES = leap_cuda.LAUNCHES = 0
    nw_cuda.LAUNCHES.update(nw=0, nw_trace=0)
    t0 = time.perf_counter()
    r = run_benchmark(*corpus, cfg, impl="cuda", device=dev)
    wall = time.perf_counter() - t0
    launches = dict(greedy=greedy_cuda.LAUNCHES, nw_band=nw_band.LAUNCHES,
                    nw=nw_cuda.LAUNCHES["nw"],
                    nw_trace=nw_cuda.LAUNCHES["nw_trace"],
                    leap=leap_cuda.LAUNCHES)
    if min(v for k, v in launches.items() if k != "nw") <= 0:
        raise AssertionError(f"the L = 512 harness launched {launches}")
    got = harness_counts(r)
    if r.coverage_checked != r.total or got != LONG_HARNESS:
        raise AssertionError(f"L = 512 harness {got} on {r.coverage_checked} "
                             f"checked != pinned {LONG_HARNESS}")
    # at err 0.05 every penalty certifies on a band: the harness's NW
    # partition at err 0.15 leaves a residue for the full kernel
    hard = generate_dataset_native(LONG_HARNESS_PAIRS, 496, 0.15, 0.96,
                                   seed=43, max_len=512)
    t = [torch.from_numpy(a).to(dev) for a in hard]
    before = nw_cuda.LAUNCHES["nw"]
    hard_pen = nw_band.nw_penalty_partitioned(*t, bws=nw_band.BWS)
    launches["nw"] += nw_cuda.LAUNCHES["nw"] - before
    if launches["nw"] <= 0:
        raise AssertionError("the L = 512 NW partition left no residue for "
                             "the full kernel")
    err["nw"] = max(err["nw"], max_diff(
        torch.from_numpy(hard_pen).to(dev), nw.nw_penalty(*t),
        "L = 512 err 0.15 partition vs plain full NW"))
    pt = run_benchmark(*corpus, cfg, impl="torch", device=dev)
    if harness_counts(pt) != got:
        raise AssertionError(f"L = 512 harness: torch {harness_counts(pt)} "
                             f"!= cuda {got}")
    # the NW kernels on the harness's pairs, timed against their bounds
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in corpus]
    planes = [torch.from_numpy(stage_planes_t(a).view(np.int32)).to(dev)
              for a in (corpus[0], corpus[2])]
    m, n = corpus[1], corpus[3]
    bw = 32
    band_ms, pen = cuda_ms(lambda: nw_band.nw_penalty_banded(
        planes[0], t[1], planes[1], t[3], bw=bw, pre_staged=True), 5)
    band_plain_ms, want = cuda_ms(lambda: nw_band.banded_plain(*t, bw), 1)
    err["nw_band"] = max(err["nw_band"], max_diff(pen, want,
                                                  "L = 512 band"))
    nw_ms, pen = cuda_ms(lambda: nw_cuda.nw_penalty_cuda(*t), 5)
    trace_ms, got_t = cuda_ms(
        lambda: nw_cuda.nw_align_cuda(*t, match_mask_threshold=3), 3)
    trace_plain_ms, want = cuda_ms(
        lambda: nw.nw_align(*t, match_mask_threshold=3), 1)
    nw_plain_ms, want_pen = cuda_ms(lambda: nw.nw_penalty(*t), 1)
    err["nw"] = max(err["nw"], max_diff(pen, want_pen, "L = 512 nw"))
    for g, w, key in zip(got_t, want, ("pen", "ops", "mask")):
        err["nw_trace"] = max(err["nw_trace"], max_diff(
            g, w, f"L = 512 nw_trace {key}"))
    bounds = dict(
        nw_band=bound_entry(*nw_band_work(m, n, np.full(m.size, bw), 512)),
        nw=bound_entry(*nw_full_work(m, n, 512)),
        nw_trace=bound_entry(*nw_full_work(m, n, 512, trace=True)))
    times = dict(nw_band=(band_ms, band_plain_ms), nw=(nw_ms, nw_plain_ms),
                 nw_trace=(trace_ms, trace_plain_ms))
    parts = "; ".join(
        f"{k} {times[k][0]:.4f} ms, bound {b['bound_ms']:.4f} "
        f"({b['bound_by']}, {100 * b['bound_ms'] / times[k][0]:.1f}%), "
        f"plain {times[k][1]:.3f} ms" for k, b in bounds.items())
    phase(f"[14c long harness L=512] {r.total} pairs of 496 bases err 0.05: "
          f"greedy == NW {got[0]}, LEAP == NW {got[1]}, covered {got[2]} of "
          f"{r.coverage_checked} (pinned; impl torch the same); the NW "
          f"partition of {LONG_HARNESS_PAIRS} err 0.15 pairs equal to the "
          f"plain full NW; launches {launches}; NW {r.nw_time * 1e3:.3f} / LEAP "
          f"{r.leap_time * 1e3:.3f} / greedy {r.greedy_time * 1e3:.3f} ms "
          f"(plain {pt.nw_time * 1e3:.3f} / {pt.leap_time * 1e3:.3f} / "
          f"{pt.greedy_time * 1e3:.3f}), {wall:.1f} s wall with coverage; "
          f"on {r.total} pairs: band BW {bw}, full, trace: {parts}; on "
          f"{card}")
    names = dict(nw_band=("nw_band.cu", "nw_band.py:174"),
                 nw=("nw.cu", "nw_pallas.py:88"),
                 nw_trace=("nw.cu", "nw_pallas.py:218"))
    return [dict(name=f"{k}_L512", route="cuda",
                 source=f"asm_tpu_torch/csrc/{names[k][0]}",
                 replaces=f"asm_tpu/kernels/{names[k][1]}",
                 **({} if k == "nw_band" else
                    {"instantiation": nw_instance(k == "nw_trace", 512)}),
                 launches=launches[k], max_abs_err=float(err[k]),
                 ms=times[k][0], plain_ms=times[k][1], **bounds[k])
            for k in bounds]


def long_sequences(dev, name, card) -> list[dict]:
    """Phase 14; returns the W = 16 kernels' JSON entries."""
    t0 = time.perf_counter()
    err = long_kernels_vs_plain(dev, name)
    entries = long_flow(dev, card, err)
    entries += long_harness(dev, card, err)
    phase(f"[14 long sequences] {time.perf_counter() - t0:.1f} s")
    return entries


def msa_path(dev, card) -> None:
    """Phase 15: profile-profile alignment of 65,536 profile pairs at
    max_len 128 on the card; the score sum and the ops digest pinned from
    asm_tpu, the first 1,024 pairs equal to the same code on the CPU, and
    the demo's output on the card equal to its output on the CPU."""
    import contextlib
    import hashlib
    import io
    import math

    from asm_tpu_torch.apps import demo
    from asm_tpu_torch.kernels import greedy_cuda, msa

    t0 = time.perf_counter()
    als = msa_alignments(2 * MSA_PAIRS)
    p1, n1 = msa.profiles_from_alignments(als[:MSA_PAIRS], MSA_LEN)
    p2, n2 = msa.profiles_from_alignments(als[MSA_PAIRS:], MSA_LEN)
    prep = time.perf_counter() - t0
    host = (p1, n1, p2, n2)
    args = [torch.from_numpy(a).to(dev) for a in host]
    msa.profile_align(*(a[:256] for a in args))  # first launches
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = msa.profile_align(*args)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    score = out["score"].cpu().numpy()
    ops = np.ascontiguousarray(out["ops"].cpu().numpy())
    got = (math.fsum(score.astype(np.float64).tolist()),
           hashlib.sha256(ops.tobytes()).hexdigest())
    if got != (MSA_SCORE_SUM, MSA_OPS_DIGEST) or ops.shape != (
            MSA_PAIRS, 2 * MSA_LEN) or not np.isfinite(score).all():
        raise AssertionError(f"MSA (score sum, ops digest) {got} != pinned "
                             f"{(MSA_SCORE_SUM, MSA_OPS_DIGEST)}")
    cpu = msa.profile_align(*(torch.from_numpy(a[:1024]) for a in host))
    if not (np.array_equal(cpu["ops"].numpy(), ops[:1024])
            and np.array_equal(cpu["score"].numpy(), score[:1024])):
        raise AssertionError("MSA on the card != the same code on the CPU")

    def demo_out(argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            demo.main(argv)
        return buf.getvalue()

    greedy_cuda.LAUNCHES = 0
    pair = ["ACGTTGCAACGTAAGGCTTACG", "ACGTGCAACGTTAAGGCTACGGATC"]
    for argv in ([], pair):
        if demo_out(argv) != demo_out(argv + ["--device", "cpu"]):
            raise AssertionError(f"the demo on the card != on the CPU "
                                 f"({argv})")
    if greedy_cuda.LAUNCHES != 2:
        raise AssertionError(f"the demo launched the greedy kernel "
                             f"{greedy_cuda.LAUNCHES} times, not 2")
    phase(f"[15 MSA] {MSA_PAIRS} profile pairs at max_len {MSA_LEN}: score "
          f"sum {got[0]!r}, ops digest {got[1][:8]}... (pinned), the first "
          f"1024 equal to the CPU's; {wall:.3f} s on the card, "
          f"{MSA_PAIRS / wall:.0f} pairs/s (profiles built on the host in "
          f"{prep:.1f} s); the demo prints on the card what it prints on "
          f"the CPU; on {card}")


def sharded_rank(rank: int, port: int, outdir: str) -> None:
    """Phase 16b's rank `rank` of two gloo ranks on the one card: its half
    of the 1M headline corpus through make_sharded_pipeline; writes its
    per-pair outputs, counters, launches and wall to outdir."""
    import os

    import torch.distributed as dist

    from asm_tpu_torch import headline
    from asm_tpu_torch.config import AlignConfig
    from asm_tpu_torch.kernels import greedy_cuda, leap_cuda, nw_band
    from asm_tpu_torch.parallel import (
        initialize_distributed,
        make_mesh,
        make_sharded_pipeline,
        shard_batch,
    )

    initialize_distributed(f"127.0.0.1:{port}", 2, rank, backend="gloo")
    try:
        mesh = make_mesh(device="cuda")
        shard = shard_batch(mesh, *headline.native_corpus(MAIN_PAIRS, 0.05))
        pipeline = make_sharded_pipeline(mesh, AlignConfig(x=1, o=1, e=1,
                                                           k=3))
        greedy_cuda.LAUNCHES = nw_band.LAUNCHES = leap_cuda.LAUNCHES = 0
        dist.barrier()
        t0 = time.perf_counter()
        nw, g, lp, stats = pipeline(*shard)
        torch.cuda.synchronize(mesh.device)
        wall = time.perf_counter() - t0
        np.savez(os.path.join(outdir, f"rank{rank}.npz"), nw=nw.cpu(),
                 g=g.cpu(), l=lp.cpu(), stats=stats.cpu(), wall=wall,
                 launches=[greedy_cuda.LAUNCHES, nw_band.LAUNCHES,
                           leap_cuda.LAUNCHES])
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def sharded_path(dev, card) -> None:
    """Phase 16: the 1M headline corpus through make_sharded_pipeline(impl
    "cuda"): (a) at NCCL world size 1 in this process, (b) in two spawned
    processes on gloo, both ranks on the one card, 500,000 pairs each.
    Every rank's summed counters must equal the pins, and (b)'s gathered
    per-pair outputs (a)'s."""
    import multiprocessing
    import tempfile

    import torch.distributed as dist

    from asm_tpu_torch import headline
    from asm_tpu_torch.config import AlignConfig
    from asm_tpu_torch.kernels import greedy_cuda, leap_cuda, nw_band
    from asm_tpu_torch.parallel import (
        initialize_distributed,
        make_mesh,
        make_sharded_pipeline,
        shard_batch,
    )

    want = [MAIN_PAIRS, HARNESS_GREEDY_EQ, HARNESS_LEAP_EQ, LEAP_PASSED_1M,
            NW_CHECKSUM_1M, CHECKSUM_1M, LEAP_CHECKSUM_1M]
    corpus = headline.native_corpus(MAIN_PAIRS, 0.05)
    initialize_distributed(f"127.0.0.1:{_free_port()}", 1, 0, backend="nccl")
    try:
        mesh = make_mesh(device=dev)
        pipeline = make_sharded_pipeline(mesh, AlignConfig(x=1, o=1, e=1,
                                                           k=3))
        shard = shard_batch(mesh, *corpus)
        greedy_cuda.LAUNCHES = nw_band.LAUNCHES = leap_cuda.LAUNCHES = 0
        walls_a = []
        for _ in range(2):  # the process's first call at 1M, then again
            t0 = time.perf_counter()
            nw, g, lp, stats = pipeline(*shard)
            torch.cuda.synchronize(dev)
            walls_a.append(round(time.perf_counter() - t0, 3))
        launches_a = [greedy_cuda.LAUNCHES, nw_band.LAUNCHES,
                      leap_cuda.LAUNCHES]
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    got_a = [int(v) for v in stats.cpu()]
    if got_a != want or min(launches_a) <= 0 or backend != "nccl":
        raise AssertionError(f"16a ({backend}): counters {got_a} != pinned "
                             f"{want}, or launches (greedy, band, LEAP) "
                             f"{launches_a}")
    per_pair_a = [t.cpu().numpy() for t in (nw, g, lp)]
    del shard, nw, g, lp
    torch.cuda.empty_cache()

    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        procs = [ctx.Process(target=sharded_rank, args=(r, port, tmp))
                 for r in range(2)]
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(timeout=600)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        wall_b = time.perf_counter() - t0
        codes = [p.exitcode for p in procs]
        if codes != [0, 0]:
            raise AssertionError(f"16b: a rank failed, exit codes {codes}")
        ranks = [dict(np.load(f"{tmp}/rank{r}.npz")) for r in range(2)]
    for r, res in enumerate(ranks):
        if res["stats"].tolist() != want or res["launches"].min() <= 0:
            raise AssertionError(f"16b rank {r}: counters "
                                 f"{res['stats'].tolist()} != pinned {want}"
                                 f", or launches {res['launches'].tolist()}")
    for key, a in zip(("nw", "g", "l"), per_pair_a):
        if not np.array_equal(np.concatenate([r[key] for r in ranks]), a):
            raise AssertionError(f"16b's gathered {key} != 16a's")
    phase(f"[16 sharded pipeline] {MAIN_PAIRS} pairs err 0.05, counters "
          f"{want} (pinned): (a) NCCL world size 1, two calls {walls_a} s, "
          f"launches "
          f"(greedy, band, LEAP) {launches_a}; (b) 2 gloo ranks on the one "
          f"card, {MAIN_PAIRS // 2} pairs each: pipeline "
          f"{[round(float(r['wall']), 3) for r in ranks]} s, launches "
          f"{[r['launches'].tolist() for r in ranks]}, {wall_b:.1f} s with "
          f"process start and corpus; per-pair outputs gathered equal to "
          f"(a)'s; on {card}")


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


def roofline_phase(dev, card, greedy_rows, leap_rows, nw_res,
                   nw_rows) -> list[dict]:
    """Phase 12; returns the three roofline kernels' JSON entries."""
    import contextlib
    import io

    from asm_tpu_torch.kernels import nw_band
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
    for name, rows in (("greedy", greedy_rows), ("leap", leap_rows)):
        with contextlib.redirect_stdout(io.StringIO()):
            got = rl.report(name, rows["counts"], rows["bytes"] / rows["n"],
                            rows["seconds"], rows["n"], issue["rate"],
                            stream["rate"], rows["bound_ms"],
                            resources=rows["resources"])
        phase(f"[12c roofline {name}] {json.dumps(got)}")
    with contextlib.redirect_stdout(io.StringIO()):
        lines = rl.nw_band_lines(nw_res, nw_band.build_kernel()[0])
    for got in lines:
        phase(f"[12d roofline nw_band BW{got['bw']}] {json.dumps(got)}")
    for name, row in nw_rows.items():
        with contextlib.redirect_stdout(io.StringIO()):
            got = rl.nw_line(name, row["m"], row["n"], row["ms"],
                             row["bound"], row.get("ops"))
        phase(f"[12e roofline {name}] {json.dumps(got)}")

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
    def timed(build):
        t = time.perf_counter()
        build()
        return round(time.perf_counter() - t, 1)

    t0 = time.perf_counter()
    kernels = (greedy_cuda, nw_cuda, nw_band, leap_cuda, roofline_cuda)
    with ThreadPoolExecutor(len(kernels) + 1) as ex:
        builds = [ex.submit(timed, k.build_kernel) for k in kernels]
        native = ex.submit(timed, build_native)
        secs = {k.__name__.rsplit(".", 1)[1]: f.result()
                for k, f in zip(kernels, builds)}
        secs["native"] = native.result()
    ptxas = "; ".join(ptxas_summary(k.ptxas_report()) for k in kernels)
    phase(f"[2 build] {len(kernels)} kernel libraries + native library in "
          f"{time.perf_counter() - t0:.1f}s (seconds each: {secs}); "
          f"ptxas: {ptxas}")

    entry, greedy_rows = greedy_phases(dev, name, card)
    entries = [entry]
    err = nw_conformance(dev, name)
    got, nw_res, full_row = nw_main_path(dev, card, err)
    entries += got
    entry, trace_row = coverage_path(dev, card, err)
    entries.append(entry)
    leap_err = leap_conformance(dev, name)
    entry, leap_rows = leap_main_path(dev, card, leap_err)
    entries.append(entry)
    filter_cli(card)
    harness_path(dev, card)
    entries += roofline_phase(dev, card, greedy_rows, leap_rows, nw_res,
                              dict(nw=full_row, nw_trace=trace_row))
    # the greedy kernel on the mapper's path, beside its main path's numbers
    entries[0]["mapper"] = mapper_path(dev, card)
    entries += long_sequences(dev, name, card)
    msa_path(dev, card)
    sharded_path(dev, card)

    print(json.dumps({"kernels": entries}))
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
