"""GPU smoke test of the PyTorch / CUDA port (asm_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card, nvcc, cuobjdump and g++. Phases, each printing one
line:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: the greedy, NW, NW band, LEAP and roofline kernels (nvcc,
     sm_90a), the native host runtime and phase 17's per-shape
     libraries, all at once, from this checkout's sources;
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
     equal the plain full NW on every pair; (6c) the NW staging kernel
     (nw_band.stage_planes, int8 codes -> the band's 2-bit planes) on
     card codes at long1k's job (25,000 x 1,056) and at 100 bp
     (1,048,576 x 128), pads inside and past the lengths, word for word
     equal to its plain version on the same tensors, timed against its
     bytes bound, every launch counted in nw_band.STAGE_LAUNCHES;
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
     op_chain (each of the Gotoh cell's opcodes in chains: add-min, min /
     max, compare and select, multiply-add, add, add-min beside
     multiply-add) against its plain version, its loop holding its
     opcodes; then the measured issue rate, each op_chain opcode's lanes
     per cycle per SM, stream rate and dispatch floor, none
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
 17. shapes outside the kernels' tuned tables, each in a library of its
     own built in phase 2 (kernels/shapes.py): (a) the filter CLI
     (apps.leap_filter) at ERROR 0, 1, 5 and 8, levenshtein + SHD and
     affine, on 262,144 pairs of 90-250-base reads (max_len 256, k =
     ERROR), passNum pinned from asm_tpu's CLI, then each levenshtein
     ERROR's kernel on the file's first batch against its plain version,
     timed; (b) the harness at max_len 160, k = 5 on 150-base reads: the
     counts of 65,536 pairs at err 0.05 and 0.10 and of 16,384 at x = 1,
     o = 4, e = 2 pinned from asm_tpu's harness (impl torch the same),
     then 1,048,576 pairs per rate on the card, impl torch equal, and each
     of the five kernels at that shape against its plain version, timed;
     (c) the long-sequence flow at max_len 160 and 384 (k = 3) on
     1,048,576 and 524,288 pairs, as 14b, pinned from asm_tpu.
 18. rows longer than 512 (each kernel's long-row path, per-shape
     libraries built in phase 2): (a) every kernel against its plain
     version at max_len 544, 800, 1024 and 2048 on edge lengths (0, 1,
     31, L/2, L - 1, L) and generated pairs at err 0.05 and 0.15: greedy
     at k = 3 and 4 in both forms, LEAP's fused CIGAR, gated filter and
     penalty pass with both penalty sets, NW full and trace (also on the
     walk-edge pairs of data/walk_edges.py, whose tracebacks cross the
     long trace kernel's walk tiles at their edges and corners), the band
     at BW 4-128 (BW 128 also at max_len 128 and 256), also on the
     band-edge pairs of data/band_edges.py (destinations at the band's
     edges, the wide path's first thread boundary and just off the band;
     BW 128 also at 128, 256 and 512); NW full also on the block-edge
     pairs of data/block_edges.py (read lengths at the long full
     kernel's strip and block edges, ref lengths where its step loop's
     parts meet) at those max_lens and at 3072 (three blocks of rows);
     (b) the long-sequence
     flow at max_len 1024 on 262,144 pairs and 2048 on 65,536, pinned from
     asm_tpu, the plain versions equal on 16,384 pairs of each; (c) the
     harness at max_len 1024 on 8,192 pairs, its counts pinned from
     asm_tpu; (d) the harness at 2048 on 512 pairs, its counts pinned
     from asm_tpu's public calls; the
     band, full and trace kernels timed at 1024 and 2048 against their
     plain versions and bounds, with their SASS per step; each of the
     five kernels must have launched at max_len >= 1024 in (b)-(d); (e)
     the greedy, LEAP, NW and band long-row kernels' registers, spill
     bytes (threads per pair) and warps per SM at each max_len, and the
     SASS of the kernels the long-row redesigns left alone (greedy's,
     LEAP's, NW's and the band's W <= 16 instantiations in the tuned
     tables and phase 17's libraries, the long NW trace kernel and the
     band's wide path) against the pin taken from the sources before the
     long NW full kernel's redesign
     (tools/sass_pin.py): no kernel may have moved.
Prints a JSON line of per-kernel results (time, plain version's time,
bound, launches; the W = 16 instantiations and phases 17's and 18's
shapes as entries of their own), the card line, and last {"ok": true, "device":
{...}}. Any failure raises (exit code != 0).
"""

from __future__ import annotations

import json
import os
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
# Phase 17, the shapes outside the tuned tables. (a) The filter CLI on a
# pair file of SHAPE_FILTER_GROUPS (read length, err, seed; 65,536 pairs
# each from the native generator at mismatch rate 0.9, max_len 256):
# passNum of `python -m asm_tpu.apps.leap_filter ARGS --file F` (the JAX
# CLI, XLA, on the CPU) per ARGS: levenshtein + SHD at ERROR 0, 1, 5, 8,
# and affine (x, o, e = 2, 3, 1; af = 3 ERROR) without the gate.
SHAPE_FILTER_GROUPS = ((90, 0.02, 171), (150, 0.04, 172), (200, 0.05, 173),
                       (250, 0.06, 174))
SHAPE_FILTER_GROUP_PAIRS = 65_536
SHAPE_FILTER_PASSED = {"0": 3445, "1": 23630, "5": 109485, "8": 169162,
                       "0 0 0": 3445, "1 0 0": 23993, "5 0 0": 139110,
                       "8 0 0": 221222}
# (b) The harness at 150-base reads, max_len 160, k = 5 (native generator,
# seed 42, mismatch rate 0.96): (greedy == NW, LEAP == NW, covered) of
# asm_tpu.bench.harness.run_benchmark(impl="xla") on the CPU, coverage on
# every pair, per (x, o, e, err, pairs).
SHAPE_HARNESS = {(1, 1, 1, 0.05, 65_536): (56731, 65192, 62597),
                 (1, 1, 1, 0.10, 65_536): (43413, 63527, 59517),
                 (1, 4, 2, 0.05, 16_384): (15223, 16248, 15873)}
SHAPE_HARNESS_BIG = 1_048_576  # the card-only run per rate
SHAPE_HARNESS_TORCH = 131_072  # of it, held against impl torch
# (c) The long-sequence flow at max_len 160 and 384, computed as LONG_FLOW
# (steps bound 256; max steps 22 and 88; E of the digest's pairs 8 and
# 137).
SHAPE_FLOW = {
    160: dict(pairs=1_048_576, greedy_cost=6428548, leap_penalty=6221133,
              leap_passed=1_048_576, digest=(
                  "d973f48539710ead8815ea8676b8961b"
                  "a2c7657788c16fcf3bc3a4b015bdbf71", 65_536)),
    384: dict(pairs=524_288, greedy_cost=7696090, leap_penalty=7395698,
              leap_passed=524_288, digest=(
                  "2777163bad57e071bd433939f4f91cc3"
                  "7b85fa09a8f88eacf21b7cc12a0058b5", 65_536)),
}
# Phase 18, rows longer than 512: (b) the long-sequence flow at max_len
# 1024 and 2048, computed as LONG_FLOW, in 8,192-pair chunks (greedy at
# max_steps L / 2: max steps 256 at L = 1024, 510 at 2048, no walk cut;
# the CIGAR digest's E, the largest passed energy among the digest's
# pairs: 200 at both), on 262,144 and 65,536 pairs.
ROW_FLOW = {
    1024: dict(pairs=262_144, greedy_cost=10764830, leap_penalty=10164241,
               leap_passed=260_928, digest=(
                   "efa5bb2587a4601e8bca20e66331cacf"
                   "f479c84a142c5f009efed01259a77bc9", 65_225)),
    2048: dict(pairs=65_536, greedy_cost=7087042, leap_penalty=5604328,
               leap_passed=61_022, digest=(
                   "5300bbef05f88b3d8a5505f0c2f6f1c6"
                   "7e768f3365f46d95b16e8f71bcf46d69", 61_022)),
}
ROW_PLAIN_SAMPLE = 16_384  # pairs of each flow held against the plain versions
# (c) the harness at max_len 1024: 8,192 native pairs of 998 bases, err
# 0.05, seed 42, x = o = e = 1, k = 3 (max_steps = max_len); (greedy ==
# NW, LEAP == NW, covered) of asm_tpu.bench.harness.run_benchmark(impl=
# "xla", chunk=1024) on the CPU, coverage on every pair.
ROW_HARNESS_PAIRS = 8192
ROW_HARNESS = (2778, 7667, 5861)
# (d) the harness at max_len 2048 on 512 native pairs of 2,002 bases, err
# 0.05, seed 42, x = o = e = 1, k = 3; (greedy == NW, LEAP == NW, covered)
# from asm_tpu's public calls on the CPU, without the fused coverage step
# (which takes minutes to compile at these lengths): greedy == NW and
# LEAP == NW from asm_tpu.bench.harness.run_benchmark(impl="xla", chunk=64,
# want_coverage=False); covered = the pairs for which
# asm_tpu.metrics.coverage.check_coverage(read, ref, greedy CIGAR, NW
# CIGAR, 1, 3) holds, the CIGARs from asm_tpu's XLA greedy_align and
# nw_align (batch_greedy_cigars, batch_nw_cigars) in chunks of 32 pairs
ROW_HARNESS_2048_PAIRS = 512
ROW_HARNESS_2048 = (50, 434, 249)
ROW_LENGTHS = (544, 800, 1024, 2048)
# (a)'s block-edge pairs also at three blocks of rows (NW full only)
BLOCK_EDGE_LENGTHS = ROW_LENGTHS + (3072,)
ROW_CASE_PAIRS = 200  # (a)'s generated err 0.05 pairs per max_len below 2048
# (a)'s LEAP cases: the fused CIGAR (lv_bag, both penalty sets), the gated
# filter and the penalty pass (simd_ed_affine)
ROW_LEAP_VARIANTS = [("lv_bag", False, (1, 1, 1)), ("lv_bag", False, (2, 3, 1)),
                     ("simd_ed_lev", True, (1, 1, 1)),
                     ("simd_ed_affine", False, (2, 3, 1))]
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
# phase 12: the check's issue_chain and op_chain iterations and stream
# size (the measurement takes tools/roofline.micro's) and the probe's loop
# trips
ISSUE_CHECK_ITERS = 16
CHAIN_CHECK_ITERS = 3
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
    m = re.search(r"greedy(_long)?_kernelILi(\d+)ELi(\d+)ELb(\d)", name)
    if m:
        return (f"greedy{' long' if m[1] else ''} k{m[2]}/W{m[3]}/"
                f"{'planes' if m[4] == '1' else 'codes'}")
    m = re.search(r"band_kernelILi(\d+)ELi(\d+)E", name)
    if m:
        return f"nw_band BW{m[1]}/W{m[2]}"
    m = re.search(r"band_wide_kernelILi(\d+)ELi(\d+)E", name)
    if m:
        return f"nw_band wide BW{m[1]}/W{m[2]}"
    m = re.search(r"nw_long_full_kernelILi(\d+)E", name)
    if m:
        return f"nw long W{m[1]}"
    m = re.search(r"nw_long_kernelILi(\d+)ELb1E", name)
    if m:
        return f"nw_trace long W{m[1]}"
    m = re.search(r"nw_kernelILi(\d+)ELi(\d+)ELi(\d)E", name)
    if m:
        route = ("", "/global", "/shared")[int(m[3])]
        return f"{'nw_trace' if route else 'nw'} W{m[1]}/G{m[2]}{route}"
    m = re.search(r"leap(_long)?_kernelILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)ELi"
                  r"(\d+)ELi(\d)ELb(\d)ELb(\d)", name)
    if m:
        return (f"leap{' long' if m[1] else ''} k{m[2]}/W{m[3]}/"
                f"x{m[4]}o{m[5]}e{m[6]}/{LEAP_SEMANTICS[int(m[7])]}"
                f"{'/cigar' if m[8] == '1' else ''}/"
                f"{'planes' if m[9] == '1' else 'codes'}")
    if re.search(r"\d+stage_kernel", name):
        return "nw_stage"
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


def write_pair_file(path: str, groups=((150, 0.01, 77), (230, 0.02, 78)),
                    per_group: int = FILTER_PAIRS // 2) -> None:
    """The filter CLI's input: read/ref line pairs from the native
    generator (mismatch rate 0.9, max_len 256), per_group pairs of each
    (read length, err, seed) of `groups` (default: phase 10's FILTER_PAIRS,
    half with 150-base reads at err 0.01, half with 230-base reads at err
    0.02)."""
    from asm_tpu_torch.data.generator import generate_dataset_native
    from asm_tpu_torch.encoding import decode_batch

    with open(path, "w") as f:
        for length, err, seed in groups:
            rc, rl, fc, fl = generate_dataset_native(
                per_group, length, err, mismatch_rate=0.9, seed=seed,
                max_len=256)
            f.writelines(f"{a}\n{b}\n" for a, b in zip(decode_batch(rc, rl),
                                                      decode_batch(fc, fl)))


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


def nw_stage_path(dev, card) -> dict:
    """Phase 6c; returns the staging kernel's JSON entry (long1k's job,
    with the 100 bp shape under "at_100bp")."""
    from asm_tpu_torch.encoding import PAD_READ, PAD_REF
    from asm_tpu_torch.kernels import nw_band
    from asm_tpu_torch.utils.bounds import bound_entry

    nw_band.STAGE_LAUNCHES = 0
    band_launches = nw_band.LAUNCHES
    queued, calls, rows = 20, 0, []
    for B, L in ((25_000, 1_056), (1_048_576, 128)):
        g = torch.Generator(device=dev).manual_seed(B + L)
        pos = torch.arange(L, device=dev)
        sides = []
        # reads padded with PAD_READ past a random length, refs with
        # PAD_REF, and 1% of the codes inside made pads too
        for pad in (PAD_READ, PAD_REF):
            codes = torch.randint(0, 4, (B, L), device=dev, generator=g,
                                  dtype=torch.int8)
            lens = torch.randint(0, L + 1, (B, 1), device=dev, generator=g)
            inside = torch.rand((B, L), device=dev, generator=g) < 0.01
            sides.append(torch.where((pos >= lens) | inside,
                                     torch.tensor(pad, dtype=torch.int8,
                                                  device=dev), codes))
        # queued behind a spin: the wrapper's host time would outlast the
        # kernel's ~0.03 ms at 25,000 x 1,056
        ms = queued_ms(lambda: nw_band.stage_planes(*sides), queued)
        got = nw_band.stage_planes(*sides)
        calls += 2 + 3 * queued
        plain_ms, want = cuda_ms(
            lambda: [nw_band.stage_plain(c) for c in sides], 2)
        for side, a, b in zip(("reads", "refs"), got, want):
            max_diff(a, b, f"staging {B} x {L} {side}: planes")
        # each side's codes read once, its planes written once
        rows.append(dict(shape=[B, L], ms=ms, plain_ms=plain_ms,
                         **bound_entry(0, 2 * (B * L + B * L // 4))))
    launches = nw_band.STAGE_LAUNCHES
    band = nw_band.LAUNCHES - band_launches
    if launches != calls or band:
        raise AssertionError(f"staging: {launches} staging launches for "
                             f"{calls} calls, {band} band launches "
                             "(expected none)")
    phase("[6c NW staging] " + "; ".join(
        f"{r['shape'][0]} x {r['shape'][1]}: kernel {r['ms']:.4f} ms "
        f"({r['bound_ms'] / r['ms']:.1%} of its {r['bound_ms']:.4f} ms "
        f"bytes bound), plain version {r['plain_ms']:.3f} ms, equal word "
        f"for word" for r in rows)
        + f"; {launches} staging launches, no band launch; on {card}")
    main, short = rows
    return dict(name="nw_stage", route="cuda",
                source="asm_tpu_torch/csrc/nw_band.cu", replaces=None,
                shape=main.pop("shape"), launches=launches, max_abs_err=0.0,
                **main, at_100bp=short)


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


def long_flow(dev, card, err, pins=None, tag="14b",
              entry_lengths=(512,), plain_sample=None,
              suffix=None) -> list[dict]:
    """Phase 14b: the long-sequence flow at max_len 256 and 512 (or, as
    phases 17c and 18b, at `pins`' lengths); returns the greedy and LEAP
    kernels' JSON entries at `entry_lengths`, named kernel_L<L><suffix>
    (suffix "_k3" with pins by default). The plain versions run on every
    pair, or on `plain_sample` pairs spread over the corpus."""
    from asm_tpu_torch.kernels import greedy_cuda, leap_cuda
    from asm_tpu_torch.kernels.greedy import greedy_align
    from asm_tpu_torch.kernels.leap import leap_align
    from asm_tpu_torch.tools import longseq_headline as lh

    entries = []
    for L, pin in (pins or LONG_FLOW).items():
        t_gen = time.perf_counter()
        corpus = lh.long_corpus(L, pin["pairs"])
        t_gen = time.perf_counter() - t_gen
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
        # the plain versions on every pair (or a sample), on the card
        rows_ = (np.arange(res["pairs"]) if plain_sample is None else
                 np.linspace(0, res["pairs"] - 1, plain_sample).astype(
                     np.int64))
        args = [torch.from_numpy(np.ascontiguousarray(a[rows_])).to(dev)
                for a in corpus]
        g = res["by_row"]["greedy"]
        gcfg = lh.greedy_config(L, g["bound"])
        plain_g_ms, want = cuda_ms(lambda: greedy_align(*args, gcfg), 1)
        for key in ("cost", "steps"):
            err["greedy"] = max(err["greedy"], max_diff(
                torch.from_numpy(g[key][rows_]).to(dev), want[key],
                f"long flow L = {L}: greedy {key}"))
        plain_l_ms, want = cuda_ms(
            lambda: leap_align(*args, lh.leap_config(L)), 1)
        for key, v in res["by_row"]["leap"].items():
            err["leap"] = max(err["leap"], max_diff(
                torch.from_numpy(v[rows_]).to(dev), want[key],
                f"long flow L = {L}: leap {key}"))
        del args, want
        parts = "; ".join(
            f"{k} {r['ms']:.3f} ms ({r['aligns_per_sec'] / 1e6:.1f}M "
            f"aligns/s), bound {r['bound_ms']:.4f} ({r['bound_by']}, "
            f"{100 * r['bound_share']:.1f}%), {r.get('warps_per_sm')} warps "
            f"per SM, {r.get('registers')} registers, "
            f"{r.get('spill_stores')} B spill" for k, r in rows.items())
        phase(f"[{tag} long flow L={L}] {res['pairs']} pairs of "
              f"{lh.read_length(L)} bases: greedy cost {got['greedy_cost']}, "
              f"LEAP penalty {got['leap_penalty']} with {got['leap_passed']} "
              f"passed, CIGAR digest {got['digest'][0][:12]}... of "
              f"{got['digest'][1]} (all pinned); greedy steps max "
              f"{rows['greedy']['steps_max']}, bounds "
              f"{rows['greedy']['chunk_bounds']}; energy max "
              f"{rows['leap_cigar']['energy_max']}, CIGAR bounds "
              f"{rows['leap_cigar']['chunk_bounds']}; launches {launches}; "
              f"{parts}; plain greedy {plain_g_ms:.3f} ms, LEAP "
              f"{plain_l_ms:.3f} ms, equal on "
              f"{'every pair' if plain_sample is None else f'{len(rows_)} pairs'}"
              f"; {wall:.1f} s "
              f"wall (corpus {t_gen:.1f} s); on {card}")
        if L not in entry_lengths:
            continue
        for kernel, row, source, replaces, plain_ms in (
                ("greedy", rows["greedy"], "greedy.cu",
                 "greedy_pallas.py:91", plain_g_ms),
                ("leap", rows["leap_penalty"], "leap.cu", "leap_pallas.py:49",
                 plain_l_ms)):
            if suffix is None:
                suffix = "_k3" if pins else ""
            entries.append(dict(
                name=f"{kernel}_L{L}{suffix}",
                route="cuda", source=f"asm_tpu_torch/csrc/{source}",
                replaces=f"asm_tpu/kernels/{replaces}",
                launches=launches[kernel], max_abs_err=float(err[kernel]),
                ms=row["ms"], plain_ms=plain_ms, bound_ms=row["bound_ms"],
                bound_by=row["bound_by"], library_ms=None,
                warps_per_sm=row.get("warps_per_sm"),
                **({} if not pins else dict(
                    shape=dict(max_len=L, k=3), bound_share=row["bound_share"],
                    registers=row.get("registers"),
                    spill_stores=row.get("spill_stores"),
                    block_threads=row.get("block_threads"))),
                **({} if plain_sample is None else
                   {"plain_pairs": int(len(rows_))})))
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


def shape_builds() -> list[tuple]:
    """(module, build_kernel arguments) of every per-shape library phase
    17 launches: the filter's LEAP at ERROR 0, 1, 5, 8 in both modes; the
    harness's greedy, LEAP (two penalty sets), band and NW at max_len 160,
    k = 5; the long-sequence flow's greedy and LEAP at 160 and 384, k = 3."""
    from asm_tpu_torch.kernels import greedy_cuda, leap_cuda, nw_band, nw_cuda

    jobs = [(leap_cuda, (k, 256, pens)) for k in (0, 1, 5, 8)
            for pens in ((1, 1, 1), (2, 3, 1))]
    jobs += [(greedy_cuda, (5, 160)), (leap_cuda, (5, 160, (1, 1, 1))),
             (leap_cuda, (5, 160, (1, 4, 2))), (nw_band, (160,)),
             (nw_cuda, (160,))]
    jobs += [(m, (3, L) if m is greedy_cuda else (3, L, (1, 1, 1)))
             for L in (160, 384) for m in (greedy_cuda, leap_cuda)]
    return jobs


def shape_stem(module, args) -> str:
    return module.plan(*args).stem


def shape_usage(module, args, fn: str) -> dict:
    """Registers and spill bytes of the instantiation `fn` (a mangled-name
    stem) in the per-shape library of `args`."""
    from asm_tpu_torch.tools import roofline as rl

    with open(module.ptxas_report(*args)) as f:
        return rl.ptxas_entry(module, fn, f.read())


def shape_entry(name, source, replaces, shape, launches, err, ms, plain_ms,
                bound, usage, warps) -> dict:
    """A phase 17 kernels-line entry: the common keys, the shape, the
    bound's share, warps per SM, registers and spills."""
    return dict(name=name, route="cuda", source=f"asm_tpu_torch/csrc/{source}",
                replaces=f"asm_tpu/kernels/{replaces}", launches=launches,
                max_abs_err=float(err), ms=ms, plain_ms=plain_ms, **bound,
                shape=shape, bound_share=bound["bound_ms"] / ms,
                warps_per_sm=warps, registers=usage["registers"],
                spill_stores=usage["spill_stores"])


def shape_filter(dev, card) -> list[dict]:
    """Phase 17a: the filter CLI at ERROR 0, 1, 5 and 8, levenshtein + SHD
    and affine, on 262,144 pairs (4 batches); passNum pinned from the JAX
    CLI. Then each levenshtein ERROR's kernel (simd_ed_lev behind the SHD
    gate, int8 codes) on the file's first batch against the plain version,
    timed; returns their entries."""
    import contextlib
    import io
    import tempfile

    from asm_tpu_torch.apps import leap_filter
    from asm_tpu_torch.encoding import encode_batch
    from asm_tpu_torch.kernels import leap_cuda
    from asm_tpu_torch.kernels.leap import leap_align
    from asm_tpu_torch.leap_headline import kernel_bound
    from asm_tpu_torch.tools import roofline as rl

    got, launches = {}, {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "pairs.seq")
        write_pair_file(path, SHAPE_FILTER_GROUPS, SHAPE_FILTER_GROUP_PAIRS)
        t_file = time.perf_counter() - t0
        for args in SHAPE_FILTER_PASSED:
            argv = args.split()
            lev = len(argv) == 1
            stem = leap_cuda.plan(int(argv[0]), 256,
                                  (1, 1, 1) if lev else (2, 3, 1)).stem
            before = leap_cuda.LIB_LAUNCHES[stem]
            with contextlib.redirect_stdout(io.StringIO()):
                got[args] = leap_filter.main(argv + ["--file", path])
            launches[args] = leap_cuda.LIB_LAUNCHES[stem] - before
        with open(path) as f:
            lines = [f.readline().strip() for _ in range(2 * leap_filter.BATCH)]
    counts = {k: v["passed"] for k, v in got.items()}
    if counts != SHAPE_FILTER_PASSED or min(launches.values()) <= 0:
        raise AssertionError(f"filter CLI passed {counts} (pinned "
                             f"{SHAPE_FILTER_PASSED}), launches {launches}")
    times = ", ".join(f"{k}: {v['align_s'] * 1e3:.3f}"
                      for k, v in got.items())
    phase(f"[17a filter CLI] {4 * SHAPE_FILTER_GROUP_PAIRS} pairs of reads "
          f"90-250 bases, max_len 256: passNum {counts} (pinned from "
          f"asm_tpu); launches per per-shape library {launches}; align ms "
          f"per ERROR ({times}); {time.perf_counter() - t0:.1f} s wall, the "
          f"file written in {t_file:.1f} s; on {card}")

    rc, rl_, fc, _ = (torch.from_numpy(a).to(dev) for a in encode_batch(
        lines[0::2], lines[1::2], 256))
    entries = []
    for error in (0, 1, 5, 8):
        cfg = leap_filter.filter_config(error, True)
        pos = torch.arange(256, device=dev)[None, :]
        fce = torch.where((pos < rl_[:, None]) & (fc >= 4),
                          torch.zeros_like(fc), fc)
        kw = dict(semantics="simd_ed_lev", use_shd_gate=True)
        args = (error, 256, (1, 1, 1))
        stem = shape_stem(leap_cuda, args)
        before = leap_cuda.LIB_LAUNCHES[stem]
        ms, out = cuda_ms(lambda: leap_cuda.leap_align_cuda(
            rc, rl_, fce, rl_, cfg, **kw), 5)
        plain_ms, want = cuda_ms(lambda: leap_align(rc, rl_, fce, rl_, cfg,
                                                    **kw), 1)
        err = max(max_diff(out[k], want[k], f"filter ERROR {error}: {k}")
                  for k in ("passed", "penalty", "lane_shift"))
        if leap_cuda.LIB_LAUNCHES[stem] <= before:
            raise AssertionError(f"filter ERROR {error}: no launch of {stem}")
        entries.append(shape_entry(
            f"leap_filter_L256_k{error}", "leap.cu", "leap_pallas.py:49",
            dict(max_len=256, k=error, semantics="simd_ed_lev+shd",
                 pairs=int(rl_.numel())),
            launches[str(error)], err, ms, plain_ms,
            kernel_bound("leap_gated", [out], cfg),
            shape_usage(leap_cuda, args, rl.leap_fn(error, 256, sem=3,
                                                    planes=False)),
            leap_cuda.occupancy(*args[:2], False, args[2]) *
            leap_cuda.plan(*args).threads // 32))
    phase("[17a filter kernels] first batch, simd_ed_lev + SHD: " + "; ".join(
        f"k {e['shape']['k']} {e['ms']:.4f} ms (plain {e['plain_ms']:.3f}), "
        f"bound {e['bound_ms']:.4f} ({e['bound_by']}, "
        f"{100 * e['bound_share']:.1f}%), {e['warps_per_sm']} warps per SM, "
        f"{e['registers']} regs, {e['spill_stores']} B spill"
        for e in entries) + f"; equal to the plain version; on {card}")
    return entries


def shape_harness(dev, card) -> list[dict]:
    """Phase 17b: the harness at max_len 160, k = 5 (150-base reads): the
    pinned runs (impl cuda, and impl torch the same), then
    SHAPE_HARNESS_BIG pairs per rate on the card, held against impl torch
    on its first SHAPE_HARNESS_TORCH; then each kernel at that shape on
    the err 0.05 run's pairs, timed against its bound and its plain
    version; returns their entries."""
    from asm_tpu_torch.bench.harness import format_report, run_benchmark
    from asm_tpu_torch.config import AlignConfig
    from asm_tpu_torch.data.generator import generate_dataset_native
    from asm_tpu_torch.kernels import greedy_cuda, leap_cuda, nw, nw_band, \
        nw_cuda
    from asm_tpu_torch.kernels.greedy import greedy_align
    from asm_tpu_torch.kernels.greedy_cuda import stage_planes_t
    from asm_tpu_torch.kernels.leap import leap_align
    from asm_tpu_torch.leap_headline import kernel_bound
    from asm_tpu_torch.tools import roofline as rl
    from asm_tpu_torch.utils.bounds import bound_entry, greedy_work, \
        nw_band_work, nw_full_work

    L, k = 160, 5

    def gen(pairs, err):
        return generate_dataset_native(pairs, 150, err, 0.96, seed=42,
                                       max_len=L)

    nw_stem = shape_stem(nw_cuda, (L,))

    def lib_counts(pens):
        return dict(
            greedy=greedy_cuda.LIB_LAUNCHES[shape_stem(greedy_cuda, (k, L))],
            leap=leap_cuda.LIB_LAUNCHES[shape_stem(leap_cuda, (k, L, pens))],
            nw_band=nw_band.LIB_LAUNCHES[shape_stem(nw_band, (L,))],
            nw=nw_cuda.LIB_LAUNCHES[nw_stem, "nw"],
            nw_trace=nw_cuda.LIB_LAUNCHES[nw_stem, "nw_trace"])

    main = {}  # the main path's launches per kernel (LEAP per penalty set)

    def run_cuda(corpus, cfg):
        pens = (cfg.x, cfg.o, cfg.e)
        before = lib_counts(pens)
        r = run_benchmark(*corpus, cfg, impl="cuda", device=dev)
        used = {key: v - before[key] for key, v in lib_counts(pens).items()}
        for key, v in used.items():
            key = (key, pens) if key == "leap" else key
            main[key] = main.get(key, 0) + v
        if min(v for key, v in used.items() if key != "nw") <= 0:
            raise AssertionError(f"harness L = {L}: launches {used}")
        return r, used

    parts = []
    t0 = time.perf_counter()
    for (x, o, e, err, pairs), pin in SHAPE_HARNESS.items():
        corpus = gen(pairs, err)
        cfg = AlignConfig(x=x, o=o, e=e, k=k, max_len=L)
        r, used = run_cuda(corpus, cfg)
        pt = run_benchmark(*corpus, cfg, impl="torch", device=dev)
        got = harness_counts(r)
        if (got, r.coverage_checked) != (pin, pairs):
            raise AssertionError(f"harness L = {L} x{x}o{o}e{e} err {err}: "
                                 f"{got} on {r.coverage_checked} != pinned "
                                 f"{pin}, launches {used}")
        if harness_counts(pt) != got:
            raise AssertionError(f"harness L = {L}: torch {harness_counts(pt)}"
                                 f" != cuda {got}")
        parts.append(f"x{x}o{o}e{e} err {err}: {got} (pinned; impl torch the "
                     f"same) launches {used}")
    phase(f"[17b harness L={L} k={k}] " + "; ".join(parts) + f"; "
          f"{time.perf_counter() - t0:.1f} s wall; on {card}")

    cfg = AlignConfig(x=1, o=1, e=1, k=k, max_len=L)
    big = {}
    for err in (0.05, 0.10):
        t_gen = time.perf_counter()
        corpus = gen(SHAPE_HARNESS_BIG, err)
        t0 = time.perf_counter()
        t_gen = t0 - t_gen
        r, _ = run_cuda(corpus, cfg)
        wall = time.perf_counter() - t0
        n = SHAPE_HARNESS_TORCH
        head = tuple(a[:n] for a in corpus)
        rc_ = run_benchmark(*head, cfg, impl="cuda", device=dev) \
            if n < SHAPE_HARNESS_BIG else r
        t_torch = time.perf_counter()
        pt = run_benchmark(*head, cfg, impl="torch", device=dev)
        t_torch = time.perf_counter() - t_torch
        if (harness_counts(pt), pt.coverage_checked) != (
                harness_counts(rc_), rc_.coverage_checked):
            raise AssertionError(f"harness L = {L} err {err}: torch "
                                 f"{harness_counts(pt)} != cuda "
                                 f"{harness_counts(rc_)} on {n} pairs")
        for ln in format_report(r).splitlines():
            phase(ln)
        big[err] = r
        phase(f"[17b harness L={L} k={k} err {err}] {r.total} pairs: "
              f"(greedy == NW, LEAP == NW, covered) {harness_counts(r)} of "
              f"{r.coverage_checked}; impl torch equal on {n} pairs; NW "
              f"{r.nw_time:.4f} s ({r.nw_aligns_per_sec / 1e6:.1f}M aligns/s)"
              f", LEAP {r.leap_time:.4f} s "
              f"({r.leap_aligns_per_sec / 1e6:.1f}M), greedy "
              f"{r.greedy_time:.4f} s ({r.greedy_aligns_per_sec / 1e6:.1f}M)"
              f"; plain NW / LEAP / greedy {pt.nw_time:.3f} / "
              f"{pt.leap_time:.3f} / {pt.greedy_time:.3f} s on {n} pairs; "
              f"{wall:.1f} s wall with coverage on every pair (corpus "
              f"{t_gen:.1f} s, impl torch {t_torch:.1f} s); on {card}")

    # at err 0.05-0.10 a band certifies nearly every pair: the harness's NW
    # partition at err 0.30 leaves a residue for the full kernel
    t = [torch.from_numpy(a).to(dev) for a in gen(8192, 0.30)]
    before = nw_cuda.LIB_LAUNCHES[nw_stem, "nw"]
    hard_pen = nw_band.nw_penalty_partitioned(*t, bws=nw_band.BWS)
    main["nw"] += nw_cuda.LIB_LAUNCHES[nw_stem, "nw"] - before
    hard_err = max_diff(torch.from_numpy(hard_pen).to(dev), nw.nw_penalty(*t),
                        f"L = {L} err 0.30 partition vs plain full NW")
    if main["nw"] <= 0:
        raise AssertionError(f"the L = {L} NW partition left no residue for "
                             f"the full kernel")
    phase(f"[17b main-path launches L={L}] {main}; the err 0.30 partition "
          f"of 8192 pairs equal to the plain full NW")

    # each kernel at the harness's shape on the err 0.05 pinned pairs
    t0 = time.perf_counter()
    corpus = gen(65_536, 0.05)
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in corpus]
    m, n_ = corpus[1], corpus[3]
    entries = []
    gcfg = AlignConfig(x=1, o=1, e=1, k=k, max_len=L, max_steps=64)
    ms, out = cuda_ms(lambda: greedy_cuda.greedy_align_cuda(
        *t, gcfg, want_cigar=False), 5)
    plain_ms, want = cuda_ms(lambda: greedy_align(*t, gcfg, records=True), 1)
    err = max(max_diff(out[key], want[key], f"L = {L} greedy {key}")
              for key in ("cost", "steps", "step_rec"))
    steps = out["steps"].cpu().numpy()
    entries.append(shape_entry(
        f"greedy_L{L}_k{k}", "greedy.cu", "greedy_pallas.py:91",
        dict(max_len=L, k=k, pairs=m.size, route="codes"),
        main["greedy"], err, ms, plain_ms,
        bound_entry(*greedy_work(steps, [64], m.size, k=k, L=L, codes=True)),
        shape_usage(greedy_cuda, (k, L), rl.greedy_fn(k, L).replace(
            "ELb1E", "ELb0E")), greedy_cuda.occupancy(k, L, False)))
    for pens in ((1, 1, 1), (1, 4, 2)):
        lcfg = AlignConfig(x=pens[0], o=pens[1], e=pens[2], k=k, max_len=L)
        ms, out = cuda_ms(lambda: leap_cuda.leap_align_cuda(*t, lcfg), 5)
        plain_ms, want = cuda_ms(lambda: leap_align(*t, lcfg), 1)
        err = max(max_diff(out[key], want[key], f"L = {L} LEAP {key}")
                  for key in ("passed", "penalty", "lane_shift"))
        args = (k, L, pens)
        entries.append(shape_entry(
            f"leap_L{L}_k{k}_x{pens[0]}o{pens[1]}e{pens[2]}", "leap.cu",
            "leap_pallas.py:49", dict(max_len=L, k=k, pens=pens,
                                      pairs=m.size, route="codes"),
            main["leap", pens], err, ms, plain_ms,
            kernel_bound("leap", [out], lcfg),
            shape_usage(leap_cuda, args, rl.leap_fn(k, L, pens=pens,
                                                    planes=False)),
            leap_cuda.occupancy(*args[:2], False, args[2]) *
            leap_cuda.plan(*args).threads // 32))
    planes = [torch.from_numpy(stage_planes_t(a).view(np.int32)).to(dev)
              for a in (corpus[0], corpus[2])]
    bw = 16
    ms, out = cuda_ms(lambda: nw_band.nw_penalty_banded(
        planes[0], t[1], planes[1], t[3], bw=bw, pre_staged=True), 5)
    plain_ms, want = cuda_ms(lambda: nw_band.banded_plain(*t, bw), 1)
    with open(nw_band.ptxas_report(L)) as f:
        usage = rl.ptxas_entry(nw_band, f"band_kernelILi{bw}ELi{L // 32}E",
                               f.read())
    entries.append(shape_entry(
        f"nw_band_L{L}", "nw_band.cu", "nw_band.py:174",
        dict(max_len=L, bw=bw, pairs=m.size, route="planes"),
        main["nw_band"], max_diff(out, want, f"L = {L} band"), ms,
        plain_ms, bound_entry(*nw_band_work(m, n_, np.full(m.size, bw), L)),
        usage, None))
    ms, out = cuda_ms(lambda: nw_cuda.nw_penalty_cuda(*t), 5)
    plain_ms, want = cuda_ms(lambda: nw.nw_penalty(*t), 1)
    res = rl.nw_resources(False, L)
    entries.append(shape_entry(
        f"nw_L{L}", "nw.cu", "nw_pallas.py:88",
        dict(max_len=L, G=nw_cuda.instance(False, L)[0], pairs=m.size),
        main["nw"], max(hard_err, max_diff(out, want, f"L = {L} nw")), ms,
        plain_ms,
        bound_entry(*nw_full_work(m, n_, L)), res, res["warps_per_sm"]))
    ms, out = cuda_ms(lambda: nw_cuda.nw_align_cuda(
        *t, match_mask_threshold=3), 3)
    plain_ms, want = cuda_ms(lambda: nw.nw_align(*t, match_mask_threshold=3),
                             1)
    err = max(max_diff(g, w, f"L = {L} nw_trace {key}")
              for g, w, key in zip(out, want, ("pen", "ops", "mask")))
    res = rl.nw_resources(True, L)
    G, route = nw_cuda.instance(True, L)
    entries.append(shape_entry(
        f"nw_trace_L{L}", "nw.cu", "nw_pallas.py:218",
        dict(max_len=L, G=G, route=route, pairs=m.size),
        main["nw_trace"], err, ms, plain_ms,
        bound_entry(*nw_full_work(m, n_, L, trace=True)), res,
        res["warps_per_sm"]))
    phase(f"[17b kernels L={L}] {m.size} pairs err 0.05: " + "; ".join(
        f"{e['name']} {e['ms']:.4f} ms (plain {e['plain_ms']:.3f}), bound "
        f"{e['bound_ms']:.4f} ({e['bound_by']}, "
        f"{100 * e['bound_share']:.1f}%), {e['warps_per_sm']} warps per SM, "
        f"{e['registers']} regs, {e['spill_stores']} B spill"
        for e in entries) + f"; all equal to their plain versions; "
        f"{time.perf_counter() - t0:.1f} s wall; on {card}")
    return entries


def shapes_path(dev, name, card) -> list[dict]:
    """Phase 17: the entry points at shapes outside the tuned tables;
    returns the new shapes' JSON entries."""
    walls = [time.perf_counter()]
    entries = shape_filter(dev, card)
    walls.append(time.perf_counter())
    entries += shape_harness(dev, card)
    walls.append(time.perf_counter())
    err = dict(greedy=0, leap=0)
    entries += long_flow(dev, card, err, pins=SHAPE_FLOW, tag="17c",
                         entry_lengths=tuple(SHAPE_FLOW))
    walls.append(time.perf_counter())
    phase(f"[17 shapes] {walls[-1] - walls[0]:.1f} s (a, b, c: "
          f"{[round(b - a, 1) for a, b in zip(walls, walls[1:])]} s) on "
          f"{name}")
    return entries


def row_builds() -> list[tuple]:
    """(module, build_kernel arguments) of every per-shape library phase
    18 launches: greedy at k = 3 and 4, LEAP at k = 3 with both penalty
    sets, NW and the band, at each of ROW_LENGTHS; NW also at the other
    BLOCK_EDGE_LENGTHS."""
    from asm_tpu_torch.kernels import greedy_cuda, leap_cuda, nw_band, nw_cuda

    jobs = []
    for L in ROW_LENGTHS:
        jobs += [(greedy_cuda, (k, L)) for k in (3, 4)]
        jobs += [(leap_cuda, (3, L, pens)) for pens in ((1, 1, 1), (2, 3, 1))]
        jobs += [(nw_cuda, (L,)), (nw_band, (L,))]
    jobs += [(nw_cuda, (L,)) for L in BLOCK_EDGE_LENGTHS
             if L not in ROW_LENGTHS]
    return jobs


def row_corpora(L):
    """(label, corpus) pairs of phase 18a at max_len L: every pair of the
    lengths 0, 1, 31, L/2, L - 1 and L, twice (reads random, refs a copy
    with 5% substitutions, cut or extended to their length); and generated
    pairs of L - 6 - L // 50 bases at err 0.05 and 0.15 (ROW_CASE_PAIRS
    and half that; half those at 2048)."""
    from asm_tpu_torch.data.generator import generate_dataset_arrays
    from asm_tpu_torch.encoding import encode_batch

    rng = np.random.default_rng(180 + L // 32)
    lens = (0, 1, 31, L // 2, L - 1, L)
    reads, refs = [], []
    for a in lens * 2:
        for b in lens:
            read, ref = rng.integers(0, 4, a), rng.integers(0, 4, b)
            n = min(a, b)
            ref[:n] = np.where(rng.random(n) < 0.05, rng.integers(0, 4, n),
                               read[:n])
            reads.append("".join("ACGT"[c] for c in read))
            refs.append("".join("ACGT"[c] for c in ref))
    n = ROW_CASE_PAIRS if L < 2048 else ROW_CASE_PAIRS // 2
    length = L - 6 - L // 50
    return [("lengths", encode_batch(reads, refs, L)),
            ("err0.05", generate_dataset_arrays(n, length, 0.05, 0.96,
                                                seed=181 + L, max_len=L)),
            ("err0.15", generate_dataset_arrays(n // 2, length, 0.15, 0.96,
                                                seed=182 + L, max_len=L))]


def row_kernels_vs_plain(dev, name) -> dict:
    """Phase 18a; returns the max abs error per kernel (all 0)."""
    from asm_tpu_torch.config import AlignConfig
    from asm_tpu_torch.data.band_edges import band_edge_pairs
    from asm_tpu_torch.data.block_edges import block_edge_pairs
    from asm_tpu_torch.data.walk_edges import walk_edge_pairs
    from asm_tpu_torch.kernels import nw
    from asm_tpu_torch.kernels.greedy_cuda import stage_planes_t
    from asm_tpu_torch.kernels.nw_band import banded_plain, nw_penalty_banded
    from asm_tpu_torch.kernels.nw_cuda import nw_align_cuda, nw_penalty_cuda

    t0 = time.perf_counter()
    err = dict(greedy=0, leap=0, nw_band=0, nw=0, nw_trace=0)
    n = dict(err)
    bws = (4, 8, 16, 32, 64, 128)

    def band(corpus, what, x=1, o=1, e=1, widths=bws):
        t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
             for a in corpus]
        planes = [torch.from_numpy(stage_planes_t(a).view(np.int32)).to(dev)
                  for a in (corpus[0], corpus[2])]
        for bw in widths:
            want = banded_plain(*t, bw, x, o, e)
            for pre, (a, b) in ((False, (t[0], t[2])), (True, planes)):
                err["nw_band"] = max(err["nw_band"], max_diff(
                    nw_penalty_banded(a, t[1], b, t[3], bw=bw, x=x, o=o, e=e,
                                      pre_staged=pre), want,
                    f"{what}/BW{bw}/pre_staged={pre}: pen"))
                n["nw_band"] += 1

    for L in ROW_LENGTHS:
        for ci, (label, corpus) in enumerate(row_corpora(L)):
            what = f"L{L}/{label}"
            for k in ((3, 4) if ci == 0 else (3,)):
                err["greedy"] = max(err["greedy"], greedy_check(
                    dev, corpus, AlignConfig(k=k, max_len=L,
                                             max_steps=L // 2),
                    f"{what}/k{k}"))
                n["greedy"] += 2
            for sem, gate, pens in ROW_LEAP_VARIANTS:
                cfg = leap_cfg(sem, pens, 1 if ci else 0, L, af=200)
                err["leap"] = max(err["leap"], leap_check(
                    dev, corpus, cfg, sem, gate,
                    f"{what}/{sem}/gate{int(gate)}/{pens}"))
                n["leap"] += 2
            # the band at every BW on the lengths corpus (x/o/e 1/1/1), at
            # BW 128 on the err 0.05 one (2/3/1); NW full and trace on the
            # lengths and err 0.15 ones (the plain versions loop over the
            # 2L diagonals in Python)
            if ci == 0:
                band(corpus, what)
            elif ci == 1:
                band(corpus, f"{what}/x2o3e1", 2, 3, 1, widths=(128,))
            if ci != 1:
                sub = [torch.from_numpy(np.ascontiguousarray(a[:200])).to(dev)
                       for a in corpus]
                x, o, e = (2, 3, 1) if ci == 2 else (1, 1, 1)
                pen, ops, mask = nw.nw_align(*sub, x, o, e,
                                             match_mask_threshold=3)
                err["nw"] = max(err["nw"], max_diff(
                    nw_penalty_cuda(*sub, x, o, e), pen,
                    f"{what}/x{x}o{o}e{e}/nw: pen"))
                got = nw_align_cuda(*sub, x, o, e, match_mask_threshold=3)
                for g, w, key in zip(got, (pen, ops, mask),
                                     ("pen", "ops", "mask")):
                    err["nw_trace"] = max(err["nw_trace"], max_diff(
                        g, w, f"{what}/x{x}o{o}e{e}/nw_trace: {key}"))
                n["nw"] += 1
                n["nw_trace"] += 1
                del sub, pen, ops, mask, got
        # the long trace kernel's walk tiles: paths across their edges
        # and corners, and along one (data/walk_edges.py)
        edges = [torch.from_numpy(a).to(dev) for a in walk_edge_pairs(L)]
        for x, o, e in ((1, 1, 1), (2, 3, 1)):
            pen, ops, mask = nw.nw_align(*edges, x, o, e,
                                         match_mask_threshold=3)
            err["nw"] = max(err["nw"], max_diff(
                nw_penalty_cuda(*edges, x, o, e), pen,
                f"L{L}/walk_edges/x{x}o{o}e{e}/nw: pen"))
            got = nw_align_cuda(*edges, x, o, e, match_mask_threshold=3)
            for g, w, key in zip(got, (pen, ops, mask),
                                 ("pen", "ops", "mask")):
                err["nw_trace"] = max(err["nw_trace"], max_diff(
                    g, w, f"L{L}/walk_edges/x{x}o{o}e{e}/nw_trace: {key}"))
            n["nw"] += 1
            n["nw_trace"] += 1
        # the band's layout edges (data/band_edges): destinations at the
        # band's edges, the first threads' boundary and just off it
        for bw in bws:
            edges = band_edge_pairs(L, bw)
            band(edges, f"L{L}/band_edges", widths=(bw,))
            band(edges, f"L{L}/band_edges/x1o4e2", 1, 4, 2, widths=(bw,))
    # the long full kernel's layout edges (data/block_edges): read lengths
    # at its strip and block edges, ref lengths where its step loop's
    # head, steady loop and tail meet; one to three blocks of rows
    for L in BLOCK_EDGE_LENGTHS:
        edges = [torch.from_numpy(a).to(dev) for a in block_edge_pairs(L)]
        for x, o, e in ((1, 1, 1), (2, 3, 1), (1, 4, 2)):
            err["nw"] = max(err["nw"], max_diff(
                nw_penalty_cuda(*edges, x, o, e),
                nw.nw_penalty(*edges, x, o, e),
                f"L{L}/block_edges/x{x}o{o}e{e}/nw: pen"))
            n["nw"] += 1
    # BW 128 at max_len 128 and 256, on the corpora of 544 cut to them,
    # and on the band-edge pairs at 128, 256 and 512
    for L in (128, 256):
        for label, corpus in row_corpora(544)[:2]:
            cut = (np.ascontiguousarray(corpus[0][:, :L]),
                   np.minimum(corpus[1], L),
                   np.ascontiguousarray(corpus[2][:, :L]),
                   np.minimum(corpus[3], L))
            band(cut, f"L{L}/{label}", widths=(128,))
            band(cut, f"L{L}/{label}/x2o3e1", 2, 3, 1, widths=(128,))
    for L in (128, 256, 512):
        edges = band_edge_pairs(L, 128)
        band(edges, f"L{L}/band_edges", widths=(128,))
        band(edges, f"L{L}/band_edges/x2o3e1", 2, 3, 1, widths=(128,))
    phase(f"[18a row kernels vs plain] max_len {ROW_LENGTHS} on {name}: "
          f"cases {n} (greedy k = 3, 4 in both forms with records, trips "
          f"and CIGARs; LEAP penalty pass (simd_ed_affine), gated filter and "
          f"fused CIGAR (lv_bag, both penalty sets) in both forms; NW band "
          f"BW {bws} in both forms, BW 128 also at max_len 128 and 256 "
          f"(and 512 on the band-edge pairs); full; trace with ops and "
          f"mask; x/o/e 1/1/1 and 2/3/1 (1/4/2 on the band-edge pairs); "
          f"lengths 0, 1, 31, L/2, L - 1 and L; NW also the walk-edge "
          f"pairs, NW full the block-edge pairs also at 3072, x/o/e 1/4/2 "
          f"too, the band also the band-edge pairs) "
          f"exactly equal (max abs err "
          f"{max(err.values())}); {time.perf_counter() - t0:.1f} s")
    return err


def row_harness(dev, card, err, L, corpus, pins=None) -> list[dict]:
    """Phase 18c (max_len 1024) and 18d (2048), counts pinned from
    asm_tpu: the harness on `corpus`, the band, full and trace kernels' launches
    in it; then those kernels timed on
    the corpus's first 2,048 pairs (all 512 at 2048) against their plain
    versions and bounds (and BW 128 beside the partition's widths).
    Returns the three NW kernels' entries, kernel_L<L>."""
    from asm_tpu_torch.bench.harness import run_benchmark
    from asm_tpu_torch.config import AlignConfig
    from asm_tpu_torch.kernels import greedy_cuda, leap_cuda, nw, nw_band, \
        nw_cuda
    from asm_tpu_torch.kernels.greedy_cuda import stage_planes_t
    from asm_tpu_torch.tools import roofline as rl
    from asm_tpu_torch.utils.bounds import bound_entry, nw_band_work, \
        nw_full_work

    tag = "18c" if L == 1024 else "18d"
    cfg = AlignConfig(x=1, o=1, e=1, k=3, max_len=L)
    greedy_cuda.LAUNCHES = nw_band.LAUNCHES = leap_cuda.LAUNCHES = 0
    nw_cuda.LAUNCHES.update(nw=0, nw_trace=0)
    t0 = time.perf_counter()
    r = run_benchmark(*corpus, cfg, impl="cuda", device=dev, chunk=4096)
    wall = time.perf_counter() - t0
    launches = dict(greedy=greedy_cuda.LAUNCHES, nw_band=nw_band.LAUNCHES,
                    nw=nw_cuda.LAUNCHES["nw"],
                    nw_trace=nw_cuda.LAUNCHES["nw_trace"],
                    leap=leap_cuda.LAUNCHES)
    if min(launches.values()) <= 0:
        raise AssertionError(f"the L = {L} harness launched {launches}")
    got = harness_counts(r)
    if r.coverage_checked != r.total or (pins is not None and got != pins):
        raise AssertionError(f"L = {L} harness {got} on {r.coverage_checked} "
                             f"checked != pinned {pins}")
    vs = "pinned from asm_tpu" if pins is not None else "no pin"
    npt = min(2048, corpus[1].size)
    sub = [np.ascontiguousarray(a[:npt]) for a in corpus]
    t = [torch.from_numpy(a).to(dev) for a in sub]
    planes = [torch.from_numpy(stage_planes_t(a).view(np.int32)).to(dev)
              for a in (sub[0], sub[2])]
    m, n = sub[1], sub[3]
    times, bounds, band128 = {}, {}, None
    for bw in (64, 128):
        ms, pen = cuda_ms(lambda: nw_band.nw_penalty_banded(
            planes[0], t[1], planes[1], t[3], bw=bw, pre_staged=True), 5)
        plain_ms, want = cuda_ms(lambda: nw_band.banded_plain(*t, bw), 1)
        err["nw_band"] = max(err["nw_band"], max_diff(
            pen, want, f"L = {L} band BW {bw}"))
        b = bound_entry(*nw_band_work(m, n, np.full(m.size, bw), L))
        if bw == 64:
            times["nw_band"], bounds["nw_band"] = (ms, plain_ms), b
        else:
            band128 = (ms, plain_ms, b)
    nw_ms, pen = cuda_ms(lambda: nw_cuda.nw_penalty_cuda(*t), 5)
    nw_plain_ms, want_pen = cuda_ms(lambda: nw.nw_penalty(*t), 1)
    err["nw"] = max(err["nw"], max_diff(pen, want_pen, f"L = {L} nw"))
    trace_ms, got_t = cuda_ms(
        lambda: nw_cuda.nw_align_cuda(*t, match_mask_threshold=3), 3)
    trace_plain_ms, want = cuda_ms(
        lambda: nw.nw_align(*t, match_mask_threshold=3), 1)
    for g, w, key in zip(got_t, want, ("pen", "ops", "mask")):
        err["nw_trace"] = max(err["nw_trace"], max_diff(
            g, w, f"L = {L} nw_trace {key}"))
    ops = got_t[1].cpu().numpy()
    del got_t, want
    times.update(nw=(nw_ms, nw_plain_ms), nw_trace=(trace_ms, trace_plain_ms))
    bounds.update(nw=bound_entry(*nw_full_work(m, n, L)),
                  nw_trace=bound_entry(*nw_full_work(m, n, L, trace=True)))
    # the long kernels' SASS per step and per existing cell
    for k in ("nw", "nw_trace"):
        line = rl.nw_line(k, m, n, times[k][0], bounds[k],
                          ops=ops if k == "nw_trace" else None, max_len=L)
        phase(f"[{tag} roofline {k} L={L}] " + json.dumps(
            {key: line[key] for key in (
                "function", "rows_per_thread", "insts_per_step",
                "insts_per_slot", "existing_share",
                "insts_per_existing_cell", "walk_insts_per_step",
                "registers", "spill_stores", "warps_per_sm", "ms",
                "bound_ms", "bound_share") if key in line}))
    res = {k: rl.ptxas_entry(nw_cuda, nw_cuda.function_name(k == "nw_trace",
                                                            L),
                             open(nw_cuda.ptxas_report(L)).read())
           for k in ("nw", "nw_trace")}
    warps = {k: nw_cuda.occupancy(k == "nw_trace", L)
             for k in ("nw", "nw_trace")}
    parts = "; ".join(
        f"{k} {times[k][0]:.4f} ms, bound {b['bound_ms']:.4f} "
        f"({b['bound_by']}, {100 * b['bound_ms'] / times[k][0]:.1f}%), "
        f"plain {times[k][1]:.3f} ms" for k, b in bounds.items())
    phase(f"[{tag} row harness L={L}] {r.total} pairs of "
          f"{int(corpus[1].max())} bases err 0.05: greedy == NW {got[0]}, "
          f"LEAP == NW {got[1]}, covered {got[2]} of {r.coverage_checked} "
          f"({vs}); launches {launches}; NW {r.nw_time * 1e3:.3f} / LEAP "
          f"{r.leap_time * 1e3:.3f} / greedy {r.greedy_time * 1e3:.3f} ms, "
          f"{wall:.1f} s wall with coverage; on {npt} pairs: band BW 64, "
          f"full, trace: {parts}; band BW 128 {band128[0]:.4f} ms, bound "
          f"{band128[2]['bound_ms']:.4f} ({band128[2]['bound_by']}), plain "
          f"{band128[1]:.3f} ms; full / trace: registers "
          f"{[res[k]['registers'] for k in res]}, spills "
          f"{[res[k]['spill_stores'] for k in res]} B, warps per SM "
          f"{[warps[k] for k in res]}; on {card}")
    names = dict(nw_band=("nw_band.cu", "nw_band.py:174"),
                 nw=("nw.cu", "nw_pallas.py:88"),
                 nw_trace=("nw.cu", "nw_pallas.py:218"))
    out = []
    for k in bounds:
        extra = dict(bw=64, bw128_ms=band128[0],
                     bw128_bound_ms=band128[2]["bound_ms"],
                     bw128_plain_ms=band128[1]) if k == "nw_band" else dict(
            instantiation=nw_instance(k == "nw_trace", L),
            registers=res[k]["registers"],
            spill_stores=res[k]["spill_stores"], warps_per_sm=warps[k])
        out.append(dict(name=f"{k}_L{L}", route="cuda",
                        source=f"asm_tpu_torch/csrc/{names[k][0]}",
                        replaces=f"asm_tpu/kernels/{names[k][1]}",
                        launches=launches[k], max_abs_err=float(err[k]),
                        ms=times[k][0], plain_ms=times[k][1],
                        **bounds[k], timed_pairs=npt,
                        bound_share=bounds[k]["bound_ms"] / times[k][0],
                        **extra))
    return out


def long_row_resources(name) -> None:
    """Phase 18e: the greedy and LEAP long-row kernels' registers, spill
    bytes, threads per pair and warps per SM (k = 3 and 4; LEAP at k = 3,
    penalty pass and fused CIGAR, unit penalties) and the NW full and
    trace long kernels' and the band's wide path's (band_wide_kernel, at
    each BW) at each of ROW_LENGTHS; then the SASS of the kernels the
    long-row redesigns leave alone against the pin (greedy's, LEAP's, NW's
    and the band's W <= 16 instantiations, the long NW full kernel)."""
    from asm_tpu_torch.kernels import greedy_cuda, leap_cuda, nw_band, shapes
    from asm_tpu_torch.tools import roofline as rl
    from asm_tpu_torch.tools import sass_pin

    parts = []
    for L in ROW_LENGTHS:
        for k in (3, 4):
            got = rl.greedy_resources(k=k, max_len=L)
            parts.append(f"greedy k{k} L{L}: {got['registers']} regs, "
                         f"{got['spill_stores']} B spill, "
                         f"{greedy_cuda.plan(k, L).group} threads a pair, "
                         f"{got['warps_per_sm']} warps/SM")
        for cigar in (False, True):
            got = rl.leap_resources(k=3, max_len=L, cigar=cigar)
            parts.append(f"leap{'_cigar' if cigar else ''} k3 L{L}: "
                         f"{got['registers']} regs, {got['spill_stores']} B "
                         f"spill, {leap_cuda.plan(3, L).group} threads a "
                         f"pair, {got['warps_per_sm']} warps/SM")
        for trace in (False, True):
            got = rl.nw_resources(trace, L)
            parts.append(f"nw{'_trace' if trace else ''} L{L}: "
                         f"{got['registers']} regs, {got['spill_stores']} B "
                         f"spill, {got['warps_per_sm']} warps/SM")
        report = open(nw_band.ptxas_report(L)).read()
        for bw in shapes.BAND_WIDTHS:
            got = rl.ptxas_entry(nw_band, rl.wide_function(bw, L), report)
            parts.append(f"band_wide BW{bw} L{L}: {got['registers']} regs, "
                         f"{got['spill_stores']} B spill, "
                         f"{shapes.band_wide_np(bw, L)} offset pairs a "
                         f"thread, "
                         f"{nw_band.occupancy(bw, L)} warps/SM")
    phase("[18e long-row kernels] " + "; ".join(parts) + f" on {name}")
    res = sass_pin.check()
    if not res["compared"]:
        phase(f"[18e short-row SASS] not compared: the pin was taken with "
              f"{res['pin_nvcc']!r}, this nvcc is {res['nvcc']!r} (take it "
              f"anew: python -m asm_tpu_torch.tools.sass_pin --help)")
        return
    phase(f"[18e short-row SASS] {res['held']} kernels of "
          f"{len(sass_pin.SHORT_SHAPES)} libraries held against the pin "
          f"(tools/short_sass.json): {len(res['moved'])} moved, "
          f"{len(res['missing'])} missing, {len(res['new'])} new")


def rows_path(dev, name, card) -> list[dict]:
    """Phase 18: rows longer than 512; returns the long-row entries."""
    from asm_tpu_torch.data.generator import generate_dataset_native

    walls = [time.perf_counter()]
    err = row_kernels_vs_plain(dev, name)
    walls.append(time.perf_counter())
    entries = long_flow(dev, card, err, pins=ROW_FLOW, tag="18b",
                        entry_lengths=tuple(ROW_FLOW),
                        plain_sample=ROW_PLAIN_SAMPLE, suffix="")
    walls.append(time.perf_counter())
    entries += row_harness(dev, card, err, 1024, generate_dataset_native(
        ROW_HARNESS_PAIRS, 998, 0.05, 0.96, seed=42, max_len=1024),
        pins=ROW_HARNESS)
    walls.append(time.perf_counter())
    entries += row_harness(dev, card, err, 2048, generate_dataset_native(
        ROW_HARNESS_2048_PAIRS, 2002, 0.05, 0.96, seed=42, max_len=2048),
        pins=ROW_HARNESS_2048)
    walls.append(time.perf_counter())
    long_row_resources(name)
    walls.append(time.perf_counter())
    for kernel in ("greedy", "leap", "nw_band", "nw", "nw_trace"):
        hit = [e for e in entries
               if e["name"].startswith(f"{kernel}_L") and e["launches"] > 0
               and int(e["name"].rsplit("_L", 1)[1]) >= 1024]
        if not hit:
            raise AssertionError(f"phase 18: {kernel} launched at no "
                                 f"max_len >= 1024")
    phase(f"[18 rows] {walls[-1] - walls[0]:.1f} s (a, b, c, d, e: "
          f"{[round(b - a, 1) for a, b in zip(walls, walls[1:])]} s) on "
          f"{name}")
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
    """Phase 12; returns the four roofline kernels' JSON entries."""
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
    err["op_chain"] = max(max_diff(
        rc.op_chain(seeds, CHAIN_CHECK_ITERS, op),
        rc.op_chain_plain(seeds, CHAIN_CHECK_ITERS, 3, op), f"op_chain {op}")
        for op in rc.OPS)
    counter = roofline_counter_checks(rc.build_kernel()[0])
    census = {op: rl.chain_census(rc.build_kernel()[0], op)
              for op in rc.OPS}

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
    chains = raw["chains"]
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
    chain_plain_ms, want = cuda_ms(
        lambda: rc.op_chain_plain(seeds, iters, 3, "viaddmin"), 1)
    err["op_chain"] = max(err["op_chain"], max_diff(
        chains["viaddmin"]["out"], want,
        f"op_chain viaddmin at {iters} iterations"))
    stream_plain_ms, want = cuda_ms(lambda: rc.stream_fold_plain(words), 1)
    err["stream_fold"] = max(err["stream_fold"], max_diff(
        stream["out"], want, f"stream_fold {mib[1]} MiB"))
    n_words = words.numel()
    del words, want, raw
    probe_plain_ms, _ = cuda_ms(lambda: rc.probe_plain(x), 3)

    phase(f"[12a roofline kernels] issue chain ({ISSUE_CHECK_ITERS} and "
          f"{iters} iterations), op_chain (each op at {CHAIN_CHECK_ITERS}, "
          f"viaddmin at {iters} iterations), stream fold "
          f"({STREAM_CHECK_MIB} and {mib[1]} MiB), probe (x[0] = "
          f"{PROBE_TRIPS}) exactly equal to their plain versions; counter: "
          f"{counter}; op_chain loops: " + "; ".join(
              f"{op} {c['chain_insts']} of {c['expected']} chain "
              f"instructions, opcodes {c['opcodes']}"
              for op, c in census.items()))
    lanes = line["chains"]
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
    per_sass = {op: c["lanes_per_cycle_per_sm"] * census[op]["chain_insts"]
                / census[op]["expected"] for op, c in lanes.items()}
    phase("[12b op_chain rates] lanes a cycle per SM at the sampled "
          f"{line['chain_sm_clock_mhz']:.0f} MHz (128: the issue limit; "
          "per SASS instruction of the op, census): " + ", ".join(
              f"{op} {c['lanes_per_cycle_per_sm']:.1f} ({per_sass[op]:.1f})"
              for op, c in lanes.items()) + f" on {card}")
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
        dict(name="op_chain", replaces="tools/roofline.py:49",
             launches=launches["op_chain"],
             max_abs_err=float(err["op_chain"]),
             ms=chains["viaddmin"]["walls"][0] * 1e3, plain_ms=chain_plain_ms,
             **common, **bound_entry(
                 rc.op_chain_ops(threads, iters, "viaddmin"),
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
    shapes = shape_builds() + row_builds()
    # one nvcc per core, the longest build (the tuned LEAP table) first
    with ThreadPoolExecutor(os.cpu_count() or 8) as ex:
        builds = {k: ex.submit(timed, k.build_kernel) for k in sorted(
            kernels, key=lambda k: k is not leap_cuda)}
        builds = [builds[k] for k in kernels]
        native = ex.submit(timed, build_native)
        shape_jobs = [ex.submit(timed, lambda m=m, a=a: m.build_kernel(*a))
                      for m, a in shapes]
        secs = {k.__name__.rsplit(".", 1)[1]: f.result()
                for k, f in zip(kernels, builds)}
        secs["native"] = native.result()
        shape_secs = {shape_stem(m, a): f.result()
                      for (m, a), f in zip(shapes, shape_jobs)}
    ptxas = "; ".join(ptxas_summary(k.ptxas_report()) for k in kernels)
    phase(f"[2 build] {len(kernels)} kernel libraries + native library + "
          f"{len(shapes)} per-shape libraries in "
          f"{time.perf_counter() - t0:.1f}s (seconds each: {secs}; per "
          f"shape: {shape_secs}); ptxas: {ptxas}")
    phase("[2 build per shape] ptxas: " + "; ".join(
        f"{shape_stem(m, a)}: {ptxas_summary(m.ptxas_report(*a))}"
        for m, a in shapes))

    entry, greedy_rows = greedy_phases(dev, name, card)
    entries = [entry]
    err = nw_conformance(dev, name)
    got, nw_res, full_row = nw_main_path(dev, card, err)
    entries += got
    entries.append(nw_stage_path(dev, card))
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
    entries += shapes_path(dev, name, card)
    entries += rows_path(dev, name, card)

    print(json.dumps({"kernels": entries}))
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
