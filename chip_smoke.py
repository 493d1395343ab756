"""GPU smoke test of the PyTorch / CUDA port (asm_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card, nvcc and g++. Phases, each printing one line:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: the greedy, NW and NW band kernels (nvcc, sm_90a) and the
     native host runtime, all at once, from this checkout's sources;
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
Prints a JSON line of per-kernel results, the card line, and last
{"ok": true, "device": {...}}. Any failure raises (exit code != 0).
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
    """Phases 3 and 4 (greedy); returns the kernel's JSON entry."""
    from asm_tpu_torch import headline
    from asm_tpu_torch.kernels import greedy_cuda
    from asm_tpu_torch.kernels.greedy import greedy_align
    from asm_tpu_torch.ops.cigar import runs_to_cigars_batch

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
            for key in ("cost", "steps", "step_rec"):
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
          f"steps, step records and CIGARs exactly equal (max abs err "
          f"{max_err})")

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
    if d or not np.array_equal(plain["steps"], res["steps"]):
        raise AssertionError("plain version disagrees on the main path")
    max_err = max(max_err, d)
    phase(f"[4 main path] {res['n_pairs']} pairs: checksum "
          f"{res['checksum']} (pinned), per-chunk max steps "
          f"{res['chunk_max']} < bounds {res['bounds']}, {launches} kernel "
          f"launches; kernel {kernel_ms:.3f} ms "
          f"({res['n_pairs'] / kernel_ms / 1e3:.1f}M aligns/s), plain "
          f"version {plain_ms:.3f} ms, both on {card}")
    return dict(name="greedy", route="cuda",
                source="asm_tpu_torch/csrc/greedy.cu",
                replaces="asm_tpu/kernels/greedy_pallas.py:91",
                launches=launches, max_abs_err=float(max_err),
                ms=kernel_ms, plain_ms=plain_ms)


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
             ms=band_ms, plain_ms=band_plain_ms),
        dict(name="nw", route="cuda", source="asm_tpu_torch/csrc/nw.cu",
             replaces="asm_tpu/kernels/nw_pallas.py:88",
             launches=full_launches, max_abs_err=float(err["nw"]),
             ms=full_ms, plain_ms=full_plain_ms),
    ]


def coverage_path(dev, card, err) -> dict:
    """Phase 7; returns the trace kernel's JSON entry."""
    from asm_tpu_torch import headline
    from asm_tpu_torch.config import AlignConfig
    from asm_tpu_torch.kernels import greedy_cuda, nw, nw_cuda
    from asm_tpu_torch.metrics.coverage_device import coverage_counts

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
                ms=trace_ms, plain_ms=plain_ms)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs only on a GPU",
              file=sys.stderr)
        return 1
    from concurrent.futures import ThreadPoolExecutor

    from asm_tpu_torch.kernels import greedy_cuda, nw_band, nw_cuda
    from asm_tpu_torch.native import build_native

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    card = card_line()
    phase(f"[1 device] {name}; nvidia-smi: {card}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")

    # every build at once: one nvcc per kernel source, and make
    t0 = time.perf_counter()
    kernels = (greedy_cuda, nw_cuda, nw_band)
    with ThreadPoolExecutor(len(kernels) + 1) as ex:
        builds = [ex.submit(k.build_kernel) for k in kernels]
        native = ex.submit(build_native)
        built = [f.result()[1] for f in builds]
        native.result()
    ptxas = "; ".join(ptxas_summary(k.ptxas_report()) for k in kernels)
    phase(f"[2 build] 3 kernel libraries + native library in "
          f"{time.perf_counter() - t0:.1f}s (built now: {built}); "
          f"ptxas: {ptxas}")

    entries = [greedy_phases(dev, name, card)]
    err = nw_conformance(dev, name)
    entries += nw_main_path(dev, card, err)
    entries.append(coverage_path(dev, card, err))

    print(json.dumps({"kernels": entries}))
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
