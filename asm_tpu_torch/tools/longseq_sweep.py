"""Layout sweeps of the max_len 512 kernels on one GPU: each variant that a
kernel source's table chooses between is built from a copy of the source
with that one table entry replaced (under asm_tpu_torch/build/variants/,
not committed) and timed beside the checked-in build in turns (checked-in,
the variants, the variants reversed, checked-in), its outputs exactly
equal to the checked-in build's.

  greedy  csrc/greedy.cu's block_threads at W = 16: 128, 64 and 32
          threads a block, on the long-sequence headline's greedy pass
          (tools/longseq_headline: the measured-steps order and the
          slices' pow2 bounds)
  nw      csrc/nw.cu's Inst<16, *>::G: 16 and 32 threads per pair, the
          penalty kernel and the trace kernel (with the match mask)
  piece   nw_cuda.TRACE_SCRATCH_BYTES: the trace kernel's launch pieces at
          L = 512 and 256 (the constant serves both), 256 MiB to 4 GiB
          of pointer scratch
  cigar   the long-row LEAP kernel's fused CIGAR at L = 1024, k = 3, on
          chip_smoke 18b's flow (--cigar-pairs, its 16 energy-sorted
          slices): the plan's 128-thread blocks beside 64 and 32 (more
          blocks for the same pairs), a copy whose groups skip the
          backtrack walk (its records not written, so only its
          penalties are compared), and with --parent DIR the per-thread
          kernel of the checkout at DIR (its csrc/leap.cu, one pair a
          thread); each also in penalty mode; then one launch of the
          middle N pairs of the energy order at each N of CIGAR_SIZES,
          the checked-in kernel and the parent's, CIGAR and penalty mode;
          its launches queued behind a spin of the card, so each time is
          the card's alone (and the host's time to issue them is beside
          it)
  nwlong  the three long-row NW kernels at L = 1024 and 2048 on several
          waves of the long-sequence headline's corpus (NWLONG_PAIRS):
          the full kernel (nw_penalty_cuda), the trace kernel
          (nw_align_cuda with the match mask at 3, as the harness's
          coverage step calls it) and the band's wide path at every BW
          (NWLONG_BWS; pre-staged planes; timed, no certificate asked),
          each queued behind a spin as in cigar, each output held against
          its plain version on --sample pairs; per kernel and L: ms,
          pairs, launches, bound (utils/bounds) and share, registers,
          spills, warps per SM, for the full kernel its step loops' SASS
          (roofline.nw_loop_counts: per step, per cell slot and per
          existing cell, by opcode; each of the split loop's parts
          weighted by its steps) and for the band its diagonal loop's
          (roofline.nw_band_loop); at L = 1024 the full kernel also
          built with the shared memory a pair takes at 2048 (OCC_LINE:
          2048's warps per SM on 1024's pairs), in turns; then the
          harness's measuring pass (nw_penalty_partitioned over
          nw_band.BWS, the residue to the full kernel) on the same
          corpus: its wall, its band launches and their summed ms, the
          full kernel's ms; then the band at NWLONG_SMALL's widths on
          the corpus's first NWLONG_SMALL pairs, a launch under one wave
          of warps (chip_smoke 18d's size at 2048). With --parent DIR the
          kernels of DIR's csrc/nw.cu and csrc/nw_band.cu (the pass:
          both) run in turns beside this checkout's (parent, checked-in,
          checked-in, parent), outputs equal; the trace's launch pieces
          are this checkout's (nw_cuda.TRACE_SCRATCH_BYTES) for both
  nwcount the long full kernel's step loops counted (nw_loop_counts over
          the nwlong corpus's lengths), its registers, spills and warps
          per SM, at L = 1024 and 2048, without timing; with --parent
          DIR, DIR's beside
  bandnp  the band's wide path at L = 1024 and 2048 (the nwlong corpus)
          with csrc/nw_band.cu's layout table replaced: the offset pairs
          a thread holds (wide_np_table) at some BW, or the main loop's
          trips a pass (kWideUnroll), BAND_VARIANTS; each timed in turns
          beside the checked-in build at every BW, outputs equal, with
          its loop's SASS per existing cell, registers and warps per SM

    python -m asm_tpu_torch.tools.longseq_sweep [greedy nw piece cigar
        nwlong nwcount bandnp] [--pairs N] [--nw-pairs N]
        [--cigar-pairs N]
        [--parent DIR] [--reps N] [--sample N]

The corpus is the long-sequence headline's at L = 512 (496-base reads,
err 0.05, seed 7) cut to --pairs; the piece sweep at L = 256 takes the
headline's L = 256 corpus at twice --nw-pairs (the same scratch bytes). Prints one JSON line per sweep: per
variant the best rep's ms in each turn, its registers and spill bytes
(its ptxas report) and warps per SM, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import os
import re
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from asm_tpu_torch.headline import stage_chunks
from asm_tpu_torch.kernels import greedy_cuda, nw_cuda
from asm_tpu_torch.tools import longseq_headline as lh
from asm_tpu_torch.utils.build import BUILD_DIR, nvcc_library, ptxas_report_path
from asm_tpu_torch.utils.timing import log, time_reps

L = 512
SWEEPS = ("greedy", "nw", "piece", "cigar", "nwlong", "nwcount", "bandnp")
# the variants, and the patterns of the source lines that set them
GREEDY_THREADS = (128, 64, 32)
GREEDY_LINE = r"return W == 16 \? \d+ : 128;"
NW_GROUPS = (16, 32)
NW_LINE = (r"template <> struct Inst<16, {trace}> {{ static constexpr int "
           r"G = \d+,")
PIECES_MIB = (256, 1024, 2048, 4096)
# the cigar sweep: chip_smoke 18b's flow at L = 1024 (k = 3, unit
# penalties), block sizes beside the plan's, and the launch sizes
CIGAR_L = 1024
CIGAR_THREADS = (64, 32)
CIGAR_SIZES = (2048, 4096, 8192, 16384, 32768, 65536, 131072)
SPIN_CYCLES = 40_000_000  # ~20 ms at 1.98 GHz
# the nwlong sweep: pairs per max_len (several waves of each kernel) and
# the band widths
NWLONG_PAIRS = {1024: 16384, 2048: 8192}
NWLONG_BWS = (4, 8, 16, 32, 64, 128)
# a small band launch: its pairs and widths
NWLONG_SMALL = (512, (64, 128))
# the full kernel at L = 1024 with the shared memory a pair takes at 2048
# (the parked row): csrc/nw.cu's long launch's line, and its replacement
OCC_L, OCC_OF = 1024, 2048
OCC_LINE = r"    constexpr size_t smem = long_slot_bytes\(32 \* W, TRACE\);"
OCC_TEXT = ("    constexpr size_t smem = long_slot_bytes(TRACE ? 32 * W : "
            f"{OCC_OF}, TRACE);")
# the bandnp sweep: csrc/nw_band.cu's layout lines, and per variant the
# offset pairs a thread at each BW it changes (the others the checked-in
# table's) and the main loop's trips a pass
WIDE_NP_LINE = (r"__host__ __device__ constexpr int wide_np_table\(int BW\) "
                r"\{ return [^}]*\}")
UNROLL_LINE = r"constexpr int kWideUnroll = \d+;"
BAND_VARIANTS = {
    "np_down": ({4: 1, 16: 1, 32: 2, 64: 2, 128: 2}, 2),
    "np_up": ({8: 2, 16: 4, 32: 8, 64: 8, 128: 8}, 2),
    "unroll1": ({}, 1),
    "unroll4": ({}, 4),
}
BANDNP_BWS = (4, 8, 16, 32, 64, 128)
# the long kernel's hand-over to its walker, and the copy that skips the
# walk: each group's thread 0 writes the outputs and returns
WALK_LINE = (r"    __syncwarp\(gm\);  // the group's parked cells, seen by "
             r"its walker\n    if \(g != 0\) return;\n")
NO_WALK = ("    __syncwarp(gm);\n    if (g != 0) return;\n"
           "    passed_out[p] = passed ? 1 : 0;\n    pen_out[p] = pen;\n"
           "    shift_out[p] = flane - MID;\n    return;\n")


def variant(module, name: str, subs, defines=(),
            source: str | None = None) -> tuple[str, str]:
    """Build a copy of `module`'s source (or of `source`) in which each
    (pattern, text) of `subs` replaces the one line the pattern matches,
    with `defines`; returns (library path, ptxas report path)."""
    with open(source or module.SOURCE) as f:
        src = f.read()
    for pattern, text in subs:
        src, n = re.subn(pattern, text, src)
        if n != 1:
            raise ValueError(f"{pattern!r} matches {n} lines of "
                             f"{module.SOURCE}")
    os.makedirs(os.path.join(BUILD_DIR, "variants"), exist_ok=True)
    path = os.path.join(BUILD_DIR, "variants", f"{name}.cu")
    with open(path, "w") as f:
        f.write(src)
    return (nvcc_library(name, path, defines)[0],
            ptxas_report_path(name, path))


def parent_bind(module, parent: str):
    """`module`'s `bind` as DIR's checkout `parent` has it, so that a
    library built from the parent's source is typed by the parent's own
    calls (a later source may export calls the parent's lacks)."""
    stem = module.__name__.rsplit(".", 1)[1]
    spec = importlib.util.spec_from_file_location(
        f"parent_{stem}", os.path.join(parent, "asm_tpu_torch", "kernels",
                                       f"{stem}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.bind


@contextlib.contextmanager
def using(module, lib, max_len: int = L):
    """`module`'s wrappers launch from `lib` (a bound variant) inside, in
    place of the library that holds `max_len` (default L); NW's cached
    `instance` answers for the library in use."""
    stem = module.plan(max_len=max_len).stem
    saved = module._libs.get(stem)
    module._libs[stem] = lib
    if module is nw_cuda:
        nw_cuda.instance.cache_clear()
    try:
        yield
    finally:
        if saved is None:
            del module._libs[stem]
        else:
            module._libs[stem] = saved
        if module is nw_cuda:
            nw_cuda.instance.cache_clear()


def turns(names, run, reps: int, same) -> dict:
    """Time run(name) for the names in turns (forward, then reversed),
    each the best of `reps`, and hold each turn's outputs against the
    first's (`same(a, b)`, outside the timed region; raises on a
    difference); returns name -> [ms per turn]."""
    out, first = {n: [] for n in names}, None
    for name in list(names) + list(reversed(names)):
        rep_s, _, outs = time_reps([lambda: run(name)], reps, "cuda")
        out[name].append(min(rep_s) * 1e3)
        log(f"{name}: {out[name][-1]:.4f} ms")
        first = outs[0] if first is None else first
        if not same(outs[0], first):
            raise AssertionError(f"{name}'s outputs differ")
    return out


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _usage(module, fn: str, report_path: str | None = None) -> dict:
    """`roofline.ptxas_entry` of `fn` in the report at `report_path`
    (default: the checked-in build's)."""
    from asm_tpu_torch.tools.roofline import ptxas_entry

    if report_path is None:
        return ptxas_entry(module, fn)
    with open(report_path) as f:
        return ptxas_entry(module, fn, f.read())


def greedy_sweep(corpus, reps: int, tile: int) -> dict:
    from asm_tpu_torch.tools.roofline import greedy_fn

    with ThreadPoolExecutor(len(GREEDY_THREADS)) as ex:
        built = dict(zip(GREEDY_THREADS, ex.map(
            lambda nt: variant(greedy_cuda, f"greedy_nt{nt}", [(
                GREEDY_LINE, f"return W == 16 ? {nt} : 128;")]),
            GREEDY_THREADS)))
    libs = {"checked-in": greedy_cuda._load(3, L)}
    libs.update({f"nt{nt}": greedy_cuda.bind(p) for nt, (p, _) in
                 built.items()})
    pairs = corpus[1].shape[0]
    ident = np.arange(pairs, dtype=np.int64)
    probe = lh._greedy_pass(stage_chunks(corpus, ident, pairs, tile, "cuda"),
                            [256], L, tile)[0]
    steps = probe["steps"].cpu().numpy()
    if steps.max() >= 256:
        raise AssertionError("the greedy probe saturated its bound 256")
    order = np.argsort(steps, kind="stable")
    gsize = max(tile, pairs // 16)
    bounds = lh.slice_bounds(steps[order], gsize)
    chunks = stage_chunks(corpus, order, gsize, tile, "cuda")

    def run(name):
        with using(greedy_cuda, libs[name]):
            return lh._greedy_pass(chunks, bounds, L, tile)

    ms = turns(list(libs), run, reps, lambda a, b: all(
        torch.equal(x[k], y[k]) for x, y in zip(a, b)
        for k in ("cost", "steps", "step_rec")))
    fn = greedy_fn(3, L)
    info = {"checked-in": dict(_usage(greedy_cuda, fn),
                               block_threads=greedy_cuda.block_threads(L),
                               warps_per_sm=greedy_cuda.occupancy(3, L))}
    for nt, (_, rep) in built.items():
        info[f"nt{nt}"] = dict(_usage(greedy_cuda, fn, rep),
                               block_threads=nt,
                               warps_per_sm=libs[f"nt{nt}"]
                               .asm_greedy_occupancy(3, L // 32, 1))
    return dict(sweep="greedy", L=L, pairs=pairs, bounds=bounds,
                ms=ms, instantiations=info)


def nw_sweep(corpus, n: int, reps: int) -> dict:
    def build(g):  # both kernels' entries at W = 16 set to G
        return variant(nw_cuda, f"nw_g{g}", [
            (NW_LINE.format(trace=t), f"template <> struct Inst<16, {t}> "
             f"{{ static constexpr int G = {g},") for t in ("false", "true")])

    with ThreadPoolExecutor(len(NW_GROUPS)) as ex:
        built = dict(zip(NW_GROUPS, ex.map(build, NW_GROUPS)))
    libs = {"checked-in": nw_cuda._load(L)}
    libs.update({f"G{g}": nw_cuda.bind(p) for g, (p, _) in built.items()})
    args = [torch.from_numpy(np.ascontiguousarray(a[:n])).to("cuda")
            for a in corpus]
    targs = [a[:n // 4] for a in args]
    out = dict(sweep="nw", L=L, pairs=n, trace_pairs=n // 4, ms={},
               instantiations={})
    for trace in (False, True):
        def run(name, trace=trace):
            with using(nw_cuda, libs[name]):
                return (nw_cuda.nw_align_cuda(*targs, match_mask_threshold=3)
                        if trace else (nw_cuda.nw_penalty_cuda(*args),))

        kernel = "nw_trace" if trace else "nw"
        out["ms"][kernel] = turns(list(libs), run, reps, _equal)
        info = {}
        for name, lib in libs.items():
            with using(nw_cuda, lib):
                G, route = nw_cuda.instance(trace, L)
                fn = nw_cuda.function_name(trace, L)
                rep = (None if name == "checked-in"
                       else built[int(name[1:])][1])
                info[name] = dict(_usage(nw_cuda, fn, rep), G=G, route=route,
                                  warps_per_sm=nw_cuda.occupancy(trace, L))
        out["instantiations"][kernel] = info
    return out


def piece_sweep(corpus, L: int, n: int, reps: int) -> dict:
    args = [torch.from_numpy(np.ascontiguousarray(a[:n])).to("cuda")
            for a in corpus]
    saved = nw_cuda.TRACE_SCRATCH_BYTES

    def run(name):
        nw_cuda.TRACE_SCRATCH_BYTES = int(name) << 20
        try:
            return nw_cuda.nw_align_cuda(*args, match_mask_threshold=3)
        finally:
            nw_cuda.TRACE_SCRATCH_BYTES = saved

    from asm_tpu_torch.kernels import shapes

    ms = turns([str(m) for m in PIECES_MIB], run, reps, _equal)
    per_pair = shapes.nw_launch(True, L)["scratch_per_pair"]
    return dict(sweep="piece", L=L, pairs=n, ms=ms, pieces={
        str(m): min(n, shapes.trace_piece(per_pair, m << 20))
        for m in PIECES_MIB}, checked_in_mib=saved >> 20)


def queued(fns, reps: int) -> tuple[list, list]:
    """Device ms of each of `fns` (called once each, in order) queued
    behind a spin of the card (torch.cuda._sleep, ~20 ms), so that the
    host's time to issue them shows nowhere: the best of `reps` (after a
    warm-up) by their sum, then the host's ms to issue that rep, and the
    outputs."""
    outs = [f() for f in fns]
    best = None
    for _ in range(reps):
        torch.cuda._sleep(SPIN_CYCLES)
        marks = [torch.cuda.Event(enable_timing=True)
                 for _ in range(len(fns) + 1)]
        t0 = time.perf_counter()
        marks[0].record()
        outs = []
        for f, mark in zip(fns, marks[1:]):
            outs.append(f())
            mark.record()
        host = (time.perf_counter() - t0) * 1e3
        marks[-1].synchronize()
        ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        if best is None or sum(ms) < sum(best[0]):
            best = (ms, host)
    return [best[0], best[1]], outs


def queued_turns(names, run, same) -> dict:
    """run(name) -> ([per-call device ms, host ms], outputs) for the names
    in turns (forward, then reversed), each turn's outputs held against
    the first's (`same(a, b, the two names)`); returns name -> dict(ms:
    the sum per turn, per_call: the first turn's, host_ms per turn)."""
    out, first = {n: dict(ms=[], host_ms=[]) for n in names}, None
    for name in list(names) + list(reversed(names)):
        (per_call, host), outs = run(name)
        got = out[name]
        got["ms"].append(sum(per_call))
        got["host_ms"].append(host)
        got.setdefault("per_call", per_call)
        log(f"{name}: {sum(per_call):.4f} ms on the card (host {host:.3f})")
        if first is None:
            first = (name, outs)
        elif not same(outs, first[1], (name, first[0])):
            raise AssertionError(f"{name}'s outputs differ")
    return out


@contextlib.contextmanager
def using_leap(lib, stem: str):
    """leap_cuda's wrappers launch from `lib` in place of the library
    `stem` inside."""
    from asm_tpu_torch.kernels import leap_cuda

    saved = leap_cuda._libs.get(stem)
    leap_cuda._libs[stem] = lib
    try:
        yield
    finally:
        if saved is None:
            del leap_cuda._libs[stem]
        else:
            leap_cuda._libs[stem] = saved


def cigar_sweep(pairs: int, parent: str | None, reps: int,
                tile: int) -> dict:
    """The cigar sweep (module docstring): per variant the 18b slices'
    ms in each turn, CIGAR and penalty mode, with registers, spills,
    threads a block and warps per SM; then ms per launch size. Every
    time is the card's alone: the launches are queued behind a spin."""
    import dataclasses

    from asm_tpu_torch.kernels import leap_cuda, shapes
    from asm_tpu_torch.kernels.leap_cuda import leap_align_cuda

    L, k, W = CIGAR_L, 3, CIGAR_L // 32
    p = leap_cuda.plan(k, L)
    base = dict(p.defines)
    jobs = {f"nt{nt}": (f"{p.stem}_nt{nt}", [], dict(
        base, ASM_SHAPE_THREADS=nt), None) for nt in CIGAR_THREADS}
    jobs["no_walk"] = (f"{p.stem}_nowalk", [(WALK_LINE, NO_WALK)], base,
                       None)
    threads = {"checked-in": p.threads, "no_walk": p.threads}
    threads.update({f"nt{nt}": nt for nt in CIGAR_THREADS})
    if parent:
        # the per-thread plan: the largest block whose rows fit
        nt = shapes.fit_threads(lambda t: shapes.leap_smem(k, W, t),
                                "the parent's plan")
        pdef = {n: v for n, v in base.items() if n != "ASM_SHAPE_GROUP"}
        jobs["parent"] = (f"parent_{p.stem}", [], dict(
            pdef, ASM_SHAPE_THREADS=nt), os.path.join(
                parent, "asm_tpu_torch", "csrc", "leap.cu"))
        threads["parent"] = nt
    leap_cuda._load(k, L)
    with ThreadPoolExecutor(len(jobs)) as ex:
        built = dict(zip(jobs, ex.map(lambda j: variant(
            leap_cuda, j[0], j[1], tuple(j[2].items()), j[3]),
            jobs.values())))
    libs = {"checked-in": leap_cuda._load(k, L)}
    libs.update({n: (parent_bind(leap_cuda, parent) if n == "parent" else
                     leap_cuda.bind)(path) for n, (path, _) in built.items()})
    info = {}
    for name, lib in libs.items():
        rep = (leap_cuda.ptxas_report(k, L) if name == "checked-in"
               else built[name][1])
        kernel = "leap_kernel" if name == "parent" else "leap_long_kernel"
        for cigar in (False, True):
            fn = (f"{kernel}ILi{k}ELi{W}ELi1ELi1ELi1ELi0ELb{int(cigar)}"
                  f"ELb1E")
            got = lib.asm_leap_occupancy(k, W, int(cigar))
            info[f"{name}{'_cigar' if cigar else ''}"] = dict(
                _usage(leap_cuda, fn, rep), block_threads=threads[name],
                warps_per_sm=got * threads[name] // 32)

    corpus = lh.long_corpus(L, pairs)
    lcfg = lh.leap_config(L)
    chunk = lh.chunk_pairs(pairs)
    ident = np.arange(pairs, dtype=np.int64)
    outs = [leap_align_cuda(*c, lcfg, pre_staged="planes_tiled", tile=tile)
            for c in stage_chunks(corpus, ident, chunk, tile, "cuda")]
    passed = np.concatenate([o["passed"].cpu().numpy() for o in outs])
    pen = np.concatenate([o["penalty"].cpu().numpy() for o in outs])
    energy = np.where(passed, pen, np.int32(1 << 20))
    order = np.argsort(energy, kind="stable")
    csize = max(tile, min(chunk, pairs // 16))
    plan = lh.plan_cigar_chunks(energy[order], lcfg.leap_af_threshold, csize)
    cfgs = [dataclasses.replace(lcfg, leap_max_energy=eb) for _, eb in plan]
    chunks = stage_chunks(corpus, order, csize, tile, "cuda")

    def run_on(chunks, cfgs, cigar):
        def run(name):
            fns = [lambda c=c, cfg=cfg: leap_align_cuda(
                *c, cfg, pre_staged="planes_tiled", tile=tile,
                want_cigar=cigar) for c, cfg in zip(chunks, cfgs)]
            with using_leap(libs[name], p.stem):
                return queued(fns, reps)
        return run

    def same(a, b, names):  # the no-walk copy writes no records
        keys = ["passed", "penalty", "lane_shift"]
        if "edit_rec" in b[0] and "no_walk" not in names:
            keys.append("edit_rec")
        return all(torch.equal(x[key], y[key]) for x, y in zip(a, b)
                   for key in keys)

    names = list(libs)
    ms = {"cigar": queued_turns(names, run_on(chunks, cfgs, True), same),
          "penalty": queued_turns([n for n in names if n != "no_walk"],
                                  run_on(chunks, cfgs, False), same)}
    sizes = {}
    pair = [n for n in ("checked-in", "parent") if n in libs]
    for n in CIGAR_SIZES:
        if n > pairs:
            break
        lo = (pairs - n) // 2  # the energy order's middle n pairs
        rows = order[lo:lo + n]
        eb = lh.plan_cigar_chunks(energy[rows], lcfg.leap_af_threshold,
                                  n)[0][1]
        one = stage_chunks(corpus, rows, n, tile, "cuda")
        ncfg = [dataclasses.replace(lcfg, leap_max_energy=eb)]
        sizes[n] = dict(energy_bound=eb, cigar=queued_turns(
            pair, run_on(one, ncfg, True), same), penalty=queued_turns(
            pair, run_on(one, ncfg, False), same))
    return dict(sweep="cigar", L=L, k=k, pairs=pairs, slice_pairs=csize,
                slice_bounds=[eb for _, eb in plan], ms=ms, sizes=sizes,
                instantiations=info, group=p.group,
                blocks_for_a_slice={n: -(-csize // (t // (1 if n == "parent"
                                                         else p.group)))
                                    for n, t in threads.items()})


def band_libs(Lr: int, parent: str | None) -> dict:
    """name -> (bound library, its path, its ptxas report) of the band at
    max_len Lr: with `parent`, DIR's csrc/nw_band.cu built first, then the
    checked-in build."""
    from asm_tpu_torch.kernels import nw_band

    p = nw_band.plan(Lr)
    out = {}
    if parent:
        path, rep = variant(nw_band, f"parent_{p.stem}", [], p.defines,
                            os.path.join(parent, "asm_tpu_torch", "csrc",
                                         "nw_band.cu"))
        out["parent"] = (parent_bind(nw_band, parent)(path), path, rep)
    path, _ = nw_band.build_kernel(Lr)
    out["checked-in"] = (nw_band._load(Lr), path, nw_band.ptxas_report(Lr))
    return out


def band_info(lib, path: str, report: str, bw: int, Lr: int, mn) -> dict:
    """Registers and spills (ptxas), warps per SM and the diagonal loop's
    SASS count (roofline.nw_band_loop over the corpus's m+n) of
    band_wide_kernel<bw, Lr/32> in one library."""
    from asm_tpu_torch.kernels import nw_band
    from asm_tpu_torch.tools.roofline import (
        WIDE_SHFL_PER_DIAGONAL,
        nw_band_loop,
        ptxas_entry,
        sass_listing,
        wide_function,
    )

    fn = wide_function(bw, Lr)
    loop = nw_band_loop(sass_listing(path, fn), bw, mn,
                        lib.asm_nw_band_wide_np(bw, Lr // 32),
                        WIDE_SHFL_PER_DIAGONAL)
    return dict(ptxas_entry(nw_band, fn, open(report).read()),
                warps_per_sm=nw_band.occupancy(bw, Lr, lib),
                **{k: loop[k] for k in (
                    "pairs_per_warp", "offset_pairs_per_thread",
                    "diagonal_loops", "loop_insts", "existing_cells_per_trip",
                    "loop_insts_per_existing_cell", "loop_body",
                    "loop_opcodes", "mn_divergence_x")})


@contextlib.contextmanager
def timed_calls(module, name: str, marks: list):
    """Inside, each call of module.<name> records a pair of CUDA events
    around it into `marks` as (name, start, stop)."""
    fn = getattr(module, name)

    def wrapped(*args, **kw):
        start, stop = (torch.cuda.Event(enable_timing=True)
                       for _ in range(2))
        start.record()
        out = fn(*args, **kw)
        stop.record()
        marks.append((name, start, stop))
        return out

    setattr(module, name, wrapped)
    try:
        yield
    finally:
        setattr(module, name, fn)


def measuring_pass(Lr: int, planes, t, libs: dict, nw_libs: dict,
                   reps: int) -> dict:
    """The harness's NW measuring pass (nw_penalty_partitioned over
    nw_band.BWS on pre-staged planes, its residue to the full kernel) on
    the corpus, with each band library of `libs` and the NW library of
    `nw_libs` under the same name in turns (forward, then reversed),
    outputs equal: per name the best rep's wall (host clock to the pass's
    numpy result) and, in that rep, the band launches, their summed device
    ms and the full kernel's."""
    from asm_tpu_torch.kernels import nw_band

    out, first = {}, None
    for name in list(libs) + list(reversed(libs)):
        best = None
        for _ in range(reps + 1):  # a warm-up, then the reps
            marks = []
            before = nw_band.LAUNCHES
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with using(nw_band, libs[name][0], Lr), \
                    using(nw_cuda, nw_libs[name], Lr), \
                    timed_calls(nw_band, "nw_penalty_banded", marks), \
                    timed_calls(nw_cuda, "nw_penalty_cuda", marks):
                pen = nw_band.nw_penalty_partitioned(
                    planes[0], t[1], planes[1], t[3], bws=nw_band.BWS,
                    pre_staged=True)
            wall = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
            ms = [(k, a.elapsed_time(b)) for k, a, b in marks]
            got = dict(wall_ms=wall, band_launches=nw_band.LAUNCHES - before,
                       band_ms=sum(v for k, v in ms
                                   if k == "nw_penalty_banded"),
                       full_ms=sum(v for k, v in ms
                                   if k == "nw_penalty_cuda"),
                       full_launches=sum(k == "nw_penalty_cuda"
                                         for k, _ in ms))
            if best is None or wall < best["wall_ms"]:
                best = got
        first = pen if first is None else first
        if not np.array_equal(pen, first):
            raise AssertionError(f"L = {Lr} measuring pass: {name}'s "
                                 f"penalties differ")
        turn = out.setdefault(name, dict(wall_ms=[], band_ms=[],
                                         full_ms=[]))
        for k in ("wall_ms", "band_ms", "full_ms"):
            turn[k].append(best[k])
        turn.update(band_launches=best["band_launches"],
                    full_launches=best["full_launches"])
        log(f"L = {Lr} pass {name}: {best}")
    certified = {bw: int(np.sum(nw_band.band_certified(first, bw)))
                 for bw in nw_band.BWS}
    return dict(sweep="nwlong_pass", L=Lr, pairs=int(t[1].shape[0]),
                bws=list(nw_band.BWS), ms=out, certified_below=certified)


def band_turns(Lr, planes, t, ts, m, n, libs, bws, reps, sample) -> dict:
    """The band's wide path at each of `bws` with each library of `libs`
    (name -> (lib, path, report)) in turns, queued behind a spin, outputs
    equal to each other and to the plain version on the first `sample`
    pairs; per BW: ms per library and turn, launches, bound and share
    (of each library's best), and band_info per library."""
    from asm_tpu_torch.kernels import nw_band
    from asm_tpu_torch.utils.bounds import bound_entry, nw_band_work

    out = {}
    mn = np.minimum(m, Lr) + np.minimum(n, Lr)
    for bw in bws:
        want = nw_band.banded_plain(*ts, bw)

        def call(bw=bw):
            return (nw_band.nw_penalty_banded(planes[0], t[1], planes[1],
                                              t[3], bw=bw, pre_staged=True),)

        def run(name, call=call):
            with using(nw_band, libs[name][0], Lr):
                return queued([call], reps)

        def same(a, b, names, bw=bw, want=want):
            for got in (a, b):
                if not torch.equal(got[0][0][:sample], want):
                    raise AssertionError(
                        f"L = {Lr} band BW {bw}: differs from the plain "
                        f"version on the first {sample} pairs")
            return _equal(a[0], b[0])

        ms = queued_turns(list(libs), run, same)
        info = {}
        for name, (lib, path, report) in libs.items():
            with using(nw_band, lib, Lr):
                before = nw_band.LAUNCHES
                call()
                launches = nw_band.LAUNCHES - before
            info[name] = dict(band_info(lib, path, report, bw, Lr, mn),
                              launches=launches)
        b = bound_entry(*nw_band_work(m, n, np.full(m.size, bw), Lr))
        out[f"nw_band_bw{bw}"] = dict(
            ms=ms, instantiations=info, **b,
            bound_share={k: b["bound_ms"] / min(v["ms"])
                         for k, v in ms.items()})
    return out


def full_function(listing: str, Lr: int) -> str:
    """The mangled name of the long full kernel at max_len Lr in a library's
    SASS listing: nw_long_full_kernel<W> (this checkout's), or the
    nw_long_kernel<W, false> of a parent before it."""
    from asm_tpu_torch.tools.roofline import find_kernels

    W = Lr // 32
    names = [k for k in find_kernels(listing)
             if f"nw_long_full_kernelILi{W}E" in k
             or f"nw_long_kernelILi{W}ELb0E" in k]
    if len(names) != 1:
        raise ValueError(f"{len(names)} long full kernels at W = {W}: "
                         f"{find_kernels(listing)}")
    return names[0]


def full_info(path: str, report: str, Lr: int, m, n, lib) -> dict:
    """The long full kernel of the library at `path` (its ptxas report at
    `report`, bound as `lib`) at max_len Lr on pairs of lengths m, n: its
    step loops' SASS (roofline.nw_loop_counts; a kernel that splits its
    step loop, each part weighted by nw_cuda.loop_steps), registers,
    spills and warps per SM."""
    from asm_tpu_torch.kernels.shapes import nw_long_rows
    from asm_tpu_torch.tools.roofline import (
        _sections,
        nw_loop_counts,
        ptxas_entry,
        sass_listing,
    )

    listing = sass_listing(path)
    fn = full_function(listing, Lr)
    one = next(text for name, text in _sections(listing) if name == fn)
    m = np.minimum(np.asarray(m, np.int64), Lr)
    n = np.minimum(np.asarray(n, np.int64), Lr)
    split = "nw_long_full_kernel" in fn
    counts = nw_loop_counts(
        one, nw_cuda.warp_steps(m, n, Lr, 32), float(np.sum(m * n)), 32,
        nw_long_rows(Lr),
        loop_steps=nw_cuda.loop_steps(m, n, Lr) if split else None)
    with using(nw_cuda, lib, Lr):
        warps = nw_cuda.occupancy(False, Lr)
    keep = ("insts_per_step", "insts_per_slot", "insts_per_existing_cell",
            "existing_share", "loop_insts", "steps_per_trip", "loop_body",
            "loop_opcodes", "loop_parts", "loop_copies")
    with open(report) as f:
        usage = ptxas_entry(nw_cuda, re.search(
            r"nw_long(?:_full)?_kernelILi\d+E(?:Lb0E)?", fn)[0], f.read())
    return dict(function=fn, **usage, warps_per_sm=warps,
                loop={k: counts[k] for k in keep if k in counts})


def full_libs(Lr: int, parent: str | None) -> dict:
    """name -> (bound library, its path, its ptxas report) of NW at max_len
    Lr: with `parent`, DIR's csrc/nw.cu built first, then the checked-in
    build."""
    p = nw_cuda.plan(Lr)
    out = {}
    if parent:
        path, rep = variant(nw_cuda, f"parent_{p.stem}", [], p.defines,
                            os.path.join(parent, "asm_tpu_torch", "csrc",
                                         "nw.cu"))
        out["parent"] = (parent_bind(nw_cuda, parent)(path), path, rep)
    path, _ = nw_cuda.build_kernel(Lr)
    out["checked-in"] = (nw_cuda._load(Lr), path, nw_cuda.ptxas_report(Lr))
    return out


def nwcount_sweep(parent: str | None) -> list[dict]:
    """The nwcount sweep (module docstring): one line per max_len."""
    lines = []
    for Lr, pairs in NWLONG_PAIRS.items():
        corpus = lh.long_corpus(Lr, pairs)
        libs = full_libs(Lr, parent)
        lines.append(dict(sweep="nwcount", L=Lr, pairs=pairs, kernels={
            name: full_info(path, rep, Lr, corpus[1], corpus[3], lib)
            for name, (lib, path, rep) in libs.items()}))
    return lines


def nwlong_sweep(parent: str | None, reps: int, sample: int) -> list[dict]:
    """The nwlong sweep (module docstring): per max_len one line of the
    kernels, one of the measuring pass and one of the small band launch."""
    from asm_tpu_torch.kernels import nw
    from asm_tpu_torch.kernels.greedy_cuda import stage_planes_t
    from asm_tpu_torch.tools.roofline import ptxas_entry
    from asm_tpu_torch.utils.bounds import bound_entry, nw_full_work

    lines = []
    for Lr, pairs in NWLONG_PAIRS.items():
        corpus = lh.long_corpus(Lr, pairs)
        t = [torch.from_numpy(np.ascontiguousarray(a)).to("cuda")
             for a in corpus]
        planes = [torch.from_numpy(stage_planes_t(a).view(np.int32)).to(
            "cuda") for a in (corpus[0], corpus[2])]
        m, n = corpus[1], corpus[3]
        ts = [a[:sample] for a in t]
        line = dict(sweep="nwlong", L=Lr, pairs=pairs, sample=sample,
                    kernels={})
        # in turns: parent, checked-in, checked-in, parent
        flibs = full_libs(Lr, parent)
        for kernel in ("nw", "nw_trace"):
            trace = kernel == "nw_trace"
            libs = {k: v[0] for k, v in flibs.items()}
            if Lr == OCC_L and not trace:
                p = nw_cuda.plan(Lr)
                occ = variant(nw_cuda, f"{p.stem}_smem{OCC_OF}",
                              [(OCC_LINE, OCC_TEXT)], p.defines)
                libs[f"smem_of_{OCC_OF}"] = nw_cuda.bind(occ[0])

            def call(trace=trace):
                return (nw_cuda.nw_align_cuda(*t, match_mask_threshold=3)
                        if trace else (nw_cuda.nw_penalty_cuda(*t),))

            def run(name, call=call, libs=libs):
                with using(nw_cuda, libs[name], Lr):
                    return queued([call], reps)

            want = (nw.nw_align(*ts, match_mask_threshold=3) if trace
                    else (nw.nw_penalty(*ts),))

            def same(a, b, names, want=want):
                for got in (a, b):
                    for g, w in zip(got[0], want):
                        if not torch.equal(g[:sample], w):
                            raise AssertionError(
                                f"L = {Lr} {kernel}: differs from the plain "
                                f"version on the first {sample} pairs")
                return _equal(a[0], b[0])

            ms = queued_turns(list(libs), run, same)
            info = {}
            for name, lib in libs.items():
                with using(nw_cuda, lib, Lr):
                    before = nw_cuda.LAUNCHES[kernel]
                    call()
                    launches = nw_cuda.LAUNCHES[kernel] - before
                    if name not in flibs:  # the shared-memory variant
                        res = dict(warps_per_sm=nw_cuda.occupancy(trace, Lr))
                    elif trace:  # the trace kernel: one name in both
                        with open(flibs[name][2]) as f:
                            res = dict(ptxas_entry(
                                nw_cuda, nw_cuda.function_name(True, Lr),
                                f.read()),
                                warps_per_sm=nw_cuda.occupancy(True, Lr))
                    else:
                        res = full_info(flibs[name][1], flibs[name][2], Lr,
                                        m, n, lib)
                info[name] = dict(res, launches=launches)
            b = bound_entry(*nw_full_work(m, n, Lr, trace=trace))
            line["kernels"][kernel] = dict(
                ms=ms, instantiations=info, **b,
                bound_share={k: b["bound_ms"] / min(v["ms"])
                             for k, v in ms.items()})
        blibs = band_libs(Lr, parent)
        line["kernels"].update(band_turns(Lr, planes, t, ts, m, n, blibs,
                                          NWLONG_BWS, reps, sample))
        lines.append(line)
        lines.append(measuring_pass(Lr, planes, t, blibs,
                                    {k: v[0] for k, v in flibs.items()},
                                    reps))
        k, bws = NWLONG_SMALL
        small = [a[:k] for a in t]
        lines.append(dict(sweep="nwlong_small", L=Lr, pairs=k, sample=sample,
                          kernels=band_turns(
                              Lr, [a[:, :k].contiguous() for a in planes],
                              small,
                              [a[:sample] for a in small], m[:k], n[:k],
                              blibs, bws, reps, sample)))
        del t, planes, ts, small
        torch.cuda.empty_cache()
    return lines


def band_variant_subs(nps: dict, unroll: int) -> list[tuple[str, str]]:
    """`variant`'s (pattern, line) pairs of a BAND_VARIANTS entry: the
    wide_np_table line with `nps` over shapes.BAND_WIDE_NP, and the main
    loop's trips a pass."""
    from asm_tpu_torch.kernels import shapes

    arms = "".join(f"BW == {bw} ? {v} : "
                   for bw, v in {**shapes.BAND_WIDE_NP, **nps}.items())
    return [(UNROLL_LINE, f"constexpr int kWideUnroll = {unroll};"),
            (WIDE_NP_LINE, "__host__ __device__ constexpr int "
             f"wide_np_table(int BW) {{ return {arms}1; }}")]


def bandnp_sweep(reps: int, sample: int) -> list[dict]:
    """The bandnp sweep (module docstring): one line per max_len."""
    from asm_tpu_torch.kernels import nw_band
    from asm_tpu_torch.kernels.greedy_cuda import stage_planes_t

    lines = []
    for Lr, pairs in NWLONG_PAIRS.items():
        p = nw_band.plan(Lr)
        nw_band.build_kernel(Lr)
        with ThreadPoolExecutor(len(BAND_VARIANTS)) as ex:
            built = dict(zip(BAND_VARIANTS, ex.map(
                lambda kv: variant(nw_band, f"{p.stem}_{kv[0]}",
                                   band_variant_subs(*kv[1]), p.defines),
                BAND_VARIANTS.items())))
        libs = {"checked-in": (nw_band._load(Lr), nw_band.build_kernel(
            Lr)[0], nw_band.ptxas_report(Lr))}
        libs.update({name: (nw_band.bind(path), path, rep)
                     for name, (path, rep) in built.items()})
        corpus = lh.long_corpus(Lr, pairs)
        t = [torch.from_numpy(np.ascontiguousarray(a)).to("cuda")
             for a in corpus]
        planes = [torch.from_numpy(stage_planes_t(a).view(np.int32)).to(
            "cuda") for a in (corpus[0], corpus[2])]
        ts = [a[:sample] for a in t]
        lines.append(dict(sweep="bandnp", L=Lr, pairs=pairs, sample=sample,
                          variants={k: dict(np=v[0], unroll=v[1])
                                    for k, v in BAND_VARIANTS.items()},
                          kernels=band_turns(Lr, planes, t, ts, corpus[1],
                                             corpus[3], libs, BANDNP_BWS,
                                             reps, sample)))
        del t, planes, ts
        torch.cuda.empty_cache()
    return lines


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sweeps", nargs="*", default=list(SWEEPS))
    ap.add_argument("--pairs", type=int, default=1 << 20)
    ap.add_argument("--nw-pairs", type=int, default=1 << 16)
    ap.add_argument("--cigar-pairs", type=int, default=1 << 18)
    ap.add_argument("--parent", help="a checkout whose csrc/leap.cu (the "
                    "cigar sweep) or csrc/nw.cu and csrc/nw_band.cu (nwlong) "
                    "are built beside this one's")
    ap.add_argument("--sample", type=int, default=256,
                    help="pairs of each nwlong kernel held against its "
                    "plain version")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--tile", type=int, default=4096)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("the sweeps measure the GPU; no CUDA device")
    for s in args.sweeps:
        if s not in SWEEPS:
            raise SystemExit(f"unknown sweep {s!r}; one of {SWEEPS}")
    from asm_tpu_torch.tools.roofline import card_line

    card = card_line()
    corpus = (lh.long_corpus(L, args.pairs)
              if set(args.sweeps) - {"cigar", "nwlong", "nwcount", "bandnp"}
              else None)
    lines = []
    for s in args.sweeps:
        if s == "nwlong":
            lines = nwlong_sweep(args.parent, args.reps, args.sample)
        elif s == "nwcount":
            lines = nwcount_sweep(args.parent)
        elif s == "bandnp":
            lines = bandnp_sweep(args.reps, args.sample)
        elif s == "cigar":
            lines = [cigar_sweep(args.cigar_pairs, args.parent, args.reps,
                                 args.tile)]
        elif s == "greedy":
            lines = [greedy_sweep(corpus, args.reps, args.tile)]
        elif s == "nw":
            lines = [nw_sweep(corpus, args.nw_pairs, args.reps)]
        else:
            n256 = 2 * args.nw_pairs
            lines = [piece_sweep(corpus, L, args.nw_pairs, args.reps),
                     piece_sweep(lh.long_corpus(256, n256), 256, n256,
                                 args.reps)]
        for line in lines:
            print(json.dumps(dict(line, card=card,
                                  device=torch.cuda.get_device_name(0))),
                  flush=True)


if __name__ == "__main__":
    main()
