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

    python -m asm_tpu_torch.tools.longseq_sweep [greedy nw piece]
        [--pairs N] [--nw-pairs N] [--reps N]

The corpus is the long-sequence headline's at L = 512 (496-base reads,
err 0.05, seed 7) cut to --pairs; the piece sweep at L = 256 takes the
headline's L = 256 corpus at twice --nw-pairs (the same scratch bytes). Prints one JSON line per sweep: per
variant the best rep's ms in each turn, its registers and spill bytes
(its ptxas report) and warps per SM, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from asm_tpu_torch.headline import stage_chunks
from asm_tpu_torch.kernels import greedy_cuda, nw_cuda
from asm_tpu_torch.tools import longseq_headline as lh
from asm_tpu_torch.utils.build import BUILD_DIR, nvcc_library, ptxas_report_path
from asm_tpu_torch.utils.timing import log, time_reps

L = 512
SWEEPS = ("greedy", "nw", "piece")
# the variants, and the patterns of the source lines that set them
GREEDY_THREADS = (128, 64, 32)
GREEDY_LINE = r"return W == 16 \? \d+ : 128;"
NW_GROUPS = (16, 32)
NW_LINE = (r"template <> struct Inst<16, {trace}> {{ static constexpr int "
           r"G = \d+,")
PIECES_MIB = (256, 1024, 2048, 4096)


def variant(module, name: str, subs) -> tuple[str, str]:
    """Build a copy of `module`'s source in which each (pattern, text) of
    `subs` replaces the one line the pattern matches; returns (library
    path, ptxas report path)."""
    with open(module.SOURCE) as f:
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
    return nvcc_library(name, path)[0], ptxas_report_path(name, path)


@contextlib.contextmanager
def using(module, lib):
    """`module`'s wrappers launch from `lib` (a bound variant) inside, in
    place of the library that holds max_len L; NW's cached `instance`
    answers for the library in use."""
    stem = module.plan(max_len=L).stem
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

    ms = turns([str(m) for m in PIECES_MIB], run, reps, _equal)
    per_pair = L * L // 2
    return dict(sweep="piece", L=L, pairs=n, ms=ms, pieces={
        str(m): min(n, (m << 20) // per_pair) for m in PIECES_MIB},
        checked_in_mib=saved >> 20)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sweeps", nargs="*", default=list(SWEEPS))
    ap.add_argument("--pairs", type=int, default=1 << 20)
    ap.add_argument("--nw-pairs", type=int, default=1 << 16)
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
    corpus = lh.long_corpus(L, args.pairs)
    lines = []
    for s in args.sweeps:
        if s == "greedy":
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
