"""LEAP batch edit-distance filter (port of `asm_tpu.apps.leap_filter`,
the mirror of LEAP_SIMD/main.cpp:35-300).

Reads pairs (two lines per pair: read, then ref) from stdin or a pair
file, runs LEAP with SIMD_ED semantics (the kernel main.cpp drives,
SIMD_ED.cpp:214-616) in batches, and reports pass and total counts and
the align time:

  python -m asm_tpu_torch.apps.leap_filter ERROR [USE_SHD] [USE_LEVENSHTEIN] \
      [--file pairs.seq] [--device cuda|cpu]

The arguments mirror main.cpp:55-69: ERROR is the edit threshold; USE_SHD
1/0 (default: on for levenshtein, off for affine, main.cpp:90-98);
USE_LEVENSHTEIN 1 for init_levenshtein(error, ED_GLOBAL) (default), 0 for
init_affine(error, 3 * error, ED_GLOBAL, 2, 3, 1) (main.cpp:97).

Pair conventions follow main.cpp:137-196: the pair's length is the read's
(at most max_len = 256); the ref is cut to it or zero-padded ('A') up to
it. The default route is the CUDA kernel with the SHD gate inside it
(`leap_cuda.leap_align_cuda`, one launch per batch); --device cpu runs the
plain version. As in the JAX CLI, the affine gate, undefined behaviour in
the reference, is replaced by the levenshtein gate at the same threshold
when asked for, and per-pair state is fresh. The align time covers the
aligner only (main.cpp:144), after one untimed warm-up batch.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from asm_tpu_torch.config import AlignConfig, LeapMode
from asm_tpu_torch.encoding import encode_batch
from asm_tpu_torch.kernels.leap import shd_gate
from asm_tpu_torch.kernels.leap_cuda import leap_align_cuda

BATCH = 1 << 16


def filter_config(error: int, use_levenshtein: bool) -> AlignConfig:
    if use_levenshtein:  # init_levenshtein(error, ED_GLOBAL): band == threshold
        return AlignConfig(x=1, o=1, e=1, k=error, leap_af_threshold=error,
                           leap_mode=LeapMode.GLOBAL, max_len=256)
    # init_affine(error, 3 * error, ED_GLOBAL, 2, 3, 1)
    return AlignConfig(x=2, o=3, e=1, k=error, leap_af_threshold=3 * error,
                       leap_mode=LeapMode.GLOBAL, max_len=256)


def make_filter_step(cfg: AlignConfig, use_levenshtein: bool, use_shd: bool):
    """step(read codes, read lengths, ref codes, ref lengths) -> passed
    bool[B], with main.cpp's pair conventions on the tensors' device."""
    semantics = "simd_ed_lev" if use_levenshtein else "simd_ed_affine"

    def step(rc, rl, fc, fl):
        pos = torch.arange(cfg.max_len, device=rc.device)[None, :]
        # strncpy(B, ref, read_len): zero-pad (code A) / cut to the read
        fc_eff = torch.where((pos < rl[:, None]) & (fc >= 4),
                             torch.zeros_like(fc), fc)
        out = leap_align_cuda(rc, rl, fc_eff, rl, cfg, semantics=semantics,
                              use_shd_gate=use_shd and use_levenshtein)
        passed = out["passed"]
        if use_shd and not use_levenshtein:
            passed = passed & shd_gate(rc, fc_eff, rl, cfg.k)
        return passed

    return step


def _batches(src, max_len: int):
    while True:
        reads, refs = [], []
        for _ in range(BATCH):
            l1 = src.readline()
            if not l1:
                break
            l2 = src.readline()
            if not l2:
                break
            reads.append(l1.strip())
            refs.append(l2.strip())
        if not reads:
            return
        yield encode_batch(reads, refs, max_len)


def run(error: int, use_shd: int = -1, use_levenshtein: int = 1, src=None,
        device="cuda") -> dict:
    """Filter the pairs of `src` (a text stream); returns passed, total
    and align_s."""
    cfg = filter_config(error, bool(use_levenshtein))
    # per-mode default when -1: on for levenshtein, off for affine
    shd = bool(use_levenshtein) if use_shd == -1 else use_shd == 1
    step = make_filter_step(cfg, bool(use_levenshtein), shd)
    device = torch.device(device)
    total = passed = 0
    align_s = 0.0
    warm = False

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    for arrays in _batches(src, cfg.max_len):
        rc, rl, fc, _ = (torch.from_numpy(a).to(device) for a in arrays)
        if not warm:
            step(rc, rl, fc, rl)  # first launch loads the kernel
            warm = True
        sync()
        t0 = time.perf_counter()
        ok = step(rc, rl, fc, rl)
        sync()
        align_s += time.perf_counter() - t0
        passed += int(ok.sum())
        total += rl.shape[0]
    return dict(passed=passed, total=total, align_s=align_s)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("error", type=int)
    p.add_argument("use_shd", type=int, nargs="?", default=-1)
    p.add_argument("use_levenshtein", type=int, nargs="?", default=1)
    p.add_argument("--file", type=str, default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernel, default) or cpu (plain version)")
    args = p.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu for the plain "
                         "version")
    src = open(args.file) if args.file else sys.stdin
    try:
        res = run(args.error, args.use_shd, args.use_levenshtein, src,
                  args.device)
    finally:
        if args.file:
            src.close()
    # report format cf. LEAP_SIMD/main.cpp:276-278
    print(f"passNum: {res['passed']}")
    print(f"totalNum: {res['total']}")
    print(f"align time: {res['align_s']:.3f} s")
    return res


if __name__ == "__main__":
    main()
