"""Demo main — mirror of GASMA/main.cpp:5-19 (port of
`asm_tpu.apps.demo`).

Runs the greedy hurdle-matrix aligner on one pair (the reference's
hardcoded strings by default, or two CLI args), printing the hurdle
matrix, CIGAR, cost, the aligned rows and the LCM coverage string. By
default the pair runs on the card through the greedy kernel
(`greedy_align_cuda`); `--device cpu` runs its plain version.

  python -m asm_tpu_torch.apps.demo [READ REF] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import torch

# the pair hardcoded in GASMA/main.cpp:8-9
DEFAULT_READ = "TTTTAAAACCCCGGGGTTTTAAAACCCCGGGG"
DEFAULT_REF = "TTTTAAACCCCGGGGTTTTAAAAACCCCGGGG"


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("pair", nargs="*", metavar="READ REF")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (the kernel, default) or cpu (plain version)")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu for the plain "
                         "version")
    read, ref = (args.pair[0], args.pair[1]) if len(args.pair) >= 2 else (
        DEFAULT_READ, DEFAULT_REF)

    from asm_tpu_torch.config import AlignConfig
    from asm_tpu_torch.encoding import encode_batch
    from asm_tpu_torch.kernels.greedy_cuda import greedy_align_cuda
    from asm_tpu_torch.metrics.coverage import (
        long_consecutive_matching_substring,
    )
    from asm_tpu_torch.ops.bitops import flip_short_hurdles
    from asm_tpu_torch.ops.cigar import aligned_strings, batch_greedy_cigars
    from asm_tpu_torch.ops.hurdles import build_greedy_lanes

    device = torch.device(args.device)
    cfg = AlignConfig(x=1, o=1, e=1, k=3)
    rc, rl, fc, fl = (torch.from_numpy(a).to(device)
                      for a in encode_batch([read], [ref], cfg.max_len))

    # print the hurdle matrix like hurdle_matrix::print (hurdle_matrix.h:602)
    lanes = flip_short_hurdles(build_greedy_lanes(rc, fc, cfg.k), 1)[0].cpu()
    width = max(len(read), len(ref)) + cfg.k + 1
    for li in range(lanes.shape[0]):
        print(f"lane {li - cfg.k:+d}: "
              + "".join(str(int(b)) for b in lanes[li][:width]))

    out = greedy_align_cuda(rc, rl, fc, fl, cfg)
    out = {k: v.cpu().numpy() for k, v in out.items()}
    cigar = batch_greedy_cigars(out)[0]
    cost = int(out["cost"][0])
    print(f"CIGAR: {cigar}")
    print(f"total cost: {cost}")
    # aligned string pair, like the reference's -DDISPLAY echo
    # (_update_match, hurdle_matrix.h:204-228 / main run print :591-594)
    a_row, b_row = aligned_strings(read, ref, cigar)
    print(f"read: {a_row}")
    print(f"ref:  {b_row}")
    lcm = long_consecutive_matching_substring(read, ref, cigar, 3)
    print(f"LCM (threshold 3): {lcm}")


if __name__ == "__main__":
    main()
