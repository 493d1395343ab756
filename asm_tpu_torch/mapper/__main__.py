"""my-mapper CLI: map reads against an indexed reference, emit SAM.

Mirrors GASMA/mapper/main.cpp:121-141:
  python -m asm_tpu_torch.mapper -r ref.fa -q reads.fq -i out.index \
      -o out.sam -e 3 [--device cuda|cpu]
The rescoring runs on the card's greedy kernel; --device cpu runs the
plain PyTorch version on the CPU.
"""

from __future__ import annotations

import argparse

import torch

from asm_tpu_torch.mapper.core import MapperConfig, map_reads
from asm_tpu_torch.native import FMIndex, read_fasta_native, read_fastq_native


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Map reads against a genome (cf. mapper/main.cpp:123)"
    )
    p.add_argument("-r", "--reference", required=True)
    p.add_argument("-q", "--query", required=True, help="FASTQ reads")
    p.add_argument("-i", "--index", required=True)
    p.add_argument("-o", "--output", required=True, help="output SAM path")
    p.add_argument("-e", "--error", type=int, default=3,
                   help="maximum allowed errors (default 3)")
    p.add_argument("--max-reads", type=int, default=1 << 20)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (the kernel, default) or cpu (plain version)")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu for the plain "
                         "version")

    codes, _ = read_fasta_native(args.reference)
    idx = FMIndex.load(args.index)
    reads, lens, names = read_fastq_native(args.query, args.max_reads)
    mcfg = MapperConfig(max_errors=args.error)
    best, sam = map_reads(idx, codes, reads, lens, names, mcfg,
                          device=args.device)
    with open(args.output, "w") as f:
        f.write(sam)
    mapped = sum(b is not None for b in best)
    print(f"mapped {mapped}/{len(best)} reads -> {args.output}")


if __name__ == "__main__":
    main()
