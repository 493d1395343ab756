"""my-indexer CLI: build and serialize the FM-index (host only).

Mirrors GASMA/mapper/indexer.cpp:60-71:
  python -m asm_tpu_torch.mapper.indexer -r reference.fasta -o out.index
"""

from __future__ import annotations

import argparse

from asm_tpu_torch.mapper.core import build_index
from asm_tpu_torch.native import read_fasta_native


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Create an index for a given reference "
        "(cf. indexer.cpp:62)"
    )
    p.add_argument("-r", "--reference", required=True,
                   help="path to the reference FASTA")
    p.add_argument("-o", "--output", required=True,
                   help="output path for the index file")
    args = p.parse_args(argv)

    codes, starts = read_fasta_native(args.reference)
    print(f"reference: {codes.shape[0]} bases, {len(starts)} record(s)")
    build_index(codes, args.output)
    print(f"index written to {args.output}")


if __name__ == "__main__":
    main()
