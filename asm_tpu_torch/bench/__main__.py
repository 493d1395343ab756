"""The benchmark CLI, mirroring GASMA/benchmark/benchmark.cpp (port of
`python -m asm_tpu.bench`).

  python -m asm_tpu_torch.bench                       # reference sweep
  python -m asm_tpu_torch.bench --pairs 100000 --err 0.05
  python -m asm_tpu_torch.bench --file pairs.seq      # ">read\\n<ref\\n"
  python -m asm_tpu_torch.bench --device cpu --impl torch --pairs 512

The reference's benchmark.cpp:12-33 generates 5M-pair corpora at
err in {.05,.10,.15,.20}, caps at 1M alignments, penalties x=1,o=1,e=1,
band k=3. Simulated corpora come from the native generator (its seeded
stream is the one the pins hold for) unless --length-range asks for the
numpy generator, which alone draws variable lengths.
"""

from __future__ import annotations

import argparse

from asm_tpu_torch.bench.harness import format_report, run_benchmark
from asm_tpu_torch.config import AlignConfig
from asm_tpu_torch.data.generator import (
    generate_dataset_arrays,
    generate_dataset_native,
    generate_real_profile_arrays,
)
from asm_tpu_torch.data.io import read_pair_file
from asm_tpu_torch.encoding import encode_batch


def _gen(pairs, length, err, mr, seed, max_len, length_range=None,
         exact=True):
    """The native generator for fixed lengths (raises if it cannot
    load), the numpy one for a length range."""
    if length_range is None:
        return generate_dataset_native(pairs, length, err, mr, seed=seed,
                                       max_len=max_len,
                                       exact_error_rate=exact)
    return generate_dataset_arrays(
        pairs, length, err, mr, seed=seed, max_len=max_len,
        length_range=length_range, exact_error_rate=exact,
    )


def corpora(args, cfg: AlignConfig) -> list:
    """(name, (read_codes, read_len, ref_codes, ref_len)) of each corpus
    the options ask for."""
    lr = tuple(args.length_range) if args.length_range else None
    tag = f" lengths {lr[0]}-{lr[1]}" if lr else ""
    if args.file:
        reads, refs = read_pair_file(args.file, max_tests=args.pairs)
        return [(f"file:{args.file}",
                 encode_batch(reads, refs, cfg.max_len))]
    if args.real_profile:
        return [(f"real-profile (SRR611076 rates){tag}",
                 generate_real_profile_arrays(
                     args.pairs, args.length, seed=args.seed,
                     max_len=cfg.max_len, length_range=lr))]
    if args.lt_eq:
        tag += " lt_eq"
    return [(f"simulated err={e_:.2f}{tag}",
             _gen(args.pairs, args.length, e_, args.mismatch_rate, args.seed,
                  cfg.max_len, length_range=lr, exact=not args.lt_eq))
            for e_ in args.err or [0.05, 0.10, 0.15, 0.20]]


def main(argv=None) -> list:
    """Run the CLI; prints each corpus's report and returns the
    BenchmarkResults."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--pairs", type=int, default=1_000_000)
    p.add_argument("--err", type=float, action="append", default=None,
                   help="error rate(s); default: 0.05 0.10 0.15 0.20")
    p.add_argument("--length", type=int, default=100)
    p.add_argument("--mismatch-rate", type=float, default=0.96)
    p.add_argument("--file", type=str, default=None,
                   help="read pairs from a '>read/<ref' file instead")
    p.add_argument("--lt-eq", action="store_true",
                   help="draw each pair's error count uniformly in "
                        "[0, ceil(err*len)] instead of exactly ceil (the "
                        "reference's *_lt_eq corpora)")
    p.add_argument("--real-profile", action="store_true",
                   help="use the SRR611076-profile synthetic corpus "
                        "(README.md:70-76 error rates) instead of the "
                        "WFA-style rate sweep")
    p.add_argument("--length-range", type=int, nargs=2, default=None,
                   metavar=("LO", "HI"),
                   help="variable-length corpus: per-pair read lengths "
                        "uniform in [LO, HI]")
    p.add_argument("--x", type=int, default=1)
    p.add_argument("--o", type=int, default=1)
    p.add_argument("--e", type=int, default=1)
    p.add_argument("--k", type=int, default=3)
    p.add_argument("--max-len", type=int, default=128)
    p.add_argument("--chunk", type=int, default=1 << 20)
    p.add_argument("--coverage-sample", type=int, default=None,
                   help="cap coverage to the first N pairs (default: full "
                        "corpus, like the reference)")
    p.add_argument("--no-coverage", action="store_true")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--impl", choices=("cuda", "torch"), default="cuda",
                   help="the hand-written kernels or their plain versions")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)

    cfg = AlignConfig(x=args.x, o=args.o, e=args.e, k=args.k,
                      max_len=args.max_len)
    results = []
    for name, (rc, rl, fc, fl) in corpora(args, cfg):
        print(f"--- {name}: {rc.shape[0]} pairs ---")
        r = run_benchmark(
            rc, rl, fc, fl, cfg,
            chunk=args.chunk,
            coverage_sample=0 if args.no_coverage else args.coverage_sample,
            want_coverage=not args.no_coverage,
            impl=args.impl,
            device=args.device,
        )
        print(format_report(r), flush=True)
        results.append(r)
    return results


if __name__ == "__main__":
    main()
