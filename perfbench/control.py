"""The control of a cell: the plain reference with one stated guarantee
broken (each `perfbench/reference/<kind>.py`'s `control`: greedy's
heuristic one type below the stated one, LEAP over k - 1, NW inside the
narrowest band without its certificate), put in the program's place and
checked exactly as a run checks the program. It has to come out not
correct.

    python3 -m perfbench.control --workload <name> --seeds <n> [<n> ...]

runs, for each seed, the cell's pool at its own size and as many jobs as
a run samples (a slice it has answered is answered again from memory),
and prints one JSON line a seed with the numbers compared.
Needs a CUDA card; the benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys

from perfbench import harness
from perfbench.run import ROOT


def control_run(root: str, name: str, seed: int, device="cuda") -> dict:
    cell = harness.load_cell(root, name)
    return harness.run_cell(root, name, seed, 0.0, False, device=device,
                            job=harness.control_job(cell.kind, cell.config))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        harness.log("the control runs on a CUDA card")
        return 3
    for seed in args.seeds:
        r = control_run(ROOT, args.workload, seed)
        print(json.dumps(dict(workload=args.workload, seed=seed,
                              correct=r["correct"], failed=r["failed"],
                              checks=r["checks"])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
