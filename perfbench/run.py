"""Run one cell of the benchmark once and print its result line.

    python3 -m perfbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds BENCHMARK.json and the
asm_tpu_torch package. It makes the cell's pool from the seed on the
card, warms up, runs a closed loop of jobs for `--seconds`, and prints
one JSON object as its last line of standard output: with `--trace 0`
the cell's end-to-end metrics, with `--trace 1` its per-layer metrics
read from a `torch.profiler` trace of whole jobs from a third into the
window (`harness.TRACE_SECONDS` at most). The
numbers compared with the plain reference close standard error and the
result line (`checks`). Without a CUDA card, or with fewer cards than
the cell asks for, it prints no result and exits with 3.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from perfbench import harness

    harness.log(f"set-up: python and torch {time.perf_counter() - T0:.3f} s")

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        cells = {w["name"]: w for w in json.load(f)["workloads"]}
    if args.workload not in cells:
        harness.log(f"no workload {args.workload!r}; cells: {sorted(cells)}")
        return 2
    chips = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        harness.log(f"{args.workload} needs {chips} CUDA device(s); "
                    f"found {torch.cuda.device_count()}")
        return 3
    # one process, one CPU thread of its own: no idle intra-op workers
    # spin beside the loop on the host's shared cores
    torch.set_num_threads(1)
    result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                              bool(args.trace), device="cuda", t0=T0)
    bad = harness.forbidden_modules()
    if bad:
        harness.log(f"modules the benchmark must not load were loaded: {bad}")
        return 4
    for name, c in result["checks"].items():
        harness.log(f"check {name} {c['value']} limit {c['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
