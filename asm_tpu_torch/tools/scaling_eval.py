"""Scaling proxy of the multi-process pipeline (port of
tools/scaling_eval.py).

Runs `parallel.multihost_demo` clusters (real torch.distributed
processes on gloo, one rank per process) and compares the median wall of
their pipeline reps:

  * STRONG proxy: the same global corpus on 1 rank and on 2 ranks. On the
    card (default) both ranks share the one GPU, so the compute is the
    same and the ratio t(1)/t(2) shows what running two processes and
    summing their counters costs or overlaps; on the CPU (`--device
    cpu`) they split the host's cores (OMP_NUM_THREADS), as the JAX
    tool's CPU proxy fixes its cores.
  * WEAK rows: a fixed corpus per rank, 1 rank -> 2 ranks sharing the
    same device (ideal ~0.5 there: the work doubles on one device).

This is no interconnect claim: a single card or host has none. Every
cluster's summed counters must agree across its ranks (checked). The
JAX tool's dryrun rows (16 and 32 virtual devices) have no counterpart:
a rank here is a process.

Usage: python -m asm_tpu_torch.tools.scaling_eval --out FILE
       [--pairs-per-proc 8192] [--reps 5] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import statistics
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_cluster(num_procs: int, pairs_global: int, reps: int, device: str,
                workdir: str, timeout: float = 900) -> dict:
    """Run a gloo cluster of `num_procs` demo workers; return process 0's
    JSON (the counters are summed, so every rank's are equal: checked)."""
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = (REPO + os.pathsep + env["PYTHONPATH"]
                         if env.get("PYTHONPATH") else REPO)
    if device == "cpu":  # the ranks split the host's cores between them
        env["OMP_NUM_THREADS"] = str(max(1, (os.cpu_count() or 1)
                                         // num_procs))
    procs, outs = [], []
    for pid in range(num_procs):
        out = os.path.join(workdir, f"rank{num_procs}_{pid}.json")
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "asm_tpu_torch.parallel.multihost_demo",
             "--process-id", str(pid), "--num-processes", str(num_procs),
             "--port", str(port), "--out", out, "--pairs",
             str(pairs_global), "--reps", str(reps), "--device", device,
             "--backend", "gloo"],
            env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT))
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"rank exited {p.returncode}:\n"
                               + log.decode(errors="replace")[-3000:])
    results = []
    for o in outs:
        with open(o) as f:
            results.append(json.load(f))
    if any(r["stats"] != results[0]["stats"] for r in results):
        raise RuntimeError(f"ranks disagree: {[r['stats'] for r in results]}")
    return results[0]


def main(argv=None) -> str:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--pairs-per-proc", type=int, default=8192)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (the kernels, ranks sharing the one card; "
                         "default) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    if args.reps < 1:
        raise SystemExit("--reps must be >= 1")

    import torch

    where = "cpu"
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device; pass --device cpu for the "
                             "CPU proxy")
        from concurrent.futures import ThreadPoolExecutor

        from asm_tpu_torch.kernels import greedy_cuda, leap_cuda, nw_band, nw_cuda

        # build once here; the ranks only load the libraries
        with ThreadPoolExecutor(4) as ex:
            for f in [ex.submit(k.build_kernel) for k in
                      (greedy_cuda, nw_cuda, nw_band, leap_cuda)]:
                f.result()
        where = torch.cuda.get_device_name(0)
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
        where += f" ({card})"

    ppp = args.pairs_per_proc
    med = lambda r: statistics.median(r["rep_seconds"])  # noqa: E731
    with tempfile.TemporaryDirectory() as tmp:
        print("strong proxy: 1 vs 2 ranks, same global corpus ...",
              file=sys.stderr)
        s1 = run_cluster(1, 2 * ppp, args.reps, args.device, tmp)
        s2 = run_cluster(2, 2 * ppp, args.reps, args.device, tmp)
        print("weak rows: fixed corpus per rank, 1 -> 2 ranks ...",
              file=sys.stderr)
        w1 = run_cluster(1, ppp, args.reps, args.device, tmp)
        w2 = run_cluster(2, 2 * ppp, args.reps, args.device, tmp)
    if s1["stats"] != s2["stats"]:
        raise RuntimeError(f"1 rank {s1['stats']} != 2 ranks {s2['stats']}")

    text = f"""# Scaling proxy of the multi-process pipeline, on {where}.
# python -m asm_tpu_torch.tools.scaling_eval --pairs-per-proc {ppp} --reps {args.reps} --device {args.device}
# gloo ranks (processes) running make_sharded_pipeline on one {args.device} device;
# no interconnect is measured.
#
# STRONG proxy (fixed total work {2 * ppp} pairs, one shared device):
#   1 rank  : median rep {med(s1):.4f} s
#   2 ranks : median rep {med(s2):.4f} s
#   t(1)/t(2) = {med(s1) / med(s2):.3f}
#
# WEAK rows (fixed corpus per rank {ppp} pairs, ranks sharing the device,
# so the work on it doubles; ideal ~0.5):
#   1 rank,  {ppp} pairs : median rep {med(w1):.4f} s
#   2 ranks, {2 * ppp} pairs: median rep {med(w2):.4f} s
#   t(1)/t(2) = {med(w1) / med(w2):.3f}
#
# summed counters equal across ranks in every cluster and between the
# strong pair: {s1["stats"]}
"""
    with open(args.out, "w") as f:
        f.write(text)
    print(text)
    return text


if __name__ == "__main__":
    main()
