"""Multi-process demonstration worker: a real torch.distributed run of the
sharded evaluation pipeline (port of `asm_tpu.parallel.multihost_demo`).

Each process joins the process group (one rank per process, one device
per rank), generates the same seeded corpus, keeps its own contiguous
`lo:hi` shard on its device, and runs `make_sharded_pipeline`, whose
counter vector is summed over the ranks by `all_reduce`. Every process
writes the summed counters and its timings to `--out` as JSON.

Backends: gloo on the CPU. On a machine with one card, NCCL runs only at
world size 1 (it refuses two ranks on one GPU), so two ranks that share
the card pass `--backend gloo`: their kernels still run on the card, and
gloo sums a host copy of the 7 counters. With one card per rank, NCCL.

Run one process per rank (tests/test_torch_multihost.py drives two):

  python -m asm_tpu_torch.parallel.multihost_demo \\
      --process-id 0 --num-processes 2 --port 9876 --out stats0.json \\
      --device cpu
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--pairs", type=int, default=256)
    ap.add_argument("--seed", type=int, default=77)
    ap.add_argument("--reps", type=int, default=0,
                    help="after the first run, run the pipeline this many "
                         "times more and record each rep's wall "
                         "(tools/scaling_eval.py)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (the kernels, default) or cpu (their plain "
                         "versions)")
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                    help="default: nccl on cuda, gloo on cpu")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu for the plain "
                         "versions")
    backend = args.backend or ("nccl" if args.device == "cuda" else "gloo")

    import torch.distributed as dist

    from asm_tpu_torch.config import AlignConfig
    from asm_tpu_torch.data.generator import generate_dataset_arrays
    from asm_tpu_torch.parallel import (
        initialize_distributed,
        make_mesh,
        make_sharded_pipeline,
        unpack_stats,
    )

    initialize_distributed(f"127.0.0.1:{args.port}", args.num_processes,
                           args.process_id, backend=backend)
    try:
        mesh = make_mesh(device=args.device)
        B = args.pairs
        if B % mesh.size:
            raise SystemExit(f"--pairs {B} not divisible by {mesh.size} "
                             f"ranks")
        # every process generates the same seeded corpus and keeps only its
        # own contiguous shard (a real ingest would read its own file shard)
        corpus = generate_dataset_arrays(B, 100, 0.10, 0.96, seed=args.seed)
        lo = mesh.rank * B // mesh.size
        hi = (mesh.rank + 1) * B // mesh.size
        shard = tuple(torch.from_numpy(np.ascontiguousarray(a[lo:hi])).to(
            mesh.device) for a in corpus)

        pipeline = make_sharded_pipeline(mesh, AlignConfig(x=1, o=1, e=1,
                                                           k=3))
        *_, stats_vec = pipeline(*shard)
        stats_list = [int(v) for v in stats_vec.cpu()]
        stats = unpack_stats(stats_list)

        rep_walls = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            stats_vec = pipeline(*shard)[-1]
            stats_vec.cpu()  # waits for the summed counters
            rep_walls.append(time.perf_counter() - t0)

        with open(args.out, "w") as f:
            json.dump(
                dict(
                    process_id=mesh.rank,
                    process_count=mesh.size,
                    local_devices=1,
                    global_devices=mesh.size,
                    stats=stats_list,
                    greedy_accuracy=stats.greedy_accuracy,
                    leap_accuracy=stats.leap_accuracy,
                    pairs_global=B,
                    rep_seconds=rep_walls,
                    device=(torch.cuda.get_device_name(mesh.device)
                            if mesh.device.type == "cuda" else "cpu"),
                ),
                f,
            )
        print(f"proc {mesh.rank}: {mesh.size} ranks on {backend}, device "
              f"{mesh.device}; stats {stats_list}")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
