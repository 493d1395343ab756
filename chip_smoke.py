"""GPU smoke test of the PyTorch / CUDA port (asm_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card, nvcc and g++. Phases, each printing one line:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: the greedy kernel (nvcc, sm_90a) and the native host runtime,
     from this checkout's sources;
  3. kernel vs plain: greedy_align_cuda on CUDA tensors against the plain
     PyTorch greedy_align on the same device, on the corpora of the
     kernel's conformance tests, both input forms — cost, steps, raw step
     records and decoded CIGARs must be exactly equal;
  4. main path: the headline flow (native corpus -> difficulty sort ->
     tile-major planes -> kernel, then the measured-order pass) at
     1,000,000 pairs, the reference's own benchmark size; the checksum
     must equal the pinned value, every chunk's max steps must stay below
     its bound, and the kernel must have been launched; then the plain
     version runs on the same pairs and must agree pair by pair.
Prints a JSON line of per-kernel results, the card line, and last
{"ok": true, "device": {...}}. Any failure raises (exit code != 0).
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

# Total cost of the 1,000,000-pair headline corpus (native generator, seed
# 42, err 0.05, mismatch rate 0.96, length 100, max_len 128; x=o=e=1,
# k=3). Computed with the JAX reference, asm_tpu.kernels.greedy.
# greedy_align on the CPU, over the same native corpus in 65,536-pair
# chunks (max steps per pair there: 13).
CHECKSUM_1M = 3817504
MAIN_PAIRS = 1_000_000
MAIN_CHUNK = 500_000
MAIN_TILE = 4096


def phase(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(path: str) -> str:
    """Registers and spill bytes per kernel instantiation (k, W, input
    form) from nvcc's -Xptxas -v report."""
    out, name, spill = [], "?", "?"
    with open(path) as f:
        for ln in f:
            m = re.search(r"greedy_kernelILi(\d+)ELi(\d+)ELb(\d)", ln)
            if "Compiling entry function" in ln and m:
                form = "planes" if m[3] == "1" else "codes"
                name = f"k{m[1]}/W{m[2]}/{form}"
            m = re.search(r"(\d+) bytes spill stores", ln)
            if m:
                spill = m[1]
            m = re.search(r"Used (\d+) registers", ln)
            if m:
                out.append(f"{name} {m[1]} regs {spill} B spill")
    return "; ".join(out)


def cigar_strings(ops, runs) -> list[str]:
    """(op, run) slot buffers -> CIGAR strings (empty slots skipped)."""
    lut = np.array(["?", "=", "X", "I", "D", "M"])
    ops, runs = np.asarray(ops), np.asarray(runs)
    return ["".join(f"{r}{lut[o]}" for o, r in zip(ro, rr) if r > 0)
            for ro, rr in zip(ops, runs)]


def conformance_cases():
    from asm_tpu_torch.config import AlignConfig, AlignmentType
    from asm_tpu_torch.data.generator import generate_dataset_arrays

    G, S = AlignmentType.GLOBAL, AlignmentType.SEMI_GLOBAL
    cases = []
    for err, mr in [(0.05, 0.96), (0.2, 0.96), (0.4, 0.5)]:
        for at in (G, S):
            cases.append((f"err{err}/mr{mr}/{at.name}",
                          AlignConfig(max_steps=24, alignment_type=at),
                          generate_dataset_arrays(5000, 100, err, mr,
                                                  seed=int(err * 100))))
    cases.append(("x2o3e1k2", AlignConfig(x=2, o=3, e=1, k=2, max_steps=24),
                  generate_dataset_arrays(5000, 80, 0.1, 0.8, seed=5)))
    for bound in (1, 2):
        for at in (G, S):
            cases.append((f"max_steps{bound}/{at.name}",
                          AlignConfig(max_steps=bound, alignment_type=at),
                          generate_dataset_arrays(3000, 100, 0.1, 0.9,
                                                  seed=17)))
    cases.append(("length_range60-120", AlignConfig(max_steps=24),
                  generate_dataset_arrays(5000, 100, 0.15, 0.96, seed=44,
                                          length_range=(60, 120))))
    cases.append(("max_len256", AlignConfig(max_len=256, max_steps=64),
                  generate_dataset_arrays(3000, 200, 0.1, 0.9, seed=3,
                                          max_len=256)))
    cases.append(("max_len256/k2/err0.3",
                  AlignConfig(max_len=256, k=2, max_steps=64),
                  generate_dataset_arrays(3000, 230, 0.3, 0.6, seed=4,
                                          max_len=256)))
    return cases


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs only on a GPU",
              file=sys.stderr)
        return 1
    from asm_tpu_torch import headline
    from asm_tpu_torch.kernels import greedy_cuda
    from asm_tpu_torch.kernels.greedy import greedy_align
    from asm_tpu_torch.native import build_native

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    card = card_line()
    phase(f"[1 device] {name}; nvidia-smi: {card}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    build_native()
    _, built = greedy_cuda.build_kernel()
    phase(f"[2 build] kernel + native library in "
          f"{time.perf_counter() - t0:.1f}s (kernel built now: {built}); "
          f"ptxas: {ptxas_summary(greedy_cuda.ptxas_report())}")

    # ---- 3: kernel vs plain on the card ----
    max_err = 0
    n_cmp = 0
    for label, cfg, (rc, rl, fc, fl) in conformance_cases():
        lens = [torch.from_numpy(a).to(dev) for a in (rl, fl)]
        plain = greedy_align(torch.from_numpy(rc).to(dev), lens[0],
                             torch.from_numpy(fc).to(dev), lens[1], cfg,
                             records=True)
        want = cigar_strings(plain["cigar_ops"].cpu(),
                             plain["cigar_runs"].cpu())
        tile = 256  # B is no multiple of it: a partial tail tile
        forms = {
            "codes": (torch.from_numpy(rc).to(dev),
                      torch.from_numpy(fc).to(dev), False),
            "planes_tiled": (
                torch.from_numpy(greedy_cuda.stage_planes_tiled_t(
                    rc, tile=tile).view(np.int32)).to(dev),
                torch.from_numpy(greedy_cuda.stage_planes_tiled_t(
                    fc, tile=tile).view(np.int32)).to(dev),
                "planes_tiled"),
        }
        for form, (a, b, pre) in forms.items():
            got = greedy_cuda.greedy_align_cuda(
                a, lens[0], b, lens[1], cfg, pre_staged=pre, tile=tile)
            torch.cuda.synchronize()
            for key in ("cost", "steps", "step_rec"):
                d = (got[key].to(torch.int64)
                     - plain[key].to(torch.int64)).abs().max().item()
                max_err = max(max_err, d)
                if d != 0:
                    raise AssertionError(f"{label}/{form}: {key} differs "
                                         f"from the plain version (max {d})")
            cig = cigar_strings(got["cigar_ops"].cpu(),
                                got["cigar_runs"].cpu())
            bad = sum(x != y for x, y in zip(cig, want))
            if bad:
                raise AssertionError(f"{label}/{form}: {bad} CIGARs differ")
            n_cmp += 1
    phase(f"[3 kernel vs plain] {n_cmp} corpus/form cases on {name}: cost, "
          f"steps, step records and CIGARs exactly equal (max abs err "
          f"{max_err})")

    # ---- 4: the main path ----
    greedy_cuda.LAUNCHES = 0
    res = headline.run(n_pairs=MAIN_PAIRS, chunk=MAIN_CHUNK, err=0.05,
                       tile=MAIN_TILE, device=dev, impl="cuda", reps=5)
    launches = greedy_cuda.LAUNCHES
    if launches <= 0:
        raise AssertionError("the main path never launched the kernel")
    if res["checksum"] != CHECKSUM_1M:
        raise AssertionError(f"checksum {res['checksum']} != pinned "
                             f"{CHECKSUM_1M}")
    for got, bound in zip(res["chunk_max"], res["bounds"]):
        assert got < bound, (res["chunk_max"], res["bounds"])
    kernel_ms = min(res["rep_s"]) * 1e3
    plain = headline.run_pass(res["corpus"], res["perm"], res["bounds"],
                              headline.headline_config(), MAIN_CHUNK,
                              MAIN_TILE, dev, impl="torch", reps=2)
    plain_ms = min(plain["rep_s"]) * 1e3
    d = int(np.abs(plain["cost"].astype(np.int64)
                   - res["cost"].astype(np.int64)).max())
    if d or not np.array_equal(plain["steps"], res["steps"]):
        raise AssertionError("plain version disagrees on the main path")
    max_err = max(max_err, d)
    phase(f"[4 main path] {res['n_pairs']} pairs: checksum "
          f"{res['checksum']} (pinned), per-chunk max steps "
          f"{res['chunk_max']} < bounds {res['bounds']}, {launches} kernel "
          f"launches; kernel {kernel_ms:.3f} ms "
          f"({res['n_pairs'] / kernel_ms / 1e3:.1f}M aligns/s), plain "
          f"version {plain_ms:.3f} ms, both on {card}")

    print(json.dumps({"kernels": [{
        "name": "greedy",
        "route": "cuda",
        "source": "asm_tpu_torch/csrc/greedy.cu",
        "replaces": "asm_tpu/kernels/greedy_pallas.py:91",
        "launches": launches,
        "max_abs_err": float(max_err),
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
