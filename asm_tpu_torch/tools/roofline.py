"""Roofline of the port's greedy and LEAP kernels on the card (port of
tools/roofline.py).

Three measurements, one report:

1. The card's integer issue rate, measured: `issue_peak_measure` times the
   issue_chain kernel (csrc/roofline.cu: independent dependent chains of
   v = (v + 1) ^ 12345 on every thread of a grid that fills the card) at
   `iters` and 2 * iters iterations; the rate is the slope, so launch and
   tail costs cancel.
2. The card's device-memory read rate, measured: `stream_measure` times
   the stream_fold kernel (the xor of every word of an array) on 4096 and
   8192 MiB of seeded random words; the rate is the slope.
3. What the kernels issue, counted: `count_sass` reads the SASS ptxas
   generated (`cuobjdump -sass` of the built library), charges every
   instruction to a category, and charges each loop body at a weight
   read from the run's own outputs (greedy: the step loop's trips a pair
   ran, `greedy_cuda.step_trips`; LEAP: the energy levels it ran,
   `utils.bounds.leap_levels`). Each kernel is
   counted under two weights: the mean per pair (the JAX tool's basis),
   and the mean over 32-pair warps, in launch order, of the warp's
   largest, which is what a warp issues; their ratio is the kernel's
   divergence factor.

`report` sets the kernel's measured time per pair beside its issue bound
(instructions / the measured issue rate), its stream bound (bytes / the
measured stream rate) and its recurrence bound (`utils.bounds`, the
fewest operations at the card's issue limit). LEAP's count charges code
lv_bag does not run, so its line marks the issue time as no bound. The
rates of `utils/bounds.py` stay; this tool prints the measured ones
beside them.

    python -m asm_tpu_torch.tools.roofline [micro greedy leap] [--pairs N]

runs the greedy and LEAP headline flows in-process at --pairs (default
67,108,864, the headlines' corpus) and prints one JSON line for the
microbenchmarks and one per kernel. Needs one CUDA card, and cuobjdump
(the CUDA toolkit's, or the copy bundled with Triton).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import shutil
import subprocess

import numpy as np
import torch

from asm_tpu_torch.kernels import roofline_cuda
from asm_tpu_torch.utils.bounds import HBM_BYTES_PER_S, INT32_OPS_PER_S
from asm_tpu_torch.utils.timing import best_of_reps, log, time_dispatches

# ---------------------------------------------------------------- micro


def _best_seconds(fn, reps: int, device) -> tuple[float, object]:
    """Best CUDA-event seconds of fn() over `reps` timed calls after a
    warm-up call, and the last call's output."""
    rep_s, _, outs = best_of_reps(lambda: time_dispatches([fn], device),
                                  reps, device)
    if not rep_s:
        raise RuntimeError("the roofline measures a CUDA device")
    return min(rep_s), outs[0]


def seeded_words(n: int, device, seed: int = 0) -> torch.Tensor:
    """int32[n] of random 32-bit words from `seed`, made on `device`."""
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(-(1 << 31), 1 << 31, (n,), dtype=torch.int32,
                         device=device, generator=g)


def issue_seeds(device, blocks_per_sm: int = 8, seed: int = 0
                ) -> torch.Tensor:
    """issue_chain's seeds: int32[threads, STREAMS], `blocks_per_sm`
    blocks of THREADS on every SM of the card."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    threads = sms * blocks_per_sm * roofline_cuda.THREADS
    return seeded_words(threads * roofline_cuda.STREAMS, device,
                        seed).view(threads, roofline_cuda.STREAMS)


def issue_peak_measure(seeds: torch.Tensor, iters: int = 8192,
                       reps: int = 10) -> dict:
    """Measured integer issue rate (thread instructions per second): the
    slope of issue_chain's best time from `iters` to 2 * iters. Returns
    rate, walls (the two best times, seconds), ops (in the slope region),
    iters and the launch's output at `iters`."""
    dev = seeds.device
    walls, outs = [], []
    for n in (iters, 2 * iters):
        t, out = _best_seconds(lambda n=n: roofline_cuda.issue_chain(seeds, n),
                               reps, dev)
        walls.append(t)
        outs.append(out)
    ops = roofline_cuda.issue_chain_ops(seeds.shape[0], iters)
    return dict(rate=ops / max(walls[1] - walls[0], 1e-12), walls=walls,
                ops=ops, iters=iters, out=outs[0])


def stream_measure(words: torch.Tensor, reps: int = 10) -> dict:
    """Measured device-memory read rate (bytes per second): the slope of
    stream_fold's best time from the first half of `words` to all of it.
    Returns rate, walls (seconds), bytes (in the slope region) and the
    fold of all the words."""
    dev = words.device
    half = words.numel() // 2
    walls, outs = [], []
    for x in (words[:half], words):
        t, out = _best_seconds(lambda x=x: roofline_cuda.stream_fold(x), reps,
                               dev)
        walls.append(t)
        outs.append(out)
    nbytes = 4 * (words.numel() - half)
    return dict(rate=nbytes / max(walls[1] - walls[0], 1e-12), walls=walls,
                bytes=nbytes, out=outs[1])


def dispatch_floor(device, reps: int = 20) -> float:
    """Best CUDA-event seconds of one empty kernel launch."""
    return _best_seconds(lambda: roofline_cuda.noop(device), reps, device)[0]


def sampled_sm_clock_mhz(fn) -> tuple[object, float]:
    """fn()'s result and the highest SM clock (MHz) nvidia-smi sampled
    while it ran (every 50 ms, from one sample before it started)."""
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
         "nounits", "-lms", "50"], stdout=subprocess.PIPE, text=True)
    try:
        first = proc.stdout.readline()
        out = fn()
    finally:
        proc.terminate()
        rest, _ = proc.communicate(timeout=30)
    samples = [float(v) for v in (first + rest).split() if v.strip()]
    if not samples:
        raise RuntimeError("nvidia-smi sampled no SM clock")
    return out, max(samples)


def issue_limit(device, sm_clock_mhz: float) -> float:
    """The issue ceiling: every SM's 4 schedulers issuing one 32-lane
    instruction per clock at the sampled SM clock."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return sms * 4 * 32 * sm_clock_mhz * 1e6


# ---------------------------------------------------------- SASS counting

CATEGORIES = ("arith", "shift", "popcount", "selcmp", "mem", "other")
ARITH = {"IADD3", "IADD", "IADD32I", "VIADD", "VIADDMNMX", "IMAD", "IMAD32I",
         "IMUL", "IMUL32I", "IMNMX", "VIMNMX", "VIMNMX3", "IABS", "LOP3",
         "LOP", "LOP32I", "LEA", "ISCADD", "ISCADD32I", "XMAD", "IDP",
         "IDP4A", "FADD", "FADD32I", "FMUL", "FMUL32I", "FFMA", "FFMA32I",
         "FMNMX", "DADD", "DMUL", "DFMA", "HADD2", "HMUL2", "HFMA2",
         "HMNMX2", "MUFU", "FSWZADD"}
SHIFT = {"SHF", "SHL", "SHR", "PRMT", "BMSK", "SGXT"}
POP = {"POPC", "FLO", "BREV"}
SELCMP = {"ISETP", "FSETP", "DSETP", "HSETP2", "SEL", "FSEL", "PLOP3",
          "PSETP", "ICMP", "FCMP", "CSET", "CSETP", "FCHK"}
MEM = {"LD", "LDG", "LDS", "LDL", "LDC", "LDSM", "LDGSTS", "ST", "STG",
       "STS", "STL", "ATOM", "ATOMG", "ATOMS", "RED", "TLD", "TEX", "SULD",
       "SUST", "UTMALDG", "UTMASTG"}
# control flow, moves, conversions, special registers and barriers
SKIP = {"BRA", "BRX", "BRXU", "JMP", "JMX", "CALL", "RET", "EXIT", "NOP",
        "MOV", "MOV32I", "MOVM", "S2R", "S2UR", "CS2R", "BAR", "BSSY",
        "BSYNC", "BREAK", "WARPSYNC", "DEPBAR", "YIELD", "MEMBAR", "ERRBAR",
        "CCTL", "CCTLL", "P2R", "R2P", "R2UR", "F2I", "I2F", "F2F", "I2I",
        "F2FP", "I2FP", "F2IP", "BMOV", "KILL", "BPT", "NANOSLEEP", "FENCE",
        "ELECT", "ENDCOLLECTIVE", "LEPC", "PMTRIG", "ACQBULK", "SYNCS"}
# opcodes whose modifier changes the category: ptxas's move and shift
# idioms on the multiply-add pipe
IDIOMS = {"IMAD.MOV": "skip", "IMAD.SHL": "shift"}
_BRANCHES = {"BRA", "JMP"}

_FUNC = re.compile(r"^\s*Function\s*:\s*(\S+)")
_INST = re.compile(r"^\s*/\*([0-9a-fA-F]+)\*/\s+([^;]*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L\w*)\s*:")
_TARGET_LABEL = re.compile(r"`\((\.L\w*)\)")
_TARGET_ADDR = re.compile(r"\b0x([0-9a-fA-F]+)\b")


def category(opcode: str) -> str:
    """The category of a SASS opcode (with modifiers, e.g. IMAD.MOV.U32):
    one of CATEGORIES, or "skip"."""
    parts = opcode.split(".")
    for n in range(len(parts), 1, -1):
        idiom = IDIOMS.get(".".join(parts[:n]))
        if idiom:
            return idiom
    base = parts[0]
    for table, cat in ((SKIP, "skip"), (ARITH, "arith"), (SHIFT, "shift"),
                       (POP, "popcount"), (SELCMP, "selcmp"), (MEM, "mem")):
        if base in table:
            return cat
    if base.startswith("U") and len(base) > 1:  # the uniform datapath
        return category(".".join([base[1:]] + parts[1:]))
    return "other"


def _cuobjdump() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    found = shutil.which("cuobjdump")
    if found:
        return found
    path = os.path.join(cuda_home, "bin", "cuobjdump")
    if os.path.exists(path):
        return path
    spec = importlib.util.find_spec("triton")
    if spec is not None and spec.submodule_search_locations:
        path = os.path.join(list(spec.submodule_search_locations)[0],
                            "backends", "nvidia", "bin", "cuobjdump")
        if os.path.exists(path):
            return path
    raise FileNotFoundError(
        "cuobjdump is in neither the CUDA toolkit's bin nor Triton's "
        "backends/nvidia/bin")


def _sections(listing: str) -> list[tuple[str, str]]:
    """(function name, its lines) of each function in a listing."""
    out, name, lines = [], None, []
    for ln in listing.splitlines():
        m = _FUNC.match(ln)
        if m:
            if name is not None:
                out.append((name, "\n".join(lines)))
            name, lines = m[1], [ln]
        elif name is not None:
            lines.append(ln)
    if name is not None:
        out.append((name, "\n".join(lines)))
    return out


def find_kernels(listing: str) -> list[str]:
    """The (mangled) names of the functions in a SASS listing."""
    return [name for name, _ in _sections(listing)]


def sass_listing(lib_path: str, function: str | None = None) -> str:
    """`cuobjdump -sass` of a built library; with `function`, only the
    one function whose mangled name contains it (raises if none or
    several do)."""
    res = subprocess.run([_cuobjdump(), "-sass", lib_path],
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        raise RuntimeError(f"cuobjdump failed ({res.returncode}): "
                           f"{res.stderr}")
    if function is None:
        return res.stdout
    hits = [text for name, text in _sections(res.stdout) if function in name]
    if len(hits) != 1:
        raise ValueError(f"{len(hits)} functions of {lib_path} match "
                         f"{function!r}: {find_kernels(res.stdout)}")
    return hits[0]


def _instructions(listing: str) -> list[tuple[int, str, str, str]]:
    """(address, opcode, operand text, predicate or "") of one function's
    instructions; branch operands resolved to addresses."""
    if len(_sections(listing)) > 1:
        raise ValueError("count one function at a time")
    insts, labels, pending = [], {}, []
    for ln in listing.splitlines():
        m = _LABEL.match(ln)
        if m:
            pending.append(m[1])
            continue
        m = _INST.match(ln)
        if not m:
            continue
        addr = int(m[1], 16)
        for lab in pending:
            labels[lab] = addr
        pending = []
        text = m[2].split()
        pred = text.pop(0) if text and text[0].startswith("@") else ""
        if not text:
            continue
        insts.append((addr, text[0], " ".join(text[1:]), pred))
    out = []
    for addr, op, rest, pred in insts:
        if op.split(".")[0] in _BRANCHES:
            m = _TARGET_LABEL.search(rest)
            if m and m[1] in labels:
                rest = hex(labels[m[1]])
        out.append((addr, op, rest, pred))
    return out


def _operands(rest: str) -> list[str]:
    return [t.strip() for t in rest.split(",")]


def loop_control(listing: str, loop: dict) -> list[tuple[int, str]]:
    """(address, opcode) of the instructions in `loop` (an entry of
    count_sass's loops) that keep its trip count: the compare that sets
    the predicate of its closing branch, and every instruction of the loop
    that writes a register that compare reads."""
    s, e = int(loop["start"], 16), int(loop["end"], 16)
    body = [i for i in _instructions(listing) if s <= i[0] <= e]
    pred = body[-1][3].lstrip("@!") if body else ""
    if not pred:  # closed by an unconditional branch: the exit test's
        exits = [i for i in body if i[1].split(".")[0] in _BRANCHES
                 and i[3] and _TARGET_ADDR.search(i[2])
                 and not s <= int(_TARGET_ADDR.search(i[2])[1], 16) <= e]
        pred = exits[-1][3].lstrip("@!") if exits else ""
    cmps = [i for i in body if i[1].split(".")[0].endswith("SETP")
            and _operands(i[2])[0] == pred]
    if not cmps:
        raise ValueError(f"no compare sets the predicate {pred!r} of the "
                         f"loop at {loop['start']}")
    cmp = cmps[-1]
    regs = {m[1] for m in (re.match(r"[-~!|]*(U?R\d+)", t)
                           for t in _operands(cmp[2])[1:]) if m}
    writes = [i for i in body if i is not cmp and i[1].split(".")[0] not in
              _BRANCHES and _operands(i[2])[0] in regs]
    return [(cmp[0], cmp[1])] + [(i[0], i[1]) for i in writes]


def _loops(insts) -> list[list[int]]:
    """[start, end] address ranges closed by backward branches (a branch
    to an earlier address; a branch to itself is the end-of-function trap,
    not a loop), merged per head and until properly nested; sorted
    outermost-first in address order."""
    heads = {}
    for addr, op, rest, _ in insts:
        if op.split(".")[0] not in _BRANCHES:
            continue
        m = _TARGET_ADDR.search(rest)
        if m and int(m[1], 16) < addr:
            t = int(m[1], 16)
            heads[t] = max(heads.get(t, addr), addr)
    loops = []
    for s, e in sorted(heads.items()):
        # a range that starts inside an earlier one and ends past it is
        # not nested: the two become one loop
        outer = [r for r in loops if r[0] < s <= r[1] < e]
        if outer:
            outer[-1][1] = e
        else:
            loops.append([s, e])
    return loops


def count_sass(listing: str, loop_weights=()) -> dict:
    """Charge every SASS instruction of one function to a category.

    loop_weights: the trips of each loop, outermost-first in address
    order (as `count_jaxpr` takes loop_iters); None, or a missing entry,
    charges that loop once. An instruction counts the product of the
    weights of the loops around it. Returns counts (per category),
    skipped (control flow, moves, conversions), and loops: per loop its
    address range, instruction count (nested ones included), depth,
    weight, whether a weight was given, and its own body's counts and
    opcodes (nested loops' excluded)."""
    insts = _instructions(listing)
    ranges = _loops(insts)
    weights = list(loop_weights)
    loops = []
    for i, (s, e) in enumerate(ranges):
        w = weights[i] if i < len(weights) else None
        loops.append(dict(
            start=hex(s), end=hex(e),
            insts=sum(1 for a, _, _, _ in insts if s <= a <= e),
            depth=sum(1 for s2, e2 in ranges[:i] if s2 <= s and e <= e2),
            weight=1.0 if w is None else float(w), weighted=w is not None,
            body={c: 0 for c in CATEGORIES + ("skip",)}, opcodes={}))
    counts = {c: 0.0 for c in CATEGORIES}
    skipped = 0.0
    for addr, op, _, _ in insts:
        mult, inner = 1.0, None
        for lp, (s, e) in zip(loops, ranges):
            if s <= addr <= e:
                mult *= lp["weight"]
                inner = lp  # ranges are outermost-first: the last is innermost
        cat = category(op)
        if inner is not None:
            inner["body"][cat] += 1
            inner["opcodes"][op] = inner["opcodes"].get(op, 0) + 1
        if cat == "skip":
            skipped += mult
        else:
            counts[cat] += mult
    return dict(counts=counts, skipped=skipped, loops=loops)


def warp_max_mean(values, warp: int = 32) -> float:
    """Mean over pairs, in launch order, of the largest value of each
    pair's warp (consecutive `warp` pairs; a partial last warp counts its
    own pairs)."""
    v = np.asarray(values, dtype=np.float64)
    n = v.size
    if n == 0:
        return 0.0
    pad = -n % warp
    m = np.concatenate([v, np.full(pad, -np.inf)]).reshape(-1, warp).max(1)
    sizes = np.full(m.size, warp)
    sizes[-1] = warp - pad
    return float((m * sizes).sum() / n)


def main_loop_weights(listing: str, weight: float) -> list:
    """loop_weights giving `weight` to the function's main loop, its
    largest outermost loop; every other loop is charged once."""
    loops = count_sass(listing)["loops"]
    top = [i for i, lp in enumerate(loops) if lp["depth"] == 0]
    if not top:
        raise ValueError("the function has no loop")
    i = max(top, key=lambda j: loops[j]["insts"])
    return [None] * i + [weight]


# the main-path instantiations: k = 3, L = 128 (W = 4); greedy on planes
# with int16 records, LEAP in penalty mode with x = o = e = 1
GREEDY_FN = "greedy_kernelILi3ELi4ELb1EsE"
LEAP_FN = "leap_kernelILi3ELi4ELi1ELi1ELi1ELb0E"


def kernel_counts(lib_path: str, function: str, trips) -> dict:
    """The function's SASS counted with its main loop weighted by the
    per-pair trip counts `trips` (launch order) under both weights:
    "mean" (the mean per pair) and "warp" (`warp_max_mean`). Returns
    weights, counts (count_sass per weight) and the function's name."""
    listing = sass_listing(lib_path, function)
    weights = {"mean": float(np.mean(trips)), "warp": warp_max_mean(trips)}
    return dict(function=find_kernels(listing)[0], weights=weights,
                counts={k: count_sass(listing, main_loop_weights(listing, w))
                        for k, w in weights.items()})


def greedy_counts(trips, lib_path: str | None = None) -> dict:
    """csrc/greedy.cu's main-path instantiation, its step loop weighted by
    the trips each pair ran (`greedy_cuda.step_trips`: its steps, plus one
    where the walk stopped on an empty highway)."""
    from asm_tpu_torch.kernels import greedy_cuda

    return kernel_counts(lib_path or greedy_cuda.build_kernel()[0],
                         GREEDY_FN, trips)


def leap_counts(levels, lib_path: str | None = None) -> dict:
    """csrc/leap.cu's main-path instantiation (lv_bag penalty mode), its
    energy loop weighted by the levels each pair ran
    (`utils.bounds.leap_levels`: one trip per level past e = 0).

    The kernel picks its semantics and the SHD gate at run time, so the
    instantiation's SASS holds the selection code of all three semantics
    and the gate's prologue, of which lv_bag runs only part: the count is
    no bound on lv_bag's issue time (report it with
    issue_is_bound=False)."""
    from asm_tpu_torch.kernels import leap_cuda

    return kernel_counts(lib_path or leap_cuda.build_kernel()[0], LEAP_FN,
                         levels)


def report(name: str, kc: dict, bytes_per_pair: float, seconds: float,
           n_pairs: int, issue_rate: float, stream_rate: float,
           recurrence_bound_ms: float, issue_is_bound: bool = True) -> dict:
    """One kernel's roofline line (printed as JSON, and returned): thread
    instructions per pair (one pair per thread) by category under both
    weights, and the measured time per pair beside the issue, stream and
    recurrence bounds. issue_is_bound=False marks a count that charges
    code the run does not reach: its issue time is then no bound, and the
    line states no binding wall and no headroom."""
    per = {k: c["counts"] for k, c in kc["counts"].items()}
    insts = {k: sum(v.values()) for k, v in per.items()}
    issue_ns = {k: v / issue_rate * 1e9 for k, v in insts.items()}
    stream_ns = bytes_per_pair / stream_rate * 1e9
    measured_ns = seconds / n_pairs * 1e9
    wall = max(issue_ns["warp"], stream_ns)
    line = {
        "kernel": name,
        "function": kc["function"],
        "loop_weights": kc["weights"],
        "loops": [dict({k: lp[k] for k in ("start", "end", "insts", "depth",
                                           "weighted")},
                       weight={k: c["loops"][i]["weight"]
                               for k, c in kc["counts"].items()})
                  for i, lp in enumerate(kc["counts"]["mean"]["loops"])],
        "thread_insts_per_pair": insts,
        "by_category_per_pair": per,
        "skipped_per_pair": {k: c["skipped"]
                             for k, c in kc["counts"].items()},
        "bytes_per_pair": bytes_per_pair,
        "measured_ns_per_pair": measured_ns,
        "issue_bound_ns_per_pair": issue_ns,
        "stream_bound_ns_per_pair": stream_ns,
        "issue_count_is_bound": issue_is_bound,
        "binding_wall": None if not issue_is_bound
        else "issue" if issue_ns["warp"] >= stream_ns else "stream",
        "headroom_x": measured_ns / wall if issue_is_bound else None,
        "divergence_x": insts["warp"] / max(insts["mean"], 1e-12),
        "recurrence_bound_ns_per_pair": recurrence_bound_ms * 1e6 / n_pairs,
    }
    print(json.dumps(line), flush=True)
    return line


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def micro(device, iters: int = 8192, stream_mib: int = 4096,
          reps: int = 10, keep_words: bool = False) -> tuple[dict, dict]:
    """The three microbenchmarks, with the issue rate's clock sampled
    while it runs. Returns the report line (rates, walls, the limits and
    utils.bounds' rates) and the raw measurements: issue and stream
    (`issue_peak_measure`, `stream_measure`), the issue seeds and, with
    keep_words, the 2 * stream_mib MiB of words streamed."""
    seeds = issue_seeds(device)
    issue, clock = sampled_sm_clock_mhz(
        lambda: issue_peak_measure(seeds, iters, reps))
    words = seeded_words(2 * stream_mib * (1 << 20) // 4, device, seed=1)
    stream = stream_measure(words, reps)
    if not keep_words:
        words = None
    line = dict(
        issue_ops_per_sec=issue["rate"],
        issue_walls_ms=[w * 1e3 for w in issue["walls"]],
        issue_iters=iters, issue_threads=seeds.shape[0],
        sm_clock_mhz=clock, issue_limit_ops_per_sec=issue_limit(device, clock),
        bounds_int32_ops_per_sec=INT32_OPS_PER_S,
        stream_bytes_per_sec=stream["rate"],
        stream_walls_ms=[w * 1e3 for w in stream["walls"]],
        stream_mib=[stream_mib, 2 * stream_mib],
        published_bytes_per_sec=HBM_BYTES_PER_S,
        dispatch_floor_us=dispatch_floor(device) * 1e6)
    return line, dict(issue=issue, stream=stream, seeds=seeds, words=words)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("rows", nargs="*", choices=("micro", "greedy", "leap"),
                    help="default: all three")
    ap.add_argument("--pairs", type=int, default=1 << 26)
    ap.add_argument("--chunk", type=int, default=1 << 25)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    args.rows = args.rows or ["micro", "greedy", "leap"]
    if not torch.cuda.is_available():
        raise SystemExit("the roofline measures the GPU; no CUDA device")
    dev = torch.device("cuda", 0)
    card = card_line()
    m = micro(dev)[0]
    log(f"issue {m['issue_ops_per_sec'] / 1e12:.3f} T ops/s, stream "
        f"{m['stream_bytes_per_sec'] / 1e12:.3f} TB/s on {card}")
    if "micro" in args.rows:
        print(json.dumps(dict(m, device=torch.cuda.get_device_name(0),
                              card=card)), flush=True)
    if "greedy" in args.rows:
        from asm_tpu_torch import headline
        from asm_tpu_torch.utils.bounds import greedy_work

        res = headline.run(args.pairs, args.chunk, reps=args.reps, device=dev)
        n = res["n_pairs"]
        nbytes = greedy_work(res["steps"], res["bounds"], args.chunk)[1]
        report("greedy", greedy_counts(res["trips"]), nbytes / n,
               min(res["rep_s"]), n, m["issue_ops_per_sec"],
               m["stream_bytes_per_sec"], res["bound"]["bound_ms"])
        del res
    if "leap" in args.rows:
        from asm_tpu_torch import leap_headline
        from asm_tpu_torch.utils.bounds import leap_levels, leap_work

        res = leap_headline.run(args.pairs, args.chunk, reps=args.reps,
                                device=dev, which=("leap",))
        lp = res["leap"]
        n = res["n_pairs"]
        cat = {k: torch.cat([o[k] for o in lp["outs"]]).cpu().numpy()
               for k in ("passed", "penalty", "lane_shift")}
        af = leap_headline.leap_config().leap_af_threshold
        levels = leap_levels(cat["passed"], cat["penalty"],
                             cat["lane_shift"], af)
        nbytes = leap_work(n, n + int(levels.sum()))[1]
        report("leap", leap_counts(levels), nbytes / n, min(lp["rep_s"]), n,
               m["issue_ops_per_sec"], m["stream_bytes_per_sec"],
               lp["bound"]["bound_ms"], issue_is_bound=False)
    print(card, flush=True)


if __name__ == "__main__":
    main()
