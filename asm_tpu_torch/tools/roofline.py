"""Roofline of the port's greedy and LEAP kernels on the card (port of
tools/roofline.py).

Three measurements, one report:

1. The card's integer issue rate, measured: `issue_peak_measure` times the
   issue_chain kernel (csrc/roofline.cu: independent dependent chains of
   v = (v + 1) ^ 12345 on every thread of a grid that fills the card) at
   `iters` and 2 * iters iterations; the rate is the slope, so launch and
   tail costs cancel.
   `chain_measure` does the same for each of op_chain's opcodes (a DPX
   add-min, a min / max, a compare and select, a multiply-add, an add,
   add-min beside multiply-add, a DPX three-way min / max, an add beside
   a xor): its lanes per cycle per SM at the sampled clock, 128 at the
   full issue rate, 64 on a half-rate pipe.
2. The card's device-memory read rate, measured: `stream_measure` times
   the stream_fold kernel (the xor of every word of an array) on 4096 and
   8192 MiB of seeded random words; the rate is the slope.
3. What the kernels issue, counted: `count_sass` reads the SASS ptxas
   generated (`cuobjdump -sass` of the built library), charges every
   instruction to a category, and charges each loop body at a weight
   read from the run's own outputs (greedy: the step loop's trips a pair
   ran, `greedy_cuda.step_trips`, and each loop over the 2k+1 lanes
   inside it 2k+1 times per trip; LEAP: the energy levels it ran,
   `utils.bounds.leap_levels`). Each kernel is
   counted under two weights: the mean per pair (the JAX tool's basis),
   and the mean over 32-pair warps, in launch order, of the warp's
   largest, which is what a warp issues; their ratio is the kernel's
   divergence factor.

`report` sets the kernel's measured time per pair beside its issue bound
(instructions / the measured issue rate), its stream bound (bytes / the
measured stream rate) and its recurrence bound (`utils.bounds`, the
fewest operations at the card's issue limit), with the rate the run
issued its count at and one trip of the main loop by category and by
opcode. Each line also carries the main-path instantiation's registers
and spill bytes (its ptxas report) and warps per SM (the occupancy
query: `greedy_resources`, `leap_resources`). The rates of
`utils/bounds.py` stay; this tool prints the measured ones beside them.

    python -m asm_tpu_torch.tools.roofline [micro greedy leap nw] [--pairs N]
        [--err R]

runs the greedy and LEAP headline flows in-process at --pairs (default
67,108,864, the headlines' corpus) and prints one JSON line for the
microbenchmarks and one per kernel. The nw row (not in the default set)
runs the NW headline flow at --err and prints, per band width, the band
kernel's diagonal loop (`nw_band_loop`: SASS instructions per existing
cell, the warp maximum of m+n against its mean) beside the dispatches'
times. Needs one CUDA card, and cuobjdump (the CUDA toolkit's, or the
copy bundled with Triton).
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
from asm_tpu_torch.kernels.shapes import LONG_W, nw_long_rows, nw_rows
from asm_tpu_torch.utils.bounds import HBM_BYTES_PER_S, INT32_OPS_PER_S
from asm_tpu_torch.utils.build import ptxas_usage
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


def chain_measure(seeds: torch.Tensor, op: str, iters: int = 8192,
                  reps: int = 10) -> dict:
    """Measured issue rate of op_chain's `op` (thread instructions per
    second in its chains): the slope of its best time from `iters` to 2 *
    iters. Returns rate, walls (seconds), ops (in the slope region), iters
    and the launch's output at `iters`."""
    dev = seeds.device
    walls, outs = [], []
    for n in (iters, 2 * iters):
        t, out = _best_seconds(
            lambda n=n: roofline_cuda.op_chain(seeds, n, op), reps, dev)
        walls.append(t)
        outs.append(out)
    ops = roofline_cuda.op_chain_ops(seeds.shape[0], iters, op)
    return dict(rate=ops / max(walls[1] - walls[0], 1e-12), walls=walls,
                ops=ops, iters=iters, out=outs[0])


def chain_census(lib_path: str, op: str) -> dict:
    """The loop of op_chain<op>'s SASS: its opcodes, and the instructions
    of the op's opcodes (roofline_cuda.OP_SASS, by stem) outside its trip
    control (`loop_control`) beside the STREAMS x UNROLL x OP_INSTS the
    rate divides by."""
    sass = sass_listing(lib_path, f"op_chainILi{roofline_cuda.OPS.index(op)}E")
    loops = [lp for lp in count_sass(sass)["loops"] if lp["depth"] == 0]
    if len(loops) != 1:
        raise ValueError(f"op_chain {op}: expected one loop, got {loops}")
    ops = loops[0]["opcodes"]
    stems = roofline_cuda.OP_SASS[op]
    control = [o for _, o in loop_control(sass, loops[0])]
    return dict(opcodes=ops, chain_insts=sum(
        v for k, v in ops.items() if k.split(".")[0] in stems) - sum(
        o.split(".")[0] in stems for o in control),
        expected=roofline_cuda.STREAMS * roofline_cuda.UNROLL
        * roofline_cuda.OP_INSTS[op])


def lanes_per_cycle_per_sm(rate: float, device, sm_clock_mhz: float) -> float:
    """A rate of thread instructions per second as lanes a cycle on each
    SM at the sampled clock: 128 is the full issue rate (4 schedulers x 32
    lanes), 64 a half-rate pipe."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return rate / (sms * sm_clock_mhz * 1e6)


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
    opcodes = {}
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
        opcodes[op] = opcodes.get(op, 0.0) + mult
    return dict(counts=counts, skipped=skipped, opcodes=opcodes, loops=loops)


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


def main_loop_weights(listing: str, weight: float,
                      inner: float | None = None) -> list:
    """loop_weights giving `weight` to the function's main loop, its
    largest outermost loop, and `inner` to each loop nested in it (trips
    per trip of the loop around it; None charges them once); every other
    loop is charged once."""
    loops = count_sass(listing)["loops"]
    top = [i for i, lp in enumerate(loops) if lp["depth"] == 0]
    if not top:
        raise ValueError("the function has no loop")
    i = max(top, key=lambda j: loops[j]["insts"])
    if inner is None:
        return [None] * i + [weight]
    s, e = (int(loops[i][k], 16) for k in ("start", "end"))
    return [None] * i + [weight] + [
        inner if s <= int(lp["start"], 16) <= e else None
        for lp in loops[i + 1:]]


def count_kernel(listing: str, trips, inner: float | None = None) -> dict:
    """One function's SASS counted with its main loop weighted by the
    per-pair trip counts `trips` (launch order) under both weights: "mean"
    (the mean per pair) and "warp" (`warp_max_mean`), and each loop nested
    in it by `inner` (its trips per main-loop trip). Returns weights,
    counts (count_sass per weight), trip (one main-loop trip, nested loops
    at `inner`: by category with "skip", and by opcode) and the function's
    name."""
    weights = {"mean": float(np.mean(trips)), "warp": warp_max_mean(trips)}
    one, zero = (count_sass(listing, main_loop_weights(listing, w, inner))
                 for w in (1.0, 0.0))
    trip = {c: one["counts"][c] - zero["counts"][c] for c in CATEGORIES}
    trip["skip"] = one["skipped"] - zero["skipped"]
    opcodes = {op: n - zero["opcodes"].get(op, 0.0)
               for op, n in one["opcodes"].items()}
    return dict(function=find_kernels(listing)[0], weights=weights,
                counts={k: count_sass(listing,
                                      main_loop_weights(listing, w, inner))
                        for k, w in weights.items()},
                trip=dict(by_category=trip, opcodes={
                    op: n for op, n in sorted(opcodes.items(),
                                              key=lambda t: -t[1]) if n}))


def greedy_fn(k: int = 3, max_len: int = 128) -> str:
    """Mangled-name stem of csrc/greedy.cu's instantiation at (k, max_len)
    on planes (int16 records at max_len <= 255, else int32; the long-row
    kernel above LONG_W words)."""
    rec = "s" if max_len <= 255 else "i"
    long = max_len // 32 > LONG_W
    return (f"greedy{'_long' if long else ''}_kernelILi{k}ELi{max_len // 32}"
            f"ELb1E{rec}E")


def leap_fn(k: int = 3, max_len: int = 128, cigar: bool = False,
            pens=(1, 1, 1), sem: int = 0, planes: bool = True) -> str:
    """Mangled-name stem of csrc/leap.cu's instantiation at (k, max_len,
    (x, o, e)), semantics `sem` (its SEM: 0 lv_bag, 1 simd_ed_lev, 2
    simd_ed_affine, 3 simd_ed_lev behind the SHD gate; default lv_bag) on
    planes or codes, in penalty or CIGAR mode (the long-row kernel above
    LONG_W words)."""
    x, o, e = pens
    long = max_len // 32 > LONG_W
    return (f"leap{'_long' if long else ''}_kernelILi{k}ELi{max_len // 32}"
            f"ELi{x}ELi{o}ELi{e}ELi{sem}ELb{int(cigar)}ELb{int(planes)}E")


# the main-path instantiations: k = 3, L = 128 (W = 4); greedy on planes
# with int16 records, LEAP in penalty mode (lv_bag, SEM 0) with x = o = e
# = 1 on planes
GREEDY_FN = greedy_fn()
GREEDY_LANES = 7  # 2k + 1 at k = 3: the trips of each lane loop per step
LEAP_FN = leap_fn()


def greedy_counts(trips, lib_path: str | None = None) -> dict:
    """csrc/greedy.cu's main-path instantiation, its step loop weighted by
    the trips each pair ran (`greedy_cuda.step_trips`: its steps, plus one
    where the walk stopped on an empty highway) and the one loop inside
    it, the rolled highway update over the 2k+1 lanes, by GREEDY_LANES.
    Raises if the step loop holds another number of loops: a loop ptxas
    unswitches into two copies, of which a trip runs one, would be
    charged twice."""
    from asm_tpu_torch.kernels import greedy_cuda

    kc = count_kernel(sass_listing(lib_path or greedy_cuda.build_kernel()[0],
                                   GREEDY_FN), trips, inner=GREEDY_LANES)
    nested = [lp for lp in kc["counts"]["mean"]["loops"] if lp["depth"]]
    if len(nested) != 1:
        raise ValueError(f"the step loop holds {len(nested)} loops, not the "
                         f"one lane loop the count weights: {nested}")
    return kc


def ptxas_entry(module, function: str, report: str | None = None) -> dict:
    """Registers and spill bytes of one instantiation from its ptxas report
    (text; default: the current build of `module`, a kernel module with
    build_kernel and ptxas_report)."""
    if report is None:
        module.build_kernel()
        with open(module.ptxas_report()) as f:
            report = f.read()
    hits = [v for k, v in ptxas_usage(report).items() if function in k]
    if len(hits) != 1:
        raise ValueError(f"{len(hits)} kernels of the ptxas report match "
                         f"{function!r}")
    return hits[0]


def greedy_resources(report: str | None = None, k: int = 3,
                     max_len: int = 128) -> dict:
    """`ptxas_entry` of greedy's instantiation at (k, max_len) on planes
    (default: the main path's; the report of the library holding the
    shape) and, from the card, its resident warps per SM
    (`greedy_cuda.occupancy`: the block size is per instantiation)."""
    from asm_tpu_torch.kernels import greedy_cuda

    if report is None:
        greedy_cuda.build_kernel(k, max_len)
        with open(greedy_cuda.ptxas_report(k, max_len)) as f:
            report = f.read()
    return dict(ptxas_entry(greedy_cuda, greedy_fn(k, max_len), report),
                warps_per_sm=greedy_cuda.occupancy(k, max_len))


def leap_resources(report: str | None = None, k: int = 3,
                   max_len: int = 128, cigar: bool = False,
                   pens=(1, 1, 1)) -> dict:
    """`ptxas_entry` of LEAP's lv_bag instantiation at (k, max_len, CIGAR
    mode, penalties) on planes (default: the main path's; the report of
    the library holding the shape) and, from the card, its resident
    blocks and warps per SM (`leap_cuda.occupancy`, blocks of the
    shape's threads)."""
    from asm_tpu_torch.kernels import leap_cuda

    if report is None:
        leap_cuda.build_kernel(k, max_len, pens)
        with open(leap_cuda.ptxas_report(k, max_len, pens)) as f:
            report = f.read()
    threads = leap_cuda.plan(k, max_len, pens).threads
    blocks = leap_cuda.occupancy(k, max_len, cigar, pens)
    return dict(ptxas_entry(leap_cuda, leap_fn(k, max_len, cigar, pens),
                            report),
                blocks_per_sm=blocks, warps_per_sm=blocks * threads // 32)


def leap_counts(levels, lib_path: str | None = None) -> dict:
    """csrc/leap.cu's main-path instantiation (lv_bag penalty mode), its
    energy loop weighted by the levels each pair ran
    (`utils.bounds.leap_levels`: one trip per level past e = 0). The
    semantics and the input route are template parameters and the mode
    is selected without a branch, so the instantiation holds only code
    the main path runs: its count bounds the issue time. Raises unless
    the function holds exactly one loop, the energy loop: a second copy
    (a loop compiled once per mode) would be charged once for nothing."""
    from asm_tpu_torch.kernels import leap_cuda

    kc = count_kernel(sass_listing(lib_path or leap_cuda.build_kernel()[0],
                                   LEAP_FN), levels)
    loops = kc["counts"]["mean"]["loops"]
    if len(loops) != 1:
        raise ValueError(f"the LEAP kernel holds {len(loops)} loops, not the "
                         f"one energy loop the count weights: {loops}")
    return kc


# csrc/nw_band.cu's band_kernel: BW/2 threads per pair (64/BW pairs per
# warp), each computing one existing cell per diagonal with two shuffles;
# its wide path (band_wide_kernel): NP cells a thread and diagonal
# (shapes.band_wide_np), one shuffle a diagonal, none where a pair is one
# thread. Either loads two code bytes a trip (LDS.U8).
BAND_SHFL_PER_DIAGONAL = 2
WIDE_SHFL_PER_DIAGONAL = 1
BAND_LOADS_PER_TRIP = 2


def band_function(bw: int, L: int = 128) -> str:
    """The mangled name of band_kernel<BW, W> at max_len L (W = L/32)."""
    return f"band_kernelILi{bw}ELi{L // 32}E"


def wide_function(bw: int, L: int) -> str:
    """The mangled name of band_wide_kernel<BW, W> at max_len L."""
    return f"band_wide_kernelILi{bw}ELi{L // 32}E"


def nw_band_loop(listing: str, bw: int, lens_sum, np_: int = 1,
                 shfl_per_diagonal: int = BAND_SHFL_PER_DIAGONAL) -> dict:
    """The diagonal loop of one band-kernel instantiation (of the loops of
    its SASS that hold shuffles, the one with the fewest instructions per
    existing cell: the wide kernel's main loop, beside its border and
    destination loops): its body's instructions (all of them, by category
    and by opcode), the existing cells a thread's trip computes (`np_`
    offset pairs a thread, shapes.band_wide_np on the wide path: np_ x its
    shuffles over `shfl_per_diagonal`, so an unrolled loop counts right;
    where a pair is one thread, bw = 2 np_, there are no shuffles, and
    2 np_ x its code loads over BAND_LOADS_PER_TRIP), and the instructions
    per existing cell; and the m+n of the pairs it ran, in launch order
    (`lens_sum`): the mean, the mean of each warp's largest
    (`warp_max_mean` over 32 / SEG pairs per warp, SEG = bw / (2 np_)
    threads a pair), which bounds the warp's trips, and their ratio."""
    seg = bw // (2 * np_)
    if seg < 1 or 32 % seg:
        raise ValueError(f"BW {bw} at {np_} offset pairs a thread takes "
                         f"{bw / (2 * np_)} threads a pair, not a divisor "
                         f"of 32")
    ppw = 32 // seg

    def count(lp, prefix):
        return sum(v for op, v in lp["opcodes"].items()
                   if op.startswith(prefix))

    if seg > 1:
        def cells(lp):
            return np_ * count(lp, "SHFL") / shfl_per_diagonal
    else:
        def cells(lp):
            return 2 * np_ * count(lp, "LDS.U8") / BAND_LOADS_PER_TRIP
    loops = [lp for lp in count_sass(listing)["loops"] if cells(lp)]
    if not loops:
        raise ValueError("expected a loop with shuffles (or, a pair on one "
                         "thread, code loads), got none")
    lp = min(loops, key=lambda lp: sum(lp["body"].values()) / cells(lp))
    insts = sum(lp["body"].values())
    mn = np.asarray(lens_sum, dtype=np.float64)
    mean = float(mn.mean()) if mn.size else 0.0
    warp = warp_max_mean(mn, ppw)
    return dict(function=find_kernels(listing)[0], pairs_per_warp=ppw,
                offset_pairs_per_thread=np_, diagonal_loops=len(loops),
                loop_shuffles=count(lp, "SHFL"),
                existing_cells_per_trip=cells(lp), loop_insts=insts,
                loop_body={k: v for k, v in lp["body"].items() if v},
                loop_opcodes=lp["opcodes"],
                loop_insts_per_existing_cell=insts / cells(lp),
                mn_mean=mean, mn_warp_max_mean=warp,
                mn_divergence_x=warp / mean if mean else 1.0)


# csrc/nw.cu's full and trace kernels: two shuffles per step of the main
# loop (in the one-warp-per-pair layout: per diagonal), in either layout
NW_SHFL_PER_STEP = 2


def nw_loop_counts(listing: str, warp_steps, cells: float,
                   lanes_per_pair: int, rows_per_thread: int,
                   walk_steps=None, loop_steps=None) -> dict:
    """The step loop of one NW full or trace instantiation (the loop of its
    SASS that holds shuffles, or with `loop_steps` each of them) and, with
    `walk_steps` (the traceback's steps per pair, launch order), the walk
    loop (the largest other outermost loop that stores: to global memory
    on the short path, to the shared ops row on the long one, whose body
    also holds its tile switch, run once every ~64 steps). `warp_steps`:
    the steps each warp ran (csrc/nw.cu: `nw_cuda.warp_steps`; the
    one-warp-per-pair layout, one pair per warp: m + n); `cells`: the
    run's existing cells, sum of m * n; each step a thread computes
    `rows_per_thread` cell slots. `loop_steps`: where the step loop is
    split (the long full kernel's head, steady loop and tail:
    `nw_cuda.loop_steps`), the steps each part ran over the run, in the
    parts' address order; the SASS must hold that many loops with
    shuffles, and each is weighted by its own steps.

    Returns the loop's instructions per trip (by category and opcode; of
    a split loop, its most-run part's), the steps a trip covers (its
    shuffles over NW_SHFL_PER_STEP: an unrolled loop counts right),
    instructions per step (a split loop's mean over the steps) and per
    cell slot, the share of the slots that are existing cells, and the
    thread instructions the step loops issue per existing cell (32 lanes
    x the steps x instructions per step / cells); of a split loop also
    each part's steps and instructions; with the walk, its instructions
    per step and the steps per pair (mean, and the mean of the warp
    maximum over the 32 / lanes_per_pair walkers of a warp)."""
    loops = count_sass(listing)["loops"]
    main = [lp for lp in loops
            if any(op.startswith("SHFL") for op in lp["opcodes"])]
    if not main:
        raise ValueError("expected a loop with shuffles, got none")

    def per_step(lp):
        shfl = sum(v for op, v in lp["opcodes"].items()
                   if op.startswith("SHFL"))
        insts = sum(lp["body"].values())
        return insts, shfl / NW_SHFL_PER_STEP, insts * NW_SHFL_PER_STEP / shfl

    total = float(np.sum(np.asarray(warp_steps, dtype=np.float64)))
    parts = None
    if loop_steps is None:
        # the long trace kernel's step loop may be compiled twice (its
        # first block and the later ones): count the longer copy
        lp = max(main, key=lambda x: sum(x["body"].values()))
        insts, steps_per_trip, mean_step = per_step(lp)
    else:
        weights = [float(w) for w in loop_steps]
        if len(main) != len(weights):
            raise ValueError(f"expected {len(weights)} step loops with "
                             f"shuffles, got {len(main)}: "
                             f"{[x['start'] for x in main]}")
        if abs(sum(weights) - total) > 1e-6 * max(total, 1.0):
            raise ValueError(f"the loops' steps {weights} do not sum to the "
                             f"warps' {total}")
        parts = [dict(start=x["start"], steps=w, insts_per_step=per_step(x)[2],
                      body={k: v for k, v in x["body"].items() if v})
                 for x, w in zip(main, weights)]
        lp = main[int(np.argmax(weights))]
        insts, steps_per_trip, _ = per_step(lp)
        mean_step = (sum(p["steps"] * p["insts_per_step"] for p in parts)
                     / total if total else 0.0)
    slots = 32 * rows_per_thread * total
    out = dict(function=find_kernels(listing)[0],
               lanes_per_pair=lanes_per_pair,
               rows_per_thread=rows_per_thread,
               loop_insts=insts, steps_per_trip=steps_per_trip,
               loop_body={k: v for k, v in lp["body"].items() if v},
               loop_opcodes=lp["opcodes"], insts_per_step=mean_step,
               insts_per_slot=mean_step / rows_per_thread,
               warp_steps=total, existing_cells=float(cells),
               existing_share=float(cells) / slots if slots else 0.0,
               insts_per_existing_cell=32 * total * mean_step / cells
               if cells else 0.0)
    if parts is not None:
        out["loop_parts"] = parts
    elif len(main) > 1:
        out["loop_copies"] = len(main)
    if walk_steps is None:
        return out
    walks = [w for w in loops if w is not lp and w["depth"] == 0
             and any(op.startswith(("STG", "ST.", "STS"))
                     for op in w["opcodes"])
             and not any(op.startswith("SHFL") for op in w["opcodes"])]
    if len(walks) > 1:  # the long path also zeroes and copies its rows
        walks = [max(walks, key=lambda w: sum(w["body"].values()))]
    if len(walks) != 1:
        raise ValueError(f"expected one walk loop, got {walks}")
    ws = np.asarray(walk_steps, dtype=np.float64)
    out.update(walk_insts_per_step=float(sum(walks[0]["body"].values())),
               walk_body={k: v for k, v in walks[0]["body"].items() if v},
               walk_opcodes=walks[0]["opcodes"],
               walk_steps_mean=float(ws.mean()) if ws.size else 0.0,
               walk_steps_warp_max_mean=warp_max_mean(
                   ws, 32 // lanes_per_pair))
    return out


def nw_resources(trace: bool, L: int = 128,
                 report: str | None = None) -> dict:
    """`ptxas_entry` and resident warps per SM (`nw_cuda.occupancy`) of
    the NW instantiation the wrapper launches for (trace, L)."""
    from asm_tpu_torch.kernels import nw_cuda

    if report is None:
        nw_cuda.build_kernel(L)
        with open(nw_cuda.ptxas_report(L)) as f:
            report = f.read()
    return dict(ptxas_entry(nw_cuda, nw_cuda.function_name(trace, L), report),
                warps_per_sm=nw_cuda.occupancy(trace, L))


def nw_line(name: str, m, n, ms: float, bound: dict, ops=None,
            max_len: int = 128) -> dict:
    """The roofline line of the NW full (`name` "nw") or trace
    ("nw_trace", with its `ops` int8[B, 2L] for the walk's steps) kernel
    on one launch's pairs: lengths m, n (launch order, max_len L read from
    ops, else `max_len`), its measured ms and its bound (`utils.bounds.
    bound_entry`): `nw_loop_counts` of the instantiation the wrapper
    launches (above max_len 512 the full kernel's three step loops each
    weighted by `nw_cuda.loop_steps`), `nw_resources`, and the time over
    the bound."""
    from asm_tpu_torch.kernels import nw_cuda

    trace = name == "nw_trace"
    L = ops.shape[1] // 2 if ops is not None else max_len
    G, route = nw_cuda.instance(trace, L)
    m = np.minimum(np.asarray(m, np.int64), L)
    n = np.minimum(np.asarray(n, np.int64), L)
    walk = (np.asarray(ops) != 0).sum(1) if trace else None
    long = L // 32 > LONG_W
    counts = nw_loop_counts(
        sass_listing(nw_cuda.build_kernel(L)[0],
                     nw_cuda.function_name(trace, L)),
        nw_cuda.warp_steps(m, n, L, G), float(np.sum(m * n)), G,
        nw_long_rows(L) if long else nw_rows(L, G), walk,
        nw_cuda.loop_steps(m, n, L) if long and not trace else None)
    line = dict(kernel=name, max_len=L, G=G, route=route, pairs=int(m.size),
                **counts, **nw_resources(trace, L), ms=ms,
                bound_ms=bound["bound_ms"], bound_by=bound["bound_by"],
                bound_share=bound["bound_ms"] / ms)
    print(json.dumps(line), flush=True)
    return line


def plan_max_len(plan) -> int:
    """max_len L of an NW plan's chunks: planes [L/16, b] or codes [b, L]."""
    rc = plan.chunks[0][0]
    return 16 * rc.shape[0] if plan.pre_staged else rc.shape[1]


def nw_band_lines(res: dict, lib_path: str) -> list[dict]:
    """One roofline line per band width of an NW headline run
    (`nw_headline.run`'s result): `nw_band_loop` of the instantiation at
    the run's max_len in `lib_path` (the band kernel's library), over the
    m+n of that width's dispatches in launch order, lengths clamped to
    max_len as the kernel clamps them, with the dispatches' pairs and
    best-rep ms. Prints each line as JSON."""
    plan = res["plan"]
    ms = res["best"]["dispatch_ms"]
    L = plan_max_len(plan)
    lines = []
    for bw in sorted({w for w in plan.widths if w}):
        idx = [i for i, w in enumerate(plan.widths) if w == bw]
        mn = np.concatenate([
            (plan.chunks[i][1].clamp(max=L) + plan.chunks[i][3].clamp(
                max=L)).cpu().numpy() for i in idx])
        line = dict(kernel="nw_band", bw=bw, max_len=L,
                    **nw_band_loop(sass_listing(lib_path,
                                                band_function(bw, L)),
                                   bw, mn),
                    pairs=int(mn.size), dispatch_ms=[ms[i] for i in idx])
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


def report(name: str, kc: dict, bytes_per_pair: float, seconds: float,
           n_pairs: int, issue_rate: float, stream_rate: float,
           recurrence_bound_ms: float, issue_is_bound: bool = True,
           resources: dict | None = None) -> dict:
    """One kernel's roofline line (printed as JSON, and returned): thread
    instructions per pair (one pair per thread) by category under both
    weights, one trip of the main loop (nested loops at their weight) by
    category and by opcode, and the measured time per pair beside the issue, stream and
    recurrence bounds, with the rate at which the run issued its count
    (the warp weight's instructions x pairs / seconds). issue_is_bound=
    False marks a count that charges code the run does not reach: its
    issue time is then no bound, and the line states no binding wall, no
    headroom and no issued rate. `resources` (registers, spills, warps per
    SM: `greedy_resources`, `leap_resources`) joins the line as it is."""
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
        "issued_thread_insts_per_sec": insts["warp"] * n_pairs / seconds
        if issue_is_bound else None,
        "main_loop_trip": {k: v for k, v in kc["trip"]["by_category"].items()
                           if v},
        "main_loop_trip_opcodes": kc["trip"]["opcodes"],
        **(resources or {}),
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
    """The microbenchmarks, with the clock sampled while the issue rate and
    while the chains run. Returns the report line (rates, walls, the
    limits, utils.bounds' rates, and per op_chain opcode its rate and lanes
    per cycle per SM) and the raw measurements: issue, chains and stream
    (`issue_peak_measure`, `chain_measure` per op, `stream_measure`), the
    issue seeds (the chains' too) and, with keep_words, the 2 * stream_mib
    MiB of words streamed."""
    seeds = issue_seeds(device)
    issue, clock = sampled_sm_clock_mhz(
        lambda: issue_peak_measure(seeds, iters, reps))
    chains, chain_clock = sampled_sm_clock_mhz(
        lambda: {op: chain_measure(seeds, op, iters, reps)
                 for op in roofline_cuda.OPS})
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
        chain_sm_clock_mhz=chain_clock,
        chains={op: dict(ops_per_sec=c["rate"],
                         lanes_per_cycle_per_sm=lanes_per_cycle_per_sm(
                             c["rate"], device, chain_clock),
                         walls_ms=[w * 1e3 for w in c["walls"]])
                for op, c in chains.items()},
        stream_bytes_per_sec=stream["rate"],
        stream_walls_ms=[w * 1e3 for w in stream["walls"]],
        stream_mib=[stream_mib, 2 * stream_mib],
        published_bytes_per_sec=HBM_BYTES_PER_S,
        dispatch_floor_us=dispatch_floor(device) * 1e6)
    return line, dict(issue=issue, chains=chains, stream=stream, seeds=seeds,
                      words=words)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("rows", nargs="*",
                    choices=("micro", "greedy", "leap", "nw"),
                    help="default: micro, greedy and leap")
    ap.add_argument("--pairs", type=int, default=1 << 26)
    ap.add_argument("--chunk", type=int, default=1 << 25)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--err", type=float, default=0.05,
                    help="the nw row's error rate")
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
        lib = roofline_cuda.build_kernel()[0]
        for op, c in m["chains"].items():
            c.update(census=chain_census(lib, op))
        log("lanes a cycle per SM: " + ", ".join(
            f"{op} {c['lanes_per_cycle_per_sm']:.1f}"
            for op, c in m["chains"].items()))
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
               m["stream_bytes_per_sec"], res["bound"]["bound_ms"],
               resources=greedy_resources())
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
               lp["bound"]["bound_ms"], resources=leap_resources())
    if "nw" in args.rows:
        from asm_tpu_torch import nw_headline
        from asm_tpu_torch.kernels import nw_band

        res = nw_headline.run(args.pairs, args.chunk, args.err,
                              reps=args.reps, device=dev)
        log(f"nw rep {min(res['rep_s']) * 1e3:.3f} ms, bound "
            f"{res['bound']['bound_ms']:.3f} ms, checksum {res['checksum']}")
        nw_band_lines(res, nw_band.build_kernel()[0])
    print(card, flush=True)


if __name__ == "__main__":
    main()
