"""One run of one cell: load it by name, make its pool, warm up, measure a
closed-loop window of jobs, read the trace where asked, and hold the
window's answers against the plain reference.

Everything a cell is made of is found by name: its entry in
BENCHMARK.json, its configuration file (the entry's `file`), its mix
(`perfbench/mixes/<traffic>.json`), the job kind the mix names
(`perfbench/jobs/<kind>.py`, `perfbench/reference/<kind>.py`) and one
reader a per-layer metric (`perfbench/metrics/<metric>.py`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from perfbench import trace as tracing
from perfbench.generator import make_pool

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "asm_tpu")
INPUTS = ("read", "read_len", "ref", "ref_len")
TRACE_SECONDS = 4.0  # the longest traced stretch


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    mix: dict
    end_to_end: list   # metric entries of BENCHMARK.json this cell reports
    per_layer: list

    @property
    def kind(self) -> str:
        return self.mix["job"]


def _reports(metric: dict, name: str) -> bool:
    return "workloads" not in metric or name in metric["workloads"]


def load_cell(root: str, name: str) -> Cell:
    """The cell `name` of root/BENCHMARK.json, with its configuration and
    mix read from their files under root."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "perfbench", "mixes",
                           w["traffic"] + ".json")) as f:
        mix = json.load(f)
    return Cell(name, config, mix,
                [m for m in bench["end_to_end"] if _reports(m, name)],
                [m for m in bench["per_layer"] if _reports(m, name)])


def _module(folder: str, name: str):
    """perfbench/<folder>/<name>.py: a job kind or a reference by import,
    a metric's reader by its file (a metric's name may hold dots)."""
    if folder != "metrics":
        return importlib.import_module(f"perfbench.{folder}.{name}")
    spec = importlib.util.spec_from_file_location(
        f"perfbench.metrics.{name}", os.path.join(PKG_DIR, folder,
                                                  name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the benchmark must never
    load (the JAX stack and the JAX package), compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def to_numpy(v) -> np.ndarray:
    return v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


class Reservoir:
    """A uniform sample of `size` of the window's jobs, drawn from the
    seed as they complete (Li's Algorithm L: the generator is drawn only
    when a job enters the sample, so a job that does not costs the loop
    one comparison)."""

    def __init__(self, size: int, rng: np.random.Generator):
        if size < 1:
            raise ValueError(f"a sample of {size} jobs")
        self.size, self.rng, self.items, self.seen = size, rng, [], 0
        self.w, self.next = 1.0, size - 1

    def _u(self) -> float:
        return 1.0 - float(self.rng.random())  # in (0, 1]

    def _skip(self) -> None:
        self.w *= math.exp(math.log(self._u()) / self.size)
        if self.w >= 1.0:
            self.next = sys.maxsize
        else:
            self.next += int(math.log(self._u()) // math.log1p(-self.w)) + 1

    def offer(self, item) -> None:
        if len(self.items) < self.size:
            self.items.append(item)
            if len(self.items) == self.size:
                self._skip()
        elif self.seen == self.next:
            self.items[int(self.rng.integers(self.size))] = item
            self._skip()
        self.seen += 1


def control_job(kind: str, config: dict):
    """The control of a run: the reference module's `control`, put in the
    program's place, over the whole job in chunks. It is deterministic, so
    a job on a slice it has answered reuses that answer."""
    ref = _module("reference", kind)
    chunk = reference_chunk(config)
    done = {}

    def run(read, read_len, ref_codes, ref_len) -> dict:
        key = (read.data_ptr(), len(read_len))
        if key not in done:
            parts = [ref.control(read[i:i + chunk], read_len[i:i + chunk],
                                 ref_codes[i:i + chunk],
                                 ref_len[i:i + chunk], config)
                     for i in range(0, len(read_len), chunk)]
            done[key] = {k: torch.cat([p[k] for p in parts])
                         for k in parts[0]}
        return done[key]

    return run


def reference_chunk(config: dict) -> int:
    """Pairs the reference takes a call: its temporaries are [pairs, lanes,
    max_len] words, kept near a few hundred megabytes."""
    return max(1024, (1 << 24) // config["max_len"])


def p95(values) -> float:
    """The 95th percentile by nearest rank."""
    v = sorted(values)
    return float(v[max(0, -(-95 * len(v) // 100) - 1)])


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Clock:
    """Job times: on a card a pair of CUDA events, reused, around each
    call (the device writes each timestamp into the stream, so a job runs
    from its call to the end of its last device work), read once the job
    has been synchronised; the host clock elsewhere."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.a = torch.cuda.Event(enable_timing=True)
            self.b = torch.cuda.Event(enable_timing=True)
        self.ms = []

    def start(self):
        if self.cuda:
            self.a.record()
        else:
            self.t = time.perf_counter()

    def stop(self):
        if self.cuda:
            self.b.record()
        else:
            self.ms.append((time.perf_counter() - self.t) * 1e3)

    def read(self):
        """After the job's synchronise."""
        if self.cuda:
            self.ms.append(self.a.elapsed_time(self.b))


@dataclasses.dataclass
class TraceContext:
    """What a per-layer metric's reader sees: the traced stretch, the
    cell, and each traced job's slice as host arrays (read_len, ref_len
    and the job's outputs)."""
    trace: tracing.Trace
    kind: str
    config: dict
    jobs: list

    def job_kernel_seconds(self) -> float:
        """Device time of every kernel the traced jobs launched (the union
        of their intervals)."""
        ivs = tracing.union(self.trace.kernels)
        return sum(e - s for s, e in ivs) / 1e6


def _trace_readings(cell: Cell, tr: tracing.Trace, jobs: list) -> dict:
    ctx = TraceContext(tr, cell.kind, cell.config, jobs)
    out = {}
    for m in cell.per_layer:
        value = _module("metrics", m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


class _Tracer:
    """`torch.profiler` over a steady stretch of the window: started
    between jobs once a third of the window has passed, stopped between
    jobs once it has traced a third of the window or TRACE_SECONDS,
    whichever is shorter. The Chrome trace goes to a temporary directory
    and is read back once the window has closed."""

    def __init__(self, device, seconds: float):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.seconds = seconds
        self.state = "before"
        self.t_on = 0.0

    @property
    def on(self) -> bool:
        return self.state == "on"

    def step(self, elapsed: float) -> None:
        if self.state == "before" and elapsed >= self.seconds / 3:
            self.prof.start()
            self.state = "on"
            self.t_on = time.perf_counter()
        elif self.state == "on" and time.perf_counter() - self.t_on >= min(
                self.seconds / 3, TRACE_SECONDS):
            self.stop()

    def stop(self) -> None:
        if self.state == "on":
            self.prof.stop()
            self.state = "done"

    def read(self) -> tracing.Trace:
        folder = tempfile.mkdtemp(prefix="perfbench-trace-")
        try:
            path = os.path.join(folder, "trace.json")
            self.prof.export_chrome_trace(path)
            return tracing.load(path)
        finally:
            shutil.rmtree(folder, ignore_errors=True)


def run_cell(root: str, name: str, seed: int, seconds: float, trace: bool,
             device="cuda", t0: float | None = None, job=None) -> dict:
    """One run of the cell `name`; returns the result line's object, the
    compared numbers last under "checks". `job` replaces the program's
    call (the control). The window runs at least as many jobs as the
    check samples."""
    t0 = time.perf_counter() if t0 is None else t0
    device = torch.device(device)
    cell = load_cell(root, name)
    cfg, mix = cell.config, cell.mix
    outputs = _module("jobs", cell.kind).OUTPUTS
    run = job or _module("jobs", cell.kind).setup(cfg, device)
    t_entry = time.perf_counter()
    ppj, pool_n = mix["pairs_per_job"], mix["pool_pairs"]
    if pool_n % ppj:
        raise ValueError(f"pool of {pool_n} pairs is not whole jobs of {ppj}")
    pool = make_pool(pool_n, cfg["read_length"], mix["error_rates"],
                     mix["shares"], cfg["mismatch_rate"], cfg["max_len"],
                     mix["order"], seed, device)
    slices = [(lo, lo + ppj) for lo in range(0, pool_n, ppj)]
    batches = [tuple(pool[k][lo:hi] for k in INPUTS) for lo, hi in slices]

    def call(s):
        return run(*batches[s])

    rng = np.random.default_rng([seed % 2**64, 0x5EED])
    R, S = mix["check_jobs"], min(mix["check_pairs_per_job"], ppj)
    # warm-up: every slice, with as many outputs alive at once as the
    # window holds (the sample, the traced slices, the job in flight)
    t_pool = time.perf_counter()
    held = [call(s % len(slices))
            for s in range(R + 1 + len(slices) * trace)]
    _sync(device)
    del held
    log(f"set-up: to the job's entry {t_entry - t0:.3f} s, pool "
        f"{t_pool - t_entry:.3f} s, warm-up {time.perf_counter() - t_pool:.3f}"
        " s")

    sample = Reservoir(R, rng)
    tracer = _Tracer(device, seconds) if trace else None
    traced, traced_slices = {}, []
    clock = _Clock(device)
    jobs = 0
    # no collector pauses inside the window: what the loop allocates is
    # freed by reference counts, and a collection waits until it closes
    gc.collect()
    gc.disable()
    t_start = time.perf_counter()
    setup_s = t_start - t0
    while True:
        elapsed = time.perf_counter() - t_start
        if tracer:
            tracer.step(elapsed)
        if (jobs >= R and elapsed >= seconds
                and (tracer is None or tracer.state == "done")):
            break
        on = tracer is not None and tracer.on
        s = jobs % len(slices)
        with (torch.profiler.record_function(tracing.JOB_SPAN) if on
              else contextlib.nullcontext()):
            clock.start()
            out = call(s)
            clock.stop()
            _sync(device)
        clock.read()
        if on:
            traced_slices.append(s)
            traced.setdefault(s, out)
        sample.offer((s, out))
        jobs += 1
    window_s = time.perf_counter() - t_start
    gc.enable()
    job_ms = clock.ms
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    dev_info = dict(platform="gpu" if device.type == "cuda" else "cpu",
                    kind=(torch.cuda.get_device_name(device)
                          if device.type == "cuda" else "cpu"),
                    count=1, memory_peak_bytes=int(peak))
    result = dict(correct=False, attempted=jobs, failed=0, metrics={},
                  device=dev_info)
    log(f"{name}: seed {seed}, {jobs} jobs of {ppj} pairs in "
        f"{window_s:.6f} s, job ms median {float(np.median(job_ms)):.6f} "
        f"p95 {p95(job_ms):.6f}, set-up {setup_s:.6f} s, memory peak "
        f"{peak} B")
    if trace:
        tr = tracer.read()
        host = {s: dict(read_len=to_numpy(batches[s][1]),
                        ref_len=to_numpy(batches[s][3]),
                        outputs={k: to_numpy(v) for k, v in o.items()})
                for s, o in traced.items()}
        result["metrics"] = _trace_readings(
            cell, tr, [host[s] for s in traced_slices])
        lo, hi = tr.window
        dev_info.update(busy_s=tracing.busy_us(tr) / 1e6,
                        window_s=(hi - lo) / 1e6)
        result["breakdown"] = tracing.breakdown(tr)
        log(f"traced {len(tr.jobs)} jobs: device busy "
            f"{dev_info['busy_s']:.6f} s of {dev_info['window_s']:.6f} s")
    else:
        e2e = dict(pairs_per_s=jobs * ppj / window_s, job_p95_ms=p95(job_ms),
                   setup_s=setup_s)
        for m in cell.end_to_end:
            result["metrics"][m["name"]] = {"value": e2e[m["name"]],
                                            "unit": m["unit"]}

    # the check: pull the sampled answers and their inputs, free the
    # program's state, then run the reference on the same inputs
    picked = []
    for s, o in sample.items:
        idx = np.sort(rng.choice(ppj, size=S, replace=False))
        rows = torch.from_numpy(idx + slices[s][0]).to(device)
        got = {k: to_numpy(o[k])[idx] for k in outputs}
        picked.append(({k: pool[k].index_select(0, rows) for k in INPUTS},
                       got))
    del pool, batches, sample, traced, out, call, run
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks, result["failed"] = _check(cell, picked, outputs)
    result["correct"] = all(c["value"] <= c["limit"] for c in checks.values())
    result["checks"] = checks
    return result


def _check(cell: Cell, picked: list, outputs):
    """Numbers compared, each beside its limit, and the sampled jobs with a
    wrong answer: pairs whose output differs from the reference's, per
    output (limit 0: the comparison is exact)."""
    ref = _module("reference", cell.kind)
    chunk = reference_chunk(cell.config)
    differ = {k: 0 for k in outputs}
    compared = failed = 0
    for inputs, got in picked:
        n = len(inputs["read_len"])
        want = {k: [] for k in outputs}
        for i in range(0, n, chunk):
            part = ref.reference(*(inputs[k][i:i + chunk] for k in INPUTS),
                                 cell.config)
            for k in outputs:
                want[k].append(to_numpy(part[k]))
        bad = np.zeros(n, bool)
        for k in outputs:
            wrong = np.concatenate(want[k]) != got[k]
            differ[k] += int(wrong.sum())
            bad |= wrong
        compared += n
        failed += int(bad.any())
    log(f"compared {compared} pairs of {len(picked)} jobs with the reference")
    return {f"{k}_differ": {"value": v, "limit": 0}
            for k, v in differ.items()}, failed
