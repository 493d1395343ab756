"""Mapper core: FM-index candidates -> greedy rescoring on the card -> SAM
(port of `asm_tpu.mapper.core`).

Candidate generation replaces SeqAn3's approximate `search(query, index,
max_error_total)` (mapper/main.cpp:67-77) with pigeonhole seeding: a read
with <= e errors split into e+1 seeds has at least one error-free seed, so
exact backward search of each seed finds every true location (plus decoys,
which batched rescoring eliminates, as the reference rescores every hit
with hurdle_matrix, main.cpp:82-86).

The flow of one `map_reads` call:
  1. one native call gives every read's candidate starts (host);
  2. the genome and the reads are uploaded once; each batch of `batch`
     (read, window) jobs is gathered on the device and rescored by the
     greedy aligner (impl="cuda": the CUDA kernel through
     `greedy_align_cuda`, on int8 codes; impl="torch": the plain
     `greedy_align`); every batch is launched before one synchronising
     pull of the costs and the largest step count;
  3. a pair at the step bound re-runs the whole call at max_steps=None;
  4. the best placement per read (first candidate wins ties); with more
     than ~2 candidates per read, only the winners are aligned again for
     their step records;
  5. the winners' records are expanded into CIGAR slots on the device,
     pulled as uint16 (op << 13 | run) and decoded by the native decoder;
     SAM is written on the host.

Reference parity quirks kept deliberately:
  * window = ref[start .. start + |q| + 1] (main.cpp:79-80 span), clipped
    at the genome's end;
  * MAPQ = 60 + greedy cost (main.cpp:96: the reference adds the penalty
    to 60);
  * hit_single_best: one best-cost record per read.
The SAM CIGAR is the greedy walk's own (the reference emits a FIXME'd
dummy alignment, main.cpp:91).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from asm_tpu_torch.config import AlignConfig
from asm_tpu_torch.encoding import PAD_READ, PAD_REF, decode_batch
from asm_tpu_torch.kernels.greedy import greedy_align
from asm_tpu_torch.kernels.greedy_cuda import expand_records, greedy_align_cuda
from asm_tpu_torch.native import FMIndex, cigar_strings_packed
from asm_tpu_torch.utils.bounds import bound_entry, greedy_work

RUN_BITS = 13  # the decoder's slot: op << 13 | run


@dataclasses.dataclass(frozen=True)
class MapperConfig:
    max_errors: int = 3          # pigeonhole seeds = max_errors + 1
    max_hits_per_seed: int = 16  # locate cap per seed range
    max_candidates: int = 64     # per read, after dedupe
    max_len: int = 128
    # max_steps=32 keeps the record buffer at 33 rows instead of 129; the
    # steps output is checked and map_reads re-runs with the safe max_len
    # bound if any pair reached it
    align: AlignConfig = AlignConfig(x=1, o=1, e=1, k=3, max_steps=32)
    batch: int = 4096            # rescoring launch size
    # None = auto: cost-only scoring + a winners-only pass for the records
    # when the candidate fan-out exceeds 2 per read
    two_phase: bool | None = None


def build_index(ref_codes: np.ndarray, out_path: str | None = None) -> FMIndex:
    """Build (and optionally serialize) the FM-index over a reference
    (my-indexer, indexer.cpp:23-93)."""
    idx = FMIndex.build(np.ascontiguousarray(ref_codes, np.int8))
    if out_path:
        idx.save(out_path)
    return idx


def window_batch(genome, reads, read_lens, ri, start, max_len: int):
    """Job tensors (q, ql, w, wl) for reads `ri` (rows of `reads`, already
    2-bit inside each length and PAD_READ past it) at genome starts
    `start`: the window holds read_len + 1 bases clipped at the genome's
    end, 2-bit codes inside it and PAD_REF past it. All on the genome's
    device."""
    n = genome.shape[0]
    pos = torch.arange(max_len, device=genome.device)
    ql = read_lens[ri]
    span = torch.minimum(ql.to(torch.int64) + 1, n - start).clamp(max=max_len)
    at = (start[:, None] + pos[None, :]).clamp(max=n - 1)
    w = torch.where(pos[None, :] < span[:, None], genome[at] & 3,
                    PAD_REF).to(torch.int8)
    return reads[ri], ql, w, span.to(torch.int32)


def stage_reads(read_codes, read_lens, device):
    """Upload reads as int8 [n, L] (2-bit inside each length, PAD_READ
    past it) and their int32 lengths."""
    lens = torch.from_numpy(np.ascontiguousarray(read_lens, np.int32)).to(
        device)
    codes = torch.from_numpy(np.ascontiguousarray(read_codes, np.int8)).to(
        device)
    pos = torch.arange(codes.shape[1], device=device)
    return torch.where(pos[None, :] < lens[:, None], codes & 3,
                       PAD_READ).to(torch.int8), lens


class _Rescorer:
    """Launches the greedy aligner on (read, window) batches, with CUDA
    events around each launch on a card (their sum is the profile's
    kernel_ms); keeps each launch's steps for the launches' bound."""

    def __init__(self, cfg: AlignConfig, impl: str, batch: int, device):
        self.cfg, self.impl, self.batch = cfg, impl, batch
        self.events = [] if device.type == "cuda" else None
        self.steps = []

    def align(self, q, ql, w, wl, records: bool):
        """(cost, steps, step_rec or None) of one batch, unsynchronised."""
        if self.events is not None:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        if self.impl == "cuda":
            g = greedy_align_cuda(q, ql, w, wl, self.cfg, want_cigar=False)
        else:
            g = greedy_align(q, ql, w, wl, self.cfg, records=records)
        if self.events is not None:
            end.record()
            self.events.append((start, end))
        self.steps.append(g["steps"])
        return g["cost"], g["steps"], g.get("step_rec")

    def report(self) -> dict:
        """kernel_ms (None off the card) and the launches' bound
        (utils.bounds.greedy_work on the codes route, this run's steps);
        synchronises."""
        steps = torch.cat(self.steps).cpu().numpy()
        chunks = -(-steps.size // self.batch)  # records: one bound, T
        bound = bound_entry(*greedy_work(
            steps, [self.cfg.steps_bound] * chunks, self.batch,
            k=self.cfg.k, L=self.cfg.max_len, codes=True))
        return dict(
            kernel_ms=None if self.events is None else sum(
                s.elapsed_time(e) for s, e in self.events),
            bound_ms=bound["bound_ms"],
            bound_by=bound["bound_by"])


def _pack_slots(rec, ql, wl, cfg: AlignConfig) -> torch.Tensor:
    """Step records [T+1, n] -> int16 slots [n, 2T+2] holding the uint16
    bits op << 13 | run (the native decoder's format)."""
    g = expand_records(rec, ql, wl, cfg)
    v = (g["cigar_ops"].to(torch.int32) << RUN_BITS) | g["cigar_runs"]
    return torch.where(v >= 1 << 15, v - (1 << 16), v).to(torch.int16)


def map_reads(
    idx: FMIndex,
    ref_codes: np.ndarray,
    read_codes: np.ndarray,
    read_lens: np.ndarray,
    read_names: list[str] | None = None,
    mcfg: MapperConfig | None = None,
    ref_name: str = "ref",
    profile: dict | None = None,
    *,
    device="cuda",
    impl: str = "cuda",
):
    """Map a read batch; returns a list of SAM record dicts (best hit per
    read; None entries for unmapped reads) and the SAM text.

    device: where the windows are gathered and rescored (the card by
    default). impl: "cuda" (the greedy kernel; on CPU tensors its wrapper
    runs the plain version) or "torch" (the plain `greedy_align`).

    Pass ``profile={}`` to receive the per-stage wall-clock breakdown
    (seconds: candidates, p1_assemble_dispatch, p1_pull, select,
    p2_assemble_dispatch, rec_pull, sam_seqs, cigar, sam), the job and
    batch counts, two_phase; kernel_ms, the summed CUDA-event time of
    the rescoring launches (None off the card; it includes any time the
    card waits there for the host to enqueue the kernel); bound_ms and
    bound_by, the least time the card could take for those launches.
    """
    if impl not in ("cuda", "torch"):
        raise ValueError(f"impl must be 'cuda' or 'torch', got {impl!r}")
    mcfg = mcfg or MapperConfig()
    cfg = mcfg.align
    device = torch.device(device)
    prof = profile if profile is not None else {}
    n_reads, L = read_codes.shape
    if L != cfg.max_len:
        raise ValueError(f"reads are [n, {L}], the aligner's max_len is "
                         f"{cfg.max_len}")
    if L >= 1 << RUN_BITS:
        raise ValueError(f"slot runs hold {RUN_BITS} bits; max_len {L}")
    ref_len_total = ref_codes.shape[0]

    t0 = time.perf_counter()
    starts, counts = idx.candidates_batch(
        read_codes, read_lens, max_errors=mcfg.max_errors,
        max_hits_per_seed=mcfg.max_hits_per_seed,
        max_candidates=mcfg.max_candidates)
    mask = np.arange(starts.shape[1])[None, :] < counts[:, None]
    jobs_ri, jobs_t = np.nonzero(mask)
    jobs_start = starts[jobs_ri, jobs_t].astype(np.int64)
    nj = jobs_ri.size
    prof["candidates_s"] = time.perf_counter() - t0
    prof["n_jobs"] = int(nj)

    two_phase = mcfg.two_phase
    if two_phase is None:
        two_phase = nj > 2 * n_reads
    prof["two_phase"] = bool(two_phase)

    big = np.iinfo(np.int64).max
    best_cost = np.full(n_reads, big, np.int64)
    best_pos = np.zeros(n_reads, np.int64)
    mapped = np.zeros(0, np.int64)
    rescorer = None
    if nj:
        # phase 1: upload the genome and the reads once, then gather and
        # launch every batch before pulling anything
        t0 = time.perf_counter()
        reads_d, lens_d = stage_reads(read_codes, read_lens, device)
        genome_d = torch.from_numpy(
            np.ascontiguousarray(ref_codes, np.int8)).to(device)
        rescorer = _Rescorer(cfg, impl, mcfg.batch, device)
        ri_d = torch.from_numpy(jobs_ri.astype(np.int64)).to(device)
        st_d = torch.from_numpy(jobs_start).to(device)
        outs, wls = [], []
        for base in range(0, nj, mcfg.batch):
            sel = slice(base, min(base + mcfg.batch, nj))
            q, ql, w, wl = window_batch(genome_d, reads_d, lens_d,
                                        ri_d[sel], st_d[sel], L)
            outs.append(rescorer.align(q, ql, w, wl, records=not two_phase))
            wls.append(wl)
        prof["p1_assemble_dispatch_s"] = time.perf_counter() - t0
        prof["p1_batches"] = len(outs)

        # one pull: every cost, and the largest step count after them
        t0 = time.perf_counter()
        steps_max = torch.cat([o[1] for o in outs]).max()
        pulled = torch.cat([o[0] for o in outs] + [steps_max[None]]).cpu()
        pulled = pulled.numpy().astype(np.int64)
        costs, max_steps = pulled[:nj], int(pulled[nj])
        prof["p1_pull_s"] = time.perf_counter() - t0
        if max_steps >= cfg.steps_bound and cfg.max_steps is not None:
            # a pair reached the tight bound: redo with the max_len bound
            # (a highway step always advances >= 1 column)
            fallback = dataclasses.replace(
                mcfg, align=dataclasses.replace(cfg, max_steps=None))
            return map_reads(idx, ref_codes, read_codes, read_lens,
                             read_names, fallback, ref_name, profile,
                             device=device, impl=impl)

        # per-read minimum, the first candidate winning ties: a stable
        # (read, cost, order) sort, keeping each read's first row
        t0 = time.perf_counter()
        order = np.lexsort((np.arange(nj), costs, jobs_ri))
        keep = np.ones(nj, bool)
        sri = jobs_ri[order]
        keep[1:] = sri[1:] != sri[:-1]
        rows = order[keep]
        best_cost[jobs_ri[rows]] = costs[rows]
        best_pos[jobs_ri[rows]] = jobs_start[rows]
        mapped = np.nonzero(best_cost < big)[0]
        prof["select_s"] = time.perf_counter() - t0

        if two_phase:
            # phase 2: the winning placements only, aligned again for
            # their records
            t0 = time.perf_counter()
            m_d = torch.from_numpy(mapped).to(device)
            p_d = torch.from_numpy(best_pos[mapped]).to(device)
            slots = []
            for base in range(0, mapped.size, mcfg.batch):
                sel = slice(base, base + mcfg.batch)
                q, ql, w, wl = window_batch(genome_d, reads_d, lens_d,
                                            m_d[sel], p_d[sel], L)
                rec = rescorer.align(q, ql, w, wl, records=True)[2]
                slots.append(_pack_slots(rec, ql, wl, cfg))
            slots = torch.cat(slots)
            prof["p2_assemble_dispatch_s"] = time.perf_counter() - t0
            prof["p2_batches"] = -(-mapped.size // mcfg.batch)
        else:
            # one pass kept every job's records; take the winners' rows
            winner = np.full(n_reads, -1, np.int64)
            winner[jobs_ri[rows]] = rows
            w_d = torch.from_numpy(winner[mapped]).to(device)
            rec = torch.cat([o[2] for o in outs], dim=1)[:, w_d]
            slots = _pack_slots(rec, lens_d[ri_d[w_d]], torch.cat(wls)[w_d],
                                cfg)
        t0 = time.perf_counter()
        slots_h = slots.cpu().numpy().view(np.uint16)
        prof["rec_pull_s"] = time.perf_counter() - t0
        prof.update(rescorer.report())

    t0 = time.perf_counter()
    names = read_names or [f"read{i}" for i in range(n_reads)]
    seqs = decode_batch(read_codes, read_lens)
    prof["sam_seqs_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    best = [None] * n_reads
    if mapped.size:
        cigars = cigar_strings_packed(slots_h)
        for mi, ri in enumerate(mapped):
            c = int(best_cost[ri])
            best[ri] = dict(
                read=int(ri),
                pos=int(best_pos[ri]),
                cost=c,
                cigar=cigars[mi],
                mapq=60 + c,  # reference quirk, main.cpp:96
            )
    prof["cigar_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    lines = [
        "@HD\tVN:1.6\tSO:unknown",
        f"@SQ\tSN:{ref_name}\tLN:{ref_len_total}",
        "@PG\tID:asm_tpu_torch\tPN:asm_tpu_torch-mapper",
    ]
    for ri in range(n_reads):
        b = best[ri]
        if b is None:
            lines.append(
                f"{names[ri]}\t4\t*\t0\t0\t*\t*\t0\t0\t{seqs[ri]}\t*"
            )
        else:
            lines.append(
                f"{names[ri]}\t0\t{ref_name}\t{b['pos'] + 1}\t{b['mapq']}\t"
                f"{b['cigar'] or '*'}\t*\t0\t0\t{seqs[ri]}\t*"
            )
    prof["sam_s"] = time.perf_counter() - t0
    return best, "\n".join(lines) + "\n"
