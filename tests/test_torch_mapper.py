"""The port's read mapper against asm_tpu's, on the CPU: the native
bindings (FM-index, FASTA / FASTQ readers, CIGAR decoder), decode_batch,
sample_reads, map_reads (best hits and SAM text, both impls), the indexer
and mapper CLIs, the recall check of tests/test_mapper_quality.py, and
mapper_eval.

Tolerance: exact equality everywhere; the SAM text is compared without
its @PG line, which names the package. The JAX runs are shared per case
through module-scoped caches."""

import json

import numpy as np
import pytest
import torch

import asm_tpu.encoding as jenc
import asm_tpu.mapper.__main__ as jcli
import asm_tpu.mapper.core as jcore
import asm_tpu.mapper.indexer as jindexer
import asm_tpu.mapper.simulate as jsim
import asm_tpu.native as jnative
import asm_tpu_torch.encoding as tenc
import asm_tpu_torch.mapper.__main__ as tcli
import asm_tpu_torch.mapper.core as tcore
import asm_tpu_torch.mapper.indexer as tindexer
import asm_tpu_torch.mapper.simulate as tsim
import asm_tpu_torch.native as tnative
from asm_tpu_torch.config import AlignConfig
from asm_tpu_torch.kernels.greedy import greedy_align
from asm_tpu_torch.ops.cigar import runs_to_cigars_batch
from asm_tpu_torch.utils.bounds import greedy_work
from test_torch_cuda import (
    mapper_config,
    mapper_edges,
    mapper_planted,
    mapper_repeat,
)

torch.set_num_threads(1)


def _sam_body(sam: str) -> list[str]:
    return [ln for ln in sam.split("\n") if not ln.startswith("@PG")]


# ---- the bindings ----------------------------------------------------------

def _fm_pair(text):
    return tnative.FMIndex.build(text), jnative.FMIndex.build(text)


def _same_queries(t, j, text, rng, n=30):
    for _ in range(n):
        p = int(rng.integers(0, text.size - 40))
        pat = text[p: p + int(rng.integers(8, 40))]
        lo, hi = t.search(pat)
        assert (lo, hi) == j.search(pat)
        np.testing.assert_array_equal(t.locate(lo, hi, 64),
                                      j.locate(lo, hi, 64))
        assert p in t.locate(lo, hi, 64)
    absent = rng.integers(0, 4, size=40).astype(np.int8)
    assert t.search(absent) == j.search(absent)


def test_fm_index_search_and_locate_match_asm_tpu():
    rng = np.random.default_rng(3)
    text = rng.integers(0, 4, size=8000).astype(np.int8)
    t, j = _fm_pair(text)
    assert len(t) == len(j) == 8000
    _same_queries(t, j, text, rng)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(max_errors=1, max_hits_per_seed=4, max_candidates=8),
    dict(max_errors=5, max_hits_per_seed=2, max_candidates=3),
])
def test_fm_candidates_match_asm_tpu(kw):
    genome, reads, lens = mapper_planted()
    _, ereads, elens = mapper_edges()
    t, j = _fm_pair(genome)
    for r, n in ((reads, lens), (ereads, elens)):
        got = t.candidates_batch(r, n, **kw)
        want = j.candidates_batch(r, n, **kw)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_fm_index_files_cross_load(tmp_path):
    rng = np.random.default_rng(5)
    text = rng.integers(0, 4, size=6000).astype(np.int8)
    t, j = _fm_pair(text)
    pt, pj = str(tmp_path / "t.idx"), str(tmp_path / "j.idx")
    t.save(pt)
    j.save(pj)
    with open(pt, "rb") as a, open(pj, "rb") as b:
        assert a.read() == b.read()
    # each package loads the other's file and answers as its own index
    _same_queries(tnative.FMIndex.load(pj), j, text, rng)
    _same_queries(t, jnative.FMIndex.load(pt), text, rng)
    with pytest.raises(IOError):
        tnative.FMIndex.load(str(tmp_path / "missing.idx"))


def test_fm_index_free():
    t = tnative.FMIndex.build(np.zeros(64, np.int8))
    t.free()
    t.free()
    with pytest.raises(ValueError):
        len(t)


def test_fasta_fastq_readers_match_asm_tpu(tmp_path):
    fa = tmp_path / "ref.fa"
    fa.write_text(">chr1 test\nACGTACGTAC\nggGTTn\n>chr2\nTTTT\n\n>chr3\nCA\n")
    got = tnative.read_fasta_native(str(fa))
    want = jnative.read_fasta_native(str(fa))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got[1].tolist() == [0, 16, 20]

    fq = tmp_path / "r.fq"
    fq.write_text("@r1 extra\nACGT\n+\nIIII\n@r2\nGGTTA\n+\nIIIII\n"
                  "@r3\n" + "ACGTN" * 30 + "\n+\n" + "I" * 150 + "\n")
    got = tnative.read_fastq_native(str(fq), 10)
    want = jnative.read_fastq_native(str(fq), 10)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2] == ["r1", "r2", "r3"]
    assert got[1].tolist() == [4, 5, 128]
    with pytest.raises(IOError):
        tnative.read_fasta_native(str(tmp_path / "missing.fa"))


def test_cigar_strings_packed_matches_asm_tpu():
    rng = np.random.default_rng(6)
    ops = rng.choice(np.array([3, 4, 5], np.int8), size=(300, 66))
    runs = np.where(rng.random((300, 66)) < 0.5, 0,
                    rng.integers(1, 8191, size=(300, 66))).astype(np.int32)
    runs[0] = 0  # an empty CIGAR
    packed = ((ops.astype(np.uint16) << 13) | runs.astype(np.uint16))
    got = tnative.cigar_strings_packed(packed)
    assert got == jnative.cigar_strings_packed(packed)
    assert got == runs_to_cigars_batch(ops, runs)
    assert got[0] == ""


def test_slots_from_records_decode_as_the_plain_cigars():
    """The mapper's CIGARs: step records -> slots (the kernel's layout,
    final leap after the walk's last row) -> native decoder, equal to the
    plain greedy's slots (final leap in the last two)."""
    from asm_tpu_torch.data.generator import generate_dataset_arrays

    rc, rl, fc, fl = (torch.from_numpy(a) for a in generate_dataset_arrays(
        500, 100, 0.08, seed=13))
    for max_steps in (32, None):
        cfg = AlignConfig(max_steps=max_steps)
        g = greedy_align(rc, rl, fc, fl, cfg, records=True)
        slots = tcore._pack_slots(g["step_rec"], rl, fl, cfg)
        assert slots.shape == (500, 2 * cfg.steps_bound + 2)
        got = tnative.cigar_strings_packed(slots.numpy().view(np.uint16))
        assert got == runs_to_cigars_batch(g["cigar_ops"].numpy(),
                                           g["cigar_runs"].numpy())


# ---- host pieces -----------------------------------------------------------

def test_decode_batch_matches_asm_tpu():
    rng = np.random.default_rng(2)
    codes = rng.integers(0, 6, size=(50, 128)).astype(np.int8)
    lens = rng.integers(0, 129, size=50).astype(np.int32)
    assert tenc.decode_batch(codes, lens) == jenc.decode_batch(codes, lens)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(mis=0.05, ins=0.01, dele=0.05),
    dict(dele=0.3),  # a wide deletion slack
])
def test_sample_reads_matches_asm_tpu(kw):
    genome = np.random.default_rng(1).integers(0, 4, size=50000,
                                               dtype=np.int8)
    got = tsim.sample_reads(genome, 200, 100, np.random.default_rng(9), **kw)
    want = jsim.sample_reads(genome, 200, 100, np.random.default_rng(9), **kw)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_greedy_work_codes_route_bytes():
    steps = np.array([3, 0, 5, 2, 7])
    planes = greedy_work(steps, [32, 32], 4)
    codes = greedy_work(steps, [32, 32], 4, codes=True)
    assert codes[0] == planes[0]
    assert codes[1] - planes[1] == 5 * 2 * (128 - 32)


# ---- map_reads against asm_tpu ----------------------------------------------

# case -> (corpus, MapperConfig keywords; "max_steps" sets align.max_steps)
MAP_CASES = {
    "planted": (mapper_planted, dict()),
    "planted-two-phase": (mapper_planted, dict(two_phase=True)),
    "planted-one-phase": (mapper_planted, dict(two_phase=False)),
    "planted-partial-batch": (mapper_planted, dict(batch=16)),
    "truncation": (mapper_planted, dict(max_steps=2)),
    "truncation-two-phase": (mapper_planted,
                             dict(max_steps=2, two_phase=True, batch=16)),
    "repeat": (mapper_repeat, dict(max_hits_per_seed=8, max_candidates=32)),
    "repeat-one-phase": (mapper_repeat, dict(
        max_hits_per_seed=8, max_candidates=32, two_phase=False)),
    "edges": (mapper_edges, dict(batch=8)),
    "edges-two-phase": (mapper_edges, dict(batch=8, two_phase=True)),
}


@pytest.fixture(scope="module")
def jax_map():
    """case -> (corpus, asm_tpu's best hits, SAM text and profile), each
    case run once for the module."""
    runs = {}

    def get(case):
        if case not in runs:
            corpus_fn, kw = MAP_CASES[case]
            genome, reads, lens = corpus_fn()
            prof = {}
            best, sam = jcore.map_reads(
                jcore.build_index(genome), genome, reads, lens,
                mcfg=mapper_config(jcore.MapperConfig, kw), profile=prof)
            runs[case] = (genome, reads, lens), best, sam, prof
        return runs[case]

    return get


@pytest.mark.parametrize("impl", ["cuda", "torch"])
@pytest.mark.parametrize("case", list(MAP_CASES))
def test_map_reads_matches_asm_tpu(jax_map, case, impl):
    (genome, reads, lens), best, sam, jprof = jax_map(case)
    prof = {}
    got_best, got_sam = tcore.map_reads(
        tcore.build_index(genome), genome, reads, lens,
        mcfg=mapper_config(tcore.MapperConfig, MAP_CASES[case][1]),
        profile=prof, device="cpu", impl=impl)
    assert got_best == best
    assert _sam_body(got_sam) == _sam_body(sam)
    assert "@PG\tID:asm_tpu_torch" in got_sam
    # the stages asm_tpu's profile names, but its packed record pull
    assert set(jprof) - {"rec_dispatch_s"} <= set(prof)
    assert prof["two_phase"] == jprof["two_phase"]
    assert prof["kernel_ms"] is None  # no card
    assert prof["bound_by"] in ("bytes", "operations")


def test_map_reads_cases_cover_their_paths(jax_map):
    """The corpora reach what their names say: both phase strategies, the
    re-run, partial batches, unmapped reads and clipped windows."""
    _, best, _, prof = jax_map("repeat")
    assert prof["two_phase"] and best[0]["cost"] == 0
    _, _, _, prof = jax_map("planted")
    assert not prof["two_phase"] and prof["n_jobs"] == 40
    _, _, _, prof = jax_map("planted-partial-batch")
    assert prof["p1_batches"] == 3
    (genome, reads, lens), best, _, _ = jax_map("edges")
    assert sum(b is None for b in best) >= 7  # random, short, empty
    n = genome.shape[0]
    assert any(b is not None and b["pos"] + lens[b["read"]] + 1 > n
               for b in best)


def test_map_reads_rejects_bad_arguments():
    genome, reads, lens = mapper_planted(n_reads=4)
    idx = tcore.build_index(genome)
    with pytest.raises(ValueError):
        tcore.map_reads(idx, genome, reads, lens, device="cpu", impl="xla")
    with pytest.raises(ValueError):
        tcore.map_reads(idx, genome, reads[:, :64], lens, device="cpu")


# ---- the CLIs --------------------------------------------------------------

def _write_inputs(tmp_path):
    genome, reads, lens = mapper_edges()
    fa = tmp_path / "ref.fa"
    seq = jenc.decode_string(genome)
    fa.write_text(">chr\n" + "\n".join(seq[i: i + 70]
                                       for i in range(0, len(seq), 70)) + "\n")
    fq = tmp_path / "reads.fq"
    with open(fq, "w") as f:
        for i, s in enumerate(jenc.decode_batch(reads, lens)):
            f.write(f"@q{i} sample\n{s}\n+\n{'I' * len(s)}\n")
    return str(fa), str(fq)


def test_clis_write_the_same_sam(tmp_path, monkeypatch):
    fa, fq = _write_inputs(tmp_path)
    ji, ti = str(tmp_path / "j.idx"), str(tmp_path / "t.idx")
    jindexer.main(["-r", fa, "-o", ji])
    tindexer.main(["-r", fa, "-o", ti])
    jcli.main(["-r", fa, "-q", fq, "-i", ji, "-o", str(tmp_path / "j.sam"),
               "-e", "3"])
    for idx_path, out in ((ti, "t.sam"), (ji, "tj.sam")):
        tcli.main(["-r", fa, "-q", fq, "-i", idx_path, "-o",
                   str(tmp_path / out), "-e", "3", "--device", "cpu"])
    want = _sam_body((tmp_path / "j.sam").read_text())
    assert any(ln.startswith("q0\t0\tref\t") for ln in want)
    assert any("\t4\t*\t0\t0\t" in ln for ln in want)
    for out in ("t.sam", "tj.sam"):
        assert _sam_body((tmp_path / out).read_text()) == want
    # the card is the default; without one the CLI says so
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        tcli.main(["-r", fa, "-q", fq, "-i", ti, "-o",
                   str(tmp_path / "x.sam")])


# ---- quality and the eval tool ----------------------------------------------

def test_mapper_recall_known_origins():
    """tests/test_mapper_quality.py on the port, and equal to asm_tpu."""
    rng = np.random.default_rng(5)
    genome = rng.integers(0, 4, size=2_000_000, dtype=np.int8)
    reads, lens, origins, nerr = tsim.sample_reads(genome, 600, 100, rng)
    mcfg = tcore.MapperConfig(max_errors=3, batch=4096)
    best, sam = tcore.map_reads(tcore.build_index(genome), genome, reads,
                                lens, mcfg=mcfg, device="cpu")
    ok = np.array([b is not None and abs(b["pos"] - int(o)) <= 5
                   for b, o in zip(best, origins)])
    elig = nerr <= mcfg.max_errors
    assert elig.sum() >= 400
    assert float(ok[elig].mean()) >= 0.995, ok[elig].mean()
    assert float(ok.mean()) >= 0.90
    for b in best:
        if b is not None:
            assert b["mapq"] == 60 + b["cost"]
    jbest, jsam = jcore.map_reads(
        jcore.build_index(genome), genome, reads, lens,
        mcfg=jcore.MapperConfig(max_errors=3, batch=4096))
    assert best == jbest
    assert _sam_body(sam) == _sam_body(jsam)


def test_mapper_eval_cli(capsys, monkeypatch):
    from asm_tpu_torch.tools import mapper_eval

    line = mapper_eval.main(["--genome-mbp", "0.2", "--reads", "64",
                             "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == line
    assert line["metric"] == "mapper_reads_per_sec" and line["value"] > 0
    assert line["device"] == "cpu" and line["kernel_ms"] is None
    assert line["recall_eligible"] == 1.0 and line["mapq_quirk_ok"]
    assert line["kernel_launches"] == 0 and "card" not in line
    assert {"candidates", "p1_pull", "select", "sam"} <= set(
        line["stage_profile_s"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        mapper_eval.main(["--reads", "8"])
