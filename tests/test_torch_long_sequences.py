"""The port's long-sequence path on the CPU (max_len 256 and 512; greedy
also at k = 4), mirroring tests/test_long_sequences.py: every CUDA
wrapper runs its plain version for CPU tensors and is held against
asm_tpu's XLA kernels, its scalar references (greedy_ref, leap_ref,
nw_ref), the Pallas greedy in interpret mode and its stage_planes_t
layout, and leap_align(want_history) + leap_backtrack_batch for the fused
CIGAR; the port's plan_cigar_chunks; and the port's long-sequence tool
against the JAX package's totals on the same native corpus.

Tolerance: exact equality everywhere."""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asm_tpu.config import AlignConfig as JaxConfig
from asm_tpu.data.generator import generate_dataset
from asm_tpu.data.generator import generate_dataset_arrays
from asm_tpu.encoding import encode_batch
from asm_tpu.kernels.greedy import greedy_align as jax_greedy
from asm_tpu.kernels.greedy_pallas import greedy_align_pallas
from asm_tpu.kernels.greedy_pallas import stage_planes_t as jax_stage
from asm_tpu.kernels.leap import leap_align as jax_leap
from asm_tpu.kernels.leap_backtrack import leap_backtrack_batch as jax_bt
from asm_tpu.kernels.nw import nw_align as jax_nw_align
from asm_tpu.kernels.nw import nw_penalty as jax_nw_penalty
from asm_tpu.native import generate_dataset_native
from asm_tpu.ops.cigar import batch_greedy_cigars
from asm_tpu.reference_impl.greedy_ref import greedy_ref
from asm_tpu.reference_impl.leap_ref import leap_ref
from asm_tpu.reference_impl.nw_ref import nw_ref
from asm_tpu_torch.config import config_from_jax
from asm_tpu_torch.kernels.greedy_cuda import (
    greedy_align_cuda,
    stage_planes_tiled_t,
)
from asm_tpu_torch.kernels.leap_cuda import leap_align_cuda, leap_cigar_decode
from asm_tpu_torch.kernels.nw_cuda import nw_align_cuda, nw_penalty_cuda
from asm_tpu_torch.tools import longseq_headline as lh
from test_torch_cuda import long_edges

torch.set_num_threads(1)


def _strings(length, max_len, n=12, err=0.05, seed=None):
    reads, refs = generate_dataset(n, length, err, 0.96,
                                   seed=length if seed is None else seed)
    return reads, refs, encode_batch(reads, refs, max_len)


def _greedy_port(corpus, jcfg, form):
    """greedy_align_cuda on CPU tensors in one input form."""
    rc, rl, fc, fl = corpus
    cfg = config_from_jax(jcfg)
    if form == "codes":
        return greedy_align_cuda(*map(torch.from_numpy, (rc, rl, fc, fl)),
                                 cfg)
    return greedy_align_cuda(
        torch.from_numpy(stage_planes_tiled_t(rc, tile=128)),
        torch.from_numpy(rl),
        torch.from_numpy(stage_planes_tiled_t(fc, tile=128)),
        torch.from_numpy(fl), cfg, pre_staged="planes_tiled", tile=128)


def _cigars(out):
    return batch_greedy_cigars({k: np.asarray(v) for k, v in out.items()})


@pytest.mark.parametrize("length,max_len", [(250, 256), (500, 512)])
def test_greedy_long_reads(length, max_len):
    """The port's greedy at L = 256 and 512 equals greedy_ref, the XLA
    greedy, the Pallas greedy (interpret) and its 2-bit-plane layout."""
    jcfg = JaxConfig(k=3, max_len=max_len, max_steps=64)
    reads, refs, corpus = _strings(length, max_len)
    a = [jnp.asarray(v) for v in corpus]
    xla = jax_greedy(*a, jcfg)
    pallas = greedy_align_pallas(*a, jcfg, interpret=True)
    planes = greedy_align_pallas(
        jnp.asarray(jax_stage(corpus[0])), a[1],
        jnp.asarray(jax_stage(corpus[2])), a[3], jcfg, interpret=True,
        pre_staged="planes")
    for form in ("codes", "planes_tiled"):
        got = _greedy_port(corpus, jcfg, form)
        cost = got["cost"].numpy()
        for ref in (xla, pallas, planes):
            np.testing.assert_array_equal(cost, np.asarray(ref["cost"]))
        np.testing.assert_array_equal(got["steps"].numpy(),
                                      np.asarray(xla["steps"]))
        assert _cigars(got) == _cigars(xla)
        for i in range(len(reads)):
            assert cost[i] == greedy_ref(reads[i], refs[i], k=3,
                                         max_len=max_len)[0], i


# k = 4 at every max_len, and the edge lengths at L = 512
GREEDY_CASES = [
    ("k4-L128", JaxConfig(k=4, max_steps=32),
     dict(num_reads=300, length=100, error_rate=0.1, seed=6)),
    ("k4-L256", JaxConfig(k=4, max_len=256, max_steps=64),
     dict(num_reads=120, length=200, error_rate=0.1, seed=7, max_len=256)),
    ("k4-L512", JaxConfig(k=4, max_len=512, max_steps=128),
     dict(num_reads=60, length=496, error_rate=0.15, seed=8, max_len=512)),
    ("edges512", JaxConfig(max_len=512, max_steps=128), "edges512"),
    ("edges512-k4-x2o3e1", JaxConfig(x=2, o=3, e=1, k=4, max_len=512,
                                     max_steps=128), "edges512"),
]


@pytest.mark.parametrize("label,jcfg,kw", GREEDY_CASES,
                         ids=[c[0] for c in GREEDY_CASES])
@pytest.mark.parametrize("form", ["codes", "planes_tiled"])
def test_greedy_k4_and_edges_match_xla(label, jcfg, kw, form):
    corpus = long_edges() if kw == "edges512" else \
        generate_dataset_arrays(**kw)
    ref = jax_greedy(*map(jnp.asarray, corpus), jcfg)
    got = _greedy_port(corpus, jcfg, form)
    for key in ("cost", "steps"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(ref[key]), err_msg=key)
    assert _cigars(got) == _cigars(ref)


@pytest.mark.parametrize("max_len", [256, 512])
@pytest.mark.parametrize("pens", [(1, 1, 1), (2, 3, 1)])
def test_leap_long_reads(max_len, pens):
    """The port's LEAP at L = 256 and 512, unit and affine penalties, equals
    the XLA leap_align and leap_ref."""
    x, o, e = pens
    jcfg = JaxConfig(x=x, o=o, e=e, k=3, max_len=max_len,
                     leap_af_threshold=100)
    reads, refs, corpus = _strings(max_len - 6, max_len, seed=9 + max_len)
    ref = jax_leap(*map(jnp.asarray, corpus), jcfg)
    got = leap_align_cuda(*map(torch.from_numpy, corpus),
                          config_from_jax(jcfg))
    for key in ("passed", "penalty", "lane_shift"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]),
                                      err_msg=key)
    for i in range(len(reads)):
        passed, pen, shift = leap_ref(
            reads[i], refs[i], k=3, af_threshold=100, ms_penalty=x,
            gap_open_penalty=o, gap_ext_penalty=e, max_len=max_len)
        assert (bool(got["passed"][i]), int(got["penalty"][i]),
                int(got["lane_shift"][i])) == (bool(passed), pen, shift), i


@pytest.mark.parametrize("k", [2, 4])
def test_leap_edges_at_512(k):
    """The edge lengths at L = 512, k = 2 and 4, against the XLA kernel."""
    corpus = long_edges()
    jcfg = JaxConfig(k=k, max_len=512, leap_af_threshold=120)
    ref = jax_leap(*map(jnp.asarray, corpus), jcfg)
    got = leap_align_cuda(*map(torch.from_numpy, corpus),
                          config_from_jax(jcfg))
    for key in ("passed", "penalty", "lane_shift"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]),
                                      err_msg=key)


@pytest.mark.parametrize("max_len", [256, 512])
def test_nw_long_reads(max_len):
    """The port's full and trace kernels' plain versions at L = 256 and
    512 equal the XLA nw_penalty, nw_ref and nw_align's ops and mask."""
    reads, refs, corpus = _strings(max_len - 6, max_len, n=8, err=0.1,
                                   seed=4)
    a = list(map(jnp.asarray, corpus))
    t = list(map(torch.from_numpy, corpus))
    pen = nw_penalty_cuda(*t).numpy()
    np.testing.assert_array_equal(pen, np.asarray(jax_nw_penalty(*a)))
    jpen, jops, jmask = jax_nw_align(*a, match_mask_threshold=3)
    got = nw_align_cuda(*t, match_mask_threshold=3)
    for g, w in zip(got, (jpen, jops, jmask)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for i in range(len(reads)):
        assert pen[i] == nw_ref(reads[i], refs[i], traceback=False)[0], i


def test_nw_edges_at_512():
    corpus = long_edges()
    a = list(map(jnp.asarray, corpus))
    got = nw_align_cuda(*map(torch.from_numpy, corpus),
                        match_mask_threshold=3)
    for g, w in zip(got, jax_nw_align(*a, match_mask_threshold=3)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("length,max_len", [(250, 256), (500, 512)])
def test_fused_leap_cigar_long_reads(length, max_len):
    """The port's fused-CIGAR records (wide cells above L = 253) decode to
    leap_align(want_history) + leap_backtrack_batch's CIGARs."""
    jcfg = JaxConfig(k=3, max_len=max_len, leap_af_threshold=200,
                     leap_max_energy=64)
    _, _, corpus = _strings(length, max_len, n=24)
    h = jax_leap(*map(jnp.asarray, corpus), jcfg, want_history=True)
    cfg = config_from_jax(jcfg)
    got = leap_align_cuda(*map(torch.from_numpy, corpus), cfg,
                          want_cigar=True)
    pen = got["penalty"].numpy()
    assert int((pen * got["passed"].numpy()).max()) <= 64
    np.testing.assert_array_equal(pen, np.asarray(h["penalty"]))
    assert [c and c[1] for c in leap_cigar_decode(got, cfg)] == [
        c and c[1] for c in jax_bt(h, jcfg)]


@pytest.mark.parametrize("csize", [1, 7, 64, 1000])
def test_plan_cigar_chunks_covers_every_pair_once(csize):
    """Every pair lies in exactly one slice; each slice's bound is a
    multiple of 8 within af and no smaller than its largest energy (at
    most af); failed pairs (any energy above af) sort last."""
    rng = np.random.default_rng(csize)
    af = 200
    energy = np.sort(np.concatenate([
        np.minimum(rng.gamma(2.0, 12.0, 997).astype(np.int64), af),
        np.full(3, 1 << 20)]))
    plan = lh.plan_cigar_chunks(energy, af, csize)
    seen = np.zeros(energy.size, np.int32)
    for base, eb in plan:
        sl = slice(base, base + csize)
        seen[sl] += 1
        assert eb % lh.CIGAR_BUCKET == 0 and eb <= af
        assert eb >= min(int(energy[sl].max()), af)
    assert (seen == 1).all()
    assert [b for b, _ in plan] == list(range(0, energy.size, csize))


@pytest.mark.parametrize("L,pairs", [(256, 3000), (512, 1500)])
def test_longseq_tool_matches_jax(L, pairs):
    """The port's long-sequence tool on the CPU (plain versions) prints the
    greedy cost total, LEAP penalty total and passed count the JAX
    package's XLA kernels give on the same native corpus, and the CIGAR
    digest of leap_align(want_history) + leap_backtrack_batch."""
    res = lh.run_length(L, pairs, reps=1, tile=256, device="cpu",
                        digest=pairs, check_plain=64)
    rows = {r["kernel"]: r for r in res["rows"]}
    corpus = generate_dataset_native(pairs, lh.read_length(L), 0.05, 0.96,
                                     seed=7, max_len=L)
    a = list(map(jnp.asarray, corpus))
    g = jax_greedy(*a, JaxConfig(k=3, max_len=L, max_steps=128))
    assert int(np.asarray(g["steps"]).max()) < 128
    assert rows["greedy"]["checksum"] == int(np.asarray(g["cost"]).sum())
    assert rows["greedy"]["steps_max"] == int(np.asarray(g["steps"]).max())
    jcfg = JaxConfig(k=3, max_len=L)
    lp = jax_leap(*a, jcfg)
    pen, ok = np.asarray(lp["penalty"]), np.asarray(lp["passed"])
    for key in ("leap_penalty", "leap_cigar"):
        assert rows[key]["checksum"] == int(pen.sum())
    assert rows["leap_penalty"]["passed"] == int(ok.sum())
    E = int(pen[ok].max())
    hcfg = JaxConfig(k=3, max_len=L, leap_max_energy=E)
    cig = [c[1] for c in jax_bt(jax_leap(*a, hcfg, want_history=True), hcfg)
           if c is not None]
    assert res["digest"] == (
        hashlib.sha256("\n".join(cig).encode()).hexdigest(), len(cig))
    assert set(res["plain"]) == {"greedy", "leap_penalty", "leap_cigar"}
    assert all(r["launches"] == 0 and r["ms"] is None for r in rows.values())
