"""Every shape the TPU kernels take, on the CPU: the port's wrappers (their
plain versions for CPU tensors) against asm_tpu at max_len and k outside
the CUDA kernels' tuned tables (greedy and LEAP against the XLA kernels,
LEAP CIGARs against leap_backtrack_batch, the SHD-gated filter, the NW
full, trace and band kernels against XLA NW, one case per kernel against
its Pallas kernel in interpret mode), the filter CLI and the harness at
those shapes against the JAX CLI and harness, and the pure-Python shape
plan (kernels/shapes.py) that names each shape's library, its block size
and the limits that raise.

Tolerance: exact equality everywhere."""

import contextlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asm_tpu.apps import leap_filter as jax_filter
from asm_tpu.bench.harness import run_benchmark as jax_run_benchmark
from asm_tpu.config import AlignConfig as JaxConfig
from asm_tpu.config import LeapMode as JaxMode
from asm_tpu.data.generator import generate_dataset_arrays
from asm_tpu.kernels.greedy import greedy_align as jax_greedy
from asm_tpu.kernels.greedy_pallas import _TILE as PALLAS_TILE
from asm_tpu.kernels.greedy_pallas import greedy_align_pallas
from asm_tpu.kernels.greedy_pallas import stage_planes_tiled_t as jax_stage
from asm_tpu.kernels.leap import leap_align as jax_leap
from asm_tpu.kernels.leap_backtrack import leap_backtrack_batch as jax_bt
from asm_tpu.kernels.leap_pallas import leap_align_pallas
from asm_tpu.kernels.nw import nw_align as jax_nw_align
from asm_tpu.kernels.nw import nw_penalty as jax_nw_penalty
from asm_tpu.kernels.nw_band import nw_penalty_banded as jax_banded
from asm_tpu.kernels.nw_pallas import nw_align_pallas, nw_penalty_pallas
from asm_tpu.native import generate_dataset_native
from asm_tpu.ops.cigar import batch_greedy_cigars
from asm_tpu_torch.apps import leap_filter
from asm_tpu_torch.bench.harness import run_benchmark
from asm_tpu_torch.config import config_from_jax
from asm_tpu_torch.encoding import PAD_READ, PAD_REF, decode_string
from asm_tpu_torch.kernels import greedy_cuda, leap_cuda, nw_band, nw_cuda
from asm_tpu_torch.kernels import shapes
from asm_tpu_torch.kernels.greedy_cuda import (
    greedy_align_cuda,
    stage_planes_tiled_t,
)
from asm_tpu_torch.kernels.leap_cuda import leap_align_cuda, leap_cigar_decode
from asm_tpu_torch.kernels.nw_band import band_certified, nw_penalty_banded
from asm_tpu_torch.kernels.nw_cuda import nw_align_cuda, nw_penalty_cuda
from asm_tpu_torch.utils.build import nvcc_command

torch.set_num_threads(1)

# (max_len, k) off the tuned tables: one and three interior lanes, the
# harness's 150-base reads, LEAP's cell-width switch on either side (224,
# 288), and a wide band at 384
GREEDY_LEAP_SHAPES = [(32, 0), (96, 1), (160, 5), (224, 8), (288, 3),
                      (384, 10)]


def _corpus(L, n=96, seed=0, err=0.08):
    """n pairs of L - 6 - L // 50 bases, lengths varied down to half, and
    a few edge pairs (empty, one base, full length)."""
    length = L - 6 - L // 50
    rc, rl, fc, fl = generate_dataset_arrays(
        n, length, err, 0.8, seed=seed + L, max_len=L,
        length_range=(max(1, length // 2), length))
    rng = np.random.default_rng(seed)
    for i, (a, b) in enumerate([(0, 0), (1, L), (L, L), (L, 1)]):
        rl[i], fl[i] = a, b
        rc[i] = np.where(np.arange(L) < a, rng.integers(0, 4, L), PAD_READ)
        fc[i] = np.where(np.arange(L) < b, rng.integers(0, 4, L), PAD_REF)
    return rc, rl, fc, fl


def _t(corpus):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in corpus]


def _j(corpus):
    return [jnp.asarray(a) for a in corpus]


def _eq(got, want, keys):
    for key in keys:
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(want[key]), err_msg=key)


# ---- greedy and LEAP against the XLA kernels -------------------------------

@pytest.mark.parametrize("L,k", GREEDY_LEAP_SHAPES)
def test_greedy_and_leap_match_jax(L, k):
    corpus = _corpus(L, seed=k)
    jcfg = JaxConfig(k=k, max_len=L, max_steps=64)
    cfg = config_from_jax(jcfg)
    want = jax_greedy(*_j(corpus), jcfg)
    got = greedy_align_cuda(*_t(corpus), cfg)
    _eq(got, want, ("cost", "steps"))
    assert batch_greedy_cigars({k_: np.asarray(v) for k_, v in got.items()}
                               ) == batch_greedy_cigars(
        {k_: np.asarray(v) for k_, v in want.items()})
    # the same through tile-major planes
    planes = [torch.from_numpy(stage_planes_tiled_t(a, tile=128))
              for a in (corpus[0], corpus[2])]
    got = greedy_align_cuda(planes[0], _t(corpus)[1], planes[1],
                            _t(corpus)[3], cfg, pre_staged="planes_tiled",
                            tile=128)
    _eq(got, want, ("cost", "steps"))
    lcfg = JaxConfig(k=k, max_len=L, leap_af_threshold=40)
    want = jax_leap(*_j(corpus), lcfg)
    got = leap_align_cuda(*_t(corpus), config_from_jax(lcfg))
    _eq(got, want, ("passed", "penalty", "lane_shift"))
    assert greedy_cuda.LAUNCHES == leap_cuda.LAUNCHES == 0


@pytest.mark.parametrize("pens,L,k,err", [((1, 4, 2), 160, 5, 0.1),
                                          ((3, 5, 2), 64, 5, 0.1),
                                          ((8, 8, 8), 288, 2, 0.01)])
@pytest.mark.parametrize("mode", [JaxMode.GLOBAL, JaxMode.SEMI_FREE_END])
def test_leap_penalty_sets_and_cigars_match_jax(pens, L, k, err, mode):
    """lv_bag at penalty sets outside the tuned table, penalty mode and
    CIGAR mode: the packed records decode to leap_backtrack_batch's."""
    x, o, e = pens
    corpus = _corpus(L, n=80, seed=x + o + e, err=err)
    jcfg = JaxConfig(x=x, o=o, e=e, k=k, max_len=L, leap_af_threshold=48,
                     leap_mode=mode)
    cfg = config_from_jax(jcfg)
    hist = jax_leap(*_j(corpus), jcfg, want_history=True)
    got = leap_align_cuda(*_t(corpus), cfg)
    _eq(got, hist, ("passed", "penalty", "lane_shift"))
    got = leap_align_cuda(*_t(corpus), cfg, want_cigar=True)
    want = jax_bt(hist, jcfg)
    assert sum(w is not None for w in want) >= 8
    assert leap_cigar_decode(got, cfg) == want


@pytest.mark.parametrize("k", [0, 1, 5, 8])
def test_simd_ed_lev_gate_matches_jax(k):
    """The filter's semantics at its max_len 256, ERROR = k (buffers below
    256, where the XLA gate is the reference's)."""
    corpus = _corpus(256, n=96, seed=k, err=0.03)
    corpus[1][:] = np.minimum(corpus[1], 250)
    corpus[3][:] = np.minimum(corpus[3], 250)
    jcfg = JaxConfig(k=k, leap_af_threshold=k, max_len=256,
                     leap_mode=JaxMode.GLOBAL)
    for gate in (True, False):
        want = jax_leap(*_j(corpus), jcfg, semantics="simd_ed_lev",
                        use_shd_gate=gate)
        got = leap_align_cuda(*_t(corpus), config_from_jax(jcfg),
                              semantics="simd_ed_lev", use_shd_gate=gate)
        _eq(got, want, ("passed", "penalty", "lane_shift"))


# ---- NW full, trace and band against XLA NW -----------------------------

@pytest.mark.parametrize("L", [96, 160, 384])
def test_nw_kernels_match_jax(L):
    corpus = _corpus(L, n=64 if L < 384 else 24, seed=3, err=0.1)
    for x, o, e in [(1, 1, 1), (2, 3, 1)][:2 if L < 384 else 1]:
        pen = np.asarray(jax_nw_penalty(*_j(corpus), x, o, e))
        np.testing.assert_array_equal(
            nw_penalty_cuda(*_t(corpus), x, o, e).numpy(), pen)
        want = jax_nw_align(*_j(corpus), x, o, e, match_mask_threshold=3)
        got = nw_align_cuda(*_t(corpus), x, o, e, match_mask_threshold=3)
        for g, w, key in zip(got, want, ("pen", "ops", "mask")):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=key)
        # the band: exact wherever its certificate holds, an upper bound
        # elsewhere, at every width the kernel takes
        for bw in shapes.BAND_WIDTHS:
            got = nw_penalty_banded(*_t(corpus), bw=bw, x=x, o=o,
                                    e=e).numpy()
            cert = band_certified(got, bw, o, e)
            np.testing.assert_array_equal(got[cert], pen[cert])
            assert (got >= pen).all()
    assert nw_cuda.LAUNCHES == {"nw": 0, "nw_trace": 0}
    assert nw_band.LAUNCHES == 0


# ---- one case per kernel against its Pallas kernel (interpret mode) ----

def test_greedy_matches_pallas_at_96():
    rc, rl, fc, fl = _corpus(96, n=24, seed=1)
    jcfg = JaxConfig(k=1, max_len=96, max_steps=8)
    ref = greedy_align_pallas(
        jnp.asarray(jax_stage(rc, tile=PALLAS_TILE)), jnp.asarray(rl),
        jnp.asarray(jax_stage(fc, tile=PALLAS_TILE)), jnp.asarray(fl), jcfg,
        interpret=True, pre_staged="planes_tiled")
    got = greedy_align_cuda(
        torch.from_numpy(stage_planes_tiled_t(rc, tile=PALLAS_TILE)),
        torch.from_numpy(rl),
        torch.from_numpy(stage_planes_tiled_t(fc, tile=PALLAS_TILE)),
        torch.from_numpy(fl), config_from_jax(jcfg),
        pre_staged="planes_tiled", tile=PALLAS_TILE)
    _eq(got, ref, ("cost", "steps"))


def test_leap_matches_pallas_at_64():
    corpus = _corpus(64, n=24, seed=2)
    jcfg = JaxConfig(x=1, o=4, e=2, k=1, max_len=64, leap_af_threshold=12)
    want = leap_align_pallas(*_j(corpus), jcfg, interpret=True)
    got = leap_align_cuda(*_t(corpus), config_from_jax(jcfg))
    _eq(got, want, ("passed", "penalty", "lane_shift"))


def test_band_matches_pallas_at_96():
    corpus = _corpus(96, n=32, seed=4, err=0.1)
    for bw in (4,):
        want = np.asarray(jax_banded(*_j(corpus), bw=bw, interpret=True))
        np.testing.assert_array_equal(
            nw_penalty_banded(*_t(corpus), bw=bw).numpy(), want)


def test_nw_full_and_trace_match_pallas_at_96():
    corpus = _corpus(96, n=24, seed=5, err=0.1)
    np.testing.assert_array_equal(
        nw_penalty_cuda(*_t(corpus), 1, 4, 2).numpy(),
        np.asarray(nw_penalty_pallas(*_j(corpus), 1, 4, 2, interpret=True)))
    want = nw_align_pallas(*_j(corpus), 1, 4, 2, match_mask_threshold=3,
                           interpret=True)
    got = nw_align_cuda(*_t(corpus), 1, 4, 2, match_mask_threshold=3)
    for g, w, key in zip(got, want, ("pen", "ops", "mask")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=key)


# ---- the entry points: the filter CLI and the harness ----------------------

@pytest.fixture(scope="module")
def pair_file(tmp_path_factory):
    """Pairs of read lengths 90-250 at err 0.02-0.06, refs cut / padded by
    the CLI (chip_smoke 17a's groups at 48 pairs each)."""
    path = str(tmp_path_factory.mktemp("shapes") / "pairs.seq")
    with open(path, "w") as f:
        for length, err, seed in ((90, 0.02, 171), (150, 0.04, 172),
                                  (200, 0.05, 173), (250, 0.06, 174)):
            rc, rl, fc, fl = generate_dataset_native(
                48, length, err, mismatch_rate=0.9, seed=seed, max_len=256)
            for i in range(48):
                f.write(f"{decode_string(rc[i], rl[i])}\n"
                        f"{decode_string(fc[i], fl[i])}\n")
    return path


def _run_cli(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    lines = dict(ln.split(": ") for ln in out.getvalue().splitlines())
    return int(lines["passNum"]), int(lines["totalNum"])


@pytest.mark.parametrize("argv", [["0"], ["1"], ["5"], ["8"], ["1", "0", "0"],
                                  ["6", "0", "0"]],
                         ids=["0", "1", "5", "8", "1-0-0", "6-0-0"])
def test_filter_cli_matches_jax_at_every_error(pair_file, argv):
    want = _run_cli(jax_filter.main, argv + ["--file", pair_file])
    got = _run_cli(leap_filter.main, argv + ["--file", pair_file,
                                             "--device", "cpu"])
    assert got == want and want[1] == 192


def test_harness_matches_jax_at_160_k5():
    """The harness CLI's `--length 150 --max-len 160 --k 5` corpus at 64
    pairs: every count and the coverage."""
    corpus = generate_dataset_native(64, 150, 0.05, 0.96, seed=42,
                                     max_len=160)
    jcfg = JaxConfig(k=5, max_len=160)
    want = jax_run_benchmark(*corpus, cfg=jcfg, chunk=64, impl="xla")
    got = run_benchmark(*corpus, cfg=config_from_jax(jcfg), chunk=64,
                        impl="cuda", device="cpu")
    for f in ("total", "nw_accuracy", "leap_accuracy", "greedy_accuracy",
              "greedy_coverage", "coverage_checked"):
        assert getattr(got, f) == getattr(want, f), f


# ---- the shape plan ---------------------------------------------------------

@pytest.mark.parametrize("k,L,stem,threads", [
    (3, 128, "greedy", 128), (4, 256, "greedy", 128), (2, 512, "greedy", 32),
    (0, 32, "greedy_k0_w1", 128), (5, 160, "greedy_k5_w5", 128),
    (10, 384, "greedy_k10_w12", 64), (16, 512, "greedy_k16_w16", 32)])
def test_greedy_plan(k, L, stem, threads):
    p = shapes.greedy_plan(k, L)
    assert (p.stem, p.threads) == (stem, threads)
    assert p.tuned == (stem == "greedy")
    assert p.smem_bytes == 4 * (2 * L // 32 + 4) * (2 * k + 1) * threads
    assert p.smem_bytes <= shapes.SMEM_BLOCK_LIMIT
    if not p.tuned:
        assert dict(p.defines) == dict(ASM_SHAPE_K=k, ASM_SHAPE_W=L // 32,
                                       ASM_SHAPE_THREADS=threads)
        # 128 threads would not fit where fewer were taken
        if threads < 128:
            assert shapes.greedy_smem(k, L // 32, 2 * threads) > \
                shapes.SMEM_BLOCK_LIMIT


@pytest.mark.parametrize("k,L,pens,stem,threads", [
    (3, 128, (1, 1, 1), "leap", 128), (2, 512, (2, 3, 1), "leap", 128),
    (3, 128, (1, 4, 2), "leap_k3_w4_x1o4e2", 128),
    (0, 256, (1, 1, 1), "leap_k0_w8_x1o1e1", 128),
    (8, 256, (2, 3, 1), "leap_k8_w8_x2o3e1", 128),
    (7, 512, (1, 1, 1), "leap_k7_w16_x1o1e1", 64),
    (16, 512, (8, 8, 8), "leap_k16_w16_x8o8e8", 32)])
def test_leap_plan(k, L, pens, stem, threads):
    p = shapes.leap_plan(k, L, *pens)
    assert (p.stem, p.threads) == (stem, threads)
    assert p.smem_bytes == 8 * (L // 32) * (2 * k + 1) * threads
    if not p.tuned:
        assert dict(p.defines) == dict(
            ASM_SHAPE_K=k, ASM_SHAPE_W=L // 32, ASM_SHAPE_X=pens[0],
            ASM_SHAPE_O=pens[1], ASM_SHAPE_G=pens[2],
            ASM_SHAPE_THREADS=threads)


def test_nw_and_band_plans():
    assert shapes.nw_plan(256).stem == "nw" and shapes.nw_plan(256).tuned
    p = shapes.nw_plan(160)
    assert p.stem == "nw_w5" and dict(p.defines) == dict(
        ASM_SHAPE_W=5, ASM_NW_G=8, ASM_NW_TRACE_G=8,
        ASM_NW_TRACE_ROUTE=shapes.ROUTE_GLOBAL)
    # G8 up to W = 8, G16 above; shared pointers up to W = 4
    for L in range(32, 513, 32):
        W = L // 32
        for trace in (False, True):
            G, route = shapes.nw_instance(trace, L)
            if W not in shapes.TUNED_WS:
                assert G == (8 if W <= 8 else 16)
                assert route == (shapes.ROUTE_NONE if not trace else
                                 shapes.ROUTE_SHARED if W <= 4 else
                                 shapes.ROUTE_GLOBAL)
            R = shapes.nw_rows(L, G)
            assert R % 4 == 0 and R <= 32 and L <= R * G < L + 4 * G
            launch = shapes.nw_launch(trace, L)
            assert launch["smem_bytes"] <= shapes.SMEM_BLOCK_LIMIT
            assert launch["scratch_per_pair"] == (
                L * R * G // 2 if route == shapes.ROUTE_GLOBAL else 0)
    # the tuned table's strips cover L exactly
    for (W, trace), (G, _) in shapes.NW_TUNED.items():
        assert shapes.nw_rows(32 * W, G) * G == 32 * W
    assert shapes.band_plan(160, 4).stem == "nw_band_w5"
    assert shapes.band_plan(512, 64).stem == "nw_band"
    cmd = nvcc_command("x.cu", "lib.so", (("ASM_SHAPE_W", 5),))
    assert "-DASM_SHAPE_W=5" in cmd and cmd[-1] == "x.cu"
    assert "-DASM_SHAPE_W=5" not in nvcc_command("x.cu", "lib.so")


def _wide_np_table() -> dict:
    """BW -> NP of csrc/nw_band.cu's wide_np_table line (BW == a ? b : ...
    : c), as tools/longseq_sweep's bandnp sweep finds and replaces it."""
    import re

    from asm_tpu_torch.tools.longseq_sweep import WIDE_NP_LINE

    with open(nw_band.SOURCE) as f:
        line = re.findall(WIDE_NP_LINE, f.read())
    assert len(line) == 1
    table = {int(a): int(b) for a, b in re.findall(
        r"BW == (\d+) \? (\d+)", line[0])}
    rest = int(re.search(r": (\d+); \}$", line[0])[1])
    return {bw: table.get(bw, rest) for bw in shapes.BAND_WIDTHS}


@pytest.mark.parametrize("L", [128, 544, 1024, 2048, 4096, 8192])
def test_band_wide_layout_mirrors_the_source(L):
    """kernels/shapes.band_wide_launch mirrors csrc/nw_band.cu's wide path:
    NP offset pairs a thread from the source's wide_np_table line (2 at BW
    4 and 16, 4 at 32-128, 1 at 8; shapes.BAND_WIDE_NP), halved while the
    code rows of one warp's pairs (32 / (BW / (2 NP)), two rows each)
    pass a block's shared memory (BW 4 takes 1 from max_len 3,648 on);
    BW / (2 NP) threads a pair, 32 / that pairs a warp; a block takes the
    largest of 128, 64 and 32 threads whose rows fit BAND_WIDE_SMEM, else
    32."""
    assert _wide_np_table() == shapes.BAND_WIDE_NP == {
        4: 2, 8: 1, 16: 2, 32: 4, 64: 4, 128: 4}
    for bw in shapes.BAND_WIDTHS:
        row = shapes.band_row_words(bw, L)
        assert row % 2 == 1 and 4 * row >= L + 2 * max(4, bw // 4)
        np_ = shapes.BAND_WIDE_NP[bw]
        while (np_ > max(1, bw // 64) and 32 // (bw // (2 * np_)) * 2 * row
               * 4 > shapes.SMEM_BLOCK_LIMIT):
            np_ //= 2
        got = shapes.band_wide_launch(bw, L)
        seg = bw // (2 * np_)
        assert (got["np"], got["seg"], got["pairs_per_warp"]) == (
            np_, seg, 32 // seg) == (shapes.band_wide_np(bw, L), seg,
                                     32 // seg)
        per_warp = 32 // seg * 2 * row * 4
        fits = [nt for nt in (128, 64, 32)
                if nt // 32 * per_warp <= shapes.BAND_WIDE_SMEM]
        assert got["threads"] == (fits[0] if fits else 32)
        assert got["smem_bytes"] == got["threads"] // 32 * per_warp
    assert shapes.band_wide_np(4, 3616) == 2
    assert shapes.band_wide_np(4, 3648) == 1


def test_band_variants_replace_the_table_line():
    """tools/longseq_sweep's bandnp variants each replace the source's one
    wide_np_table line and its kWideUnroll line; a variant's table is the
    checked-in one with its own entries over it."""
    import re

    from asm_tpu_torch.tools import longseq_sweep as ls

    with open(nw_band.SOURCE) as f:
        src = f.read()
    for nps, unroll in ls.BAND_VARIANTS.values():
        out = src
        for pattern, line in ls.band_variant_subs(nps, unroll):
            out, n = re.subn(pattern, line, out)
            assert n == 1, pattern
        table = {int(a): int(b) for a, b in re.findall(
            r"BW == (\d+) \? (\d+)", re.findall(ls.WIDE_NP_LINE, out)[0])}
        assert table == {**shapes.BAND_WIDE_NP, **nps}
        assert f"constexpr int kWideUnroll = {unroll};" in out


@pytest.mark.parametrize("stem", ["nw_band", "nw_cuda", "leap_cuda"])
def test_parent_bind_is_the_parents_own(tmp_path, stem):
    """tools/longseq_sweep --parent types a parent's library with the
    parent checkout's own `bind`, not this checkout's: a parent module's
    bind is the one called."""
    import importlib

    from asm_tpu_torch.tools import longseq_sweep as ls

    module = importlib.import_module(f"asm_tpu_torch.kernels.{stem}")
    kernels = tmp_path / "asm_tpu_torch" / "kernels"
    kernels.mkdir(parents=True)
    (kernels / f"{stem}.py").write_text(
        "def bind(path):\n    return ('parent', path)\n")
    assert ls.parent_bind(module, str(tmp_path))("lib.so") == ("parent",
                                                              "lib.so")
    assert module.bind is not ls.parent_bind(module, str(tmp_path))


def test_band_wide_limit_is_named():
    """At 32 threads a block the wide path's shared memory is one warp's
    pairs' rows, NP halved to fit down to one offset pair a thread (two at
    BW 128), so the band takes every max_len it took before its wide path
    held more offsets a thread (BW 4 to 7,232): every max_len whose rows
    fit has a plan, the next one raises naming shared memory."""
    for bw in shapes.BAND_WIDTHS:
        seg = bw // (2 * max(1, bw // 64))
        top = max(L for L in range(544, 1 << 17, 32)
                  if 32 // seg * 2 * shapes.band_row_words(bw, L) * 4
                  <= shapes.SMEM_BLOCK_LIMIT)
        assert shapes.band_plan(top, bw).stem == f"nw_band_w{top // 32}"
        with pytest.raises(NotImplementedError, match="shared memory"):
            shapes.band_plan(top + 32, bw)
        if bw == 4:
            assert top == 7232
    assert shapes.band_plan(8192, 128).stem == "nw_band_w256"


@pytest.mark.parametrize("call,match", [
    (lambda: shapes.greedy_plan(32, 128), "7 bits"),
    (lambda: shapes.greedy_plan(25, 512), "shared memory"),
    (lambda: shapes.leap_plan(28, 512, 1, 1, 1), "shared memory"),
    (lambda: shapes.leap_plan(3, 128, 9, 1, 1), "x, o, e"),
    (lambda: _long_plan_then(shapes.leap_plan(3, 544, 1, 1, 1),
                             "leap_k3_w17_x1o1e1",
                             lambda: shapes.leap_plan(32, 544, 1, 1, 1)),
     "one word"),
    (lambda: _long_plan_then(shapes.greedy_plan(3, 544), "greedy_k3_w17",
                             lambda: shapes.greedy_plan(3, 66560)),
     "shared memory"),
    (lambda: _long_plan_then(shapes.nw_plan(544), "nw_w17",
                             lambda: shapes.nw_plan(32 * 1024)),
     "shared memory"),
    (lambda: _long_plan_then(shapes.band_plan(160, 128), "nw_band_w5",
                             lambda: shapes.band_plan(8192, 4)),
     "shared memory"),
], ids=["greedy-record", "greedy-smem", "leap-smem", "leap-penalty",
        "leap-544", "greedy-544", "nw-544", "band-128"])
def test_plan_limits_raise_naming_them(call, match):
    """Each limit raises NotImplementedError naming it. max_len 544 and
    BW 128 have plans now (the long-row path, the band's wide path):
    their cases check the plan, then the computed limit past
    it (the LEAP long path's one-word lane shift, greedy's rows in shared
    memory)."""
    with pytest.raises(NotImplementedError, match=match):
        call()


def _long_plan_then(plan, stem, refused):
    assert plan.stem == stem and not plan.tuned
    refused()


def test_plan_range_is_whole():
    """Every shape the range names has a plan: k 0-16 at every max_len
    32-512 for greedy and LEAP (LEAP at every penalty set of 1-8 at k
    0-16 fits too), k 0-4 at every max_len 544-2048 (the long-row path),
    and every max_len 32-2048 for the NW kernels and the band at BW
    4-128; a max_len off the 32 grid is a ValueError, as the wrappers
    raise it."""
    for L in range(32, 2049, 32):
        for k in range(17 if L <= 512 else 5):
            shapes.greedy_plan(k, L)
            shapes.leap_plan(k, L, 1, 1, 1)
            shapes.leap_plan(k, L, 8, 8, 8)
        shapes.nw_plan(L)
        for bw in shapes.BAND_WIDTHS:
            shapes.band_plan(L, bw)
    with pytest.raises(ValueError):
        shapes.greedy_plan(3, 100)


def test_sources_take_one_shape_by_defines():
    """Each kernel source compiles its tuned table out and one shape in
    under the plan's defines, and each wrapper builds through the plan."""
    for module, names in ((greedy_cuda, ("ASM_SHAPE_K", "ASM_SHAPE_W",
                                         "ASM_SHAPE_THREADS")),
                          (leap_cuda, ("ASM_SHAPE_K", "ASM_SHAPE_W",
                                       "ASM_SHAPE_X", "ASM_SHAPE_O",
                                       "ASM_SHAPE_G", "ASM_SHAPE_THREADS")),
                          (nw_cuda, ("ASM_SHAPE_W", "ASM_NW_G",
                                     "ASM_NW_TRACE_G", "ASM_NW_TRACE_ROUTE")),
                          (nw_band, ("ASM_SHAPE_W",))):
        with open(module.SOURCE) as f:
            src = f.read()
        for name in names:
            assert name in src, (module.__name__, name)
    assert greedy_cuda.plan(5, 160) == shapes.greedy_plan(5, 160)
    assert leap_cuda.plan(5, 160, (1, 4, 2)).stem == "leap_k5_w5_x1o4e2"
    assert nw_cuda.plan(96).stem == "nw_w3"
    assert nw_band.plan(96).stem == "nw_band_w3"
