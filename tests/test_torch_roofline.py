"""The roofline port on the CPU: the plain versions of the three roofline
kernels (kernels/roofline_cuda.py) against the JAX package's, and the SASS
counter (tools/roofline.py) on a listing in cuobjdump's format.

- probe: against the synthetic Pallas kernel of
  tests/test_roofline_counts.py, rebuilt here and run with interpret=True
  on a nonzero input;
- issue_chain and stream_fold: against a numpy statement of
  tools/roofline.py:56-73 (the issue kernel's chains) and :125-135 (the
  stream kernel's fold). The JAX functions build their pallas_calls
  without an interpret flag and cannot lower on the CPU.
- count_sass: the counterpart of test_count_jaxpr_on_synthetic_kernel: a
  loop body charged at the given weight, memory counted per instruction,
  nothing left uncategorised.

Tolerance: exact (integer words and counts)."""

import numpy as np
import pytest
import torch

from asm_tpu_torch.kernels import roofline_cuda as rc
from asm_tpu_torch.tools import roofline as rl

torch.set_num_threads(1)


def test_probe_plain_matches_synthetic_pallas_kernel():
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    def kernel(x_ref, o_ref, scratch):
        v = x_ref[...]
        v = v + 1
        v = v ^ 3
        scratch[0] = v

        def body(i):
            scratch[0] = scratch[0] + 1
            return i + 1

        jax.lax.while_loop(lambda i: i < x_ref[0, 0], body, 0)
        o_ref[...] = scratch[0]

    fn = pl.pallas_call(
        kernel,
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((8, 128), jnp.int32),
        scratch_shapes=[pltpu.VMEM((1, 8, 128), jnp.int32)],
        interpret=True,
    )
    rng = np.random.default_rng(5)
    x = rng.integers(-(1 << 31), 1 << 31, size=(8, 128), dtype=np.int64
                     ).astype(np.int32)
    x[0, 0] = 6
    x[0, 1], x[0, 2] = np.iinfo(np.int32).max, -1  # wrap and sign
    want = np.asarray(fn(jnp.asarray(x)))
    got = rc.probe(torch.from_numpy(x.reshape(-1))).numpy().reshape(8, 128)
    np.testing.assert_array_equal(got, want)
    # a nonpositive x[0] runs the loop no times
    x[0, 0] = -4
    np.testing.assert_array_equal(
        rc.probe_plain(torch.from_numpy(x.reshape(-1))).numpy(),
        (((x.reshape(-1).astype(np.int64) + 1) & 0xFFFFFFFF) ^ 3
         ).astype(np.uint32).view(np.int32))


def test_issue_chain_plain_matches_numpy_statement():
    """roofline.py:56-73: acc[s] = x + s; n times, per stream, unroll times
    v = (v + 1) ^ 12345; out = the xor of the streams."""
    rng = np.random.default_rng(6)
    x = rng.integers(0, 1 << 32, size=(8, 128), dtype=np.uint64
                     ).astype(np.uint32)
    n = 5
    acc = [x + np.uint32(s) for s in range(rc.STREAMS)]
    for _ in range(n):
        for s in range(rc.STREAMS):
            v = acc[s]
            for _ in range(rc.UNROLL):
                v = (v + np.uint32(1)) ^ np.uint32(12345)
            acc[s] = v
    want = acc[0]
    for s in range(1, rc.STREAMS):
        want = want ^ acc[s]
    seeds = np.stack([x.reshape(-1) + np.uint32(s)
                      for s in range(rc.STREAMS)], axis=1)
    got = rc.issue_chain(torch.from_numpy(seeds.view(np.int32)), n)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.reshape(-1))
    assert rc.issue_chain_ops(1024, n) == 1024 * n * rc.STREAMS * rc.UNROLL * 2


@pytest.mark.parametrize("rows", [64, 192, 3])
def test_stream_fold_plain_matches_numpy_statement(rows):
    """roofline.py:125-135: the xor of each grid step's 64 (8, 128) rows,
    xor-accumulated into one (8, 128) tile; its 1024 words xor to the
    fold of the whole array (an odd length exercises the zero pad)."""
    rng = np.random.default_rng(rows)
    x = rng.integers(0, 1 << 32, size=(rows, 8, 128), dtype=np.uint64
                     ).astype(np.uint32)
    tile = np.zeros((8, 128), np.uint32)
    for i in range(0, rows, 64):
        acc = x[i]
        for r in range(i + 1, min(i + 64, rows)):
            acc = acc ^ x[r]
        tile = tile ^ acc
    want = np.bitwise_xor.reduce(tile.reshape(-1))
    flat = torch.from_numpy(x.reshape(-1).view(np.int32))
    got = rc.stream_fold(flat)
    assert got.shape == (1,)
    assert int(got.numpy().view(np.uint32)[0]) == int(want)
    odd = flat[:1001]
    assert int(rc.stream_fold_plain(odd)) == int(
        np.bitwise_xor.reduce(odd.numpy()))


def test_wrappers_refuse_bad_inputs():
    with pytest.raises(ValueError):
        rc.probe(torch.zeros(0, dtype=torch.int32))
    with pytest.raises(TypeError):
        rc.stream_fold(torch.zeros(8, dtype=torch.int64))
    with pytest.raises(ValueError):
        rc.issue_chain(torch.zeros((4, rc.STREAMS + 1), dtype=torch.int32), 1)
    with pytest.raises(ValueError):
        rc.issue_chain(torch.zeros((4, rc.STREAMS), dtype=torch.int32), -1)


# One function in cuobjdump -sass's format: straight-line code, a loop
# (0x90-0xe0) and an outer loop (0x100-0x180) around an inner one
# (0x120-0x150); the end-of-function self-branch is no loop.
LISTING = """\
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_116synthetic_kernelEPKiPii
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                 /* 0x00000a00ff017b82 */
                                                                          /* 0x000fe40000000800 */
        /*0010*/                   S2R R0, SR_TID.X ;                     /* 0x0000000000007919 */
                                                                          /* 0x000e220000002100 */
        /*0020*/                   LDG.E R2, desc[UR4][R4.64] ;           /* 0x0000000404027981 */
                                                                          /* 0x000ea4000c1e1900 */
        /*0030*/                   IADD3 R2, R2, 0x1, RZ ;                /* 0x0000000102027810 */
                                                                          /* 0x004fc80007ffe0ff */
        /*0040*/                   LOP3.LUT R2, R2, 0x3, RZ, 0x3c, !PT ;  /* 0x0000000302027812 */
                                                                          /* 0x000fca00078e3cff */
        /*0050*/                   STS [R0], R2 ;                         /* 0x0000000200007388 */
                                                                          /* 0x0001e80000000800 */
        /*0060*/                   ISETP.GE.AND P0, PT, R6, 0x1, PT ;     /* 0x000000010600780c */
                                                                          /* 0x000fe20003f06270 */
        /*0070*/                   IMAD.MOV.U32 R7, RZ, RZ, RZ ;          /* 0x000000ffff077224 */
                                                                          /* 0x000fd400078e00ff */
        /*0080*/              @!P0 BRA `(.L_x_0) ;                        /* 0x0000000000188947 */
                                                                          /* 0x000fea0003800000 */
.L_x_1:
        /*0090*/                   LDS R3, [R0] ;                         /* 0x0000000000037984 */
                                                                          /* 0x000e240000000800 */
        /*00a0*/                   VIADD R3, R3, 0x1 ;                    /* 0x0000000103037836 */
                                                                          /* 0x001fca0000000000 */
        /*00b0*/                   STS [R0], R3 ;                         /* 0x0000000300007388 */
                                                                          /* 0x0001e20000000800 */
        /*00c0*/                   VIADD R7, R7, 0x1 ;                    /* 0x0000000107077836 */
                                                                          /* 0x000fca0000000000 */
        /*00d0*/                   ISETP.GE.AND P0, PT, R7.reuse, R6, PT ; /* 0x000000060700720c */
                                                                          /* 0x000fda0003f06270 */
        /*00e0*/              @!P0 BRA `(.L_x_1) ;                        /* 0xfffffffc00e88947 */
                                                                          /* 0x001fea000383ffff */
.L_x_0:
        /*00f0*/                   MOV R9, RZ ;                           /* 0x000000ff00097202 */
                                                                          /* 0x000fe40000000f00 */
.L_x_3:
        /*0100*/                   SHF.L.U32 R10, R9, 0x2, RZ ;           /* 0x00000002090a7819 */
                                                                          /* 0x000fe200000006ff */
        /*0110*/                   MOV R11, RZ ;                          /* 0x000000ff000b7202 */
                                                                          /* 0x000fe40000000f00 */
.L_x_2:
        /*0120*/                   POPC R12, R10 ;                        /* 0x0000000a000c7309 */
                                                                          /* 0x000e220000000000 */
        /*0130*/                   IADD3 R11, R11, 0x1, RZ ;              /* 0x000000010b0b7810 */
                                                                          /* 0x000fc80007ffe0ff */
        /*0140*/                   ISETP.NE.AND P1, PT, R11, 0x4, PT ;    /* 0x000000040b00780c */
                                                                          /* 0x000fda0003f25270 */
        /*0150*/               @P1 BRA `(.L_x_2) ;                        /* 0xfffffffc00f01947 */
                                                                          /* 0x001fea000383ffff */
        /*0160*/                   IADD3 R9, R9, 0x1, RZ ;                /* 0x0000000109097810 */
                                                                          /* 0x000fc80007ffe0ff */
        /*0170*/                   ISETP.NE.AND P2, PT, R9, R6, PT ;      /* 0x000000060900720c */
                                                                          /* 0x000fda0003f45270 */
        /*0180*/               @P2 BRA `(.L_x_3) ;                        /* 0xfffffff400dc2947 */
                                                                          /* 0x000fea000383ffff */
        /*0190*/                   LDS R3, [R0] ;                         /* 0x0000000000037984 */
                                                                          /* 0x000e240000000800 */
        /*01a0*/                   STG.E desc[UR4][R4.64], R3 ;           /* 0x0000000304007986 */
                                                                          /* 0x001fe2000c101904 */
        /*01b0*/                   EXIT ;                                 /* 0x000000000000794d */
                                                                          /* 0x000fea0003800000 */
.L_x_4:
        /*01c0*/                   BRA `(.L_x_4);                         /* 0xfffffffc00fc7947 */
                                                                          /* 0x000fc0000383ffff */
        /*01d0*/                   NOP;                                   /* 0x0000000000007918 */
                                                                          /* 0x000fc00000000000 */
\t\t..........
"""


def test_count_sass_on_synthetic_listing():
    assert rl.find_kernels(LISTING) == [
        "_ZN12_GLOBAL__N_116synthetic_kernelEPKiPii"]
    c = rl.count_sass(LISTING, [7.0, 3.0, 5.0])
    loops = c["loops"]
    assert [(lp["start"], lp["end"], lp["insts"], lp["depth"])
            for lp in loops] == [("0x90", "0xe0", 6, 0),
                                 ("0x100", "0x180", 9, 0),
                                 ("0x120", "0x150", 4, 1)]
    counts = c["counts"]
    # each loop body at its weight, the inner one at the product
    assert counts["arith"] == 2 + 7.0 * 2 + 3.0 * 1 + 3.0 * 5.0 * 1, counts
    assert counts["shift"] == 3.0 and counts["popcount"] == 15.0
    assert counts["selcmp"] == 1 + 7.0 + 3.0 + 15.0
    # memory per instruction: LDC, LDG, STS; the loop's LDS + STS; LDS, STG
    assert counts["mem"] == 3 + 7.0 * 2 + 2
    assert counts["other"] == 0
    assert c["skipped"] == 7 + 7.0 * 1 + 3.0 * 2 + 15.0 * 1

    # weight w against weight 0: exactly w times the body
    c0, c7 = rl.count_sass(LISTING, [0.0]), rl.count_sass(LISTING, [7.0])
    body = c7["loops"][0]["body"]
    assert body == dict(arith=2, shift=0, popcount=0, selcmp=1, mem=2,
                        other=0, skip=1)
    for cat in rl.CATEGORIES:
        assert c7["counts"][cat] - c0["counts"][cat] == 7.0 * body[cat]
    # loops without a weight are charged once, and say so
    assert [lp["weighted"] for lp in c7["loops"]] == [True, False, False]
    assert c7["loops"][1]["weight"] == 1.0
    assert rl.main_loop_weights(LISTING, 4.0) == [None, 4.0]
    # the first loop's trip control: its compare and its counter's add
    assert rl.loop_control(LISTING, c7["loops"][0]) == [
        (0xD0, "ISETP.GE.AND"), (0xC0, "VIADD")]


def test_sass_categories_and_warp_weights():
    cats = {op: rl.category(op) for op in (
        "IMAD.MOV.U32", "IMAD.SHL.U32", "IMAD.IADD", "LOP3.LUT", "UIADD3",
        "ULDC.64", "UMOV", "BREV", "FLO.U32", "SEL", "SHFL.BFLY", "BAR.SYNC")}
    assert cats == {
        "IMAD.MOV.U32": "skip", "IMAD.SHL.U32": "shift",
        "IMAD.IADD": "arith", "LOP3.LUT": "arith", "UIADD3": "arith",
        "ULDC.64": "mem", "UMOV": "skip", "BREV": "popcount",
        "FLO.U32": "popcount", "SEL": "selcmp", "SHFL.BFLY": "other",
        "BAR.SYNC": "skip"}
    # warps of 32 in launch order, a partial last warp counted by its pairs
    assert rl.warp_max_mean(np.arange(70)) == pytest.approx(
        (31 * 32 + 63 * 32 + 69 * 6) / 70)
    assert rl.warp_max_mean([2.0] * 64) == 2.0


@pytest.mark.parametrize("is_bound", [True, False])
def test_report_marks_a_count_that_is_no_bound(is_bound, capsys):
    kc = dict(function=rl.find_kernels(LISTING)[0],
              weights={"mean": 2.0, "warp": 3.0},
              counts={"mean": rl.count_sass(LISTING, [2.0]),
                      "warp": rl.count_sass(LISTING, [3.0])})
    line = rl.report("synthetic", kc, 100.0, 1e-3, 10 ** 6, 1e10, 1e12, 0.5,
                     issue_is_bound=is_bound)
    insts = {k: sum(c["counts"].values()) for k, c in kc["counts"].items()}
    assert line["thread_insts_per_pair"] == insts
    assert line["divergence_x"] == insts["warp"] / insts["mean"]
    assert line["issue_bound_ns_per_pair"]["warp"] == pytest.approx(
        insts["warp"] / 10)
    assert line["stream_bound_ns_per_pair"] == pytest.approx(0.1)
    assert line["recurrence_bound_ns_per_pair"] == 0.5
    assert line["issue_count_is_bound"] is is_bound
    if is_bound:  # 1 ns per pair measured against the issue wall
        assert line["binding_wall"] == "issue"
        assert line["headroom_x"] == pytest.approx(10 / insts["warp"])
    else:
        assert line["binding_wall"] is None and line["headroom_x"] is None
    assert '"kernel": "synthetic"' in capsys.readouterr().out


def test_sass_listing_needs_cuobjdump(monkeypatch, tmp_path):
    import importlib.util

    monkeypatch.setattr(rl.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(importlib.util, "find_spec", lambda name: None)
    with pytest.raises(FileNotFoundError):
        rl.sass_listing(str(tmp_path / "lib.so"), "probe_kernel")


def test_roofline_cli_parses_and_needs_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in ([], ["micro", "leap", "--pairs", "64"]):
        with pytest.raises(SystemExit, match="no CUDA device"):
            rl.main(argv)
    with pytest.raises(SystemExit):
        rl.main(["bogus"])
    assert "invalid choice" in capsys.readouterr().err
