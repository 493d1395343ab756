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
  nothing left uncategorised; and the NW band kernel's loop count
  (nw_band_loop, on band_kernel's layout and the wide path's) and
  instantiation at the plan's max_len.

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


@pytest.mark.parametrize("op", rc.OPS)
def test_op_chain_plain_matches_numpy_statement(op):
    """csrc/roofline.cu op_chain: at each step every chain s at once, from
    its value v and its neighbours' w and z (chains (s + 1) and (s + 2) %
    STREAMS), becomes min(v + a, w) (viaddmin; seeds shifted right by 8),
    min(v, w) at even and max(v, w) at odd steps (minmax), a if v < w else
    w (setp_sel), v * w + a (imad), v + w (iadd), for mix viaddmin on the
    first half of the chains and imad on the second, min(v, w, z) at even
    and max(v, w, z) at odd steps (minmax3), w + a at even and w ^ a at
    odd steps (add_xor): 32-bit signed words, wrapping; out is the xor of
    the chains."""
    rng = np.random.default_rng(8)
    seeds = rng.integers(-(1 << 31), 1 << 31, size=(64, rc.STREAMS),
                         dtype=np.int64)
    seeds[0] = [(1 << 31) - 1, -(1 << 31), -1, 0, 1, 2, 3, 4]
    iters, a = 3, 5

    def wrap(x):
        return (x + (1 << 31)) % (1 << 32) - (1 << 31)

    v = seeds >> 8 if op in ("viaddmin", "mix") else seeds.copy()
    for _ in range(iters):
        for u in range(rc.UNROLL):
            w, z = np.roll(v, -1, axis=1), np.roll(v, -2, axis=1)
            new = np.empty_like(v)
            for s in range(rc.STREAMS):
                kind = op if op != "mix" else (
                    "viaddmin" if s < rc.STREAMS // 2 else "imad")
                vs, ws, zs = v[:, s], w[:, s], z[:, s]
                f3 = np.maximum if u % 2 else np.minimum
                new[:, s] = wrap({
                    "viaddmin": lambda: np.minimum(vs + a, ws),
                    "minmax": lambda: (np.maximum if u % 2 else np.minimum)(
                        vs, ws),
                    "setp_sel": lambda: np.where(vs < ws, a, ws),
                    "imad": lambda: vs * ws + a,
                    "iadd": lambda: vs + ws,
                    "minmax3": lambda: f3(vs, f3(ws, zs)),
                    "add_xor": lambda: ws ^ a if u % 2 else ws + a}[kind]())
            v = new
    want = np.bitwise_xor.reduce(v & 0xFFFFFFFF, axis=1)
    got = rc.op_chain(torch.from_numpy(seeds.astype(np.int32)), iters, op,
                      a)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.astype(np.uint32))
    assert rc.op_chain_ops(256, iters, op) == (
        256 * iters * rc.STREAMS * rc.UNROLL * rc.OP_INSTS[op])


def test_chain_census_leaves_out_the_trip_control(monkeypatch):
    """roofline.chain_census counts the op's opcodes in op_chain's loop,
    not the compare that closes the loop (a compare and select chain's
    ISETP beside the trip's)."""
    body = ["ISETP.GE.AND P1, PT, R2, R3, PT", "SEL R2, R4, R3, P1"] * 3
    listing = _split_listing([body + ["UIADD3 UR4, UR4, 0x1, URZ",
                                      "ISETP.LE.AND P0, PT, R9, UR4, PT"]])
    monkeypatch.setattr(rl, "sass_listing", lambda lib, fn: listing)
    got = rl.chain_census("lib.so", "setp_sel")
    assert got["chain_insts"] == 6
    assert got["expected"] == rc.STREAMS * rc.UNROLL * 2
    assert got["opcodes"]["ISETP.GE.AND"] == 3


def test_wrappers_refuse_bad_inputs():
    with pytest.raises(ValueError):
        rc.probe(torch.zeros(0, dtype=torch.int32))
    with pytest.raises(TypeError):
        rc.stream_fold(torch.zeros(8, dtype=torch.int64))
    with pytest.raises(ValueError):
        rc.issue_chain(torch.zeros((4, rc.STREAMS + 1), dtype=torch.int32), 1)
    with pytest.raises(ValueError):
        rc.issue_chain(torch.zeros((4, rc.STREAMS), dtype=torch.int32), -1)
    with pytest.raises(ValueError, match="op must be one of"):
        rc.op_chain(torch.zeros((4, rc.STREAMS), dtype=torch.int32), 1,
                    "vimnmx3")
    with pytest.raises(ValueError):
        rc.op_chain(torch.zeros((4, rc.STREAMS), dtype=torch.int32), -1,
                    "imad")


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


def test_count_kernel_weights_nested_loops():
    """A loop nested in the main loop runs `inner` trips per main-loop
    trip (greedy's lane loops: 2k+1); loops outside it are charged once."""
    assert rl.main_loop_weights(LISTING, 4.0, inner=5.0) == [None, 4.0, 5.0]
    kc = rl.count_kernel(LISTING, [2.0, 2.0, 4.0], inner=5.0)
    assert kc["weights"] == {"mean": pytest.approx(8 / 3), "warp": 4.0}
    assert kc["trip"]["by_category"] == dict(
        arith=6.0, shift=1.0, popcount=5.0, selcmp=6.0, mem=0.0, other=0.0,
        skip=7.0)
    assert kc["trip"]["opcodes"]["POPC"] == 5.0
    base = rl.count_sass(LISTING, [None, 0.0])["counts"]
    for cat in rl.CATEGORIES:  # 4 trips of the main loop at the warp weight
        assert kc["counts"]["warp"]["counts"][cat] == pytest.approx(
            base[cat] + 4.0 * kc["trip"]["by_category"][cat]), cat


def test_greedy_counts_weight_the_one_lane_loop(monkeypatch):
    """greedy_counts weights the one loop inside the step loop (here the
    inner loop 0x120-0x150) by the 2k+1 lanes, and refuses a step loop
    that holds another number of loops."""
    monkeypatch.setattr(rl, "sass_listing", lambda lib, fn: LISTING)
    kc = rl.greedy_counts([1.0, 1.0], lib_path="lib.so")
    assert kc["trip"]["by_category"]["popcount"] == rl.GREEDY_LANES
    flat = LISTING.replace("@P1 BRA `(.L_x_2) ;      ", "@P1 NOP ;              ")
    monkeypatch.setattr(rl, "sass_listing", lambda lib, fn: flat)
    with pytest.raises(ValueError, match="holds 0 loops"):
        rl.greedy_counts([1.0, 1.0], lib_path="lib.so")


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


@pytest.mark.parametrize("bw", [8, 16])
def test_nw_band_loop_on_synthetic_listing(bw):
    """The band kernel's diagonal loop is the one that holds shuffles: here
    the first loop, once its LDS is a SHFL.UP and its STS a SHFL.DOWN. Two
    shuffles are one diagonal, one existing cell per thread; a warp holds
    64/BW pairs."""
    listing = LISTING.replace(
        "LDS R3, [R0] ;                         /* 0x0",
        "SHFL.UP PT, R3, R3, 0x1, RZ ;          /* 0x0", 1).replace(
        "STS [R0], R3 ;                         /* 0x0",
        "SHFL.DOWN PT, R3, R3, 0x1, 0x1f ;      /* 0x0", 1)
    mn = np.array([200, 10, 10, 10, 150, 150, 150, 20, 4])
    got = rl.nw_band_loop(listing, bw, mn)
    assert got["pairs_per_warp"] == 64 // bw and got["loop_shuffles"] == 2
    assert got["existing_cells_per_trip"] == 1.0
    assert got["loop_insts"] == 6
    assert got["loop_body"] == dict(arith=2, selcmp=1, other=2, skip=1)
    assert got["loop_opcodes"]["SHFL.UP"] == got["loop_opcodes"][
        "SHFL.DOWN"] == 1
    assert got["loop_insts_per_existing_cell"] == 6.0
    assert got["mn_mean"] == pytest.approx(mn.mean())
    assert got["mn_warp_max_mean"] == rl.warp_max_mean(mn, 64 // bw)
    assert got["mn_divergence_x"] == pytest.approx(
        rl.warp_max_mean(mn, 64 // bw) / mn.mean())
    with pytest.raises(ValueError, match="shuffles"):
        rl.nw_band_loop(LISTING, bw, mn)


def _band_listing(second_loop_shuffles: int) -> str:
    """LISTING with two shuffles in its first loop (6 instructions) and
    `second_loop_shuffles` (1 or 2) in its second loop's own body (5)."""
    listing = LISTING.replace(
        "LDS R3, [R0] ;                         /* 0x0",
        "SHFL.UP PT, R3, R3, 0x1, RZ ;          /* 0x0", 1).replace(
        "STS [R0], R3 ;                         /* 0x0",
        "SHFL.DOWN PT, R3, R3, 0x1, 0x1f ;      /* 0x0", 1).replace(
        "SHF.L.U32 R10, R9, 0x2, RZ ;           /* 0x0",
        "SHFL.UP PT, R10, R9, 0x1, RZ ;         /* 0x0", 1)
    if second_loop_shuffles == 2:
        listing = listing.replace(
            "IADD3 R9, R9, 0x1, RZ ;                /* 0x0",
            "SHFL.DOWN PT, R9, R9, 0x1, 0x1f ;      /* 0x0", 1)
    return listing


@pytest.mark.parametrize("bw,np_", [(64, 1), (64, 2), (128, 2), (128, 4)])
def test_nw_band_loop_counts_the_wide_layout(bw, np_):
    """The wide path (band_wide_kernel): np_ offset pairs a thread (1 and
    2, and 4, the layout kept at BW 128), one shuffle a diagonal, so a
    trip's existing cells are np_ x its shuffles; with two shuffles a
    diagonal (band_kernel's layout, widened) np_ x half of them. A pair takes
    bw / (2 np_) threads, so a warp holds 32 / that. Of several loops that
    hold shuffles (the wide kernel's border, main and destination loops)
    the count reads the one with the fewest instructions per shuffle."""
    mn = np.array([200, 10, 10, 10, 150, 150, 150, 20, 4])
    ppw = 32 // (bw // (2 * np_))
    one = _band_listing(1)  # the first loop: 6 instructions, 2 shuffles
    got = rl.nw_band_loop(one, bw, mn, np_, rl.WIDE_SHFL_PER_DIAGONAL)
    assert got["diagonal_loops"] == 2 and got["loop_insts"] == 6
    assert got["loop_shuffles"] == 2
    assert got["existing_cells_per_trip"] == 2 * np_
    assert got["loop_insts_per_existing_cell"] == 6 / (2 * np_)
    assert got["pairs_per_warp"] == ppw
    assert got["offset_pairs_per_thread"] == np_
    assert got["mn_warp_max_mean"] == rl.warp_max_mean(mn, ppw)
    old = rl.nw_band_loop(one, bw, mn, np_)
    assert old["existing_cells_per_trip"] == np_
    assert old["loop_insts_per_existing_cell"] == 6 / np_
    # two shuffles in the second loop's 5 instructions: now the main one
    got = rl.nw_band_loop(_band_listing(2), bw, mn, np_,
                          rl.WIDE_SHFL_PER_DIAGONAL)
    assert got["loop_insts"] == 5 and got["loop_shuffles"] == 2
    assert got["loop_body"]["other"] == 2
    assert rl.wide_function(bw, 2048) == f"band_wide_kernelILi{bw}ELi64E"
    with pytest.raises(ValueError, match="threads a pair"):
        rl.nw_band_loop(one, bw, mn, bw)  # a pair on half a thread


def test_nw_band_loop_on_one_thread_a_pair():
    """Where a pair is one thread (BW = 2 NP: BW 4 at NP 2) its loop holds
    no shuffles: a trip is its two code loads (LDS.U8), 2 NP cells; a
    warp holds 32 pairs."""
    listing = LISTING.replace(
        "LDS R3, [R0] ;                         /* 0x0",
        "LDS.U8 R3, [R0] ;                      /* 0x0", 1).replace(
        "STS [R0], R3 ;                         /* 0x0",
        "LDS.U8 R3, [R0+0x1] ;                  /* 0x0", 1)
    mn = np.array([200, 10, 10, 10, 150, 150, 150, 20, 4])
    got = rl.nw_band_loop(listing, 4, mn, 2)
    assert got["diagonal_loops"] == 1 and got["loop_shuffles"] == 0
    assert got["existing_cells_per_trip"] == 4 and got["loop_insts"] == 6
    assert got["loop_insts_per_existing_cell"] == 1.5
    assert got["pairs_per_warp"] == 32
    with pytest.raises(ValueError, match="code loads"):
        rl.nw_band_loop(LISTING, 4, mn, 2)


@pytest.mark.parametrize("L", [128, 256])
@pytest.mark.parametrize("pre_staged", [True, False])
def test_band_instantiation_follows_the_plans_max_len(L, pre_staged):
    """nw_band_lines counts band_kernel<BW, L/32>, L read from the plan's
    chunks: planes [L/16, b] or codes [b, L]."""
    from asm_tpu_torch.kernels.nw_dispatch import nw_partition_plan

    b = 5
    codes = (np.zeros((L // 16, b), np.uint32) if pre_staged
             else np.zeros((b, L), np.int8))
    lens = np.full(b, 3, np.int32)
    plan = nw_partition_plan(codes, lens, codes, lens,
                             np.full(b, 16, np.int32), pre_staged=pre_staged,
                             device="cpu")
    assert rl.plan_max_len(plan) == L
    assert rl.band_function(16, L) == f"band_kernelILi16ELi{L // 32}E"


@pytest.mark.parametrize("is_bound", [True, False])
def test_report_marks_a_count_that_is_no_bound(is_bound, capsys):
    kc = rl.count_kernel(LISTING, [1.0, 3.0])  # mean 2, warp maximum 3
    assert kc["weights"] == {"mean": 2.0, "warp": 3.0}
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
        # the warp weight's instructions for 10^6 pairs in 1 ms
        assert line["issued_thread_insts_per_sec"] == pytest.approx(
            insts["warp"] * 1e9)
    else:
        assert line["binding_wall"] is None and line["headroom_x"] is None
        assert line["issued_thread_insts_per_sec"] is None
    # one trip of the main loop (0x100-0x180), its inner loop once
    assert line["main_loop_trip"] == dict(arith=2, shift=1, popcount=1,
                                          selcmp=2, skip=3)
    assert line["main_loop_trip_opcodes"] == {
        "IADD3": 2.0, "ISETP.NE.AND": 2.0, "BRA": 2.0, "SHF.L.U32": 1.0,
        "MOV": 1.0, "POPC": 1.0}
    assert '"kernel": "synthetic"' in capsys.readouterr().out
    line = rl.report("synthetic", kc, 100.0, 1e-3, 10 ** 6, 1e10, 1e12, 0.5,
                     issue_is_bound=is_bound,
                     resources=dict(registers=96, warps_per_sm=20))
    assert (line["registers"], line["warps_per_sm"]) == (96, 20)


# nvcc -Xptxas -v's report for two kernels: the greedy kernel's main-path
# instantiation without spills, and another that spills
PTXAS_REPORT = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_113greedy_kernelILi3ELi4ELb1EsEEvPKjS2_PKiS4_NS_6ParamsEPiS7_PT2_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_113greedy_kernelILi3ELi4ELb1EsEEvPKjS2_PKiS4_NS_6ParamsEPiS7_PT2_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, used 0 barriers, 416 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_113greedy_kernelILi3ELi8ELb1EiEEvPKjS2_PKiS4_NS_6ParamsEPiS7_PT2_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_113greedy_kernelILi3ELi8ELb1EiEEvPKjS2_PKiS4_NS_6ParamsEPiS7_PT2_
    24 bytes stack frame, 16 bytes spill stores, 20 bytes spill loads
ptxas info    : Used 128 registers, used 0 barriers, 416 bytes cmem[0]
"""


def test_greedy_resources_from_a_ptxas_report(monkeypatch):
    """The greedy line's registers and spills come from the main-path
    instantiation's entry in the ptxas report, its warps per SM from the
    occupancy query (which answers warps: the block size is per
    instantiation)."""
    from asm_tpu_torch.kernels import greedy_cuda
    from asm_tpu_torch.utils.build import ptxas_usage

    usage = ptxas_usage(PTXAS_REPORT)
    assert list(usage.values()) == [
        dict(registers=96, spill_stores=0, spill_loads=0),
        dict(registers=128, spill_stores=16, spill_loads=20)]
    assert all("greedy_kernel" in k for k in usage)
    monkeypatch.setattr(greedy_cuda, "occupancy", lambda *a, **kw: 20)
    assert rl.greedy_resources(PTXAS_REPORT) == dict(
        registers=96, spill_stores=0, spill_loads=0, warps_per_sm=20)
    with pytest.raises(ValueError, match="0 kernels"):
        rl.greedy_resources(PTXAS_REPORT.replace("ILi3ELi4E", "ILi2ELi4E"))


# the LEAP kernel's main-path instantiation (k = 3, W = 4, x = o = e = 1,
# lv_bag, penalty mode, planes) beside a CIGAR one and a simd_ed_affine one
# on codes, as nvcc -Xptxas -v reports them
LEAP_TAIL = "EEvPKjS2_PKiS4_NS_6ParamsEPhPiS8_S8_Pj"
LEAP_NAMES = [f"_ZN12_GLOBAL__N_111leap_kernelILi{a}{LEAP_TAIL}" for a in (
    "3ELi4ELi1ELi1ELi1ELi0ELb0ELb1", "3ELi4ELi1ELi1ELi1ELi0ELb1ELb1",
    "4ELi8ELi2ELi3ELi1ELi2ELb0ELb0")]
# LISTING with its second loop nest's back-edges gone: one loop
ONE_LOOP = LISTING.replace("@P1 BRA `(.L_x_2) ;      ",
                           "@P1 NOP ;              ").replace(
    "@P2 BRA `(.L_x_3) ;      ", "@P2 NOP ;              ")
LEAP_PTXAS = "".join(
    f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
    f"    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
    f"ptxas info    : Used {regs} registers, used 0 barriers\n"
    for name, regs in zip(LEAP_NAMES, (48, 72, 56)))


def test_leap_line_is_a_bound(monkeypatch, capsys):
    """LEAP's count reads the main path's instantiation alone (lv_bag,
    penalty mode, planes: template parameters) with its one loop, so its
    line states a binding wall, a headroom and the rate it issued at, with
    the instantiation's registers and warps per SM."""
    from asm_tpu_torch.kernels import leap_cuda

    assert rl.LEAP_FN in LEAP_NAMES[0]
    assert sum(rl.LEAP_FN in name for name in LEAP_NAMES) == 1
    asked = []
    monkeypatch.setattr(rl, "sass_listing",
                        lambda lib, fn: asked.append(fn) or ONE_LOOP)
    kc = rl.leap_counts([1.0, 3.0], lib_path="lib.so")
    assert asked == [rl.LEAP_FN]
    assert kc["weights"] == {"mean": 2.0, "warp": 3.0}
    monkeypatch.setattr(leap_cuda, "occupancy", lambda *a, **kw: 7)
    use = rl.leap_resources(LEAP_PTXAS)
    assert use == dict(registers=48, spill_stores=0, spill_loads=0,
                       blocks_per_sm=7, warps_per_sm=28)
    line = rl.report("leap", kc, 100.0, 1e-3, 10 ** 6, 1e10, 1e12, 0.5,
                     resources=use)
    insts = {k: sum(c["counts"].values()) for k, c in kc["counts"].items()}
    assert line["issue_count_is_bound"] is True
    assert line["binding_wall"] == "issue"
    assert line["headroom_x"] == pytest.approx(10 / insts["warp"])
    assert line["issued_thread_insts_per_sec"] == pytest.approx(
        insts["warp"] * 1e9)
    assert (line["registers"], line["warps_per_sm"]) == (48, 28)
    assert '"kernel": "leap"' in capsys.readouterr().out
    with pytest.raises(ValueError, match="0 kernels"):
        rl.leap_resources(LEAP_PTXAS.replace("ELi0ELb0ELb1", "ELi0ELb0ELb0"))
    # a second loop (the energy loop compiled once per mode) is refused
    monkeypatch.setattr(rl, "sass_listing", lambda lib, fn: LISTING)
    with pytest.raises(ValueError, match="holds 3 loops"):
        rl.leap_counts([1.0, 3.0], lib_path="lib.so")


# LISTING as an NW kernel: the first loop holds the two shuffles of a
# step (its LDS and STS become SHFL.UP), the second loop nest stores the
# walk's op (its SHF becomes an STG.E.U8)
NW_LISTING = LISTING.replace(
    "LDS R3, [R0] ;                         /* 0x0",
    "SHFL.UP PT, R3, R3, 0x1, RZ ;          /* 0x0", 1).replace(
    "STS [R0], R3 ;                         /* 0x0",
    "SHFL.UP PT, R7, R3, 0x1, RZ ;          /* 0x0", 1).replace(
    "SHF.L.U32 R10, R9, 0x2, RZ ;           /* 0x0",
    "STG.E.U8 desc[UR4][R4.64], R9 ;        /* 0x0", 1)


@pytest.mark.parametrize("layout", ["warp", "G8", "G16", "G32"])
def test_nw_loop_counts_on_synthetic_listing(layout):
    """The NW main loop is the one that holds shuffles (two a step), the
    walk the other outermost loop that stores to global memory. The count
    weights the loop by the warps' steps: one pair per warp and m + n
    steps in the one-warp-per-pair layout (rows W = L/32 per thread),
    32/G pairs per warp and `nw_cuda.warp_steps` in the strips' (rows
    L/G)."""
    from asm_tpu_torch.kernels import nw_cuda

    rng = np.random.default_rng(3)
    m = rng.integers(0, 129, 37)
    n = rng.integers(0, 129, 37)
    m[:3], n[:3] = (0, 5, 128), (7, 0, 128)
    walk = m + n - rng.integers(0, 20, 37).clip(max=np.minimum(m, n))
    if layout == "warp":
        lanes, rows, steps = 32, 4, m + n
    else:
        lanes = int(layout[1:])
        rows, steps = 128 // lanes, nw_cuda.warp_steps(m, n, 128, lanes)
    cells = float(np.sum(m * n))
    got = rl.nw_loop_counts(NW_LISTING, steps, cells, lanes, rows, walk)
    # the first loop: SHFL.UP x2, VIADD x2, ISETP, BRA
    assert got["loop_insts"] == 6 and got["steps_per_trip"] == 1.0
    assert got["insts_per_step"] == 6.0
    assert got["insts_per_slot"] == 6.0 / rows
    assert got["loop_body"] == dict(arith=2, selcmp=1, other=2, skip=1)
    assert got["warp_steps"] == float(np.sum(steps))
    # 32 lanes issue every step of every warp
    assert got["insts_per_existing_cell"] == pytest.approx(
        32 * np.sum(steps) * 6.0 / cells)
    assert got["existing_share"] == pytest.approx(
        cells / (32 * rows * np.sum(steps)))
    # the walk: the outer loop's own body (STG, MOV, IADD3, ISETP, BRA)
    assert got["walk_insts_per_step"] == 5.0
    assert got["walk_body"] == dict(arith=1, selcmp=1, mem=1, skip=2)
    assert got["walk_steps_mean"] == pytest.approx(walk.mean())
    assert got["walk_steps_warp_max_mean"] == pytest.approx(
        rl.warp_max_mean(walk, 32 // lanes))
    # the penalty kernel: no walk asked, none looked for
    assert "walk_insts_per_step" not in rl.nw_loop_counts(
        NW_LISTING, steps, cells, lanes, rows)
    with pytest.raises(ValueError, match="shuffles"):
        rl.nw_loop_counts(LISTING, steps, cells, lanes, rows)
    with pytest.raises(ValueError, match="walk loop"):
        rl.nw_loop_counts(NW_LISTING.replace("STG.E.U8", "LDS.U8"), steps,
                          cells, lanes, rows, walk)


def _split_listing(bodies) -> str:
    """One function in cuobjdump -sass's format whose loops, one after
    another, hold `bodies` (each closed by its backward branch)."""
    lines = ["\tcode for sm_90a", "\t\tFunction : _ZN12_GLOBAL__N_119"
             "nw_long_full_kernelILi32EEvPKaS2_PKiS4_NS_6ParamsEPi"]
    insts = [["S2R R0, SR_TID.X"]] + [
        [f".L_x_{k}:"] + body + [f"@P0 BRA `(.L_x_{k})"]
        for k, body in enumerate(bodies)] + [["EXIT"]]
    addr = 0
    for text in (t for block in insts for t in block):
        if text.endswith(":"):
            lines.append(text)
            continue
        lines.append(f"        /*{addr:04x}*/                   {text} ;")
        addr += 16
    return "\n".join(lines) + "\n"


SHFL = ["SHFL.UP PT, R3, R3, 0x1, RZ", "SHFL.UP PT, R4, R4, 0x1, RZ"]
CELL = ["VIADDMNMX R5, R5, R6, R7, !PT", "VIADDMNMX R8, R8, R6, R9, !PT",
        "ISETP.NE.AND P1, PT, R2, RZ, PT", "SEL R10, R11, R12, P1",
        "VIMNMX R13, R5, R8, PT", "VIADDMNMX R14, R15, R10, R13, PT",
        "IADD3 R9, R14, R16, RZ"]


def test_nw_loop_counts_weight_the_split_step_loop():
    """The long full kernel's step loop in three (head, steady loop,
    tail: `nw_cuda.loop_steps`, in address order): each loop with
    shuffles is weighted by its own steps, its instructions per step read
    from its shuffles (an unrolled loop counts right); the count refuses
    another number of such loops or steps that are not the warps'."""
    # with the branch: 11, 20 (two steps) and 12 instructions a trip
    head = SHFL + ["ISETP.GE.AND P2, PT, R1, 0x1, PT"] + CELL
    steady = SHFL + CELL + SHFL + CELL + ["IADD3 R1, R1, 0x2, RZ"]
    tail = SHFL + ["ISETP.GE.AND P2, PT, R1, R0, PT", "NOP"] + CELL
    listing = _split_listing([head, steady, tail])
    steps = np.array([100, 62])  # two warps (pairs)
    parts = [31, 100, 31]
    cells = 2000.0
    got = rl.nw_loop_counts(listing, steps, cells, 32, 32, loop_steps=parts)
    issued = 31 * 11 + 100 * 10 + 31 * 12
    assert got["insts_per_step"] == pytest.approx(issued / 162)
    assert got["insts_per_slot"] == pytest.approx(issued / 162 / 32)
    assert got["insts_per_existing_cell"] == pytest.approx(
        32 * issued / cells)
    assert got["existing_share"] == pytest.approx(cells / (32 * 32 * 162))
    # the most-run part's loop: the steady one, two steps a trip
    assert (got["loop_insts"], got["steps_per_trip"]) == (20, 2.0)
    assert [p["steps"] for p in got["loop_parts"]] == parts
    assert [p["insts_per_step"] for p in got["loop_parts"]] == [11, 10, 12]
    assert got["loop_parts"][1]["body"] == dict(arith=11, selcmp=4, other=4,
                                                skip=1)
    # without the parts: the longest loop alone (the trace kernel's rule)
    assert rl.nw_loop_counts(listing, steps, cells, 32, 32)[
        "insts_per_step"] == 10
    with pytest.raises(ValueError, match="expected 2 step loops"):
        rl.nw_loop_counts(listing, steps, cells, 32, 32,
                          loop_steps=[62, 100])
    with pytest.raises(ValueError, match="do not sum"):
        rl.nw_loop_counts(listing, steps, cells, 32, 32,
                          loop_steps=[31, 90, 31])


@pytest.mark.parametrize("L", [544, 2048, 3072])
def test_nw_loop_steps_against_a_direct_count(L):
    """The long full kernel's schedule, step by step: in each block of a
    pair (the blocks above its last run n + 31 steps, the last n + (m-1 -
    b RB) // R) steps 1..min(31, steps) are the head, steps 32..n the
    steady loop, the rest the tail; their sum is warp_steps'."""
    from asm_tpu_torch.kernels import nw_cuda
    from asm_tpu_torch.kernels.shapes import nw_long_rows

    rng = np.random.default_rng(L)
    m = np.concatenate([rng.integers(0, L + 9, 40), [0, 5, L, 1, 1024, 1025,
                                                      L, 40, 33]])
    n = np.concatenate([rng.integers(0, L + 9, 40), [9, 0, L, 1, 30, 31,
                                                      32, 33, 1]])
    R = nw_long_rows(L)
    RB = 32 * R
    want = np.zeros(3, np.int64)
    for mi, ni in zip(np.minimum(m, L), np.minimum(n, L)):
        if not (mi and ni):
            continue
        nb = (mi - 1) // RB + 1
        for b in range(nb):
            steps = ni + 31 if b < nb - 1 else ni + (mi - 1 - b * RB) // R
            for s in range(1, steps + 1):
                want[0 if s <= min(31, steps) else 1 if s <= ni else 2] += 1
    got = nw_cuda.loop_steps(m, n, L)
    assert got.tolist() == want.tolist()
    assert got.sum() == nw_cuda.warp_steps(m, n, L, 32).sum()


def test_nw_warp_steps_against_a_direct_count():
    """A warp of 32/G pairs runs until its last pair's thread holding row
    m has swept column n: max over its pairs of n + (m-1) // (L/G), 0 for
    a pair with an empty side; lengths clamped to L."""
    from asm_tpu_torch.kernels import nw_cuda

    rng = np.random.default_rng(5)
    for L in (128, 256):
        m = rng.integers(0, L + 9, 101)
        n = rng.integers(0, L + 9, 101)
        for G in (8, 16, 32):
            want = []
            for w in range(0, 101, 32 // G):
                best = 0
                for i in range(w, min(w + 32 // G, 101)):
                    mi, ni = min(m[i], L), min(n[i], L)
                    if mi and ni:
                        best = max(best, ni + (mi - 1) // (L // G))
                want.append(best)
            assert nw_cuda.warp_steps(m, n, L, G).tolist() == want


# the NW instantiations as nvcc -Xptxas -v reports them: (W, G, route)
NW_TAIL = "EEvPKaS1_PKiS3_NS_6ParamsEPiPaS6_Ph"
NW_INSTANCES = {(4, False): (8, 0), (4, True): (16, 2), (8, False): (8, 0),
                (8, True): (8, 1), (16, False): (16, 0), (16, True): (16, 1)}
NW_PTXAS = "".join(
    f"ptxas info    : Compiling entry function "
    f"'_ZN12_GLOBAL__N_19nw_kernelILi{w}ELi{g}ELi{r}{NW_TAIL}' for 'sm_90a'\n"
    f"    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
    f"ptxas info    : Used {regs} registers, used 0 barriers\n"
    for ((w, _), (g, r)), regs in zip(NW_INSTANCES.items(),
                                      (72, 64, 40, 56, 122, 159)))


def test_nw_resources_from_a_ptxas_report(monkeypatch):
    """The NW lines' registers and spills come from the launched
    instantiation's entry (W, G and route in its name), its warps per SM
    from `nw_cuda.occupancy`."""
    from asm_tpu_torch.kernels import nw_cuda

    table = dict(NW_INSTANCES)
    monkeypatch.setattr(nw_cuda, "instance",
                        lambda trace, L: table[L // 32, trace])
    asked = []
    monkeypatch.setattr(nw_cuda, "occupancy",
                        lambda *a: asked.append(a) or 12)
    assert rl.nw_resources(False, 128, report=NW_PTXAS) == dict(
        registers=72, spill_stores=0, spill_loads=0, warps_per_sm=12)
    assert rl.nw_resources(True, 128, report=NW_PTXAS)["registers"] == 64
    assert rl.nw_resources(False, 256, report=NW_PTXAS)["registers"] == 40
    assert rl.nw_resources(True, 256, report=NW_PTXAS)["registers"] == 56
    assert rl.nw_resources(False, 512, report=NW_PTXAS)["registers"] == 122
    assert rl.nw_resources(True, 512, report=NW_PTXAS)["registers"] == 159
    assert asked == [(False, 128), (True, 128), (False, 256), (True, 256),
                     (False, 512), (True, 512)]
    table[4, False] = (32, 0)  # an instantiation the library does not hold
    with pytest.raises(ValueError, match="0 kernels"):
        rl.nw_resources(False, 128, report=NW_PTXAS)


def test_chip_smoke_names_every_instantiation():
    """chip_smoke's ptxas summary names each kernel instantiation; LEAP's
    carry the semantics (csrc/leap.cu's SEM) and the CIGAR mode."""
    import chip_smoke

    got = [chip_smoke._instance_name(n) for n in LEAP_NAMES]
    assert got == ["leap k3/W4/x1o1e1/lv_bag/planes",
                   "leap k3/W4/x1o1e1/lv_bag/cigar/planes",
                   "leap k4/W8/x2o3e1/simd_ed_affine/codes"]
    assert chip_smoke._instance_name(LEAP_NAMES[0].replace(
        "ELi0ELb0", "ELi3ELb0")) == (
        "leap k3/W4/x1o1e1/simd_ed_lev_gated/planes")
    assert chip_smoke._instance_name(
        "_ZN12_GLOBAL__N_113greedy_kernelILi3ELi4ELb1EsEEvPKj") == (
        "greedy k3/W4/planes")
    # the NW full and trace kernels: W, G threads per pair, the route
    got = [chip_smoke._instance_name(ln.split("'")[1])
           for ln in NW_PTXAS.splitlines() if "Compiling" in ln]
    assert got == ["nw W4/G8", "nw_trace W4/G16/shared", "nw W8/G8",
                   "nw_trace W8/G8/global", "nw W16/G16",
                   "nw_trace W16/G16/global"]
    # max_len 512 (W = 16): greedy at k = 4 with int32 records, LEAP, the
    # band kernel
    assert chip_smoke._instance_name(
        "_ZN12_GLOBAL__N_113greedy_kernelILi4ELi16ELb0EiEEvPKj") == (
        "greedy k4/W16/codes")
    assert chip_smoke._instance_name(rl.greedy_fn(3, 512)) == (
        "greedy k3/W16/planes")
    assert chip_smoke._instance_name(rl.leap_fn(4, 512, cigar=True)) == (
        "leap k4/W16/x1o1e1/lv_bag/cigar/planes")
    assert chip_smoke._instance_name(
        "_ZN12_GLOBAL__N_111band_kernelILi8ELi16EEEvPKjS2_PKiS4_NS_6ParamsEPi"
    ) == "nw_band BW8/W16"
    # the long path: the full kernel and the trace kernel
    assert chip_smoke._instance_name(
        "_ZN12_GLOBAL__N_119nw_long_full_kernelILi64EEEvPKaS2_") == (
        "nw long W64")
    assert chip_smoke._instance_name(
        "_ZN12_GLOBAL__N_114nw_long_kernelILi64ELb1EEEvPKaS2_") == (
        "nw_trace long W64")
    assert chip_smoke._instance_name(
        "_ZN12_GLOBAL__N_112stage_kernelEPKaS1_iiPj") == "nw_stage"
    assert chip_smoke._instance_name("_Z11unknown_fnv") is None


def test_sass_listing_needs_cuobjdump(monkeypatch, tmp_path):
    import importlib.util

    monkeypatch.setattr(rl.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(importlib.util, "find_spec", lambda name: None)
    with pytest.raises(FileNotFoundError):
        rl.sass_listing(str(tmp_path / "lib.so"), "probe_kernel")


def test_roofline_cli_parses_and_needs_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in ([], ["micro", "leap", "--pairs", "64"],
                 ["nw", "--err", "0.2"]):
        with pytest.raises(SystemExit, match="no CUDA device"):
            rl.main(argv)
    with pytest.raises(SystemExit):
        rl.main(["bogus"])
    assert "invalid choice" in capsys.readouterr().err


@pytest.mark.parametrize("kernel,trace", [
    ("greedy", None), ("nw", "false"), ("nw", "true"), ("nw", "smem")])
def test_longseq_sweep_rewrites_one_source_line(kernel, trace):
    """Each layout the sweep tool varies is set by exactly one line of the
    checked-in source, the line its variants replace (nw's "smem": the
    long launch's shared bytes, which the nwlong sweep sets to 2048's for
    the full kernel at 1024); a pattern that matches no line is refused
    before anything is built."""
    import re

    from asm_tpu_torch.kernels import greedy_cuda, nw_cuda
    from asm_tpu_torch.tools import longseq_sweep as ls

    module = greedy_cuda if kernel == "greedy" else nw_cuda
    pattern = (ls.GREEDY_LINE if trace is None else ls.OCC_LINE
               if trace == "smem" else ls.NW_LINE.format(trace=trace))
    with open(module.SOURCE) as f:
        assert len(re.findall(pattern, f.read())) == 1
    with pytest.raises(ValueError, match="matches 0 lines"):
        ls.variant(module, "unused", [(pattern + "x", "")])


def test_longseq_sweep_cli_needs_a_card(monkeypatch):
    from asm_tpu_torch.tools import longseq_sweep as ls

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in ([], ["piece", "--nw-pairs", "64"]):
        with pytest.raises(SystemExit, match="no CUDA device"):
            ls.main(argv)
