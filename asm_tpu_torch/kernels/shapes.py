"""The shape plan: which compiled library holds a kernel's instantiation
for a shape, with what block size and shared memory, and which shapes
the card cannot hold.

Each hand-written kernel (csrc/greedy.cu, csrc/leap.cu, csrc/nw.cu,
csrc/nw_band.cu) takes its shape as template parameters. By default its
source is built for a fixed table of shapes, the ones measured and tuned
on the card (the "tuned table", library stem = the kernel's name). Every
other shape the Pallas kernel takes is built at first use into a library
of its own: the same source, with that one shape given by -D defines and
the table compiled out, named by the shape (stem "leap_k5_w5_x1o4e2":
build/libleap_k5_w5_x1o4e2_<hash>.so). This module is that mapping; it
is plain Python, so the CPU tests hold it, and the wrappers raise
NotImplementedError from here, naming the limit, for a shape the card
cannot hold.

Ranges: max_len any multiple of 32 from 32 up, for all four kernels, as
far as a computed limit allows. Up to max_len 512 (W = L/32 <= 16) each
kernel unrolls a pair's loops over W; above it (W > LONG_W) each source
has a long-row path of its own: greedy and LEAP take a group of
long_group(k) threads per pair (LEAP at least 4: leap_group), one lane a
thread, greedy with the pair's hurdle rows once in shared memory, LEAP
with its planes staged there and no rows; NW sweeps one pair per warp in horizontal blocks of
NW_BLOCK_ROWS rows; the band kernel keeps its code rows in dynamic shared
memory. The limits: shared memory per block (SMEM_BLOCK_LIMIT) at 32
threads for greedy, LEAP, the NW long path and the band kernel; greedy's
7-bit lane delta (k <= 31); LEAP's penalties (1-8), its 16-bit history
cells (L < 2^16 - 2) and, on its long path, a lane's shift within one
word (k <= 31); NW's trace scratch per pair (TRACE_SCRATCH_BYTES). The
band takes BW 4-128 at every max_len.
"""

from __future__ import annotations

import dataclasses

# bytes of shared memory one block may take on Hopper (227 KB)
SMEM_BLOCK_LIMIT = 232_448
# above this many words a row (max_len 512) every kernel takes its
# long-row path
LONG_W = 16
# the NW long path: 32 threads a pair, rows swept in blocks of at most
# 32 x 32 rows
NW_LONG_G = 32
NW_BLOCK_ROWS = 1024
# the NW trace kernel's global pointer scratch a launch may hold (its
# launches are cut to it, trace_piece; one pair's must fit it): on an H100
# 7.8 waves of the card's resident pairs at L = 1024 and 3.1 at 2048 (2
# GiB held 0.78 of one there), 65,536 pairs at 512 (4 GiB ran within 3%
# of 2 GiB, 256 MiB 1.37x slower; PERF.md)
TRACE_SCRATCH_BYTES = 8 << 30
# the long trace kernel's walk tiles (csrc/nw.cu kTileSlots x kTileBytes)
NW_WALK_TILE_BYTES = 4 * 64 * 64 // 2
# LEAP's history cells hold a position + 2 in 16 bits above L = 253
LEAP_MAX_LEN = (1 << 16) - 3
THREAD_CHOICES = (128, 64, 32)  # the block sizes a new shape may take
TUNED_WS = (4, 8, 16)  # words per row of the tuned tables (128, 256, 512)
GREEDY_KS = (2, 3, 4)
LEAP_KS = (2, 3, 4)
# unit, and the reference LEAP driver's affine init_affine(.., 2, 3, 1)
LEAP_PENALTIES = ((1, 1, 1), (2, 3, 1))
LEAP_MAX_PENALTY = 8
# the greedy records' in-loop lane delta (at most 2k) + 64 in 7 bits
GREEDY_MAX_K = 31
# the LEAP long-row path's lane shifts (at most k) stay within one word
LEAP_LONG_MAX_K = 31
# the least group of the LEAP long-row path: at 32 threads a block then
# stages at most 8 pairs' planes, 128 (W + 1) bytes, so k = 0 reaches
# max_len 58,080 (one thread a pair would stage 32 and stop at 14,496)
LEAP_MIN_GROUP = 4
# csrc/nw.cu's pointer routes and its tuned table: (W, trace) -> (G, route)
ROUTE_NONE, ROUTE_GLOBAL, ROUTE_SHARED = 0, 1, 2
NW_TUNED = {(4, False): (8, ROUTE_NONE), (8, False): (8, ROUTE_NONE),
            (16, False): (16, ROUTE_NONE), (4, True): (16, ROUTE_SHARED),
            (8, True): (8, ROUTE_GLOBAL), (16, True): (16, ROUTE_GLOBAL)}
# the band widths csrc/nw_band.cu is built for: BW/2 threads per pair on
# the short path (BW 4-64, max_len <= 512); the wide path's threads own
# band_wide_np(BW, L) offset pairs each, BAND_WIDE_NP's (its wide_np_table,
# as timed) where a warp's rows fit a block
BAND_WIDTHS = (4, 8, 16, 32, 64, 128)
BAND_WIDE_NP = {4: 2, 8: 1, 16: 2, 32: 4, 64: 4, 128: 4}
# the band kernel's wide path (BW 128, and every BW above max_len 512)
# takes the largest of 128, 64 and 32 threads whose code rows fit this
# much shared memory, else 32
BAND_WIDE_SMEM = 64 * 1024


@dataclasses.dataclass(frozen=True)
class Plan:
    """The library of one shape: its stem (lib<stem>_<hash>.so), the -D
    defines that select the shape (empty for the tuned table), threads
    per block, dynamic shared memory per block and threads per pair (1,
    or the group of a greedy or LEAP long-row path)."""
    stem: str
    defines: tuple = ()
    threads: int = 0
    smem_bytes: int = 0
    group: int = 1

    @property
    def pairs_per_block(self) -> int:
        return self.threads // self.group

    @property
    def tuned(self) -> bool:
        return not self.defines


def words(max_len: int, kernel: str) -> int:
    """W = max_len / 32; raises ValueError for a max_len off the 32 grid
    (the kernels' limits on W are each plan's own)."""
    if max_len % 32 or max_len < 32:
        raise ValueError(f"the {kernel} kernel takes max_len a positive "
                         f"multiple of 32, got {max_len}")
    return max_len // 32


def fit_threads(smem_of, what: str) -> int:
    """The largest block size of THREAD_CHOICES whose shared memory
    (smem_of(threads) bytes) fits a block; raises naming the limit."""
    for nt in THREAD_CHOICES:
        if smem_of(nt) <= SMEM_BLOCK_LIMIT:
            return nt
    nt = THREAD_CHOICES[-1]
    raise NotImplementedError(
        f"{what} needs {smem_of(nt)} bytes of shared memory a block at {nt} "
        f"threads per block, above the {SMEM_BLOCK_LIMIT} a block may take")


def greedy_smem(k: int, W: int, threads: int) -> int:
    """csrc/greedy.cu's smem_bytes (the short path): per thread and lane,
    W orig and W den words and 4 scalars."""
    return 4 * (2 * W + 4) * (2 * k + 1) * threads


def greedy_long_smem(k: int, W: int, group: int, threads: int) -> int:
    """csrc/greedy.cu's long_smem_bytes: the 2k+1 hurdle rows, at an odd
    stride of W | 1 words, of each of the block's threads / group pairs."""
    return 4 * (2 * k + 1) * (W | 1) * (threads // group)


def leap_long_smem(W: int, group: int, threads: int) -> int:
    """csrc/leap.cu's long_smem_bytes: the staged planes, W + 1 words of
    16 bytes (the four planes' word w), for each of the block's threads /
    group pairs."""
    return 16 * (W + 1) * (threads // group)


def long_group(k: int) -> int:
    """Threads per pair of the greedy long-row path: one lane a thread,
    the least power of two >= 2k + 1 (8 at k = 2-3, 16 at 4-7), at most 32
    (k >= 16: two lanes a thread)."""
    return min(32, 1 << (2 * k).bit_length())


def leap_group(k: int) -> int:
    """Threads per pair of the LEAP long-row path: long_group(k), at least
    LEAP_MIN_GROUP, so that a block holds few enough pairs' staged planes
    (at k = 0 one real lane and three padding lanes a pair)."""
    return max(LEAP_MIN_GROUP, long_group(k))


def greedy_plan(k: int, max_len: int) -> Plan:
    W = words(max_len, "greedy")
    if k < 0:
        raise ValueError(f"k must be >= 0, got {k}")
    if k > GREEDY_MAX_K:
        raise NotImplementedError(
            f"greedy k={k}: the step records hold the in-loop lane delta "
            f"(up to 2k) + 64 in 7 bits, which caps k at {GREEDY_MAX_K}")
    if k in GREEDY_KS and W in TUNED_WS:
        nt = 32 if W == 16 else 128
        return Plan("greedy", (), nt, greedy_smem(k, W, nt))
    what = f"greedy at k={k}, max_len={max_len}"
    if W > LONG_W:
        G = long_group(k)
        nt = fit_threads(lambda t: greedy_long_smem(k, W, G, t), what)
        return Plan(f"greedy_k{k}_w{W}",
                    (("ASM_SHAPE_K", k), ("ASM_SHAPE_W", W),
                     ("ASM_SHAPE_THREADS", nt), ("ASM_SHAPE_GROUP", G)), nt,
                    greedy_long_smem(k, W, G, nt), G)
    nt = fit_threads(lambda t: greedy_smem(k, W, t), what)
    return Plan(f"greedy_k{k}_w{W}",
                (("ASM_SHAPE_K", k), ("ASM_SHAPE_W", W),
                 ("ASM_SHAPE_THREADS", nt)), nt, greedy_smem(k, W, nt))


def leap_smem(k: int, W: int, threads: int) -> int:
    """csrc/leap.cu's smem_bytes: per thread and interior lane, W row
    words and W next-hurdle entries."""
    return 8 * W * (2 * k + 1) * threads


def leap_plan(k: int, max_len: int, x: int, o: int, e: int) -> Plan:
    W = words(max_len, "LEAP")
    if k < 0:
        raise ValueError(f"k must be >= 0, got {k}")
    if not all(1 <= v <= LEAP_MAX_PENALTY for v in (x, o, e)):
        raise NotImplementedError(
            f"the LEAP kernel keeps the end rows of max(x, o) levels and "
            f"the I/D rows of e levels in registers and is built for 1 <= "
            f"x, o, e <= {LEAP_MAX_PENALTY}; got {(x, o, e)}")
    if k in LEAP_KS and W in TUNED_WS and (x, o, e) in LEAP_PENALTIES:
        return Plan("leap", (), 128, leap_smem(k, W, 128))
    if max_len > LEAP_MAX_LEN:
        raise NotImplementedError(
            f"LEAP's history cells hold a position + 2 in 16 bits, which "
            f"caps max_len at {LEAP_MAX_LEN}; got {max_len}")
    what = f"LEAP at k={k}, max_len={max_len}"
    defines = (("ASM_SHAPE_K", k), ("ASM_SHAPE_W", W), ("ASM_SHAPE_X", x),
               ("ASM_SHAPE_O", o), ("ASM_SHAPE_G", e))
    stem = f"leap_k{k}_w{W}_x{x}o{o}e{e}"
    if W > LONG_W:
        if k > LEAP_LONG_MAX_K:
            raise NotImplementedError(
                f"{what}: the long-row path makes a lane's hurdle word from "
                f"two plane words, so a lane's shift (up to k) stays within "
                f"one word, which caps k at {LEAP_LONG_MAX_K}")
        G = leap_group(k)
        nt = fit_threads(lambda t: leap_long_smem(W, G, t), what)
        return Plan(stem, defines + (("ASM_SHAPE_THREADS", nt),
                                     ("ASM_SHAPE_GROUP", G)),
                    nt, leap_long_smem(W, G, nt), G)
    nt = fit_threads(lambda t: leap_smem(k, W, t), what)
    return Plan(stem, defines + (("ASM_SHAPE_THREADS", nt),), nt,
                leap_smem(k, W, nt))


def nw_rows(L: int, G: int) -> int:
    """Rows per thread of csrc/nw.cu's strips: ceil(L / G) rounded up to
    a multiple of 4 (the codes load as words, the pointers store as half
    words); G threads then cover rows_per_thread * G >= L rows, the rows
    past L being rows past every pair's end."""
    r = -(-L // G)
    return -(-r // 4) * 4


def nw_blocks(L: int) -> int:
    """Horizontal blocks of csrc/nw.cu's long path at max_len L: one up to
    NW_BLOCK_ROWS rows, two up to twice that, ..."""
    return -(-L // NW_BLOCK_ROWS)


def nw_long_rows(L: int) -> int:
    """Rows per thread of the long path: each block's share of L over
    NW_LONG_G strips (nw_rows), at most 32."""
    return nw_rows(-(-L // nw_blocks(L)), NW_LONG_G)


def nw_instance(trace: bool, max_len: int) -> tuple[int, int]:
    """(G threads per pair, pointer route) of the NW kernel (`trace`) at
    max_len: the tuned table's, else by the rule behind it: G8 up to W =
    8 and G16 above; the trace pointers in shared memory up to W = 4
    (L * L / 2 <= 8 KB a pair; at L = 256 the tuned table found shared
    pointers 1.5x slower), in the global scratch above. Above W = LONG_W
    the long path: G32, the pointers in the global scratch."""
    W = words(max_len, "NW")
    if W in TUNED_WS:
        return NW_TUNED[W, trace]
    if W > LONG_W:
        return NW_LONG_G, ROUTE_GLOBAL if trace else ROUTE_NONE
    G = 8 if W <= 8 else 16
    if not trace:
        return G, ROUTE_NONE
    return G, ROUTE_SHARED if W <= 4 else ROUTE_GLOBAL


def nw_slot_bytes(L: int, rows: int, route: int) -> int:
    """csrc/nw.cu's slot_bytes: shared bytes per pair, whose strips
    cover `rows` rows (>= L)."""
    if route == ROUTE_NONE:
        return L
    if route == ROUTE_GLOBAL:
        return 2 * L
    return ((2 * L + L * rows // 2 + 63) // 128) * 128 + 64


def nw_long_slot_bytes(L: int, trace: bool) -> int:
    """csrc/nw.cu's long_slot_bytes: a pair's codes (two rows with the
    trace), then the larger of the parked row's H and E (with more than
    one block) and the trace walk's tiles, ops and mask rows (8 KiB +
    3L), which reuse its bytes."""
    park = 8 * L if nw_blocks(L) > 1 else 0
    walk = NW_WALK_TILE_BYTES + 3 * L if trace else 0
    return (2 * L if trace else L) + max(park, walk)


def trace_piece(per_pair: int, cap: int) -> int:
    """Pairs a launch of the NW trace kernel's global route holds, of
    `per_pair` bytes of pointer scratch each: as many as `cap` bytes (the
    wrapper's TRACE_SCRATCH_BYTES) hold; raises when one pair's scratch
    does not fit."""
    if per_pair > cap:
        raise NotImplementedError(
            f"the NW trace parks {per_pair} pointer bytes a pair, above the "
            f"{cap} trace scratch a launch may take")
    return cap // per_pair


def nw_launch(trace: bool, max_len: int) -> dict:
    """G, route, rows per thread (a block's, on the long path), the
    horizontal blocks, threads and shared bytes per block of the NW
    kernel's launch, and the global scratch bytes per pair (0 unless the
    route is global); raises naming the limit the card cannot hold."""
    G, route = nw_instance(trace, max_len)
    if max_len // 32 > LONG_W:
        rows, nb = nw_long_rows(max_len), nw_blocks(max_len)
        smem = nw_long_slot_bytes(max_len, trace)
        if smem > SMEM_BLOCK_LIMIT:
            raise NotImplementedError(
                f"the NW long path at max_len {max_len} needs {smem} bytes "
                f"of shared memory a pair, above the {SMEM_BLOCK_LIMIT} a "
                f"block may take")
        scratch = max_len * rows * G * nb // 2 if trace else 0
        if scratch > TRACE_SCRATCH_BYTES:
            raise NotImplementedError(
                f"the NW trace at max_len {max_len} parks {scratch} pointer "
                f"bytes a pair, above the {TRACE_SCRATCH_BYTES} trace scratch "
                f"a launch may take")
        return dict(G=G, route=route, rows=rows, blocks=nb, threads=G,
                    smem_bytes=smem, scratch_per_pair=scratch)
    rows = nw_rows(max_len, G)
    threads = 32 if route == ROUTE_SHARED else 128
    return dict(G=G, route=route, rows=rows, blocks=1, threads=threads,
                smem_bytes=threads // G * nw_slot_bytes(max_len, rows * G,
                                                        route),
                scratch_per_pair=(max_len * rows * G // 2
                                  if route == ROUTE_GLOBAL else 0))


def nw_plan(max_len: int) -> Plan:
    """The library of both NW kernels (full and trace) at max_len."""
    W = words(max_len, "NW")
    if W in TUNED_WS:
        return Plan("nw")
    nw_launch(True, max_len)  # raises for a max_len the card cannot hold
    G, _ = nw_instance(False, max_len)
    Gt, route = nw_instance(True, max_len)
    return Plan(f"nw_w{W}", (("ASM_SHAPE_W", W), ("ASM_NW_G", G),
                             ("ASM_NW_TRACE_G", Gt),
                             ("ASM_NW_TRACE_ROUTE", route)))


def band_row_words(bw: int, L: int) -> int:
    """csrc/nw_band.cu's row_words: a code row's words, L codes padded by
    max(4, BW/4) on both sides, made odd."""
    w = (L + 2 * max(4, bw // 4)) // 4
    return w if w % 2 else w + 1


def band_wide_np(bw: int, L: int) -> int:
    """csrc/nw_band.cu's wide_np: the offset pairs a thread of the wide
    path holds at (bw, L), BAND_WIDE_NP's, halved while one warp's code
    rows (32 / (bw / (2 NP)) pairs) pass a block's shared memory, down to
    the least NP whose pair fits a warp."""
    np_ = BAND_WIDE_NP[bw]
    while (np_ > max(1, bw // 64)
           and _band_rows_smem(bw, L, 32, np_) > SMEM_BLOCK_LIMIT):
        np_ //= 2
    return np_


def _band_rows_smem(bw: int, L: int, threads: int, np_: int) -> int:
    """Dynamic shared bytes of a wide block: two code rows a pair."""
    return threads // 32 * (32 // (bw // (2 * np_))) * 2 * band_row_words(
        bw, L) * 4


def band_wide_launch(bw: int, L: int) -> dict:
    """Threads and dynamic shared bytes per block of the band kernel's wide
    path (csrc/nw_band.cu wide_threads / wide_smem), with its offset pairs
    a thread (np), threads per pair (seg: bw / (2 np)) and pairs per warp
    (32 / seg)."""
    np_ = band_wide_np(bw, L)
    seg = bw // (2 * np_)
    nt = next((nt for nt in THREAD_CHOICES
               if _band_rows_smem(bw, L, nt, np_) <= BAND_WIDE_SMEM), 32)
    return dict(threads=nt, smem_bytes=_band_rows_smem(bw, L, nt, np_),
                np=np_, seg=seg, pairs_per_warp=32 // seg)


def band_plan(max_len: int, bw: int) -> Plan:
    """The library of the band kernel at max_len (all BAND_WIDTHS)."""
    if bw not in BAND_WIDTHS:
        raise NotImplementedError(
            f"the band kernel is built for BW in {BAND_WIDTHS}; got {bw}")
    W = words(max_len, "NW band")
    if W > LONG_W or bw == 128:
        got = band_wide_launch(bw, max_len)["smem_bytes"]
        if got > SMEM_BLOCK_LIMIT:
            raise NotImplementedError(
                f"the band kernel at BW {bw}, max_len {max_len} needs {got} "
                f"bytes of shared memory a block at 32 threads per block, "
                f"above the {SMEM_BLOCK_LIMIT} a block may take")
    if W in TUNED_WS:
        return Plan("nw_band")
    return Plan(f"nw_band_w{W}", (("ASM_SHAPE_W", W),))
