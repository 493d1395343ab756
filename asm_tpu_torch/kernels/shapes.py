"""The shape plan: which compiled library holds a kernel's instantiation
for a shape, with what block size and shared memory, and which shapes
the card cannot hold.

Each hand-written kernel (csrc/greedy.cu, csrc/leap.cu, csrc/nw.cu,
csrc/nw_band.cu) takes its shape as template parameters and unrolls over
them. By default its source is built for a fixed table of shapes, the
ones measured and tuned on the card (the "tuned table", library stem =
the kernel's name). Every other shape the Pallas kernel takes is built
at first use into a library of its own: the same source, with that one
shape given by -D defines and the table compiled out, named by the
shape (stem "leap_k5_w5_x1o4e2": build/libleap_k5_w5_x1o4e2_<hash>.so).
This module is that mapping; it is plain Python, so the CPU tests hold
it, and the wrappers raise NotImplementedError from here, naming the
limit, for a shape the card cannot hold.

Ranges: max_len any multiple of 32 from 32 to 512 for all four kernels
(above 512 is not built: every kernel unrolls a pair's loops over W =
L/32 words and greedy and LEAP hold its 4W plane words in registers; a
longer row needs a tiled layout, a later piece of work); greedy any k >=
0 whose records and shared memory fit; LEAP any k whose rows fit in
shared memory and any lv_bag penalty set with 1 <= x, o, e <= 8.
"""

from __future__ import annotations

import dataclasses

# bytes of shared memory one block may take on Hopper (227 KB)
SMEM_BLOCK_LIMIT = 232_448
MAX_LEN = 512
THREAD_CHOICES = (128, 64, 32)  # the block sizes a new shape may take
TUNED_WS = (4, 8, 16)  # words per row of the tuned tables (128, 256, 512)
GREEDY_KS = (2, 3, 4)
LEAP_KS = (2, 3, 4)
# unit, and the reference LEAP driver's affine init_affine(.., 2, 3, 1)
LEAP_PENALTIES = ((1, 1, 1), (2, 3, 1))
LEAP_MAX_PENALTY = 8
# the greedy records' in-loop lane delta (at most 2k) + 64 in 7 bits
GREEDY_MAX_K = 31
# csrc/nw.cu's pointer routes and its tuned table: (W, trace) -> (G, route)
ROUTE_NONE, ROUTE_GLOBAL, ROUTE_SHARED = 0, 1, 2
NW_TUNED = {(4, False): (8, ROUTE_NONE), (8, False): (8, ROUTE_NONE),
            (16, False): (16, ROUTE_NONE), (4, True): (16, ROUTE_SHARED),
            (8, True): (8, ROUTE_GLOBAL), (16, True): (16, ROUTE_GLOBAL)}
# the band widths csrc/nw_band.cu is built for: BW/2 threads per pair, so
# a pair's band lies in one warp up to BW 64 (asm_tpu's kernel also takes
# 128, a band of 64 threads, which would span two warps)
BAND_WIDTHS = (4, 8, 16, 32, 64)


@dataclasses.dataclass(frozen=True)
class Plan:
    """The library of one shape: its stem (lib<stem>_<hash>.so), the -D
    defines that select the shape (empty for the tuned table), threads
    per block and dynamic shared memory per block."""
    stem: str
    defines: tuple = ()
    threads: int = 0
    smem_bytes: int = 0

    @property
    def tuned(self) -> bool:
        return not self.defines


def words(max_len: int, kernel: str) -> int:
    """W = max_len / 32; raises for a max_len the kernels do not take."""
    if max_len % 32:
        raise ValueError(f"max_len must be a multiple of 32, got {max_len}")
    if not 32 <= max_len <= MAX_LEN:
        raise NotImplementedError(
            f"the {kernel} kernel is built for max_len 32-{MAX_LEN}, got "
            f"{max_len}: it unrolls a pair's rows over W = max_len / 32 "
            f"words held per thread, and longer rows need a tiled layout")
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
    """csrc/greedy.cu's smem_bytes: per thread and lane, W orig and W den
    words and 4 scalars."""
    return 4 * (2 * W + 4) * (2 * k + 1) * threads


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
    nt = fit_threads(lambda t: greedy_smem(k, W, t),
                     f"greedy at k={k}, max_len={max_len}")
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
    nt = fit_threads(lambda t: leap_smem(k, W, t),
                     f"LEAP at k={k}, max_len={max_len}")
    return Plan(f"leap_k{k}_w{W}_x{x}o{o}e{e}",
                (("ASM_SHAPE_K", k), ("ASM_SHAPE_W", W), ("ASM_SHAPE_X", x),
                 ("ASM_SHAPE_O", o), ("ASM_SHAPE_G", e),
                 ("ASM_SHAPE_THREADS", nt)), nt, leap_smem(k, W, nt))


def nw_rows(L: int, G: int) -> int:
    """Rows per thread of csrc/nw.cu's strips: ceil(L / G) rounded up to
    a multiple of 4 (the codes load as words, the pointers store as half
    words); G threads then cover rows_per_thread * G >= L rows, the rows
    past L being rows past every pair's end."""
    r = -(-L // G)
    return -(-r // 4) * 4


def nw_instance(trace: bool, max_len: int) -> tuple[int, int]:
    """(G threads per pair, pointer route) of the NW kernel (`trace`) at
    max_len: the tuned table's, else by the rule behind it: G8 up to W =
    8 and G16 above; the trace pointers in shared memory up to W = 4
    (L * L / 2 <= 8 KB a pair; at L = 256 the tuned table found shared
    pointers 1.5x slower), in the global scratch above."""
    W = words(max_len, "NW")
    if W in TUNED_WS:
        return NW_TUNED[W, trace]
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


def nw_launch(trace: bool, max_len: int) -> dict:
    """G, route, rows per thread, threads and shared bytes per block of
    the NW kernel's launch, and the global scratch bytes per pair (0
    unless the route is global)."""
    G, route = nw_instance(trace, max_len)
    rows = nw_rows(max_len, G)
    threads = 32 if route == ROUTE_SHARED else 128
    return dict(G=G, route=route, rows=rows, threads=threads,
                smem_bytes=threads // G * nw_slot_bytes(max_len, rows * G,
                                                        route),
                scratch_per_pair=(max_len * rows * G // 2
                                  if route == ROUTE_GLOBAL else 0))


def nw_plan(max_len: int) -> Plan:
    """The library of both NW kernels (full and trace) at max_len."""
    W = words(max_len, "NW")
    if W in TUNED_WS:
        return Plan("nw")
    G, _ = nw_instance(False, max_len)
    Gt, route = nw_instance(True, max_len)
    return Plan(f"nw_w{W}", (("ASM_SHAPE_W", W), ("ASM_NW_G", G),
                             ("ASM_NW_TRACE_G", Gt),
                             ("ASM_NW_TRACE_ROUTE", route)))


def band_plan(max_len: int, bw: int) -> Plan:
    """The library of the band kernel at max_len (all BAND_WIDTHS)."""
    if bw not in BAND_WIDTHS:
        raise NotImplementedError(
            f"the band kernel is built for BW in {BAND_WIDTHS} (BW/2 "
            f"threads a pair, within one warp); got {bw}")
    W = words(max_len, "NW band")
    if W in TUNED_WS:
        return Plan("nw_band")
    return Plan(f"nw_band_w{W}", (("ASM_SHAPE_W", W),))
