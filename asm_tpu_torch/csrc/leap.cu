// LEAP / Landau-Vishkin energy wavefront, one pair per thread (sm_90a).
//
// Replaces the Pallas TPU kernel asm_tpu/kernels/leap_pallas.py
// _leap_kernel (wrapper leap_align_pallas) in its three modes: the
// penalty pass, the SHD-gated SIMD_ED filter and the fused CIGAR
// backtrack. Per pair: unpack the 2-bit planes (or pack int8 codes),
// build the 2k+1 interior hurdle lane rows of LEAP's 2k+3 lanes (funnel
// shift + XOR/OR, validity from the lengths), optionally run the SHD gate
// (before the rows at L <= 256, after them at L = 512), then advance the energy wavefront one level at a time until the pair
// converges or e passes af, answering count_ID_length (LV_BAG.cpp:9-23)
// for every interior lane.
//
// Compile-time choices. K, W = L/32, the penalties, the semantics (SEM:
// lv_bag, simd_ed_lev, simd_ed_lev behind the SHD gate, simd_ed_affine),
// the CIGAR mode and the input route are template parameters (144
// instantiations in the tuned table: k in {2, 3, 4} x L in {128, 256,
// 512} x two penalty sets; any other shape, L > 512 too, is built into a
// library of its own, kThreads below), and the
// LeapMode, a run-time field, is applied by selects, never by a branch,
// so the energy loop is compiled once. An instantiation thus holds only
// code its launches run, and the SASS count of the main path's (lv_bag,
// planes) bounds what it issues.
//
// Layout: the O(1) match-run query. The TPU kernel holds one pair per
// vector element, and a vector register cannot be read at a per-element
// position, so its count_id scans every word of the row (~11 integer
// instructions a word). Here each thread builds its 2k+1 lane rows once
// per pair into dynamic shared memory, thread index fastest: lane j's word
// w at (j * 2W + w) * 128 + t, and beside it a next-hurdle table, entry w
// at (j * 2W + W + w) * 128 + t holding the first hurdle in words
// w+1 .. W-1 (32W if none), built from the top word down. A query reads
// the word that holds its start and one table entry at a per-thread index:
// ~16 instructions whatever W, no loop, no branch, and no bank conflict,
// since a warp's 32 threads read 32 consecutive words whatever word index
// each one asks for. A thread reads and writes only its own column: no
// barrier, no shuffle. 28 KB a block at k = 3, L = 128 (7 blocks, 28
// warps, per SM; 56 KB at L = 256, 112 KB, 2 blocks, at L = 512); the
// carveout prefers shared memory.
// The recurrence's state stays in registers: the TPU kernel's e-ring (R =
// max(o, e, x) + 1 slots indexed by e % R) becomes shift registers, `endh`
// the end rows of levels e-1 .. e-max(o, x), `ih` / `dh` the I / D rows
// of e-1 .. e-e, so every read is a static slot and the rows of levels
// below 0 start UNREACHED, which is exactly the reference's `e >= o`
// reachability test (no peeled levels). Each thread stops at its own
// level; the host's measured-energy order keeps a warp's pairs at similar
// energies.
//
// What bounds it on Hopper: integer issue, in penalty mode. A pair reads
// 2 * L/4 bytes of planes and writes 9 bytes; the main path's
// instantiation (k = 3, L = 128, lv_bag, planes) issues 298 SASS
// instructions per energy level and ~1,800 per pair (~1,109 of them in
// the energy loop), at ~25 T thread instructions/s against the ~31 T the
// card issues (H100 80GB HBM3, 700 W; PERF.md); with the scanning query a
// level cost 527. In CIGAR mode the history scratch and the record rows'
// stores weigh more than issue.
//
// Long rows (L > 512, W > kShortW = 16): leap_long_kernel below, chosen by
// W at compile time, so the W <= 16 instantiations are the code they were.
// There, 2W(2k + 1) words of rows and next-hurdle table a thread (3,584 B
// at L = 2048, k = 3) leave 2 warps per SM. So a group of G threads
// (kGroup: the least power of two >= 2k + 1, at least 4 and at most 32;
// 8 at k = 2-3)
// takes each pair, thread g owning interior lanes g * LPT .. g * LPT +
// LPT - 1 (LPT = 1 up to k = 15) with their endh / ih / dh shift
// registers; a level reads the neighbour lanes' rows by __shfl_up_sync /
// __shfl_down_sync within the group, and the convergence and lane choice
// are group reductions (__reduce_min_sync / __reduce_max_sync) with the
// tie rules below. No lane row is kept: the block stages its pairs' planes
// in shared memory, word w's four planes in one 16-byte word ((W + 1) x 16
// B a pair, 1 KB at L = 2048 whatever k is; bits past each length
// cleared), and count_ID_length makes its lane's hurdle word from the
// staged words w and w - 1 where it reads it, scanning forward from the
// start's word (a match run ends within a word or two off the true
// diagonal). The SHD gate splits the words over the group and sums its
// counts. In CIGAR mode each thread parks its own lanes' cells, the
// scratch laid out so that a warp's stores at one level are consecutive
// words; one thread of the group walks the history. The 16-bit cells hold
// positions to 65,533 (kernels/shapes.py LEAP_MAX_LEN). What bounds it:
// issue; each of a pair's threads makes its hurdle word anew at every
// level and runs the group's shuffles, several times the short path's
// instructions per pair and level, bought back by 48 warps per SM; a
// level where no lane converges runs one vote instead of the reductions
// of the lane choice.
//
// Left for later: the lengths as a per-lane cutoff instead of bits in
// every row word (~10 instructions a lane and word in the prologue); the
// CIGAR mode's record rows, which each thread stores at its own time
// (uncoalesced), and its history scratch (5-9% of leap_cigar).
//
// Semantics and the lane-order quirks: SIMD_ED's scan order is mirrored
// against this lane axis, so its "first" lane is our last; simd_ed_lev
// stops at the last converged lane, passed or not; simd_ed_affine keeps
// corrected ties with <=, lv_bag with <; at e = 0 lv_bag takes the first
// converged lane and the SIMD_ED semantics the last.
//
// The SHD gate (simd_ed_lev only): AND of the interior lanes over planes
// whose bits past each string's length are cleared (padding compares as
// 'A', the reference's zero-padded buffer), bits below k and past the
// buffer length cleared, bit 255 cleared at L = 256 (the error==0 lane's
// out-of-bounds BEG row); then per nibble the 1-run starts plus one for
// nibble 0b0110; a count above k stops the pair before e = 0 with passed
// 0, penalty 0.
//
// CIGAR mode (lv_bag): every level e <= E parks its interior cells
// (start, end, I, D), +2 biased, in a per-launch global scratch laid out
// pair-minor ([(E+1) * (2k+1) * CW, n] words, so a warp's writes at one
// level coalesce): 8 bits x 4 in one word when L <= 253, 16 bits x 2 in two
// words beyond. After the wavefront the thread walks its own history down
// from (final lane, penalty) as LV::backtrack does (LV_BAG.cpp:250-354)
// and writes one packed record per energy row: op in bits 0-1 (0 none,
// 1 M, 2 I, 3 D), is_open in bit 2, the match run in bits 3 and up; row 0
// holds the terminal match run. A pair passing above E is not walked (its
// records stay 0); the caller checks max(penalty * passed) <= E.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kFull = 0xFFFFFFFFu;
constexpr int kUnr = -2;
constexpr int kBig = 1 << 29;
// the semantics, a template parameter of the kernel
constexpr int kLvBag = 0, kSimdLev = 1, kSimdAffine = 2, kSimdLevGated = 3;
constexpr int kModeLocal = 0, kModeGlobal = 1, kModeSemiFreeBegin = 2;
// threads per block, one pair each: 128 in the tuned table; a library
// built for one shape outside it (kernels/shapes.py: -D ASM_SHAPE_K, _W,
// _X, _O, _G and _THREADS) takes the largest of 128, 64 and 32 whose rows
// fit a block's shared memory
#ifdef ASM_SHAPE_THREADS
constexpr int kThreads = ASM_SHAPE_THREADS;
#else
constexpr int kThreads = 128;
#endif

// bits of word w at positions >= c (c may lie outside the row)
__device__ __forceinline__ uint32_t mask_ge(int c, int w) {
    int low = c - 32 * w;
    low = low < 0 ? 0 : (low > 32 ? 32 : low);
    return low >= 32 ? 0u : (kFull << low);
}

__device__ __forceinline__ int ctz32(uint32_t v) { return __clz(__brev(v)); }

__device__ __forceinline__ int iabs(int v) { return v < 0 ? -v : v; }

// bit p of the result = bit p - s of the row (the sequence displaced s
// positions forward), zeros shifted in; 0 <= s < 32
template <int W>
__device__ __forceinline__ uint32_t shl(const uint32_t (&v)[W], int s, int w) {
    if (s == 0) return v[w];
    const uint32_t lo = w > 0 ? v[w - 1] >> (32 - s) : 0u;
    return (v[w] << s) | lo;
}

// The SHD gate: true where simd_ed_lev stops the pair before e = 0. It
// clears each plane's bits past its string's length in place (they read
// as 'A'); the lane rows force a hurdle wherever a shifted index lies past
// its length, so they read no cleared bit, before the gate or after it.
template <int K, int W>
__device__ __forceinline__ bool shd_gate(uint32_t (&r0)[W], uint32_t (&r1)[W],
                                         uint32_t (&f0)[W], uint32_t (&f1)[W],
                                         int m, int n, int buflen) {
    constexpr int L = 32 * W, NI = 2 * K + 1, MID = K + 1;
#pragma unroll
    for (int w = 0; w < W; w++) {
        r0[w] &= ~mask_ge(m, w);
        r1[w] &= ~mask_ge(m, w);
        f0[w] &= ~mask_ge(n, w);
        f1[w] &= ~mask_ge(n, w);
    }
    int count = 0;
#pragma unroll
    for (int w = 0; w < W; w++) {
        uint32_t dw = kFull;
#pragma unroll
        for (int j = 0; j < NI; j++) {
            const int l = j + 1;
            const int a_off = MID - l > 0 ? MID - l : 0;
            const int b_off = l - MID > 0 ? l - MID : 0;
            dw &= (shl<W>(r0, a_off, w) ^ shl<W>(f0, b_off, w)) |
                  (shl<W>(r1, a_off, w) ^ shl<W>(f1, b_off, w)) |
                  ~mask_ge(a_off + b_off, w);
        }
        dw &= ~mask_ge(buflen, w) & mask_ge(K, w);
        if (L == 256 && w == W - 1) dw &= 0x7FFFFFFFu;
        const uint32_t starts = dw & ~((dw << 1) & 0xEEEEEEEEu);
        uint32_t t6 = dw ^ 0x66666666u;
        t6 |= t6 >> 1;
        t6 |= t6 >> 2;
        count += __popc(starts) + __popc(~t6 & 0x11111111u);
    }
    return count > K;
}

// int8 codes as uint32 words -> two bit-planes (bit p of word w = bit 0 or
// 1 of the code at 32w + p); the carry-free multiply by 0x01020408
// gathers the four byte bits of a word at bits 24..27
template <int W>
__device__ __forceinline__ void pack_row(const uint32_t* __restrict__ row,
                                         uint32_t (&p0)[W], uint32_t (&p1)[W]) {
#pragma unroll
    for (int w = 0; w < W; w++) {
        uint32_t a0 = 0, a1 = 0;
#pragma unroll
        for (int jj = 0; jj < 8; jj++) {
            const uint32_t v = row[8 * w + jj];
            a0 |= (((v & 0x01010101u) * 0x01020408u) >> 24) << (4 * jj);
            a1 |= ((((v >> 1) & 0x01010101u) * 0x01020408u) >> 24) << (4 * jj);
        }
        p0[w] = a0;
        p1[w] = a1;
    }
}

// a block's shared memory: per interior lane, W row words and W
// next-hurdle entries, per thread
template <int K, int W>
constexpr size_t smem_bytes() {
    return sizeof(uint32_t) * 2 * W * (2 * K + 1) * kThreads;
}

// count_ID_length: the match-run end from `start` on one lane row, in
// O(1). `row` is the lane's first word in this thread's column: word w at
// row[w * kThreads], then nxt[w] at row[(W + w) * kThreads], the first
// hurdle in words w+1 .. W-1 (32W if none). The word that holds the start
// answers the query when it holds a hurdle at or past the start, nxt
// otherwise: the scan's answer from two shared loads.
template <int W>
__device__ __forceinline__ int count_id(const uint32_t* row, int start,
                                        int buflen) {
    const int c = start > 0 ? start : 0;
    const int ws = min(c >> 5, W - 1);  // a start past the row never reads
    const uint32_t x = row[ws * kThreads] & (kFull << (c & 31));
    const int nx = (int)row[(W + ws) * kThreads];
    const int first = x ? 32 * ws + ctz32(x) : nx;
    return start >= buflen ? start : min(first, buflen);
}

// rows of more words than this take the long-row path (leap_long_kernel)
constexpr int kShortW = 16;

struct Params {
    int n;       // pairs in this launch
    int p0;      // batch index of the launch's first pair
    int B;       // pairs in the batch (row stride of the records)
    int tile;    // tile of the tile-major planes
    int mode;    // LeapMode
    int af;      // energy threshold
    int E;       // record rows - 1 (CIGAR)
};

template <int CW>
struct Cell {
    int s, e, i, d;
};

// packed history cell of level ev, interior lane index j, this thread
template <int CW>
__device__ __forceinline__ Cell<CW> load_cell(const uint32_t* __restrict__ hist,
                                              int NI, int ev, int j, int64_t n,
                                              int64_t t) {
    Cell<CW> c{kUnr, kUnr, kUnr, kUnr};
    if (j < 0 || j >= NI) return c;  // border lanes are UNREACHED
    const int64_t row = ((int64_t)ev * NI + j) * CW;
    if (CW == 1) {
        const uint32_t w = hist[row * n + t];
        c.s = (int)(w & 0xFF) - 2;
        c.e = (int)((w >> 8) & 0xFF) - 2;
        c.i = (int)((w >> 16) & 0xFF) - 2;
        c.d = (int)(w >> 24) - 2;
    } else {
        const uint32_t a = hist[row * n + t];
        const uint32_t b = hist[(row + 1) * n + t];
        c.s = (int)(a & 0xFFFF) - 2;
        c.e = (int)(a >> 16) - 2;
        c.i = (int)(b & 0xFFFF) - 2;
        c.d = (int)(b >> 16) - 2;
    }
    return c;
}

template <int CW>
__device__ __forceinline__ void park_cell(uint32_t* __restrict__ hist, int NI,
                                          int ev, int j, int64_t n, int64_t t,
                                          int s, int e, int i, int d) {
    const int64_t row = ((int64_t)ev * NI + j) * CW;
    if (CW == 1) {
        hist[row * n + t] = (uint32_t)(s + 2) | ((uint32_t)(e + 2) << 8) |
                            ((uint32_t)(i + 2) << 16) | ((uint32_t)(d + 2) << 24);
    } else {
        hist[row * n + t] = (uint32_t)(s + 2) | ((uint32_t)(e + 2) << 16);
        hist[(row + 1) * n + t] = (uint32_t)(i + 2) | ((uint32_t)(d + 2) << 16);
    }
}

// K: band half-width; W: words per row (L = 32W); X, O, G: mismatch,
// gap-open and gap-extension penalties; SEM: the semantics (kLvBag,
// kSimdLev, kSimdAffine, or kSimdLevGated: simd_ed_lev behind the SHD
// gate); CIGAR: park + backtrack (kLvBag only); kPlanes: tile-major planes
// in, else int8 codes [B, L]
template <int K, int W, int X, int O, int G, int SEM, bool CIGAR,
          bool kPlanes>
__global__ void __launch_bounds__(kThreads)
leap_kernel(const uint32_t* __restrict__ rc, const uint32_t* __restrict__ fc,
            const int* __restrict__ rl, const int* __restrict__ fl,
            const Params P, uint8_t* __restrict__ passed_out,
            int* __restrict__ pen_out, int* __restrict__ shift_out,
            int* __restrict__ rec, uint32_t* __restrict__ hist) {
    constexpr int NI = 2 * K + 1;  // interior lanes l = 1..2K+1, j = l - 1
    constexpr int MID = K + 1;
    constexpr int L = 32 * W;
    constexpr int DE = X > O ? X : O;  // end rows kept: levels e-1..e-DE
    constexpr int CW = L > 253 ? 2 : 1;
    constexpr bool kLev = SEM == kSimdLev || SEM == kSimdLevGated;
    static_assert(!CIGAR || SEM == kLvBag, "CIGARs mirror LV_BAG only");
    const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
    if (t >= P.n) return;
    extern __shared__ __align__(16) uint32_t g_rows[];
    // this thread's column; lane j's row starts at j * 2W * kThreads
    uint32_t* const col = g_rows + threadIdx.x;
    const int64_t p = P.p0 + t;
    const int64_t n_launch = P.n;
    const int m = min(rl[p], L);
    const int n = min(fl[p], L);
    const int buflen = max(m, n);  // benchmark_utils.h:162
    const int af = P.af;
    const bool corrected = P.mode == kModeGlobal || P.mode == kModeSemiFreeBegin;

    // ---- the pair's bit-planes ----
    uint32_t r0[W], r1[W], f0[W], f1[W];
    if constexpr (kPlanes) {
        // tile-major planes [NBT, 2W, tile]: row w plane 0, row W+w plane 1
        const int64_t tile = P.tile;
        const int64_t base = (p / tile) * (2 * W) * tile + (p % tile);
#pragma unroll
        for (int w = 0; w < W; w++) {
            r0[w] = rc[base + w * tile];
            r1[w] = rc[base + (W + w) * tile];
            f0[w] = fc[base + w * tile];
            f1[w] = fc[base + (W + w) * tile];
        }
    } else {
        pack_row<W>(rc + p * (L / 4), r0, r1);
        pack_row<W>(fc + p * (L / 4), f0, f1);
    }

    // The SHD gate (simd_ed_lev only) reads the planes alone, so it may run
    // before the lane rows are built or after them. At L = 512 it runs
    // after: built first, its shifted words are the rows' own and stay live
    // until the rows, which spilled at k = 4. At L <= 256 it runs before:
    // after the rows, leap_gated at L = 128 ran 5-7% slower in two
    // alternated runs (PERF.md section 6); L = 256 was not timed apart.
    constexpr bool kGate = SEM == kSimdLevGated, kGateFirst = W < 16;
    bool gated = false;
    if constexpr (kGate && kGateFirst)
        gated = shd_gate<K, W>(r0, r1, f0, f1, m, n, buflen);

    // ---- interior hurdle rows (build_leap_lanes semantics) ----
    // lane l < MID compares A[p - (MID-l)] vs B[p], l > MID A[p] vs
    // B[p - (l-MID)]; a position is a hurdle where the planes differ, where
    // a shifted index lies past its string's length, or before index 0.
    // Each row goes to shared memory with its next-hurdle entries, built
    // from the top word down.
#pragma unroll
    for (int j = 0; j < NI; j++) {
        const int l = j + 1;
        const int a_off = MID - l > 0 ? MID - l : 0;
        const int b_off = l - MID > 0 ? l - MID : 0;
        uint32_t* const row = col + j * 2 * W * kThreads;
        int nx = L;
#pragma unroll
        for (int w = W - 1; w >= 0; w--) {
            const uint32_t h = (shl<W>(r0, a_off, w) ^ shl<W>(f0, b_off, w)) |
                               (shl<W>(r1, a_off, w) ^ shl<W>(f1, b_off, w)) |
                               mask_ge(m + a_off, w) | mask_ge(n + b_off, w) |
                               ~mask_ge(a_off + b_off, w);
            row[w * kThreads] = h;
            row[(W + w) * kThreads] = (uint32_t)nx;
            nx = h ? 32 * w + ctz32(h) : nx;
        }
    }

    if constexpr (kGate && !kGateFirst)
        gated = shd_gate<K, W>(r0, r1, f0, f1, m, n, buflen);

    // ---- e = 0 row (LV::init + the first run step) ----
    int endh[DE][NI], ih[G][NI], dh[G][NI];
    bool conv_any = false;
    int lane0 = MID;
#pragma unroll
    for (int j = 0; j < NI; j++) {
        const int ld = iabs(j + 1 - MID);
        const bool free_begin =
            P.mode == kModeLocal || P.mode == kModeSemiFreeBegin;
        const int s0 = free_begin ? ld : (ld == 0 ? 0 : kUnr);
        const int q0 = count_id<W>(col + j * 2 * W * kThreads, s0, buflen);
        const int e0 = s0 >= 0 ? q0 : kUnr;
        endh[0][j] = e0;
#pragma unroll
        for (int d = 1; d < DE; d++) endh[d][j] = kUnr;
#pragma unroll
        for (int d = 0; d < G; d++) ih[d][j] = dh[d][j] = kUnr;
        const bool c0 = e0 == buflen && s0 >= 0;
        // lv_bag takes the first converged lane, SIMD_ED (mirrored) the last
        if (c0 && (SEM != kLvBag || !conv_any)) lane0 = j + 1;
        conv_any = conv_any || c0;
        if (CIGAR) park_cell<CW>(hist, NI, 0, j, n_launch, t, s0, e0, kUnr, kUnr);
    }
    int pen0, default_pen;
    if (SEM == kSimdAffine && corrected) {
        pen0 = default_pen = 1000000;  // reset_affine converge_ED
    } else if (corrected || SEM == kLvBag) {
        pen0 = 0;
        default_pen = af + 1;
    } else {
        pen0 = default_pen = 0;
    }
    bool stop = conv_any, passed = conv_any;
    int pen = conv_any ? pen0 : default_pen;
    const int flane0 = conv_any ? lane0 : MID;
    int flane = flane0;
    if (gated) {  // the reference stops a gated pair before e = 0
        stop = true;
        passed = false;
        pen = 0;
    }

    // ---- the energy loop ----
    int e = 1;
    for (; e <= af && !stop; e++) {
        int ns[NI], ne[NI], ni[NI], nd[NI];
        bool conv[NI];
#pragma unroll
        for (int j = 0; j < NI; j++) {
            const int l = j + 1;
            const int top = l >= MID ? 1 : 0;  // LV_BAG.cpp:153-157
            const int bot = l <= MID ? 1 : 0;
            // the max form of the reference's I/D choice: equal on the
            // value domain {UNREACHED} u [0, inf)
            const int end_up = j > 0 ? endh[O - 1][j - 1] : kUnr;
            const int i_up = j > 0 ? ih[G - 1][j - 1] : kUnr;
            const int ic = max(end_up, i_up);
            const int iv = ic >= 0 ? ic + top : kUnr;
            const int end_dn = j < NI - 1 ? endh[O - 1][j + 1] : kUnr;
            const int d_dn = j < NI - 1 ? dh[G - 1][j + 1] : kUnr;
            const int dc = max(end_dn, d_dn);
            const int dv = dc >= 0 ? dc + bot : kUnr;
            const int em = endh[X - 1][j];
            const int sm = em >= 0 ? em + 1 : kUnr;
            const int s = max(sm, max(iv, dv));
            const int q = count_id<W>(col + j * 2 * W * kThreads, s, buflen);
            const int en = s >= 0 ? q : kUnr;
            ns[j] = s;
            ne[j] = en;
            ni[j] = iv;
            nd[j] = dv;
            conv[j] = en == buflen && s >= 0;
        }

        bool stop_now = false, pass_now = false;
        int lane_now = 0, pen_now = e;
        if constexpr (kLev) {
            // run_levenshtein stops at its first converged lane (our last)
            // whether or not the converge correction passes it
#pragma unroll
            for (int j = 0; j < NI; j++) {
                if (conv[j]) {
                    stop_now = true;
                    lane_now = j + 1;
                }
            }
            pen_now = corrected ? e + iabs(lane_now - MID) : e;
            pass_now = stop_now && (!corrected || pen_now <= af);
        } else {
            // corrected modes: the lane of least corrected penalty within
            // af, lv_bag keeping the first of equals and simd_ed_affine the
            // last; the other modes: the last converged lane (LV_BAG.cpp:
            // 233-237), every converged lane's penalty being e. One loop
            // for every mode, with selects on `corrected`: no branch on the
            // mode, so the energy loop is compiled once, not once a mode.
            int tmin = kBig;
#pragma unroll
            for (int j = 0; j < NI; j++) {
                const int ld = iabs(j + 1 - MID);
                const int tc = e + (corrected && ld > 0 ? O + (ld - 1) * G : 0);
                const int tt = conv[j] && tc <= af ? tc : kBig;
                const bool better = SEM == kSimdAffine || !corrected
                                        ? tt <= tmin
                                        : tt < tmin;
                if (better) {
                    tmin = tt;
                    lane_now = j + 1;
                }
            }
            pass_now = stop_now = tmin < kBig;
            if (SEM == kSimdAffine) pen_now = tmin;
        }
        if (stop_now) {
            stop = true;
            passed = pass_now;
            pen = pen_now;
            flane = lane_now;
        }

#pragma unroll
        for (int j = 0; j < NI; j++) {
#pragma unroll
            for (int d = DE - 1; d > 0; d--) endh[d][j] = endh[d - 1][j];
            endh[0][j] = ne[j];
#pragma unroll
            for (int d = G - 1; d > 0; d--) {
                ih[d][j] = ih[d - 1][j];
                dh[d][j] = dh[d - 1][j];
            }
            ih[0][j] = ni[j];
            dh[0][j] = nd[j];
            if (CIGAR && e <= P.E)
                park_cell<CW>(hist, NI, e, j, n_launch, t, ns[j], ne[j], ni[j],
                              nd[j]);
        }
    }

    passed_out[p] = passed ? 1 : 0;
    pen_out[p] = pen;
    shift_out[p] = flane - MID;

    if (!CIGAR) return;
    // ---- the backtrack walk (LV::backtrack, LV_BAG.cpp:250-354) ----
    // cm: 0 a fresh arrival, 1 inside an insertion chain, 2 a deletion chain
    const int64_t B = P.B;
    int row_hi = P.E;  // rows above row_hi are written
    int term = 0;
    if (passed && pen <= P.E) {
        int cur = pen, ln = flane, cm = 0;
        for (int guard = 0; cur > 0 && guard <= P.E; guard++) {
            const int ev = cur;
            const Cell<CW> c = load_cell<CW>(hist, NI, ev, ln - 1, n_launch, t);
            const bool ok_ge = ev - G >= 0;
            const int evg = ok_ge ? ev - G : 0;
            const int i_prev =
                load_cell<CW>(hist, NI, evg, ln - 2, n_launch, t).i;
            const int d_prev = load_cell<CW>(hist, NI, evg, ln, n_launch, t).d;
            const bool fresh = cm == 0;
            const int run = fresh ? c.e - c.s : 0;
            const bool is_i = fresh ? c.s == c.i : cm == 1;
            const bool is_d = fresh ? (c.s != c.i && c.s == c.d) : cm == 2;
            const int top = ln >= MID ? 1 : 0;
            const int bot = ln <= MID ? 1 : 0;
            const bool ext_i = ok_ge && i_prev != kUnr && i_prev + top == c.i;
            const bool ext_d = ok_ge && d_prev != kUnr && d_prev + bot == c.d;
            const int op = is_i ? 2 : (is_d ? 3 : 1);
            const bool is_open = (is_i && !ext_i) || (is_d && !ext_d);
            for (int r = row_hi; r > ev; r--) rec[r * B + p] = 0;
            rec[ev * B + p] = op | ((is_open ? 1 : 0) << 2) | (run << 3);
            row_hi = ev - 1;
            const int de = is_i ? (ext_i ? G : O) : (is_d ? (ext_d ? G : O) : X);
            cur = max(ev - de, 0);
            ln += is_i ? -1 : (is_d ? 1 : 0);
            cm = (is_i && ext_i) ? 1 : ((is_d && ext_d) ? 2 : 0);
        }
        // the terminal match run at energy 0 on the walk's final lane
        const Cell<CW> c0 = load_cell<CW>(hist, NI, 0, ln - 1, n_launch, t);
        term = c0.e - c0.s;
    }
    for (int r = row_hi; r >= 1; r--) rec[r * B + p] = 0;
    rec[p] = term;
}

// ---- the long-row path (W > kShortW): a group of threads per pair ----

// threads per pair on the long-row path (kernels/shapes.py leap_group).
// Every long shape is built per shape with it; the tuned table (W <= 16)
// builds no long instantiation, and leap_long_kernel refuses to build
// without it.
#ifdef ASM_SHAPE_GROUP
constexpr int kGroup = ASM_SHAPE_GROUP;
constexpr bool kGroupSet = true;
#else
constexpr int kGroup = 1;
constexpr bool kGroupSet = false;
#endif

// the threads of this thread's group: G consecutive lanes of its warp
template <int G>
__device__ __forceinline__ unsigned group_mask() {
    if constexpr (G == 32)
        return kFull;
    else
        return ((1u << G) - 1u) << ((threadIdx.x & 31) & ~(G - 1));
}

// the long path's shared memory: the block's pairs' planes, W + 1 16-byte
// words a pair
template <int W>
constexpr size_t long_smem_bytes() {
    return sizeof(uint4) * (W + 1) * (kThreads / kGroup);
}

// The block's PB pairs (the first nb of them real) staged in shared
// memory: pair q's word w of read plane 0, read plane 1, ref plane 0 and
// ref plane 1 in the 16-byte sm[q * (W + 1) + w] (x, y, z, w), the bits
// at and past each string's length cleared (padding reads as 'A', as the
// SHD gate needs). Tile-major planes are read pair-fastest (a warp's load
// spans PB adjacent pairs), int8 codes word-fastest (a row is contiguous).
template <int W, int PB, int NT, bool kPlanes>
__device__ __forceinline__ void stage_planes(
    const uint32_t* __restrict__ rc, const uint32_t* __restrict__ fc,
    const int* __restrict__ rl, const int* __restrict__ fl, int64_t first,
    int nb, int64_t tile, uint4* sm) {
    constexpr int L = 32 * W;
    uint32_t* const words = reinterpret_cast<uint32_t*>(sm);
    if constexpr (kPlanes) {
        // NT is a multiple of PB: a thread keeps its pair q
        const int q = threadIdx.x % PB;
        if (q >= nb) return;
        const int64_t p = first + q;
        const int64_t base = (p / tile) * (2 * W) * tile + p % tile;
        const int m = min(rl[p], L), n = min(fl[p], L);
#pragma unroll 1
        for (int row = threadIdx.x / PB; row < 4 * W; row += NT / PB) {
            const bool ref = row >= 2 * W;
            const int pr = ref ? row - 2 * W : row;  // plane row: w or W + w
            const int w = pr < W ? pr : pr - W;
            const uint32_t v = (ref ? fc : rc)[base + pr * tile];
            words[4 * (q * (W + 1) + w) + 2 * ref + (pr >= W)] =
                v & ~mask_ge(ref ? n : m, w);
        }
    } else {
#pragma unroll 1
        for (int idx = threadIdx.x; idx < 2 * PB * W; idx += NT) {
            const int w = idx % W, sq = idx / W;
            const int q = sq % PB;
            const bool ref = sq >= PB;
            if (q >= nb) continue;
            const int64_t p = first + q;
            const uint32_t* row = (ref ? fc : rc) + p * (L / 4) + 8 * w;
            uint32_t p0 = 0, p1 = 0;
#pragma unroll
            for (int jj = 0; jj < 8; jj++) {
                const uint32_t v = row[jj];
                p0 |= (((v & 0x01010101u) * 0x01020408u) >> 24) << (4 * jj);
                p1 |= ((((v >> 1) & 0x01010101u) * 0x01020408u) >> 24)
                      << (4 * jj);
            }
            const uint32_t keep = ~mask_ge(min((ref ? fl : rl)[p], L), w);
            uint32_t* const at = words + 4 * (q * (W + 1) + w) + 2 * ref;
            at[0] = p0 & keep;
            at[1] = p1 & keep;
        }
    }
}

// the mismatch bits of a word of the lane that shifts the read by a_off
// and the ref by b_off (0 <= shifts < 32), from the staged planes of that
// word (cur) and the one below it (prev): bit p is set where A[p - a_off]
// and B[p - b_off] differ
__device__ __forceinline__ uint32_t lane_xor(uint4 prev, uint4 cur, int a_off,
                                             int b_off) {
    return (__funnelshift_l(prev.x, cur.x, a_off) ^
            __funnelshift_l(prev.z, cur.z, b_off)) |
           (__funnelshift_l(prev.y, cur.y, a_off) ^
            __funnelshift_l(prev.w, cur.w, b_off));
}

// One interior lane on the long path: its shifts, and the hurdles no
// mismatch makes, a shifted index past its length (positions >= cut) or
// before index 0 (lo, the low bits of word 0).
struct LaneLong {
    int a_off, b_off, cut;
    uint32_t lo;
};

__device__ __forceinline__ LaneLong lane_long(int j, int MID, int m, int n) {
    LaneLong ln;
    ln.a_off = MID - (j + 1) > 0 ? MID - (j + 1) : 0;
    ln.b_off = (j + 1) - MID > 0 ? (j + 1) - MID : 0;
    ln.cut = min(m + ln.a_off, n + ln.b_off);
    ln.lo = ~(kFull << (ln.a_off + ln.b_off));
    return ln;
}

// count_ID_length on one interior lane without its row: the first hurdle
// at or past start (>= 0), capped at buflen; a start at or past buflen
// answers itself (count_id's answers). Word w of the lane's hurdle row is
// made where it is read, scanning up from the start's word.
template <int W>
__device__ __forceinline__ int count_id_long(const uint4* pl, int start,
                                             const LaneLong& ln, int buflen) {
    if (start >= buflen) return start;
    const int last = (buflen - 1) >> 5;  // a hurdle past it answers buflen
    int w = start >> 5;
    uint4 prev = w > 0 ? pl[w - 1] : make_uint4(0u, 0u, 0u, 0u);
    uint4 cur = pl[w];
    uint32_t h = (lane_xor(prev, cur, ln.a_off, ln.b_off) |
                  mask_ge(ln.cut, w) | (w == 0 ? ln.lo : 0u)) &
                 (kFull << (start & 31));
#pragma unroll 1
    while (h == 0u && w < last) {
        prev = cur;
        cur = pl[++w];
        h = lane_xor(prev, cur, ln.a_off, ln.b_off) | mask_ge(ln.cut, w);
    }
    return h ? min(32 * w + ctz32(h), buflen) : buflen;
}

// CIGAR-mode history of the long path: cell (level ev, lane j) of launch
// pair t, lane j held by thread j / LPT of its group as its lane j % LPT;
// word c of the cell at (((ev * CW + c) * LPT + r) * n + t) * G + g, so the
// warp's stores at one level are consecutive words
template <int CW, int G, int LPT>
__device__ __forceinline__ int64_t cell_at(int ev, int c, int j, int64_t n,
                                           int64_t t) {
    return ((((int64_t)ev * CW + c) * LPT + j % LPT) * n + t) * G + j / LPT;
}

template <int CW, int G, int LPT>
__device__ __forceinline__ Cell<CW> load_cell_long(
    const uint32_t* __restrict__ hist, int NI, int ev, int j, int64_t n,
    int64_t t) {
    Cell<CW> c{kUnr, kUnr, kUnr, kUnr};
    if (j < 0 || j >= NI) return c;  // border lanes are UNREACHED
    if (CW == 1) {
        const uint32_t w = hist[cell_at<CW, G, LPT>(ev, 0, j, n, t)];
        c.s = (int)(w & 0xFF) - 2;
        c.e = (int)((w >> 8) & 0xFF) - 2;
        c.i = (int)((w >> 16) & 0xFF) - 2;
        c.d = (int)(w >> 24) - 2;
    } else {
        const uint32_t a = hist[cell_at<CW, G, LPT>(ev, 0, j, n, t)];
        const uint32_t b = hist[cell_at<CW, G, LPT>(ev, 1, j, n, t)];
        c.s = (int)(a & 0xFFFF) - 2;
        c.e = (int)(a >> 16) - 2;
        c.i = (int)(b & 0xFFFF) - 2;
        c.d = (int)(b >> 16) - 2;
    }
    return c;
}

template <int CW, int G, int LPT>
__device__ __forceinline__ void park_cell_long(uint32_t* __restrict__ hist,
                                               int ev, int j, int64_t n,
                                               int64_t t, int s, int e, int i,
                                               int d) {
    if (CW == 1) {
        hist[cell_at<CW, G, LPT>(ev, 0, j, n, t)] =
            (uint32_t)(s + 2) | ((uint32_t)(e + 2) << 8) |
            ((uint32_t)(i + 2) << 16) | ((uint32_t)(d + 2) << 24);
    } else {
        hist[cell_at<CW, G, LPT>(ev, 0, j, n, t)] =
            (uint32_t)(s + 2) | ((uint32_t)(e + 2) << 16);
        hist[cell_at<CW, G, LPT>(ev, 1, j, n, t)] =
            (uint32_t)(i + 2) | ((uint32_t)(d + 2) << 16);
    }
}

// The wavefront of leap_kernel for rows of W > kShortW words, G = kGroup
// threads a pair (the header's "Long rows"); template parameters, inputs
// and outputs as leap_kernel's, the history scratch in cell_at's layout.
template <int K, int W, int X, int O, int Ge, int SEM, bool CIGAR,
          bool kPlanes>
__global__ void __launch_bounds__(kThreads)
leap_long_kernel(const uint32_t* __restrict__ rc,
                 const uint32_t* __restrict__ fc, const int* __restrict__ rl,
                 const int* __restrict__ fl, const Params P,
                 uint8_t* __restrict__ passed_out, int* __restrict__ pen_out,
                 int* __restrict__ shift_out, int* __restrict__ rec,
                 uint32_t* __restrict__ hist) {
    constexpr int NI = 2 * K + 1;  // interior lanes l = 1..2K+1, j = l - 1
    constexpr int MID = K + 1;
    constexpr int L = 32 * W;
    constexpr int DE = X > O ? X : O;  // end rows kept: levels e-1..e-DE
    constexpr int CW = L > 253 ? 2 : 1;
    constexpr int G = kGroup, PB = kThreads / G;
    constexpr int LPT = (NI + G - 1) / G;  // lanes a thread owns
    constexpr bool kLev = SEM == kSimdLev || SEM == kSimdLevGated;
    constexpr bool kGate = SEM == kSimdLevGated;
    static_assert(!CIGAR || SEM == kLvBag, "CIGARs mirror LV_BAG only");
    static_assert(kGroupSet || W <= kShortW,
                  "a long-row instantiation needs -D ASM_SHAPE_GROUP");
    static_assert(K < 32, "a lane's shift stays within one word");
    static_assert(kThreads % G == 0 && 32 % G == 0, "whole groups in a warp");
    extern __shared__ __align__(16) uint32_t g_planes[];
    uint4* const planes = reinterpret_cast<uint4*>(g_planes);
    const int64_t first = (int64_t)blockIdx.x * PB;  // launch-relative
    const int64_t left = (int64_t)P.n - first;  // pairs from this block on
    const int nb = left < PB ? (int)left : PB;
    stage_planes<W, PB, kThreads, kPlanes>(rc, fc, rl, fl, P.p0 + first, nb,
                                           P.tile, planes);
    __syncthreads();
    const int q = threadIdx.x / G, g = threadIdx.x % G;
    if (q >= nb) return;  // a group leaves whole
    const unsigned gm = group_mask<G>();
    const int64_t t = first + q;
    const int64_t p = P.p0 + t;
    const int64_t n_launch = P.n;
    const int m = min(rl[p], L);
    const int n = min(fl[p], L);
    const int buflen = max(m, n);  // benchmark_utils.h:162
    const int af = P.af;
    const bool corrected = P.mode == kModeGlobal || P.mode == kModeSemiFreeBegin;
    const uint4* const pl = planes + q * (W + 1);

    // ---- the SHD gate: the group's threads take every G-th word ----
    bool gated = false;
    if constexpr (kGate) {
        int count = 0;
#pragma unroll 1
        for (int w = g; w < W; w += G) {
            const uint4 prev = w > 0 ? pl[w - 1] : make_uint4(0u, 0u, 0u, 0u);
            const uint4 cur = pl[w];
            uint32_t dw = kFull;
#pragma unroll
            for (int j = 0; j < NI; j++) {
                const int l = j + 1;
                const int a_off = MID - l > 0 ? MID - l : 0;
                const int b_off = l - MID > 0 ? l - MID : 0;
                dw &= lane_xor(prev, cur, a_off, b_off) |
                      ~mask_ge(a_off + b_off, w);
            }
            dw &= ~mask_ge(buflen, w) & mask_ge(K, w);
            const uint32_t starts = dw & ~((dw << 1) & 0xEEEEEEEEu);
            uint32_t t6 = dw ^ 0x66666666u;
            t6 |= t6 >> 1;
            t6 |= t6 >> 2;
            count += __popc(starts) + __popc(~t6 & 0x11111111u);
        }
        gated = __reduce_add_sync(gm, count) > K;
    }

    // this thread's lanes: j = g * LPT + r (lanes past NI are padding:
    // they run no query and converge never, and no real lane reads them,
    // its neighbour past NI - 1 being UNREACHED)
    auto lane_of = [g](int r) { return g * LPT + r; };
    LaneLong lanes[LPT];
#pragma unroll
    for (int r = 0; r < LPT; r++) lanes[r] = lane_long(lane_of(r), MID, m, n);

    // ---- e = 0 row (LV::init + the first run step) ----
    int endh[DE][LPT], ih[Ge][LPT], dh[Ge][LPT];
    int first_conv = kBig, last_conv = -1;
    const bool free_begin = P.mode == kModeLocal || P.mode == kModeSemiFreeBegin;
#pragma unroll
    for (int r = 0; r < LPT; r++) {
        const int j = lane_of(r);
        const int ld = iabs(j + 1 - MID);
        const int s0 = free_begin ? ld : (ld == 0 ? 0 : kUnr);
        const bool real = j < NI;
        const int e0 = real && s0 >= 0
                           ? count_id_long<W>(pl, s0, lanes[r], buflen)
                           : kUnr;
        endh[0][r] = e0;
#pragma unroll
        for (int d = 1; d < DE; d++) endh[d][r] = kUnr;
#pragma unroll
        for (int d = 0; d < Ge; d++) ih[d][r] = dh[d][r] = kUnr;
        if (real && e0 == buflen && s0 >= 0) {
            first_conv = min(first_conv, j);
            last_conv = max(last_conv, j);
        }
        if (CIGAR && real)
            park_cell_long<CW, G, LPT>(hist, 0, j, n_launch, t, s0, e0, kUnr,
                                       kUnr);
    }
    // lv_bag takes the first converged lane, SIMD_ED (mirrored) the last
    int lane0;
    bool conv_any;
    if constexpr (SEM == kLvBag) {
        const int jf = __reduce_min_sync(gm, first_conv);
        conv_any = jf < kBig;
        lane0 = conv_any ? jf + 1 : MID;
    } else {
        const int jl = __reduce_max_sync(gm, last_conv);
        conv_any = jl >= 0;
        lane0 = conv_any ? jl + 1 : MID;
    }
    int pen0, default_pen;
    if (SEM == kSimdAffine && corrected) {
        pen0 = default_pen = 1000000;  // reset_affine converge_ED
    } else if (corrected || SEM == kLvBag) {
        pen0 = 0;
        default_pen = af + 1;
    } else {
        pen0 = default_pen = 0;
    }
    bool stop = conv_any, passed = conv_any;
    int pen = conv_any ? pen0 : default_pen;
    int flane = lane0;
    if (gated) {  // the reference stops a gated pair before e = 0
        stop = true;
        passed = false;
        pen = 0;
    }

    // ---- the energy loop (the same trips on the whole group) ----
    int e = 1;
    for (; e <= af && !stop; e++) {
        // the neighbour threads' edge lanes: the I row from below and the D
        // row from above, with their end rows
        const int up_end = __shfl_up_sync(gm, endh[O - 1][LPT - 1], 1, G);
        const int up_i = __shfl_up_sync(gm, ih[Ge - 1][LPT - 1], 1, G);
        const int dn_end = __shfl_down_sync(gm, endh[O - 1][0], 1, G);
        const int dn_d = __shfl_down_sync(gm, dh[Ge - 1][0], 1, G);
        int ns[LPT], ne[LPT], ni[LPT], nd[LPT];
        bool conv[LPT];
#pragma unroll
        for (int r = 0; r < LPT; r++) {
            const int j = lane_of(r);
            const int l = j + 1;
            const int top = l >= MID ? 1 : 0;  // LV_BAG.cpp:153-157
            const int bot = l <= MID ? 1 : 0;
            const int end_up =
                j == 0 ? kUnr : (r > 0 ? endh[O - 1][r - 1] : up_end);
            const int i_up = j == 0 ? kUnr : (r > 0 ? ih[Ge - 1][r - 1] : up_i);
            const int ic = max(end_up, i_up);
            const int iv = ic >= 0 ? ic + top : kUnr;
            const int end_dn =
                j >= NI - 1 ? kUnr : (r < LPT - 1 ? endh[O - 1][r + 1] : dn_end);
            const int d_dn =
                j >= NI - 1 ? kUnr : (r < LPT - 1 ? dh[Ge - 1][r + 1] : dn_d);
            const int dc = max(end_dn, d_dn);
            const int dv = dc >= 0 ? dc + bot : kUnr;
            const int em = endh[X - 1][r];
            const int sm = em >= 0 ? em + 1 : kUnr;
            const int s = max(sm, max(iv, dv));
            const int en = j < NI && s >= 0
                               ? count_id_long<W>(pl, s, lanes[r], buflen)
                               : kUnr;
            ns[r] = s;
            ne[r] = en;
            ni[r] = iv;
            nd[r] = dv;
            conv[r] = j < NI && en == buflen && s >= 0;
        }

        bool stop_now = false, pass_now = false;
        int lane_now = 0, pen_now = e;
        bool conv_mine = false;
#pragma unroll
        for (int r = 0; r < LPT; r++) conv_mine = conv_mine || conv[r];
        // a level with no converged lane stops nothing: one vote, and the
        // lane choice only where a lane converged
        if (__any_sync(gm, conv_mine)) {
            if constexpr (kLev) {
                // run_levenshtein stops at its first converged lane (our
                // last) whether or not the converge correction passes it
                int mine = -1;
#pragma unroll
                for (int r = 0; r < LPT; r++)
                    if (conv[r]) mine = lane_of(r);
                const int jl = __reduce_max_sync(gm, mine);
                stop_now = true;
                lane_now = jl + 1;
                pen_now = corrected ? e + iabs(lane_now - MID) : e;
                pass_now = !corrected || pen_now <= af;
            } else {
                // the lane of least (corrected) penalty within af: lv_bag
                // corrected keeps the first of equals, simd_ed_affine and
                // the uncorrected modes the last (LV_BAG.cpp:233-237)
                const bool last_of_equals = SEM == kSimdAffine || !corrected;
                int tt[LPT], tmine = kBig;
#pragma unroll
                for (int r = 0; r < LPT; r++) {
                    const int ld = iabs(lane_of(r) + 1 - MID);
                    const int tc =
                        e + (corrected && ld > 0 ? O + (ld - 1) * Ge : 0);
                    tt[r] = conv[r] && tc <= af ? tc : kBig;
                    tmine = min(tmine, tt[r]);
                }
                const int tmin = __reduce_min_sync(gm, tmine);
                int pick_last = -1, pick_first = kBig;
#pragma unroll
                for (int r = 0; r < LPT; r++) {
                    if (tt[r] == tmin) {
                        pick_last = max(pick_last, lane_of(r));
                        pick_first = min(pick_first, lane_of(r));
                    }
                }
                const int jsel = last_of_equals
                                     ? __reduce_max_sync(gm, pick_last)
                                     : __reduce_min_sync(gm, pick_first);
                pass_now = stop_now = tmin < kBig;
                lane_now = jsel + 1;
                if (SEM == kSimdAffine) pen_now = tmin;
            }
        }
        if (stop_now) {
            stop = true;
            passed = pass_now;
            pen = pen_now;
            flane = lane_now;
        }

#pragma unroll
        for (int r = 0; r < LPT; r++) {
#pragma unroll
            for (int d = DE - 1; d > 0; d--) endh[d][r] = endh[d - 1][r];
            endh[0][r] = ne[r];
#pragma unroll
            for (int d = Ge - 1; d > 0; d--) {
                ih[d][r] = ih[d - 1][r];
                dh[d][r] = dh[d - 1][r];
            }
            ih[0][r] = ni[r];
            dh[0][r] = nd[r];
            if (CIGAR && e <= P.E && lane_of(r) < NI)
                park_cell_long<CW, G, LPT>(hist, e, lane_of(r), n_launch, t,
                                           ns[r], ne[r], ni[r], nd[r]);
        }
    }

    if (!CIGAR) {
        if (g == 0) {
            passed_out[p] = passed ? 1 : 0;
            pen_out[p] = pen;
            shift_out[p] = flane - MID;
        }
        return;
    }
    __syncwarp(gm);  // the group's parked cells, seen by its walker
    if (g != 0) return;
    passed_out[p] = passed ? 1 : 0;
    pen_out[p] = pen;
    shift_out[p] = flane - MID;
    // ---- the backtrack walk (LV::backtrack, LV_BAG.cpp:250-354) ----
    // cm: 0 a fresh arrival, 1 inside an insertion chain, 2 a deletion chain
    const int64_t B = P.B;
    int row_hi = P.E;  // rows above row_hi are written
    int term = 0;
    if (passed && pen <= P.E) {
        int cur = pen, ln = flane, cm = 0;
        for (int guard = 0; cur > 0 && guard <= P.E; guard++) {
            const int ev = cur;
            const Cell<CW> c =
                load_cell_long<CW, G, LPT>(hist, NI, ev, ln - 1, n_launch, t);
            const bool ok_ge = ev - Ge >= 0;
            const int evg = ok_ge ? ev - Ge : 0;
            const int i_prev =
                load_cell_long<CW, G, LPT>(hist, NI, evg, ln - 2, n_launch, t)
                    .i;
            const int d_prev =
                load_cell_long<CW, G, LPT>(hist, NI, evg, ln, n_launch, t).d;
            const bool fresh = cm == 0;
            const int run = fresh ? c.e - c.s : 0;
            const bool is_i = fresh ? c.s == c.i : cm == 1;
            const bool is_d = fresh ? (c.s != c.i && c.s == c.d) : cm == 2;
            const int top = ln >= MID ? 1 : 0;
            const int bot = ln <= MID ? 1 : 0;
            const bool ext_i = ok_ge && i_prev != kUnr && i_prev + top == c.i;
            const bool ext_d = ok_ge && d_prev != kUnr && d_prev + bot == c.d;
            const int op = is_i ? 2 : (is_d ? 3 : 1);
            const bool is_open = (is_i && !ext_i) || (is_d && !ext_d);
            for (int r = row_hi; r > ev; r--) rec[r * B + p] = 0;
            rec[ev * B + p] = op | ((is_open ? 1 : 0) << 2) | (run << 3);
            row_hi = ev - 1;
            const int de =
                is_i ? (ext_i ? Ge : O) : (is_d ? (ext_d ? Ge : O) : X);
            cur = max(ev - de, 0);
            ln += is_i ? -1 : (is_d ? 1 : 0);
            cm = (is_i && ext_i) ? 1 : ((is_d && ext_d) ? 2 : 0);
        }
        // the terminal match run at energy 0 on the walk's final lane
        const Cell<CW> c0 =
            load_cell_long<CW, G, LPT>(hist, NI, 0, ln - 1, n_launch, t);
        term = c0.e - c0.s;
    }
    for (int r = row_hi; r >= 1; r--) rec[r * B + p] = 0;
    rec[p] = term;
}

// once per instantiation: room for the rows above the 48 KB default, and
// the carveout that gives shared memory the most of the SM's 256 KB
template <typename F>
cudaError_t set_attributes(F* kernel, size_t smem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                (int)cudaSharedmemCarveoutMaxShared);
}

struct Launch {
    const void *rc, *fc, *rl, *fl;
    Params P;
    void *passed, *pen, *shift, *rec, *hist;
    cudaStream_t stream;
};

// the launch's run-time choice of instantiation: penalties (0 = unit, x =
// o = e = 1; 1 = affine, x = 2, o = 3, e = 1), semantics (0 lv_bag, 1
// simd_ed_lev, behind the SHD gate with gate != 0, 2 simd_ed_affine), and
// the CIGAR mode (lv_bag alone)
struct Choice {
    int pens, sem, gate, cigar;
};

// the kernel of the instantiation: the long-row path's above kShortW words
template <int K, int W, int X, int O, int G, int SEM, bool CIGAR,
          bool kPlanes>
auto kernel_of() {
    if constexpr (W > kShortW)
        return leap_long_kernel<K, W, X, O, G, SEM, CIGAR, kPlanes>;
    else
        return leap_kernel<K, W, X, O, G, SEM, CIGAR, kPlanes>;
}

// launches the instantiation (a != nullptr) or, with a == nullptr, stores
// its resident blocks per SM in *blocks
template <int K, int W, int X, int O, int G, int SEM, bool CIGAR,
          bool kPlanes>
cudaError_t run(const Launch* a, int* blocks) {
    const auto kernel = kernel_of<K, W, X, O, G, SEM, CIGAR, kPlanes>();
    constexpr bool kLong = W > kShortW;
    constexpr size_t smem = kLong ? long_smem_bytes<W>() : smem_bytes<K, W>();
    // pairs per block: one a thread, one a group on the long path
    constexpr int PB = kLong ? kThreads / kGroup : kThreads;
    static const cudaError_t attr = set_attributes(kernel, smem);
    if (attr != cudaSuccess) return attr;
    if (a == nullptr)
        return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                             kThreads, smem);
    const int grid = (a->P.n + PB - 1) / PB;
    kernel<<<grid, kThreads, smem, a->stream>>>(
        (const uint32_t*)a->rc, (const uint32_t*)a->fc, (const int*)a->rl,
        (const int*)a->fl, a->P, (uint8_t*)a->passed, (int*)a->pen,
        (int*)a->shift, (int*)a->rec, (uint32_t*)a->hist);
    return cudaGetLastError();
}

// simd_ed_lev is init_levenshtein: unit penalties alone (the wrapper's
// check_options refuses any other set), so only those are built
template <int K, int W, int X, int O, int G, bool kPlanes>
cudaError_t by_semantics(const Choice& c, const Launch* a, int* blocks) {
    constexpr bool kUnit = X == 1 && O == 1 && G == 1;
    if (c.sem == kLvBag && !c.gate)
        return c.cigar ? run<K, W, X, O, G, kLvBag, true, kPlanes>(a, blocks)
                       : run<K, W, X, O, G, kLvBag, false, kPlanes>(a, blocks);
    if (c.cigar) return cudaErrorInvalidValue;
    if constexpr (kUnit) {
        if (c.sem == kSimdLev && c.gate)
            return run<K, W, X, O, G, kSimdLevGated, false, kPlanes>(a,
                                                                     blocks);
        if (c.sem == kSimdLev)
            return run<K, W, X, O, G, kSimdLev, false, kPlanes>(a, blocks);
    }
    if (c.sem == kSimdAffine && !c.gate)
        return run<K, W, X, O, G, kSimdAffine, false, kPlanes>(a, blocks);
    return cudaErrorInvalidValue;
}

#ifndef ASM_SHAPE_K
template <int K, int W, bool kPlanes>
cudaError_t by_penalty(const Choice& c, const Launch* a, int* blocks) {
    if (c.pens == 0) return by_semantics<K, W, 1, 1, 1, kPlanes>(c, a, blocks);
    if (c.pens == 1) return by_semantics<K, W, 2, 3, 1, kPlanes>(c, a, blocks);
    return cudaErrorInvalidValue;
}

cudaError_t dispatch(int k, int W, int planes, const Choice& c,
                     const Launch* a, int* blocks) {
#define ASM_LEAP_CASE(KK, WW)                                \
    if (k == KK && W == WW)                                  \
        return planes ? by_penalty<KK, WW, true>(c, a, blocks) \
                      : by_penalty<KK, WW, false>(c, a, blocks);
    ASM_LEAP_CASE(2, 4)
    ASM_LEAP_CASE(2, 8)
    ASM_LEAP_CASE(3, 4)
    ASM_LEAP_CASE(3, 8)
    ASM_LEAP_CASE(4, 4)
    ASM_LEAP_CASE(4, 8)
    ASM_LEAP_CASE(2, 16)
    ASM_LEAP_CASE(3, 16)
    ASM_LEAP_CASE(4, 16)
#undef ASM_LEAP_CASE
    return cudaErrorInvalidValue;
}
#else
// the one shape this library is built for; its penalty set is the
// library's own, whatever `pens` the caller names
cudaError_t dispatch(int k, int W, int planes, const Choice& c,
                     const Launch* a, int* blocks) {
    constexpr int K = ASM_SHAPE_K, WW = ASM_SHAPE_W;
    constexpr int X = ASM_SHAPE_X, O = ASM_SHAPE_O, G = ASM_SHAPE_G;
    if (k != K || W != WW) return cudaErrorInvalidValue;
    return planes ? by_semantics<K, WW, X, O, G, true>(c, a, blocks)
                  : by_semantics<K, WW, X, O, G, false>(c, a, blocks);
}
#endif

}  // namespace

// rc/fc: tile-major planes uint32[NBT, 2W, tile] (planes != 0) or int8
// codes [B, 32W] (rows read as uint32 words); rl/fl: int32[B]. The launch
// covers pairs p0 .. p0+n-1 of the batch. Outputs: passed uint8[B],
// penalty / lane_shift int32[B]; with cigar, rec int32[E+1, B] and the
// scratch hist uint32[(E+1) * (2k+1) * CW, n]. Returns the launch's
// cudaError_t (0 on success); does not synchronise.
extern "C" int asm_leap_launch(const void* rc, const void* fc, const void* rl,
                               const void* fl, int n, int p0, int B, int tile,
                               int planes, int k, int W, int pens, int sem,
                               int gate, int mode, int af, int E, int cigar,
                               void* passed, void* pen, void* shift, void* rec,
                               void* hist, int device, void* stream) {
    if (n <= 0) return 0;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const Launch a{rc,   fc,  rl,    fl,  Params{n, p0, B, tile, mode, af, E},
                   passed, pen, shift, rec, hist, (cudaStream_t)stream};
    return (int)dispatch(k, W, planes, Choice{pens, sem, gate, cigar}, &a,
                         nullptr);
}

// Resident blocks per SM of the lv_bag instantiation at (k, W), unit
// penalties, on tile-major planes, in CIGAR mode or not, on the current
// device, with the shared memory its launch uses; a negative value is
// -cudaError_t.
extern "C" int asm_leap_occupancy(int k, int W, int cigar) {
    int blocks = 0;
    const cudaError_t err =
        dispatch(k, W, 1, Choice{0, kLvBag, 0, cigar}, nullptr, &blocks);
    return err != cudaSuccess ? -(int)err : blocks;
}
