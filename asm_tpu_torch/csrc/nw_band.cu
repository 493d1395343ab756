// Banded NW/Gotoh penalty on Hopper (sm_90a): BW/2 threads per pair, each
// computing one existing band cell per diagonal.
//
// Replaces the Pallas TPU kernel asm_tpu/kernels/nw_band.py _nw_band_kernel
// (wrapper nw_penalty_banded). Band offsets: offset u of a pair's band
// holds the diagonal offset k = i - j = u - KB, KB = BW/2 - 1; cell (d, k)
// reads E from (d-1, k-1), F from (d-1, k+1) and the substitution from
// (d-2, k), and INF enters at the band's two edges. The pair's result is
// H at (d = m+n, k = m-n), min-folded with the closed form of empty reads,
// so uncertified upper bounds and INF (destination off the band) come out
// as the JAX kernel's.
//
// Layout. A cell (d, k) exists only where d + k is even, and an existing
// cell reads only existing ones. KB is odd for every BW, so a pair takes
// SEG = BW/2 threads (64/BW pairs per warp) and thread t owns two
// adjacent offsets: A at u = 2t (k odd, cells on odd diagonals) and B at
// u = 2t + 1 (k even, even diagonals). One loop trip is two diagonals:
//   A on odd d:  E from B of thread t-1 (two shuffles up), F from the
//                thread's own B, the substitution from its own A;
//   B on d + 1:  E from the thread's own A, F from A of thread t+1 (two
//                shuffles down), the substitution from its own B.
// Shuffles run with width SEG, so a segment's edge thread takes INF in
// place of its neighbour, exactly the TPU kernel's at_lo / at_hi. The
// state is six registers (H, E, F of A and B); no cell of the wrong parity
// is computed. Along a trip A and B share the ref code, and B's read code
// is the next trip's A's, so a trip loads two code bytes from shared
// memory. The borders (k == d, k == -d) live only in the first BW/4 trips,
// which are unrolled apart from the main loop. Each pair's 2-bit planes
// are loaded once per word and unpacked in registers, four codes per
// 32-bit shared store, into rows padded by BW/4 codes on both sides, so
// the running code indices need no clamps.
//
// Shapes: BW 4-128 at every L = 32W; W in {4, 8, 16} is built together,
// any other W at its first use into a library of its own. BW 4 packs 16
// pairs a warp, and at L >= 384 a block of 64 threads keeps its rows in
// the 48 KB of static shared memory (block_threads). BW 128 at every L,
// and every BW above L = 512, take band_wide_kernel (below): wide_np(BW, L)
// offset pairs a thread, the code rows in dynamic shared memory.
//
// What bounds it: integer issue. A pair reads 64 B of planes and writes
// 4 B, so memory is far below. By the SASS count (tools/roofline.py
// nw_band_loop), the diagonal loop issues 18 instructions per existing
// cell at BW 8/16 (19-19.5 at BW 32/64): two shuffles, one shared byte
// load, half a branch and 14.5 integer instructions where the recurrence
// needs 11 (utils/bounds.py); the earlier kernel, one thread per offset,
// issued 78-86. The shuffle pipe is not the limit: two shuffles in 18
// instructions. A warp loops to the largest m+n of its 64/BW pairs,
// 1.001-1.002x the mean in the headline's band-major order. Of the loop's
// 36 instructions per trip at BW 16, ptxas already fuses six add-min
// pairs into DPX VIADDMNMX; 4 are the band edges' INF selects and 6 the
// destination's capture (two compares, two selects, two counters). Left
// for later: those ten, DPX min-plus written out (__viaddmin_s32,
// __vimin3_s32) where ptxas does not fuse, and mismatches from the bit
// planes without shared memory. Int8 codes reach the band kernels as
// planes through stage_kernel (the end of this file).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kInf = 1 << 29;
constexpr unsigned kFull = 0xFFFFFFFFu;

// code rows: PAD bytes, the L codes, PAD bytes; the running indices reach
// BW/4 codes past either end. An odd number of words per row skews a
// warp's rows across the banks.
__host__ __device__ constexpr int pad_codes(int BW) { return BW / 4 < 4 ? 4 : BW / 4; }
__host__ __device__ constexpr int row_words(int BW, int L) {
    return (L + 2 * pad_codes(BW)) / 4 % 2 ? (L + 2 * pad_codes(BW)) / 4
                                           : (L + 2 * pad_codes(BW)) / 4 + 1;
}

// threads per block: 128, or 64 or 32 where the block's code rows (two
// per pair, 64/BW pairs a warp) would pass the 48 KB of static shared
// memory (BW 4 at L >= 384); 128 at every BW of 8 and up
__host__ __device__ constexpr int block_threads(int BW, int L) {
    return 8 * row_words(BW, L) * (64 / BW) * 4 <= 48 * 1024   ? 128
           : 8 * row_words(BW, L) * (64 / BW) * 2 <= 48 * 1024 ? 64
                                                                : 32;
}

struct Params {
    int B, x, o, e;
};

// the low 4 bits of v, one to bit 0 of each byte
__device__ __forceinline__ uint32_t spread4(uint32_t v) {
    return ((v & 15u) * 0x00204081u) & 0x01010101u;
}

// the j == 0 column (k == d: h = e = the border penalty, f = INF) and the
// i == 0 row (k == -d: h = the border penalty, e = f = INF)
__device__ __forceinline__ void border(int k, int d, int o, int e, int& h,
                                       int& en, int& fn) {
    const int bp = o + (d - 1) * e;
    const bool bl = k == d, bt = k == -d;
    if (bl || bt) {
        h = bp;
        fn = kInf;
    }
    en = bl ? bp : (bt ? kInf : en);
}

struct Cells {
    int ha, ea, fa, hb, eb, fb;
};

// One trip: A on odd diagonal d, then B on d + 1. ra / rb: the read codes
// of A's and B's cells, c: their ref code (the same column j).
template <int SEG, bool BORDERS>
__device__ __forceinline__ void trip(Cells& s, int& hit, int d, int ra, int rb,
                                     int c, int t, int ka, int hit_a,
                                     int hit_b, int x, int o, int e) {
    {
        int uh = __shfl_up_sync(kFull, s.hb, 1, SEG);
        int ue = __shfl_up_sync(kFull, s.eb, 1, SEG);
        if (t == 0) {
            uh = kInf;
            ue = kInf;
        }
        int en = min(uh + o, ue + e);
        int fn = min(s.hb + o, s.fb + e);
        int hn = min(s.ha + (ra != c ? x : 0), min(en, fn));
        if (BORDERS) border(ka, d, o, e, hn, en, fn);
        if (d == hit_a) hit = hn;
        s.ha = hn;
        s.ea = en;
        s.fa = fn;
    }
    {
        int dh = __shfl_down_sync(kFull, s.ha, 1, SEG);
        int df = __shfl_down_sync(kFull, s.fa, 1, SEG);
        if (t == SEG - 1) {
            dh = kInf;
            df = kInf;
        }
        int en = min(s.ha + o, s.ea + e);
        int fn = min(dh + o, df + e);
        int hn = min(s.hb + (rb != c ? x : 0), min(en, fn));
        if (BORDERS) border(ka + 1, d + 1, o, e, hn, en, fn);
        if (d + 1 == hit_b) hit = hn;
        s.hb = hn;
        s.eb = en;
        s.fb = fn;
    }
}

template <int BW, int W>
__global__ void __launch_bounds__(block_threads(BW, 32 * W))
band_kernel(const uint32_t* __restrict__ rp, const uint32_t* __restrict__ fp,
            const int* __restrict__ rl, const int* __restrict__ fl, Params P,
            int* __restrict__ pen_out) {
    constexpr int L = 32 * W;
    constexpr int SEG = BW / 2;  // threads per pair
    constexpr int PPW = 32 / SEG;  // pairs per warp
    constexpr int PPB = (block_threads(BW, L) / 32) * PPW;
    constexpr int KB = BW / 2 - 1;
    constexpr int PAD = pad_codes(BW);
    constexpr int ROWW = row_words(BW, L);
    __shared__ __align__(16) uint32_t s_read[PPB][ROWW];
    __shared__ __align__(16) uint32_t s_ref[PPB][ROWW];

    const int lane = threadIdx.x & 31;
    const int slot = (threadIdx.x >> 5) * PPW + lane / SEG;
    const int t = lane % SEG;  // thread within the pair's segment
    const int64_t p = (int64_t)blockIdx.x * PPB + slot;
    const bool live = p < P.B;
    const int64_t B = P.B;
    const int x = P.x, o = P.o, e = P.e;

    int m = 0, n = 0;
    if (live) {
        m = min(rl[p], L);
        n = min(fl[p], L);
    }
    // unpack the pair's planes (row w: bit 0 of positions 32w..32w+31,
    // row W + w: bit 1): each thread loads its words once and stores
    // QPT quads (4 codes each) of every one of them
    {
        constexpr int WN = W < SEG ? W : SEG;  // threads on distinct words
        // the threads split the words evenly when one count divides the
        // other and a word has at most 8 threads, one quad each or more
        // (the tuned table's W); else thread t takes words t, t + SEG, ...
        // whole
        constexpr bool kEven =
            W < SEG ? SEG % W == 0 && SEG / W <= 8 : W % SEG == 0;
        constexpr int G = kEven ? SEG / WN : 1;  // threads per word
        constexpr int QPT = 8 / G;  // quads per thread and word
        const int ws = t % WN, g = t / WN;
#pragma unroll
        for (int i = 0; i < (kEven ? W / WN : (W + SEG - 1) / SEG); i++) {
            const int w = kEven ? ws + WN * i : t + SEG * i;
            if (!kEven && w >= W) break;
            uint32_t rlo = 0, rhi = 0, flo = 0, fhi = 0;
            if (live) {
                rlo = rp[w * B + p];
                rhi = rp[(W + w) * B + p];
                flo = fp[w * B + p];
                fhi = fp[(W + w) * B + p];
            }
#pragma unroll
            for (int j = 0; j < QPT; j++) {
                const int q = (kEven ? g * QPT : 0) + j, sh = 4 * q;
                const int at = PAD / 4 + 8 * w + q;
                s_read[slot][at] = spread4(rlo >> sh) | (spread4(rhi >> sh) << 1);
                s_ref[slot][at] = spread4(flo >> sh) | (spread4(fhi >> sh) << 1);
            }
        }
        for (int u = t; u < PAD / 2; u += SEG) {  // the pads: don't-care
            const int at = u < PAD / 4 ? u : u + 8 * W;
            s_read[slot][at] = 0;
            s_ref[slot][at] = 0;
        }
    }
    __syncwarp();

    const int mn = m + n, dk = m - n;
    const int trips = (__reduce_max_sync(kFull, mn) + 1) >> 1;
    const int ka = 2 * t - KB;  // offset A; B is ka + 1
    // the destination's owner captures H on diagonal m+n
    const int ud = dk + KB;
    const bool in_band = ud >= 0 && ud < BW;
    const bool owner = in_band && (ud >> 1) == t;
    const int hit_a = owner && !(ud & 1) ? mn : -1;
    const int hit_b = owner && (ud & 1) ? mn : -1;

    Cells s{kInf, kInf, kInf, ka + 1 == 0 ? 0 : kInf, kInf, kInf};
    int hit = kInf;
    // trip tau: A's cell is (i, j) = (tau + t + 1 - BW/4, tau - t + BW/4),
    // B's (i + 1, j); codes at i - 1 and j - 1
    const uint8_t* pr =
        reinterpret_cast<const uint8_t*>(s_read[slot]) + PAD + t - BW / 4;
    const uint8_t* pc = reinterpret_cast<const uint8_t*>(s_ref[slot]) + PAD +
                        BW / 4 - 1 - t;
    int ra = pr[0];
#pragma unroll
    for (int tau = 0; tau < BW / 4; tau++) {  // the borders' trips
        if (tau >= trips) break;
        const int rb = pr[tau + 1], c = pc[tau];
        trip<SEG, true>(s, hit, 2 * tau + 1, ra, rb, c, t, ka, hit_a, hit_b,
                        x, o, e);
        ra = rb;
    }
#pragma unroll 1
    for (int tau = BW / 4; tau < trips; tau++) {
        const int rb = pr[tau + 1], c = pc[tau];
        trip<SEG, false>(s, hit, 2 * tau + 1, ra, rb, c, t, ka, hit_a, hit_b,
                         x, o, e);
        ra = rb;
    }

    if (!live) return;
    const int closed = mn == 0 ? 0 : (m == 0 ? o + (mn - 1) * e : kInf);
    if (in_band ? owner : t == 0) pen_out[p] = min(closed, hit);
}

// ---- the wide path: BW 128 at every L, and every BW at L > 512 ----
// Each thread owns NP pairs of adjacent offsets, A_q at u = 2(NP t + q)
// and B_q at u + 1, q < NP: a pair takes SEG = BW / (2 NP) threads, a warp
// 32 / SEG pairs. NP per BW is wide_np_table's, chosen by timing
// (tools/longseq_sweep bandnp; PERF.md section 6), halved where one warp's
// rows would not fit a block (wide_np). At BW 4 a pair is one thread (no
// shuffle at all). A pair never spans two warps: that would trade both
// band edges through shared memory and a barrier every diagonal. The code
// rows live in dynamic shared memory: at L > 512 the two rows of a warp's
// pairs pass the 48 KB of static shared memory at 32 threads a block (L =
// 2048: 131,840 B a warp at BW 4, 16,672 at BW 64).
//
// What bounds it: integer issue, as band_kernel. The loop takes out what
// band_kernel's layout kept in every cell and that the recurrence does
// not need:
// - the borders (k == +-d) lie in the first BW/4 trips only: those run in
//   a loop of their own (wide_trip<.., true>), the rest test nothing;
// - the destination: a pair's last trip ends on its diagonal m+n, so its
//   owner reads H there once. The trips before the warp's first such trip
//   run with no capture; the last ones (a warp holding pairs of other
//   lengths) test the trip, not each cell;
// - one shuffle a diagonal, not two: a thread sends its neighbour the E
//   (or F) that the neighbour's cell takes, min(h + o, e + e), computed
//   from its own cell, whose h + o also serves the F (or E) of the cell
//   beside it in the thread; NP offset pairs share each shuffle and each
//   edge select;
// - the main loop runs kWideUnroll trips a pass, so the code window (a
//   read code and a ref code a trip) rotates by register renaming.
// An edge thread takes INF for its absent neighbour's E or F, where the
// plain version takes INF + min(o, e): values grown from INF never win a
// min at a cell that a path from (0, 0) reaches, so the outputs are the
// plain version's bit for bit.
constexpr int kShortW = 16;
constexpr int kWideSmem = 64 * 1024;  // a wide block's shared memory, at most,
                                      // while more than one warp fits
constexpr int kSmemBlock = 232448;    // the most a block may take (sm_90)
constexpr int kWideUnroll = 2;        // trips a pass of the main loop
constexpr int kNever = 0x7fffffff;

// offset pairs a thread holds at BW, as timed (tools/longseq_sweep bandnp)
__host__ __device__ constexpr int wide_np_table(int BW) { return BW == 128 ? 4 : BW == 64 ? 4 : BW == 32 ? 4 : BW == 16 ? 2 : BW == 4 ? 2 : 1; }
// dynamic shared bytes of a wide block of `threads` at NP offset pairs a
// thread: two code rows a pair, 32 / SEG pairs a warp
__host__ __device__ constexpr int wide_rows_smem(int BW, int L, int threads,
                                                 int np) {
    return threads / 32 * (32 / (BW / (2 * np))) * 2 * row_words(BW, L) * 4;
}
// the table's NP, halved while one warp's rows pass a block's shared
// memory (down to the least NP whose pair fits a warp), so every L the
// layout of one offset pair a thread took still builds
__host__ __device__ constexpr int wide_np(int BW, int L) {
    int np = wide_np_table(BW);
    while (np > (BW > 64 ? BW / 64 : 1) &&
           wide_rows_smem(BW, L, 32, np) > kSmemBlock)
        np /= 2;
    return np;
}
__host__ __device__ constexpr int wide_seg(int BW, int L) {
    return BW / (2 * wide_np(BW, L));
}
__host__ __device__ constexpr int wide_smem(int BW, int L, int threads) {
    return wide_rows_smem(BW, L, threads, wide_np(BW, L));
}
__host__ __device__ constexpr int wide_threads(int BW, int L) {
    return wide_smem(BW, L, 128) <= kWideSmem  ? 128
           : wide_smem(BW, L, 64) <= kWideSmem ? 64
                                               : 32;
}

template <int NP>
struct WideCells {
    int ha[NP], ea[NP], fa[NP], hb[NP], eb[NP], fb[NP];
};

// One trip of the wide layout: every A_q on odd diagonal d, then every B_q
// on d + 1. rw[q]: A_q's read code (B_q's is rw[q + 1]); cw[q]: the ref
// code of both; ka: offset k of A_0 (the borders' test).
template <int NP, int SEG, bool BORDERS>
__device__ __forceinline__ void wide_trip(WideCells<NP>& s, int d,
                                          const int (&rw)[NP + 1],
                                          const int (&cw)[NP], int t, int ka,
                                          int x, int o, int e) {
    {  // A_q: E from B_{q-1} (q = 0: B_{NP-1} of thread t-1), F from B_q
        int ho[NP], eo[NP];  // B_q's h + o, and the E that A_{q+1} takes
#pragma unroll
        for (int q = 0; q < NP; q++) {
            ho[q] = s.hb[q] + o;
            eo[q] = min(s.eb[q] + e, ho[q]);
        }
        int ein = __shfl_up_sync(kFull, eo[NP - 1], 1, SEG);
        if (t == 0) ein = kInf;
#pragma unroll
        for (int q = 0; q < NP; q++) {
            int en = q == 0 ? ein : eo[q - 1];
            int fn = min(s.fb[q] + e, ho[q]);
            int hn = min(s.ha[q] + (rw[q] != cw[q] ? x : 0), min(en, fn));
            if (BORDERS) border(ka + 2 * q, d, o, e, hn, en, fn);
            s.ha[q] = hn;
            s.ea[q] = en;
            s.fa[q] = fn;
        }
    }
    {  // B_q: E from A_q, F from A_{q+1} (q = NP-1: A_0 of thread t+1)
        int ho[NP], fo[NP];  // A_q's h + o, and the F that B_{q-1} takes
#pragma unroll
        for (int q = 0; q < NP; q++) {
            ho[q] = s.ha[q] + o;
            fo[q] = min(s.fa[q] + e, ho[q]);
        }
        int fin = __shfl_down_sync(kFull, fo[0], 1, SEG);
        if (t == SEG - 1) fin = kInf;
#pragma unroll
        for (int q = 0; q < NP; q++) {
            int en = min(s.ea[q] + e, ho[q]);
            int fn = q == NP - 1 ? fin : fo[q + 1];
            int hn = min(s.hb[q] + (rw[q + 1] != cw[q] ? x : 0), min(en, fn));
            if (BORDERS) border(ka + 2 * q + 1, d + 1, o, e, hn, en, fn);
            s.hb[q] = hn;
            s.eb[q] = en;
            s.fb[q] = fn;
        }
    }
}

template <int BW, int W>
__global__ void __launch_bounds__(wide_threads(BW, 32 * W))
band_wide_kernel(const uint32_t* __restrict__ rp,
                 const uint32_t* __restrict__ fp, const int* __restrict__ rl,
                 const int* __restrict__ fl, Params P,
                 int* __restrict__ pen_out) {
    constexpr int L = 32 * W;
    constexpr int NP = wide_np(BW, L);
    constexpr int SEG = wide_seg(BW, L);  // threads per pair
    constexpr int PPW = 32 / SEG;      // pairs per warp
    constexpr int PPB = (wide_threads(BW, L) / 32) * PPW;
    constexpr int KB = BW / 2 - 1;
    constexpr int PAD = pad_codes(BW);
    constexpr int ROWW = row_words(BW, L);
    constexpr int NB = BW / 4;  // the trips that hold border cells
    static_assert(SEG >= 1 && 32 % SEG == 0 && 2 * NP * SEG == BW,
                  "wide_np must split a band into whole warp segments");
    extern __shared__ __align__(16) uint32_t s_rows[];  // [PPB][2][ROWW]

    const int lane = threadIdx.x & 31;
    const int slot = (threadIdx.x >> 5) * PPW + lane / SEG;
    const int t = lane % SEG;
    const int64_t p = (int64_t)blockIdx.x * PPB + slot;
    const bool live = p < P.B;
    const int64_t B = P.B;
    const int x = P.x, o = P.o, e = P.e;
    uint32_t* const s_read = s_rows + slot * 2 * ROWW;
    uint32_t* const s_ref = s_read + ROWW;

    int m = 0, n = 0;
    if (live) {
        m = min(rl[p], L);
        n = min(fl[p], L);
    }
    // unpack the planes: thread t takes words t, t + SEG, ..., 8 quads each
    for (int w = t; w < W; w += SEG) {
        uint32_t rlo = 0, rhi = 0, flo = 0, fhi = 0;
        if (live) {
            rlo = rp[w * B + p];
            rhi = rp[(W + w) * B + p];
            flo = fp[w * B + p];
            fhi = fp[(W + w) * B + p];
        }
#pragma unroll
        for (int q = 0; q < 8; q++) {
            const int at = PAD / 4 + 8 * w + q;
            s_read[at] = spread4(rlo >> (4 * q)) | (spread4(rhi >> (4 * q)) << 1);
            s_ref[at] = spread4(flo >> (4 * q)) | (spread4(fhi >> (4 * q)) << 1);
        }
    }
    for (int u = t; u < PAD / 2; u += SEG) {  // the pads: don't-care
        const int at = u < PAD / 4 ? u : u + 8 * W;
        s_read[at] = 0;
        s_ref[at] = 0;
    }
    __syncwarp();

    const int mn = m + n, dk = m - n;
    // the destination (d = m+n, offset ud) lies in thread ud / (2 NP), pair
    // qd = ud / 2 % NP, slot A where ud is even (m+n odd)
    const int ud = dk + KB;
    const bool in_band = ud >= 0 && ud < BW;
    const bool owner = in_band && ud / (2 * NP) == t;
    const int qd = ud / 2 % NP;
    const bool dest_b = ud & 1;
    // a pair's trips end on its destination's diagonal; the owner reads H
    // on the last one (m+n = 0 takes the closed form)
    const int need = (mn + 1) >> 1;
    const int cap = owner && mn > 0 ? need - 1 : -1;
    const int hi = __reduce_max_sync(kFull, need);
    const int lo = __reduce_min_sync(kFull, cap >= NB ? cap : kNever);

    const int ka = 2 * NP * t - KB;  // offset A_0; A_q is ka + 2q, B_q + 1
    WideCells<NP> s;
#pragma unroll
    for (int q = 0; q < NP; q++) {
        s.ha[q] = s.ea[q] = s.fa[q] = s.eb[q] = s.fb[q] = kInf;
        s.hb[q] = ka + 2 * q + 1 == 0 ? 0 : kInf;  // diagonal 0: only (0, 0)
    }
    int hit = kInf;
    auto take = [&]() {  // the owner's H at its destination
#pragma unroll
        for (int q = 0; q < NP; q++)
            if (q == qd) hit = dest_b ? s.hb[q] : s.ha[q];
    };
    // trip tau: A_q's cell is (i, j) = (tau + v + 1 - BW/4, tau - v + BW/4),
    // v = NP t + q, B_q's (i + 1, j); the read codes of A_q and B_q are
    // pr[tau + q] and pr[tau + q + 1], their ref code pc[tau - q]
    const uint8_t* pr =
        reinterpret_cast<const uint8_t*>(s_read) + PAD + NP * t - BW / 4;
    const uint8_t* pc =
        reinterpret_cast<const uint8_t*>(s_ref) + PAD + BW / 4 - 1 - NP * t;
    int rw[NP + 1], cw[NP];  // pr[tau .. tau + NP], pc[tau - q]
#pragma unroll
    for (int q = 0; q <= NP; q++) rw[q] = pr[q];
#pragma unroll
    for (int q = 0; q < NP; q++) cw[q] = pc[-q];
    auto advance = [&](int tau) {  // the codes of trip tau + 1
#pragma unroll
        for (int q = 0; q < NP; q++) rw[q] = rw[q + 1];
        rw[NP] = pr[tau + NP + 1];
#pragma unroll
        for (int q = NP - 1; q > 0; q--) cw[q] = cw[q - 1];
        cw[0] = pc[tau + 1];
    };

    const int nb = min(NB, hi);
    int tau = 0;
#pragma unroll 1
    for (; tau < nb; tau++) {  // the borders' trips
        wide_trip<NP, SEG, true>(s, 2 * tau + 1, rw, cw, t, ka, x, o, e);
        if (tau == cap) take();
        advance(tau);
    }
    // up to the warp's first destination past the borders: no capture
    const int end = max(nb, min(lo, hi));
#pragma unroll 1
    for (; tau + kWideUnroll <= end; tau += kWideUnroll) {
#pragma unroll
        for (int u = 0; u < kWideUnroll; u++) {
            wide_trip<NP, SEG, false>(s, 0, rw, cw, t, ka, x, o, e);
            advance(tau + u);
        }
    }
#pragma unroll 1
    for (; tau < hi; tau++) {  // the destinations' trips
        wide_trip<NP, SEG, false>(s, 0, rw, cw, t, ka, x, o, e);
        if (tau == cap) take();
        advance(tau);
    }

    if (!live) return;
    const int closed = mn == 0 ? 0 : (m == 0 ? o + (mn - 1) * e : kInf);
    if (in_band ? owner : t == 0) pen_out[p] = min(closed, hit);
}

template <int BW, int W>
cudaError_t launch_wide(const void* rp, const void* fp, const void* rl,
                        const void* fl, const Params& P, void* pen,
                        cudaStream_t s) {
    constexpr int threads = wide_threads(BW, 32 * W);
    constexpr int smem = wide_smem(BW, 32 * W, threads);
    constexpr int PPB = (threads / 32) * (32 / wide_seg(BW, 32 * W));
    static const cudaError_t prepared = cudaFuncSetAttribute(
        band_wide_kernel<BW, W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (prepared != cudaSuccess) return prepared;
    const int blocks = (P.B + PPB - 1) / PPB;
    band_wide_kernel<BW, W><<<blocks, threads, smem, s>>>(
        (const uint32_t*)rp, (const uint32_t*)fp, (const int*)rl,
        (const int*)fl, P, (int*)pen);
    return cudaGetLastError();
}

template <int BW, int W>
cudaError_t launch(const void* rp, const void* fp, const void* rl,
                   const void* fl, const Params& P, void* pen,
                   cudaStream_t s) {
    constexpr int threads = block_threads(BW, 32 * W);
    constexpr int PPB = (threads / 32) * (64 / BW);
    const int blocks = (P.B + PPB - 1) / PPB;
    band_kernel<BW, W><<<blocks, threads, 0, s>>>(
        (const uint32_t*)rp, (const uint32_t*)fp, (const int*)rl,
        (const int*)fl, P, (int*)pen);
    return cudaGetLastError();
}

template <int W>
cudaError_t dispatch(int bw, const void* rp, const void* fp, const void* rl,
                     const void* fl, const Params& P, void* pen,
                     cudaStream_t s) {
    if constexpr (W > kShortW) {
        switch (bw) {
            case 4: return launch_wide<4, W>(rp, fp, rl, fl, P, pen, s);
            case 8: return launch_wide<8, W>(rp, fp, rl, fl, P, pen, s);
            case 16: return launch_wide<16, W>(rp, fp, rl, fl, P, pen, s);
            case 32: return launch_wide<32, W>(rp, fp, rl, fl, P, pen, s);
            case 64: return launch_wide<64, W>(rp, fp, rl, fl, P, pen, s);
            case 128: return launch_wide<128, W>(rp, fp, rl, fl, P, pen, s);
            default: return cudaErrorInvalidValue;
        }
    } else {
    switch (bw) {
        case 4: return launch<4, W>(rp, fp, rl, fl, P, pen, s);
        case 8: return launch<8, W>(rp, fp, rl, fl, P, pen, s);
        case 16: return launch<16, W>(rp, fp, rl, fl, P, pen, s);
        case 32: return launch<32, W>(rp, fp, rl, fl, P, pen, s);
        case 64: return launch<64, W>(rp, fp, rl, fl, P, pen, s);
        case 128: return launch_wide<128, W>(rp, fp, rl, fl, P, pen, s);
        default: return cudaErrorInvalidValue;
    }
    }
}

// resident warps per SM of the wide path's instantiation (BW, W), with
// the shared memory its launch uses
template <int BW, int W>
cudaError_t wide_occupancy(int* warps) {
    constexpr int threads = wide_threads(BW, 32 * W);
    constexpr int smem = wide_smem(BW, 32 * W, threads);
    cudaError_t err = cudaFuncSetAttribute(
        band_wide_kernel<BW, W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, band_wide_kernel<BW, W>, threads, smem);
    *warps = blocks * threads / 32;
    return err;
}

// the wide path's occupancy at (bw, W): every BW above kShortW, BW 128 at
// and below it
template <int W>
cudaError_t occupancy_of(int bw, int* warps) {
    if constexpr (W > kShortW) {
        switch (bw) {
            case 4: return wide_occupancy<4, W>(warps);
            case 8: return wide_occupancy<8, W>(warps);
            case 16: return wide_occupancy<16, W>(warps);
            case 32: return wide_occupancy<32, W>(warps);
            case 64: return wide_occupancy<64, W>(warps);
            case 128: return wide_occupancy<128, W>(warps);
            default: return cudaErrorInvalidValue;
        }
    } else {
        return bw == 128 ? wide_occupancy<128, W>(warps) : cudaErrorInvalidValue;
    }
}

// ---- staging: int8 codes -> the band kernels' 2-bit planes ----
// Replaces no TPU kernel: the JAX entry packs planes in XLA
// (asm_tpu.encoding.pack_planes_t), which the port ran as a chain of
// int64 ATen ops in every band pass. Codes [B, L] (row-major) become
// position-major planes [2W, B] of 32-bit words, W = L/32: row w holds
// bit 0 of positions 32w..32w+31, row W + w bit 1 (the host's
// asm_stage_planes_t, native/src/hostmem.cpp); codes above 3 keep their
// low two bits (the band kernels read no position past a length).
//
// What bounds it: bytes. A side reads L bytes a pair and writes L/4; at
// the issue limit a word's ~90 integer instructions for its 32 codes take
// under a quarter of the time its 40 bytes take. One thread per (pair,
// word), the pairs fastest across a block (grid: pair blocks x W words x
// 2 sides), so each plane row's stores are 128 B a warp; a thread reads
// its word's 32 code bytes as two 16-byte loads, one whole sector, and
// every sector of the codes is read once; the bits are gathered by the
// host's carry-free multiply.
constexpr int kStageThreads = 256;

__global__ void __launch_bounds__(kStageThreads)
stage_kernel(const int8_t* __restrict__ read, const int8_t* __restrict__ ref,
             int B, int W, uint32_t* __restrict__ out) {
    const int64_t i = (int64_t)blockIdx.x * kStageThreads + threadIdx.x;
    if (i >= B) return;
    const int64_t w = blockIdx.y;
    const int8_t* codes = blockIdx.z ? ref : read;
    const uint4* s = reinterpret_cast<const uint4*>(codes + (i * W + w) * 32);
    const uint4 lo = __ldg(s), hi = __ldg(s + 1);
    const uint32_t v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    uint32_t p0 = 0, p1 = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) {  // byte b of v[j]: position 4j + b
        p0 |= (((v[j] & 0x01010101u) * 0x01020408u) >> 24) << (4 * j);
        p1 |= ((((v[j] >> 1) & 0x01010101u) * 0x01020408u) >> 24) << (4 * j);
    }
    uint32_t* o = out + (int64_t)blockIdx.z * 2 * W * B;
    o[w * B + i] = p0;
    o[(W + w) * B + i] = p1;
}

}  // namespace

// rp/fp: position-major 2-bit planes uint32[2W, B] of reads and refs;
// rl/fl: int32[B]; pen: int32[B] out. Returns the launch's cudaError_t
// (0 on success); does not synchronise.
extern "C" int asm_nw_band_launch(const void* rp, const void* fp,
                                  const void* rl, const void* fl, int B,
                                  int bw, int W, int x, int o, int e,
                                  void* pen, int device, void* stream) {
    if (B <= 0) return 0;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const Params P{B, x, o, e};
    cudaStream_t s = (cudaStream_t)stream;
#ifdef ASM_SHAPE_W
    // a library built for one W outside the tuned table (kernels/shapes.py)
    if (W == ASM_SHAPE_W)
        return (int)dispatch<ASM_SHAPE_W>(bw, rp, fp, rl, fl, P, pen, s);
#else
    if (W == 4) return (int)dispatch<4>(bw, rp, fp, rl, fl, P, pen, s);
    if (W == 8) return (int)dispatch<8>(bw, rp, fp, rl, fl, P, pen, s);
    if (W == 16) return (int)dispatch<16>(bw, rp, fp, rl, fl, P, pen, s);
#endif
    return (int)cudaErrorInvalidValue;
}

// resident warps per SM of the wide path (band_wide_kernel) at (bw, W) on
// the current device; -cudaError on failure (cudaErrorInvalidValue for a
// (bw, W) the short path serves or a W that is not built)
extern "C" int asm_nw_band_occupancy(int bw, int W) {
    int warps = 0;
    cudaError_t err = cudaErrorInvalidValue;
#ifdef ASM_SHAPE_W
    if (W == ASM_SHAPE_W) err = occupancy_of<ASM_SHAPE_W>(bw, &warps);
#else
    if (W == 4) err = occupancy_of<4>(bw, &warps);
    if (W == 8) err = occupancy_of<8>(bw, &warps);
    if (W == 16) err = occupancy_of<16>(bw, &warps);
#endif
    return err == cudaSuccess ? warps : -(int)err;
}

// offset pairs a thread of the wide path (band_wide_kernel) holds at bw
// and W: the layout tools/longseq_sweep counts the loop by
extern "C" int asm_nw_band_wide_np(int bw, int W) { return wide_np(bw, 32 * W); }

// read/ref: int8 codes [B, 32W], row-major, 16-byte aligned; out:
// uint32[2, 2W, B], the planes of reads then of refs. Returns the
// launch's cudaError_t (0 on success); does not synchronise.
extern "C" int asm_nw_stage_planes(const void* read, const void* ref, int B,
                                   int W, void* out, int device,
                                   void* stream) {
    if (B <= 0) return 0;
    if (W <= 0 || W > 65535) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((B + kStageThreads - 1) / kStageThreads, W, 2);
    stage_kernel<<<grid, kStageThreads, 0, (cudaStream_t)stream>>>(
        (const int8_t*)read, (const int8_t*)ref, B, W, (uint32_t*)out);
    return (int)cudaGetLastError();
}
