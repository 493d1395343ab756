// GASMA greedy hurdle-matrix alignment, one pair per thread (sm_90a).
//
// Replaces the Pallas TPU kernel asm_tpu/kernels/greedy_pallas.py
// _greedy_kernel (wrapper greedy_align_pallas). Computes the whole walk
// per pair: unpack the 2-bit planes (or pack int8 codes), build the 2k+1
// hurdle lane rows by funnel shift + XOR/OR with validity from the
// lengths, denoise (flip_short_hurdles(1)), run the greedy highway loop
// with ctz/popcount word queries and the float32 significance heuristic,
// take the final leap and write one packed step record per step.
//
// Layout. The TPU kernel holds a pair's rows in 4 KB vector registers; a
// thread that held them in its own registers (orig and den: 2 x (2k+1) x W
// words, 56 at k = 3, L = 128) took 185 registers, and 8 warps fit on an
// SM. Here a block's state lives in dynamic shared memory with the thread
// index fastest: the rows as uint32[2][NL][W][NT] (word (r, li, w) of
// thread t at ((r * NL + li) * W + w) * NT + t, NT the block's threads),
// then the per-lane scalars sp, hlen, nsw and nhur as int32[4][NL][NT]. A
// warp's access touches 32 consecutive words in 32 banks whatever lane
// each thread indexes, so the chosen lane's row and scalars are read at a
// per-thread index (best_li, bil, dl_c + K) without bank conflicts and
// without select chains over the lanes. A thread reads and writes only
// its own column: no barrier, no shuffle. The highway update, the lane
// loop with the most live state, stays rolled (#pragma unroll 1):
// unrolled, ptxas hoists its shared loads across lanes and spilled at 96
// registers. Shared memory bounds residency: (2W + 4)(2k + 1) words a
// thread, 43,008 B a 128-thread block at k = 3, L = 128, so 5 blocks (20
// warps) per SM at 79 registers, no spills; 3 at L = 256. At L = 512 a
// thread holds 1,008 B (k = 3; 1,296 at k = 4), so a 128-thread block
// leaves one block, 4 warps, per SM; smaller blocks pack the SM finer,
// and the block's thread count is fixed per max_len in block_threads()
// (PERF.md: the L = 512 sweep of 128, 64 and 32). __launch_bounds__ asks
// for the blocks that fit (min_blocks), and the carveout prefers shared
// memory over L1.
//
// What bounds it on Hopper: integer issue. The step loop issues ~2,140
// SASS instructions a trip (one or two trips per pair at the headline's
// error rate, plus ~1,000 outside the loop) at ~24 T thread instructions/s,
// three quarters of the card's measured ~31.5 T; 168 of a trip's are on
// the popcount pipe (POPC, FLO, BREV: 24 per lane), and a warp runs until
// its slowest pair is done (1.06x the mean trips). Not memory: a pair
// reads 2 * L/4 bytes of planes and writes (T+1) records, both coalesced
// (thread t of tile i reads planes[i, w, t]; rec[it, pair]).
//
// Left for later: ordering the pairs by the trips they run, the long-row
// path's group of threads per pair with the lanes spread over it (below)
// at L <= 512, and fewer popcount-pipe instructions per query.
//
// Numerics: the heuristic match_sig*hlen + mismatch_sig*nhur +
// indel_sig*nsw hits exact ties (mismatch_sig == indel_sig), so the
// last ulp decides walks. It is evaluated with __fmul_rn/__fadd_rn in
// the reference's association order, ((a + b) + c), so no FMA
// contraction can change a rounding; the constants arrive as float32
// values rounded from the host's doubles. Tie-breaks of the two lane
// scans follow the reference exactly.
//
// Long rows (L > 512, W > kShortW = 16): greedy_long_kernel below, chosen
// by W at compile time, so the W <= 16 instantiations are the code they
// were. One pair a thread with its own copy of the rows in shared memory
// ((W + 4)(2k + 1) words) leaves 3 warps per SM at L = 2048. So a group
// of G threads (kGroup: the least power of two >= 2k + 1, at most 32; 8
// at k = 2-3) takes each pair and shares one copy of its 2k+1 hurdle rows
// in shared memory, and thread g owns lanes g * LPT .. g * LPT + LPT - 1
// (LPT = 1 up to k = 15): it builds their rows from the planes (all the
// group's threads read the same plane words) and keeps their sp, hlen, nsw
// and nhur in registers. The lane loops run on the group's threads at
// once: each thread's highway search and popcount windows read its own
// lane's row word by word from the word that holds their start, so a
// query costs the words it needs and not W. The two scans across lanes
// keep their results: the selection scan's first lane of the largest (h,
// lh) (its strict >) is found by three group reductions over an
// order-preserving int of h; _choose_best_highway's filter depends on lane
// order, so each thread computes its lanes' totals (the cross popcount on
// the chosen lane's row) and every thread then runs the filter in lane
// order on values shuffled from their owners. The float heuristic is the
// short path's, in ((a + b) + c) order. Rows lie W | 1 words apart (lanes
// at one word fall in other banks); shared memory, (2k + 1)(W | 1) words a
// pair, sets the residency, and a warp waits for its 32 / G pairs. Rows
// held in registers instead, a slice of words of every row on each of 16-
// 32 threads a pair, make every query run over every word of every row on
// every thread: ~30x the instructions a step of one pair a thread, and
// slower than it (PERF.md).
//
// Shapes: k in {2, 3, 4} x L in {128, 256, 512} are built together (the
// tuned table); any other (k, L), L > 512 too, is built at its first use
// into a library of its own (block_threads below). k is capped at 31 by
// the records' 7-bit lane delta and by shared memory.
//
// Records (int16 when L <= 255, else int32): bit 0 final-leap flag, bits
// 1-7 the in-loop lane delta + 64, bits 8+ the match advance. The pair's
// loop exits on its own, so its final-leap record sits at its own trip
// count; every later row is written 0.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr uint32_t kFull = 0xFFFFFFFFu;
constexpr int kMinRegs = 96;  // registers per thread min_blocks leaves

// threads per block (one pair each) at W words per row: 128 at L = 128 and
// 256; at L = 512 the fastest of 128, 64 and 32 on the card. A library
// built for one shape outside that table (kernels/shapes.py: -D
// ASM_SHAPE_K, ASM_SHAPE_W, ASM_SHAPE_THREADS) takes the largest of 128,
// 64 and 32 whose shared memory fits a block; on the long-row path
// likewise, a group of kGroup threads a pair.
__host__ __device__ constexpr int block_threads(int W) {
#ifdef ASM_SHAPE_THREADS
    return ASM_SHAPE_THREADS;
#else
    return W == 16 ? 32 : 128;
#endif
}

// rows of more words than this take the long-row path (below)
constexpr int kShortW = 16;

// a block's shared memory: per lane, W orig and W den words and 4
// scalars, per thread
template <int K, int W>
constexpr size_t smem_bytes() {
    return sizeof(uint32_t) * (2 * W + 4) * (2 * K + 1) * block_threads(W);
}

// the blocks per SM that __launch_bounds__ asks for: as many as fit in the
// SM's 228 KB of shared memory (1 KB of it reserved per block; 5 at k = 3,
// L = 128, 3 at L = 256), at most as many as leave kMinRegs registers per
// thread (5 blocks of 128 threads)
template <int K, int W>
constexpr int min_blocks() {
    const int fit = (int)((228 * 1024) / (smem_bytes<K, W>() + 1024));
    const int regs = 65536 / (kMinRegs * block_threads(W));
    return fit < regs ? fit : regs;
}

__device__ __forceinline__ uint32_t mask_ge(int c, int w) {
    int low = c - 32 * w;
    low = low < 0 ? 0 : (low > 32 ? 32 : low);
    return low >= 32 ? 0u : (kFull << low);
}

// trailing zeros; 32 for a zero word
__device__ __forceinline__ int ctz32(uint32_t v) { return __clz(__brev(v)); }

__device__ __forceinline__ int iabs(int v) { return v < 0 ? -v : v; }

// switch_forward_column (GASMA/utils.h:587-593)
__device__ __forceinline__ int sfc(int l1, int l2) {
    const int a1 = iabs(l1), a2 = iabs(l2);
    return (l1 * l2 >= 0) ? max(a1 - a2, 0) : a1;
}

// switch_lane_penalty (GASMA/utils.h:576-579)
__device__ __forceinline__ int slp(int l1, int l2, int o, int e) {
    const int d = iabs(l1 - l2);
    return d == 0 ? 0 : o + e * (d - 1);
}

// popcount of positions in [lo, hi); empty or inverted windows count 0
template <int W>
__device__ __forceinline__ int count_range(const uint32_t (&words)[W], int lo,
                                           int hi) {
    int cnt = 0;
#pragma unroll
    for (int w = 0; w < W; w++)
        cnt += __popc(words[w] & mask_ge(lo, w) & ~mask_ge(hi, w));
    return cnt;
}

// the W words of a row of this thread's column (stride NT)
template <int W>
__device__ __forceinline__ void load_row(const uint32_t* row,
                                         uint32_t (&words)[W]) {
#pragma unroll
    for (int w = 0; w < W; w++) words[w] = row[w * block_threads(W)];
}

// bit p of the result = bit p + s of the row (shift toward position 0)
template <int W>
__device__ __forceinline__ uint32_t funnel(const uint32_t (&words)[W], int s,
                                           int w) {
    if (s == 0) return words[w];
    const uint32_t hi = (w + 1 < W) ? (words[w + 1] << (32 - s)) : 0u;
    return (words[w] >> s) | hi;
}

// int8 codes [B, L] as uint32 words -> two bit-planes: bit p of word w is
// bit 0 (or 1) of the code at 32w + p. The carry-free multiply by
// 0x01020408 gathers the four byte bits of a word at bits 24..27.
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

struct Params {
    int B, tile, T, x, o, e, is_global;
    float match_sig, mismatch_sig, indel_sig;
};

template <int K, int W, bool kPlanes, typename RecT>
__global__ void __launch_bounds__(block_threads(W), (min_blocks<K, W>()))
greedy_kernel(const uint32_t* __restrict__ rc, const uint32_t* __restrict__ fc,
              const int* __restrict__ rl, const int* __restrict__ fl,
              const Params P, int* __restrict__ cost_out,
              int* __restrict__ steps_out, RecT* __restrict__ rec) {
    constexpr int NL = 2 * K + 1;
    constexpr int L = 32 * W;
    constexpr int NT = block_threads(W);
    const int64_t p = (int64_t)blockIdx.x * NT + threadIdx.x;
    if (p >= P.B) return;
    const int64_t B = P.B;
    const int x = P.x, o = P.o, e = P.e;
    const int m = min(rl[p], L);
    const int n = min(fl[p], L);
    extern __shared__ __align__(16) uint32_t g_state[];
    // this thread's column: orig row li at orig + li * W * NT, den
    // row li at den + li * W * NT, word w at w * NT
    uint32_t* const orig = g_state + threadIdx.x;
    uint32_t* const den = orig + NL * W * NT;

    {
        // ---- the pair's bit-planes ----
        uint32_t r0[W], r1[W], f0[W], f1[W];
        if constexpr (kPlanes) {
            // tile-major planes [NBT, 2W, tile]: row w plane 0, row W+w
            // plane 1
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

        // ---- hurdle rows (_construct_hurdles, hurdle_matrix.h:441-455) ----
        // lane < 0 shifts the read by -lane, lane > 0 the ref by lane; a
        // position is a hurdle where either plane differs or either shifted
        // position lies past its length (closed form: mask_ge(len - shift));
        // denoise: flip_short_hurdles(1) keeps a hurdle with a neighbour
#pragma unroll
        for (int li = 0; li < NL; li++) {
            const int lane = li - K;
            const int a_off = lane < 0 ? -lane : 0;
            const int b_off = lane > 0 ? lane : 0;
            uint32_t h[W];
#pragma unroll
            for (int w = 0; w < W; w++) {
                h[w] = (funnel<W>(r0, a_off, w) ^ funnel<W>(f0, b_off, w)) |
                       (funnel<W>(r1, a_off, w) ^ funnel<W>(f1, b_off, w)) |
                       mask_ge(m - a_off, w) | mask_ge(n - b_off, w);
            }
#pragma unroll
            for (int w = 0; w < W; w++) {
                const uint32_t lo_prev = w > 0 ? h[w - 1] >> 31 : 0u;
                const uint32_t hi_next = w < W - 1 ? h[w + 1] << 31 : 0u;
                orig[(li * W + w) * NT] = h[w];
                den[(li * W + w) * NT] =
                    h[w] & (((h[w] << 1) | lo_prev) | ((h[w] >> 1) | hi_next));
            }
        }
    }

    const int dest_lane = n - m;
    const bool in_band = iabs(dest_lane) <= K;
    // ---- per-lane destinations (_calculate_destination, :58-68) ----
    auto dest_of = [m, n](int lane) {
        const int dest_ge = lane > 0 ? n - lane : (lane >= n - m ? n : m + lane);
        const int dest_lt = lane < 0 ? m + lane : (lane <= n - m ? m : n - lane);
        return m >= n ? dest_ge : dest_lt;
    };
    // the per-lane scalars, after the rows, lane li at li * NT
    int* const sp = (int*)(den + NL * W * NT);
    int* const hlen = sp + NL * NT;
    int* const nsw = hlen + NL * NT;
    int* const nhur = nsw + NL * NT;

    int cur_lane = 0, cur_col = 0, cost = 0, steps = 0;
    bool done = false;
#pragma unroll
    for (int li = 0; li < NL; li++) {
        sp[li * NT] = -1;
        hlen[li * NT] = 0;
        nsw[li * NT] = L;
    }

    int it = 0;
    while (it < P.T && !done) {
        auto swc_of = [&](int li) {
            return (P.is_global || it > 0) ? slp(cur_lane, li - K, o, e) : 0;
        };
        // ---- _update_highway_list (hurdle_matrix.h:285-362) ----
        // rolled (see the header); each lane's nhur window follows its
        // highway's update
        bool reaching = false;
#pragma unroll 1
        for (int li = 0; li < NL; li++) {
            const int lane = li - K;
            const int s = cur_col + sfc(cur_lane, lane);
            uint32_t u[W];
            load_row<W>(den + li * W * NT, u);
#pragma unroll
            for (int w = 0; w < W; w++) u[w] |= ~mask_ge(s, w);
            int fz = L;
#pragma unroll
            for (int w = 0; w < W; w++) {
                const uint32_t nu = ~u[w];
                fz = min(fz, nu == 0u ? L : 32 * w + ctz32(nu));
            }
            uint32_t carry = 1u;
            int no_g = L;
#pragma unroll
            for (int w = 0; w < W; w++) {
                const uint32_t s_w = u[w] + carry;
                carry = carry & (s_w == 0u ? 1u : 0u);
                const uint32_t v_w = u[w] & s_w;
                no_g = min(no_g, v_w == 0u ? L : 32 * w + ctz32(v_w));
            }
            const int d = dest_of(lane);
            const int sp_new = s > L ? s : fz;
            const int raw_len = (sp_new >= L || no_g >= L) ? L : no_g - sp_new;
            const bool clamp = sp_new + raw_len > d;
            const int len_new = clamp ? max(d - sp_new, 0) : raw_len;
            int spv = sp[li * NT], hl = hlen[li * NT];
            if (spv < s) {
                spv = sp_new;
                hl = len_new;
                sp[li * NT] = spv;
                hlen[li * NT] = hl;
                nsw[li * NT] = iabs(lane - cur_lane);
                reaching = reaching || clamp;
            }
            uint32_t h[W];
            load_row<W>(orig + li * W * NT, h);
            nhur[li * NT] = count_range<W>(h, s, spv + hl);
        }

        // ---- selection scan (hurdle_matrix.h:325-352) ----
        float best_h = __int_as_float(0xff800000);  // -inf
        int best_lh = -2147483647 - 1;
        int best_li = 0;
#pragma unroll
        for (int li = 0; li < NL; li++) {
            const int lane = li - K;
            const int hl = hlen[li * NT], nh = nhur[li * NT];
            const int swc = swc_of(li);
            const float sig = __fadd_rn(
                __fadd_rn(__fmul_rn(P.match_sig, __int2float_rn(hl)),
                          __fmul_rn(P.mismatch_sig, __int2float_rn(nh))),
                __fmul_rn(P.indel_sig, __int2float_rn(nsw[li * NT])));
            const int fsc = P.is_global ? slp(lane, dest_lane, o, e) : 0;
            const float h_reach = __int2float_rn(
                -(swc + x * nh) - fsc -
                x * (dest_of(lane) - sp[li * NT] - hl));
            const float h = reaching ? h_reach : sig;
            const int lh = -swc - (reaching ? fsc : 0);
            if (h > best_h || (h == best_h && lh > best_lh)) {
                best_h = h;
                best_lh = lh;
                best_li = li;
            }
        }

        // the chosen lane's scalars and row, read at the index best_li
        const int best_len = hlen[best_li * NT];
        const int sp_b = sp[best_li * NT];
        int stc = swc_of(best_li) + x * nhur[best_li * NT];
        uint32_t row_b[W];
        load_row<W>(orig + best_li * W * NT, row_b);
        const bool valid = best_len > 0;  // else: stop without a step

        // ---- _choose_best_highway (hurdle_matrix.h:368-401) ----
        const int best_lane = best_li - K;
        int sic = stc;
        int bil = best_li;
#pragma unroll
        for (int li = 0; li < NL; li++) {
            const int lane = li - K;
            const int spv = sp[li * NT];
            const int fwd_lb = sfc(lane, best_lane);
            const bool skip = (li == best_li) || (spv + fwd_lb > sp_b);
            // the RAW popcount (hurdle_matrix.h:389), nhur's window
            const int ic = swc_of(li) + nhur[li * NT];
            const int cross = count_range<W>(
                row_b, fwd_lb + spv + hlen[li * NT], sp_b);
            const int tc = ic + slp(lane, best_lane, o, e) + max(0, x * cross);
            if (!skip && tc <= stc && ic <= sic) {
                stc = tc;
                sic = ic;
                bil = li;
            }
        }

        // ---- commit the step (_step, hurdle_matrix.h:407-434) ----
        const int bl_lane = bil - K;
        int packed = 0;
        if (valid) {
            const int sp_c = sp[bil * NT], len_c = hlen[bil * NT];
            cost += swc_of(bil) + x * nhur[bil * NT];
            const int distance = sp_c + len_c - (cur_col + sfc(cur_lane, bl_lane));
            packed = (((bl_lane - cur_lane) + 64) << 1) | (distance << 8);
            cur_lane = bl_lane;
            cur_col = sp_c + len_c;
            steps += 1;
            done = cur_col >= dest_of(bl_lane);
        } else {
            done = true;
        }
        rec[(int64_t)it * B + p] = (RecT)packed;
        it += 1;
    }

    // ---- final leap (run(), hurdle_matrix.h:574-590) ----
    const int dl_c = min(max(dest_lane, -K), K);
    const int dest_col = dest_of(dl_c);
    uint32_t row_dl[W];
    load_row<W>(orig + (dl_c + K) * W * NT, row_dl);
    const int lo = cur_col + sfc(cur_lane, dest_lane);
    const int distance = in_band ? count_range<W>(row_dl, lo, dest_col) : 0;
    const bool moved_off = cur_lane != dest_lane;
    const bool needs = in_band ? (moved_off || cur_col < dest_col) : moved_off;
    if (needs) {
        const int sc_pen = P.is_global ? slp(cur_lane, dest_lane, o, e) : 0;
        cost += sc_pen + max(0, x * distance);
    }
    // the final leap's lane delta spans +-(L+k) and is not stored: the
    // expansion rebuilds it as dest_lane - sum(in-loop deltas)
    rec[(int64_t)it * B + p] = (RecT)(needs ? 1 | (max(distance, 0) << 8) : 0);
    for (int r = it + 1; r <= P.T; r++) rec[(int64_t)r * B + p] = (RecT)0;
    cost_out[p] = cost;
    steps_out[p] = steps;
}

// ---- the long-row path (W > kShortW): a group of threads per pair ----

// threads per pair on the long-row path (kernels/shapes.py long_group).
// Every long shape is built per shape with it; the tuned table (W <= 16)
// builds no long instantiation, and greedy_long_kernel refuses to build
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

// words between a pair's rows in shared memory: odd, so the group's lanes
// at one word index fall in different banks
__host__ __device__ constexpr int row_stride(int W) { return W | 1; }

// the long path's shared memory: each of the block's pairs' 2k+1 rows
template <int K, int W>
constexpr size_t long_smem_bytes() {
    return sizeof(uint32_t) * (2 * K + 1) * row_stride(W) *
           (block_threads(W) / kGroup);
}

// word w of a pair's two code planes (0 past the row): tile-major planes
// [NBT, 2W, tile] at base, or int8 codes [B, 32W] packed from the row's 8
// words at 8w
template <int W, bool kPlanes>
__device__ __forceinline__ void plane_word(const uint32_t* __restrict__ c,
                                           int64_t base, int64_t tile, int w,
                                           uint32_t& p0, uint32_t& p1) {
    p0 = p1 = 0u;
    if (w >= W) return;
    if constexpr (kPlanes) {
        p0 = c[base + w * tile];
        p1 = c[base + (W + w) * tile];
    } else {
#pragma unroll
        for (int jj = 0; jj < 8; jj++) {
            const uint32_t v = c[base + 8 * w + jj];
            p0 |= (((v & 0x01010101u) * 0x01020408u) >> 24) << (4 * jj);
            p1 |= ((((v >> 1) & 0x01010101u) * 0x01020408u) >> 24) << (4 * jj);
        }
    }
}

// popcount of positions [lo, hi) of a row (word w at row[w])
template <int W>
__device__ __forceinline__ int count_rows(const uint32_t* row, int lo,
                                          int hi) {
    lo = max(lo, 0);
    hi = min(hi, 32 * W);
    int cnt = 0;
#pragma unroll 1
    for (int w = lo >> 5; w < ((hi + 31) >> 5); w++)
        cnt += __popc(row[w] & mask_ge(lo, w) & ~mask_ge(hi, w));
    return cnt;
}

// word w of the denoised row (flip_short_hurdles(1): a hurdle stays when
// a neighbour is one) from row words w - 1, w and w + 1
__device__ __forceinline__ uint32_t denoise(uint32_t prev, uint32_t cur,
                                            uint32_t next) {
    return cur & (((cur << 1) | (prev >> 31)) | ((cur >> 1) | (next << 31)));
}

// the highway search on the denoised hurdle row `row` (word w at row[w])
// from s: fz, the first gap (zero) at or past s, and no_g, the first
// hurdle past fz (L where there is none); the short path's carry-add,
// word by word from the word that holds s
template <int W>
__device__ __forceinline__ void gap_rows(const uint32_t* row, int s, int& fz,
                                         int& no_g) {
    constexpr int L = 32 * W;
    fz = L;
    no_g = L;
    const int w0 = s >> 5;
    if (w0 >= W) return;
    uint32_t prev = w0 > 0 ? row[w0 - 1] : 0u, cur = row[w0];
#pragma unroll 1
    for (int w = w0; w < W; w++) {
        const uint32_t next = w + 1 < W ? row[w + 1] : 0u;
        const uint32_t u = denoise(prev, cur, next) | ~mask_ge(s, w);
        prev = cur;
        cur = next;
        uint32_t v = u;
        if (fz == L) {
            const uint32_t nu = ~u;
            if (nu == 0u) continue;
            const int b = ctz32(nu);
            fz = 32 * w + b;
            v = b == 31 ? 0u : u & (kFull << (b + 1));
        }
        if (v) {
            no_g = 32 * w + ctz32(v);
            break;
        }
    }
}

// value v[r] of the lane li this thread owns as its lane r (g * LPT + r ==
// li), 0 elsewhere: what a thread sends when li's owner is asked for it
template <int LPT>
__device__ __forceinline__ int of_lane(const int (&v)[LPT], int g, int li) {
    int out = 0;
#pragma unroll
    for (int r = 0; r < LPT; r++)
        if (g * LPT + r == li) out = v[r];
    return out;
}

// an int whose order is the float's (-0 first made +0)
__device__ __forceinline__ int float_key(float h) {
    const int i = __float_as_int(__fadd_rn(h, 0.0f));
    return i < 0 ? i ^ 0x7FFFFFFF : i;
}

// The walk of greedy_kernel for rows of W > kShortW words, G = kGroup
// threads a pair (the header's "Long rows"). Outputs as greedy_kernel's.
template <int K, int W, bool kPlanes, typename RecT>
__global__ void __launch_bounds__(block_threads(W))
greedy_long_kernel(const uint32_t* __restrict__ rc,
                   const uint32_t* __restrict__ fc,
                   const int* __restrict__ rl, const int* __restrict__ fl,
                   const Params P, int* __restrict__ cost_out,
                   int* __restrict__ steps_out, RecT* __restrict__ rec) {
    constexpr int NL = 2 * K + 1;
    constexpr int L = 32 * W;
    constexpr int G = kGroup, NT = block_threads(W), PB = NT / G;
    constexpr int LPT = (NL + G - 1) / G;  // lanes a thread owns
    constexpr int RS = row_stride(W);
    constexpr int kNone = 2147483647;
    static_assert(kGroupSet || W <= kShortW,
                  "a long-row instantiation needs -D ASM_SHAPE_GROUP");
    static_assert(K < 32, "a lane's shift stays within one word");
    static_assert(NT % G == 0 && 32 % G == 0, "whole groups in a warp");
    extern __shared__ __align__(16) uint32_t g_rows[];
    const int q = threadIdx.x / G, g = threadIdx.x % G;
    const int64_t p = (int64_t)blockIdx.x * PB + q;
    if (p >= P.B) return;  // a group leaves whole; no block barrier follows
    const unsigned gm = group_mask<G>();
    const int64_t B = P.B;
    const int x = P.x, o = P.o, e = P.e;
    const int m = min(rl[p], L);
    const int n = min(fl[p], L);
    // the pair's rows, lane li's word w at rows[li * RS + w]
    uint32_t* const rows = g_rows + q * (NL * RS);

    // ---- hurdle rows (_construct_hurdles): each thread its own lanes,
    // word w from plane words w and w + 1 ----
    {
        const int64_t tile = P.tile;
        const int64_t base =
            kPlanes ? (p / tile) * (2 * W) * tile + (p % tile) : p * (L / 4);
        uint32_t r0, r1, f0, f1;
        plane_word<W, kPlanes>(rc, base, tile, 0, r0, r1);
        plane_word<W, kPlanes>(fc, base, tile, 0, f0, f1);
#pragma unroll 1
        for (int w = 0; w < W; w++) {
            uint32_t r0n, r1n, f0n, f1n;
            plane_word<W, kPlanes>(rc, base, tile, w + 1, r0n, r1n);
            plane_word<W, kPlanes>(fc, base, tile, w + 1, f0n, f1n);
#pragma unroll
            for (int r = 0; r < LPT; r++) {
                const int li = g * LPT + r;
                if (li >= NL) continue;
                const int lane = li - K;
                const int a_off = lane < 0 ? -lane : 0;
                const int b_off = lane > 0 ? lane : 0;
                rows[li * RS + w] =
                    (__funnelshift_r(r0, r0n, a_off) ^
                     __funnelshift_r(f0, f0n, b_off)) |
                    (__funnelshift_r(r1, r1n, a_off) ^
                     __funnelshift_r(f1, f1n, b_off)) |
                    mask_ge(m - a_off, w) | mask_ge(n - b_off, w);
            }
            r0 = r0n;
            r1 = r1n;
            f0 = f0n;
            f1 = f1n;
        }
    }
    __syncwarp(gm);  // every row, seen by the whole group

    const int dest_lane = n - m;
    const bool in_band = iabs(dest_lane) <= K;
    auto dest_of = [m, n](int lane) {
        const int dest_ge = lane > 0 ? n - lane : (lane >= n - m ? n : m + lane);
        const int dest_lt = lane < 0 ? m + lane : (lane <= n - m ? m : n - lane);
        return m >= n ? dest_ge : dest_lt;
    };
    // this thread's lanes' scalars (lane g * LPT + r)
    int sp[LPT], hlen[LPT], nsw[LPT], nhur[LPT];
#pragma unroll
    for (int r = 0; r < LPT; r++) {
        sp[r] = -1;
        hlen[r] = 0;
        nsw[r] = L;
        nhur[r] = 0;
    }

    int cur_lane = 0, cur_col = 0, cost = 0, steps = 0;
    bool done = false;
    int it = 0;
    while (it < P.T && !done) {
        auto swc_of = [&](int li) {
            return (P.is_global || it > 0) ? slp(cur_lane, li - K, o, e) : 0;
        };
        // ---- _update_highway_list (hurdle_matrix.h:285-362), own lanes ----
        bool reach_mine = false;
#pragma unroll
        for (int r = 0; r < LPT; r++) {
            const int li = g * LPT + r;
            if (li >= NL) continue;
            const int lane = li - K;
            const int s = cur_col + sfc(cur_lane, lane);
            int fz, no_g;
            gap_rows<W>(rows + li * RS, s, fz, no_g);
            const int d = dest_of(lane);
            const int sp_new = s > L ? s : fz;
            const int raw_len = (sp_new >= L || no_g >= L) ? L : no_g - sp_new;
            const bool clamp = sp_new + raw_len > d;
            const int len_new = clamp ? max(d - sp_new, 0) : raw_len;
            if (sp[r] < s) {
                sp[r] = sp_new;
                hlen[r] = len_new;
                nsw[r] = iabs(lane - cur_lane);
                reach_mine = reach_mine || clamp;
            }
            nhur[r] = count_rows<W>(rows + li * RS, s, sp[r] + hlen[r]);
        }
        const bool reaching = __any_sync(gm, reach_mine);

        // ---- selection scan (hurdle_matrix.h:325-352): the first lane of
        // the largest (h, lh), as the scan's strict > keeps it ----
        int key_b = -2147483647 - 1, lh_b = -2147483647 - 1, li_b = kNone;
#pragma unroll
        for (int r = 0; r < LPT; r++) {
            const int li = g * LPT + r;
            if (li >= NL) continue;
            const int lane = li - K;
            const int hl = hlen[r], nh = nhur[r];
            const int swc = swc_of(li);
            const float sig = __fadd_rn(
                __fadd_rn(__fmul_rn(P.match_sig, __int2float_rn(hl)),
                          __fmul_rn(P.mismatch_sig, __int2float_rn(nh))),
                __fmul_rn(P.indel_sig, __int2float_rn(nsw[r])));
            const int fsc = P.is_global ? slp(lane, dest_lane, o, e) : 0;
            const float h_reach = __int2float_rn(
                -(swc + x * nh) - fsc - x * (dest_of(lane) - sp[r] - hl));
            const int key = float_key(reaching ? h_reach : sig);
            const int lh = -swc - (reaching ? fsc : 0);
            if (li_b == kNone || key > key_b || (key == key_b && lh > lh_b)) {
                key_b = key;
                lh_b = lh;
                li_b = li;
            }
        }
        const int key_max = __reduce_max_sync(gm, key_b);
        const int lh_max =
            __reduce_max_sync(gm, key_b == key_max ? lh_b : -2147483647 - 1);
        const int best_li = __reduce_min_sync(
            gm, key_b == key_max && lh_b == lh_max ? li_b : kNone);
        const int owner_b = best_li / LPT;
        const int best_len = __shfl_sync(gm, of_lane(hlen, g, best_li), owner_b, G);
        const int sp_b = __shfl_sync(gm, of_lane(sp, g, best_li), owner_b, G);
        const int nh_b = __shfl_sync(gm, of_lane(nhur, g, best_li), owner_b, G);
        int stc = swc_of(best_li) + x * nh_b;
        const bool valid = best_len > 0;  // else: stop without a step

        // ---- _choose_best_highway (hurdle_matrix.h:368-401): each thread
        // its lanes' totals, then the scan in lane order on every thread ----
        const int best_lane = best_li - K;
        int tcv[LPT], icv[LPT];
#pragma unroll
        for (int r = 0; r < LPT; r++) {
            const int li = g * LPT + r;
            const int lane = li - K;
            const int fwd_lb = sfc(lane, best_lane);
            tcv[r] = kNone;  // skipped: never taken
            icv[r] = 0;
            if (li >= NL || li == best_li || sp[r] + fwd_lb > sp_b) continue;
            // the RAW popcount (hurdle_matrix.h:389), nhur's window
            icv[r] = swc_of(li) + nhur[r];
            const int cross = count_rows<W>(rows + best_li * RS,
                                            fwd_lb + sp[r] + hlen[r], sp_b);
            tcv[r] = icv[r] + slp(lane, best_lane, o, e) + max(0, x * cross);
        }
        int sic = stc;
        int bil = best_li;
#pragma unroll
        for (int li = 0; li < NL; li++) {
            const int tc = __shfl_sync(gm, tcv[li % LPT], li / LPT, G);
            const int ic = __shfl_sync(gm, icv[li % LPT], li / LPT, G);
            if (tc != kNone && tc <= stc && ic <= sic) {
                stc = tc;
                sic = ic;
                bil = li;
            }
        }

        // ---- commit the step (_step, hurdle_matrix.h:407-434) ----
        const int owner_c = bil / LPT;
        const int sp_c = __shfl_sync(gm, of_lane(sp, g, bil), owner_c, G);
        const int len_c = __shfl_sync(gm, of_lane(hlen, g, bil), owner_c, G);
        const int nh_c = __shfl_sync(gm, of_lane(nhur, g, bil), owner_c, G);
        const int bl_lane = bil - K;
        int packed = 0;
        if (valid) {
            cost += swc_of(bil) + x * nh_c;
            const int distance =
                sp_c + len_c - (cur_col + sfc(cur_lane, bl_lane));
            packed = (((bl_lane - cur_lane) + 64) << 1) | (distance << 8);
            cur_lane = bl_lane;
            cur_col = sp_c + len_c;
            steps += 1;
            done = cur_col >= dest_of(bl_lane);
        } else {
            done = true;
        }
        if (g == 0) rec[(int64_t)it * B + p] = (RecT)packed;
        it += 1;
    }

    // the rows after the final leap, spread over the group
    for (int r = it + 1 + g; r <= P.T; r += G) rec[(int64_t)r * B + p] = (RecT)0;
    if (g != 0) return;
    // ---- final leap (run(), hurdle_matrix.h:574-590) ----
    const int dl_c = min(max(dest_lane, -K), K);
    const int dest_col = dest_of(dl_c);
    const int lo = cur_col + sfc(cur_lane, dest_lane);
    const int distance =
        in_band ? count_rows<W>(rows + (dl_c + K) * RS, lo, dest_col) : 0;
    const bool moved_off = cur_lane != dest_lane;
    const bool needs = in_band ? (moved_off || cur_col < dest_col) : moved_off;
    if (needs) {
        const int sc_pen = P.is_global ? slp(cur_lane, dest_lane, o, e) : 0;
        cost += sc_pen + max(0, x * distance);
    }
    rec[(int64_t)it * B + p] = (RecT)(needs ? 1 | (max(distance, 0) << 8) : 0);
    cost_out[p] = cost;
    steps_out[p] = steps;
}

// once per instantiation: room for the state above the 48 KB default, and
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
    void *cost, *steps, *rec;
    cudaStream_t stream;
};

// the kernel of (K, W): the long-row path's above kShortW words a row
template <int K, int W, bool kPlanes, typename RecT>
auto kernel_of() {
    if constexpr (W > kShortW)
        return greedy_long_kernel<K, W, kPlanes, RecT>;
    else
        return greedy_kernel<K, W, kPlanes, RecT>;
}

// launches the instantiation (a != nullptr) or, with a == nullptr, stores
// its resident warps per SM in *warps
template <int K, int W, bool kPlanes>
cudaError_t run(const Launch* a, int* warps) {
    using RecT = typename std::conditional<(32 * W <= 255 && 2 * K <= 62),
                                           int16_t, int32_t>::type;
    constexpr bool kLong = W > kShortW;
    constexpr size_t smem =
        kLong ? long_smem_bytes<K, W>() : smem_bytes<K, W>();
    const auto kernel = kernel_of<K, W, kPlanes, RecT>();
    static const cudaError_t attr = set_attributes(kernel, smem);
    if (attr != cudaSuccess) return attr;
    constexpr int NT = block_threads(W);
    // pairs per block: one a thread, one a group on the long path
    constexpr int PB = kLong ? NT / kGroup : NT;
    if (a == nullptr) {
        const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            warps, kernel, NT, smem);
        *warps = *warps * NT / 32;
        return err;
    }
    const int grid = (a->P.B + PB - 1) / PB;
    kernel<<<grid, NT, smem, a->stream>>>(
        (const uint32_t*)a->rc, (const uint32_t*)a->fc, (const int*)a->rl,
        (const int*)a->fl, a->P, (int*)a->cost, (int*)a->steps,
        (RecT*)a->rec);
    return cudaGetLastError();
}

#ifndef ASM_SHAPE_K
template <int W, bool kPlanes>
cudaError_t by_k(int k, const Launch* a, int* warps) {
    if (k == 2) return run<2, W, kPlanes>(a, warps);
    if (k == 3) return run<3, W, kPlanes>(a, warps);
    if (k == 4) return run<4, W, kPlanes>(a, warps);
    return cudaErrorInvalidValue;
}
#endif

#ifdef ASM_SHAPE_K
// the one shape this library is built for
template <bool kPlanes>
cudaError_t dispatch(int k, int W, const Launch* a, int* warps) {
    if (k == ASM_SHAPE_K && W == ASM_SHAPE_W)
        return run<ASM_SHAPE_K, ASM_SHAPE_W, kPlanes>(a, warps);
    return cudaErrorInvalidValue;
}
#else
// the tuned table: k in {2, 3, 4} x L in {128, 256, 512}
template <bool kPlanes>
cudaError_t dispatch(int k, int W, const Launch* a, int* warps) {
    if (W == 4) return by_k<4, kPlanes>(k, a, warps);
    if (W == 8) return by_k<8, kPlanes>(k, a, warps);
    if (W == 16) return by_k<16, kPlanes>(k, a, warps);
    return cudaErrorInvalidValue;
}
#endif

}  // namespace

// planes != 0: rc/fc are tile-major planes uint32[NBT, 2W, tile];
// planes == 0: rc/fc are int8 codes [B, 32W] (rows read as uint32 words).
// Outputs: cost/steps int32[B], rec [T+1, B] (int16 when 32W <= 255).
// Returns the launch's cudaError_t (0 on success); does not synchronise.
extern "C" int asm_greedy_launch(const void* rc, const void* fc,
                                 const void* rl, const void* fl, int B,
                                 int tile, int planes, int k, int W, int T,
                                 int x, int o, int e, int is_global,
                                 float match_sig, float mismatch_sig,
                                 float indel_sig, void* cost, void* steps,
                                 void* rec, int device, void* stream) {
    if (B <= 0) return 0;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const Launch a{rc,   fc,    rl,  fl, Params{B, tile, T, x, o, e, is_global,
                                                match_sig, mismatch_sig,
                                                indel_sig},
                   cost, steps, rec, (cudaStream_t)stream};
    err = planes ? dispatch<true>(k, W, &a, nullptr)
                 : dispatch<false>(k, W, &a, nullptr);
    return (int)err;
}

// Resident warps per SM of the (k, W, planes) instantiation on the
// current device, with the block size and shared memory its launch uses;
// a negative value is -cudaError_t.
extern "C" int asm_greedy_occupancy(int k, int W, int planes) {
    int warps = 0;
    const cudaError_t err = planes ? dispatch<true>(k, W, nullptr, &warps)
                                   : dispatch<false>(k, W, nullptr, &warps);
    return err != cudaSuccess ? -(int)err : warps;
}

// threads per block of the instantiations at W words per row
extern "C" int asm_greedy_block_threads(int W) { return block_threads(W); }
