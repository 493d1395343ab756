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
// What bounds it on Hopper: integer issue and warp divergence in the step
// loop, not memory (a pair reads 2 * L/4 bytes of planes and writes
// (T+1) records). Each thread keeps its pair's state in registers —
// orig/den rows are (2k+1) x W words each, templated on K and W = L/32
// so every lane/word loop unrolls and indexes registers statically. A
// warp runs until its slowest pair is done; the host's difficulty sort
// groups pairs of similar step count, so that bound is a warp's (not a
// batch's) maximum. Loads are coalesced (thread t of tile i reads
// planes[i, w, t]) and so are the record rows (rec[it, pair]).
//
// Numerics: the heuristic match_sig*hlen + mismatch_sig*nhur +
// indel_sig*nsw hits exact ties (mismatch_sig == indel_sig), so the
// last ulp decides walks. It is evaluated with __fmul_rn/__fadd_rn in
// the reference's association order, ((a + b) + c), so no FMA
// contraction can change a rounding; the constants arrive as float32
// values rounded from the host's doubles. Tie-breaks of the two lane
// scans follow the reference exactly.
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
__global__ void __launch_bounds__(128)
greedy_kernel(const uint32_t* __restrict__ rc, const uint32_t* __restrict__ fc,
              const int* __restrict__ rl, const int* __restrict__ fl,
              const Params P, int* __restrict__ cost_out,
              int* __restrict__ steps_out, RecT* __restrict__ rec) {
    constexpr int NL = 2 * K + 1;
    constexpr int L = 32 * W;
    const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= P.B) return;
    const int64_t B = P.B;
    const int x = P.x, o = P.o, e = P.e;
    const int m = min(rl[p], L);
    const int n = min(fl[p], L);

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

    // ---- hurdle rows (_construct_hurdles, hurdle_matrix.h:441-455) ----
    // lane < 0 shifts the read by -lane, lane > 0 the ref by lane; a
    // position is a hurdle where either plane differs or either shifted
    // position lies past its length (closed form: mask_ge(len - shift))
    uint32_t orig[NL][W];
#pragma unroll
    for (int li = 0; li < NL; li++) {
        const int lane = li - K;
        const int a_off = lane < 0 ? -lane : 0;
        const int b_off = lane > 0 ? lane : 0;
#pragma unroll
        for (int w = 0; w < W; w++) {
            orig[li][w] = (funnel<W>(r0, a_off, w) ^ funnel<W>(f0, b_off, w)) |
                          (funnel<W>(r1, a_off, w) ^ funnel<W>(f1, b_off, w)) |
                          mask_ge(m - a_off, w) | mask_ge(n - b_off, w);
        }
    }

    // ---- denoise: flip_short_hurdles(1) keeps a hurdle with a neighbour ----
    uint32_t den[NL][W];
#pragma unroll
    for (int li = 0; li < NL; li++) {
#pragma unroll
        for (int w = 0; w < W; w++) {
            const uint32_t h = orig[li][w];
            const uint32_t lo_prev = w > 0 ? orig[li][w - 1] >> 31 : 0u;
            const uint32_t hi_next = w < W - 1 ? orig[li][w + 1] << 31 : 0u;
            den[li][w] = h & (((h << 1) | lo_prev) | ((h >> 1) | hi_next));
        }
    }

    // ---- per-lane destinations (_calculate_destination, :58-68) ----
    int dest[NL];
#pragma unroll
    for (int li = 0; li < NL; li++) {
        const int lane = li - K;
        const int dest_ge = lane > 0 ? n - lane : (lane >= n - m ? n : m + lane);
        const int dest_lt = lane < 0 ? m + lane : (lane <= n - m ? m : n - lane);
        dest[li] = m >= n ? dest_ge : dest_lt;
    }
    const int dest_lane = n - m;
    const bool in_band = iabs(dest_lane) <= K;

    int cur_lane = 0, cur_col = 0, cost = 0, steps = 0;
    bool done = false;
    int sp[NL], hlen[NL], nsw[NL];
#pragma unroll
    for (int li = 0; li < NL; li++) {
        sp[li] = -1;
        hlen[li] = 0;
        nsw[li] = L;
    }

    int it = 0;
    while (it < P.T && !done) {
        // ---- _update_highway_list (hurdle_matrix.h:285-362) ----
        int sc[NL];
        bool reaching = false;
#pragma unroll
        for (int li = 0; li < NL; li++) {
            const int lane = li - K;
            const int s = cur_col + sfc(cur_lane, lane);
            sc[li] = s;
            // u = den with every bit below s forced to 1: the first zero
            // of u is the highway start fz, and u & (u + 1) (multiword
            // increment) is den restricted to bits past fz, whose first
            // one ends the highway
            uint32_t u[W];
#pragma unroll
            for (int w = 0; w < W; w++) u[w] = den[li][w] | ~mask_ge(s, w);
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
            const int sp_new = s > L ? s : fz;
            const int raw_len = (sp_new >= L || no_g >= L) ? L : no_g - sp_new;
            const bool clamp = sp_new + raw_len > dest[li];
            const int len_new = clamp ? max(dest[li] - sp_new, 0) : raw_len;
            if (sp[li] < s) {
                sp[li] = sp_new;
                hlen[li] = len_new;
                nsw[li] = iabs(lane - cur_lane);
                reaching = reaching || clamp;
            }
        }

        int swc[NL], nhur[NL];
#pragma unroll
        for (int li = 0; li < NL; li++) {
            const int pen = slp(cur_lane, li - K, o, e);
            swc[li] = (P.is_global || it > 0) ? pen : 0;
            nhur[li] = count_range<W>(orig[li], sc[li], sp[li] + hlen[li]);
        }

        // ---- selection scan (hurdle_matrix.h:325-352) ----
        float best_h = __int_as_float(0xff800000);  // -inf
        int best_lh = -2147483647 - 1;
        int best_li = 0;
#pragma unroll
        for (int li = 0; li < NL; li++) {
            const int lane = li - K;
            const float sig = __fadd_rn(
                __fadd_rn(__fmul_rn(P.match_sig, __int2float_rn(hlen[li])),
                          __fmul_rn(P.mismatch_sig, __int2float_rn(nhur[li]))),
                __fmul_rn(P.indel_sig, __int2float_rn(nsw[li])));
            const int fsc = P.is_global ? slp(lane, dest_lane, o, e) : 0;
            const float h_reach = __int2float_rn(
                -(swc[li] + x * nhur[li]) - fsc -
                x * (dest[li] - sp[li] - hlen[li]));
            const float h = reaching ? h_reach : sig;
            const int lh = -swc[li] - (reaching ? fsc : 0);
            if (h > best_h || (h == best_h && lh > best_lh)) {
                best_h = h;
                best_lh = lh;
                best_li = li;
            }
        }

        int best_len = 0, sp_b = 0, stc = 0;
        uint32_t row_b[W];
#pragma unroll
        for (int w = 0; w < W; w++) row_b[w] = 0u;
#pragma unroll
        for (int li = 0; li < NL; li++) {
            if (li == best_li) {
                best_len = hlen[li];
                sp_b = sp[li];
                stc = swc[li] + x * nhur[li];
#pragma unroll
                for (int w = 0; w < W; w++) row_b[w] = orig[li][w];
            }
        }
        const bool valid = best_len > 0;  // else: stop without a step

        // ---- _choose_best_highway (hurdle_matrix.h:368-401) ----
        const int best_lane = best_li - K;
        int sic = stc;
        int bil = best_li;
#pragma unroll
        for (int li = 0; li < NL; li++) {
            const int lane = li - K;
            const int fwd_lb = sfc(lane, best_lane);
            const bool skip = (li == best_li) || (sp[li] + fwd_lb > sp_b);
            // the RAW popcount (hurdle_matrix.h:389), nhur's window
            const int ic = swc[li] + nhur[li];
            const int cross =
                count_range<W>(row_b, fwd_lb + sp[li] + hlen[li], sp_b);
            const int tc = ic + slp(lane, best_lane, o, e) + max(0, x * cross);
            if (!skip && tc <= stc && ic <= sic) {
                stc = tc;
                sic = ic;
                bil = li;
            }
        }

        // ---- commit the step (_step, hurdle_matrix.h:407-434) ----
        int sp_c = 0, len_c = 0, cost_c = 0;
#pragma unroll
        for (int li = 0; li < NL; li++) {
            if (li == bil) {
                sp_c = sp[li];
                len_c = hlen[li];
                cost_c = swc[li] + x * nhur[li];
            }
        }
        const int bl_lane = bil - K;
        int packed = 0;
        if (valid) {
            cost += cost_c;
            const int distance = sp_c + len_c - (cur_col + sfc(cur_lane, bl_lane));
            packed = (((bl_lane - cur_lane) + 64) << 1) | (distance << 8);
            cur_lane = bl_lane;
            cur_col = sp_c + len_c;
            steps += 1;
            int dest_new = 0;
#pragma unroll
            for (int li = 0; li < NL; li++)
                if (li == bl_lane + K) dest_new = dest[li];
            done = cur_col >= dest_new;
        } else {
            done = true;
        }
        rec[(int64_t)it * B + p] = (RecT)packed;
        it += 1;
    }

    // ---- final leap (run(), hurdle_matrix.h:574-590) ----
    const int dl_c = min(max(dest_lane, -K), K);
    int dest_col = 0;
    uint32_t row_dl[W];
#pragma unroll
    for (int w = 0; w < W; w++) row_dl[w] = 0u;
#pragma unroll
    for (int li = 0; li < NL; li++) {
        if (li == dl_c + K) {
            dest_col = dest[li];
#pragma unroll
            for (int w = 0; w < W; w++) row_dl[w] = orig[li][w];
        }
    }
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

template <int K, int W, bool kPlanes>
cudaError_t launch(const void* rc, const void* fc, const void* rl,
                   const void* fl, const Params& P, void* cost, void* steps,
                   void* rec, cudaStream_t stream) {
    using RecT = typename std::conditional<(32 * W <= 255 && 2 * K <= 62),
                                           int16_t, int32_t>::type;
    constexpr int kThreads = 128;
    const int blocks = (P.B + kThreads - 1) / kThreads;
    greedy_kernel<K, W, kPlanes, RecT><<<blocks, kThreads, 0, stream>>>(
        (const uint32_t*)rc, (const uint32_t*)fc, (const int*)rl,
        (const int*)fl, P, (int*)cost, (int*)steps, (RecT*)rec);
    return cudaGetLastError();
}

template <bool kPlanes>
cudaError_t dispatch(int k, int W, const void* rc, const void* fc,
                     const void* rl, const void* fl, const Params& P,
                     void* cost, void* steps, void* rec, cudaStream_t s) {
    if (k == 2 && W == 4) return launch<2, 4, kPlanes>(rc, fc, rl, fl, P, cost, steps, rec, s);
    if (k == 2 && W == 8) return launch<2, 8, kPlanes>(rc, fc, rl, fl, P, cost, steps, rec, s);
    if (k == 3 && W == 4) return launch<3, 4, kPlanes>(rc, fc, rl, fl, P, cost, steps, rec, s);
    if (k == 3 && W == 8) return launch<3, 8, kPlanes>(rc, fc, rl, fl, P, cost, steps, rec, s);
    return cudaErrorInvalidValue;
}

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
    const Params P{B, tile, T, x, o, e, is_global, match_sig, mismatch_sig,
                   indel_sig};
    cudaStream_t s = (cudaStream_t)stream;
    err = planes ? dispatch<true>(k, W, rc, fc, rl, fl, P, cost, steps, rec, s)
                 : dispatch<false>(k, W, rc, fc, rl, fl, P, cost, steps, rec, s);
    return (int)err;
}
