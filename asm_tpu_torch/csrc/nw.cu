// Exact NW/Gotoh penalty and traceback, one warp per pair (sm_90a).
//
// Replaces the Pallas TPU kernels asm_tpu/kernels/nw_pallas.py _nw_kernel
// (wrapper nw_penalty_pallas) and _nw_trace_kernel (wrapper
// nw_align_pallas). Anti-diagonal wavefront over cells i in [1, L] (the
// i == 0 top border is virtual: closed form o + (d-1)*e, entering as the
// fill of the i-1 shift); thread t of the warp holds the C = L/32
// consecutive cells i = C*t + 1 .. C*t + C. Per diagonal d the shifted
// (i-1) values cross thread boundaries by __shfl_up_sync: one shuffle for
// H and one for E, since the i-1 value of H two diagonals back is last
// step's shifted H (the TPU kernel's pipelined rows). The reversed-ref
// window the TPU kernel rolls through a [2L] buffer becomes an index into
// the pair's ref codes in shared memory, with the window's sentinel (-2)
// for j outside [1, L]. The warp loops to its own pair's m+n.
//
// What bounds it on Hopper: integer throughput (~20 ops per cell per
// diagonal, C cells per thread) and, for the trace kernel, the pointer
// bytes: 2L x L bytes per pair (32 KiB at L = 128), far beyond shared
// memory for a warp per pair, so they go to a per-launch global scratch
// the wrapper sizes (one coalesced store of C bytes per thread and
// diagonal), and the traceback is one dependent walk per pair (one
// thread, up to 2L scratch reads that mostly hit L2). The penalty kernel touches memory only for
// 2L code bytes in and 4 bytes out per pair.
//
// Traceback: exactly asm_tpu/kernels/nw.py's reverse replay (pointer
// byte: bits 0-1 H source 0 sub / 1 E / 2 F, bit 2 E opened, bit 3 F
// opened, bit 4 mismatch; ties prefer sub, then E, then F; at the left
// border H comes from E, opened iff d == 1; the virtual i == 0 byte is
// F, opened iff d == 1). The op of diagonal d goes to column 2L - d; every
// other column holds OP_NONE. The '='-run match mask is kept as an L-bit
// mask in registers and flushed at the end.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kInf = 1 << 29;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kWarps = 8;  // pairs per block
constexpr int kThreads = 32 * kWarps;

enum : int8_t { OP_NONE = 0, OP_EQ = 1, OP_X = 2, OP_I = 3, OP_D = 4 };

struct Params {
    int B, x, o, e, thr;
};

__device__ __forceinline__ int h_top(int dd, int o, int e) {
    return dd <= 0 ? (dd == 0 ? 0 : kInf) : o + (dd - 1) * e;
}

// bits [lo, hi) of word w of an L-bit mask
__device__ __forceinline__ uint32_t span_bits(int lo, int hi, int w) {
    const int a = min(max(lo - 32 * w, 0), 32);
    const int b = min(max(hi - 32 * w, 0), 32);
    const uint32_t ma = a >= 32 ? 0u : (kFull << a);
    const uint32_t mb = b >= 32 ? 0u : (kFull << b);
    return ma & ~mb;
}

template <int W, bool kTrace>
__global__ void __launch_bounds__(kThreads)
nw_kernel(const int8_t* __restrict__ rc, const int8_t* __restrict__ fc,
          const int* __restrict__ rl, const int* __restrict__ fl, Params P,
          int* __restrict__ pen_out, int8_t* ops_out, int8_t* mask_out,
          uint32_t* scratch) {  // scratch: written, then read back here
    constexpr int L = 32 * W;
    constexpr int C = W;  // cells per thread
    __shared__ __align__(16) int8_t s_ref[kWarps][L];  // stored as words

    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int64_t p = (int64_t)blockIdx.x * kWarps + warp;
    if (p >= P.B) return;  // warp-uniform
    const int x = P.x, o = P.o, e = P.e;
    const int m = min(rl[p], L), n = min(fl[p], L), mn = m + n;

    // read codes of this thread's cells; the pair's ref in shared memory
    int a[C];
    {
        const uint32_t* src = (const uint32_t*)(rc + p * L) + lane * (C / 4);
        const uint32_t* ref = (const uint32_t*)(fc + p * L);
        uint32_t* dst = (uint32_t*)s_ref[warp];
#pragma unroll
        for (int w = 0; w < C / 4; w++) {
            const uint32_t v = src[w];
#pragma unroll
            for (int b = 0; b < 4; b++) a[4 * w + b] = (int8_t)(v >> (8 * b));
            dst[lane * (C / 4) + w] = ref[lane * (C / 4) + w];
        }
    }
    __syncwarp();

    // state of diagonal d-1: h1, e-shift se1 (E at i-1), f1; sa / sb = H
    // at i-1 on diagonals d-1 / d-2
    int h1[C], sa[C], sb[C], se1[C], f1[C];
#pragma unroll
    for (int c = 0; c < C; c++) {
        h1[c] = kInf;
        sa[c] = (lane == 0 && c == 0) ? 0 : kInf;  // fill h_top(0) = 0
        sb[c] = kInf;
        se1[c] = kInf;
        f1[c] = kInf;
    }
    int pen = mn == 0 ? 0 : (m == 0 ? o + (mn - 1) * e : kInf);
    uint32_t* ptr_row = kTrace ? scratch + (p * 2 * L) * (L / 4) : nullptr;

    for (int d = 1; d <= mn; d++) {
        int hn[C], en[C];
        uint32_t bytes[C / 4];
#pragma unroll
        for (int w = 0; w < C / 4; w++) bytes[w] = 0;
        const int bp = o + (d - 1) * e;
#pragma unroll
        for (int c = 0; c < C; c++) {
            const int i = lane * C + c + 1;
            const int jj = d - i - 1;  // ref index j - 1
            const int b = (jj >= 0 && jj < L) ? s_ref[warp][jj] : -2;
            const int mis = a[c] != b;
            const int e_open = sa[c] + o, e_ext = se1[c] + e;
            const int f_open = h1[c] + o, f_ext = f1[c] + e;
            const int sub = sb[c] + x * mis;
            int ev = min(e_open, e_ext);
            int fv = min(f_open, f_ext);
            int hv = min(sub, min(ev, fv));
            const bool at_left = i == d;  // j == 0
            if (at_left) {
                hv = bp;
                ev = bp;
                fv = kInf;
            }
            if (d == mn && i == m) pen = hv;
            if (kTrace) {
                const int ptr_h = at_left ? 1 : (hv == sub ? 0 : (hv == ev ? 1 : 2));
                const int eo = at_left ? (d == 1) : (e_open <= e_ext);
                const int fo = f_open <= f_ext;
                const uint32_t byte = ptr_h | (eo << 2) | (fo << 3) | (mis << 4);
                bytes[c / 4] |= byte << (8 * (c % 4));
            }
            hn[c] = hv;
            en[c] = ev;
            f1[c] = fv;
        }
        if (kTrace) {
            uint32_t* row = ptr_row + (d - 1) * (L / 4) + lane * (C / 4);
#pragma unroll
            for (int w = 0; w < C / 4; w++) row[w] = bytes[w];
        }
        // i-1 neighbours for diagonal d+1
        const int up_h = __shfl_up_sync(kFull, hn[C - 1], 1);
        const int up_e = __shfl_up_sync(kFull, en[C - 1], 1);
#pragma unroll
        for (int c = C - 1; c >= 1; c--) {
            sb[c] = sa[c];
            sa[c] = hn[c - 1];
            se1[c] = en[c - 1];
        }
        sb[0] = sa[0];
        sa[0] = lane == 0 ? h_top(d, o, e) : up_h;
        se1[0] = lane == 0 ? kInf : up_e;
#pragma unroll
        for (int c = 0; c < C; c++) h1[c] = hn[c];
    }

    // the thread holding cell i == m has the result (m == 0: closed form)
    if (m == 0 ? lane == 0 : (m - 1) / C == lane) pen_out[p] = pen;
    if (!kTrace) return;

    // ---- traceback ----
    int8_t* ops = ops_out + p * 2 * L;
    {
        uint32_t* o32 = (uint32_t*)ops;  // 2L bytes: 2C bytes per thread
#pragma unroll
        for (int w = 0; w < C / 2; w++) o32[lane * (C / 2) + w] = 0u;
    }
    __syncwarp();  // pointer bytes and zeroed ops visible to lane 0
    uint32_t mk[W];
#pragma unroll
    for (int w = 0; w < W; w++) mk[w] = 0u;
    if (lane == 0) {
        const uint8_t* ptr8 = (const uint8_t*)ptr_row;
        const int thr = P.thr;
        int i = m, j = n, st = 0, run = 0;
        // every move lowers i + j, and the borders' bytes lead to (0, 0);
        // the bounds only keep a corrupt byte from walking off the scratch
        for (int step = 0; (i > 0 || j > 0) && i >= 0 && j >= 0 && step < 2 * L;
             step++) {
            const int d = i + j;
            const int byte = i == 0 ? (2 | (d == 1 ? 8 : 0))
                                    : ptr8[(int64_t)(d - 1) * L + (i - 1)];
            const int ptr_h = byte & 3, e_open = (byte >> 2) & 1,
                      f_open = (byte >> 3) & 1, mis = (byte >> 4) & 1;
            const bool go_diag = st == 0 && ptr_h == 0;
            const bool go_e = (st == 0 && ptr_h == 1) || st == 1;
            const bool go_f = (st == 0 && ptr_h == 2) || st == 2;
            ops[2 * L - d] = go_diag ? (mis ? OP_X : OP_EQ) : (go_e ? OP_I : OP_D);
            if (thr >= 0) {
                // a '=' run ending at read cursor i covered [i, i + run)
                const bool is_eq = go_diag && !mis;
                if (!is_eq && run > 0 && run >= thr) {
#pragma unroll
                    for (int w = 0; w < W; w++) mk[w] |= span_bits(i, i + run, w);
                }
                run = is_eq ? run + 1 : 0;
            }
            const int new_st = go_diag ? 0 : (go_e ? (e_open ? 0 : 1) : (f_open ? 0 : 2));
            i -= (go_diag || go_e);
            j -= (go_diag || go_f);
            st = new_st;
        }
        // flush a run still open at the start of the alignment
        if (thr >= 0 && run > 0 && run >= thr) {
#pragma unroll
            for (int w = 0; w < W; w++) mk[w] |= span_bits(i, i + run, w);
        }
    }
    if (mask_out == nullptr) return;
    // broadcast the mask; thread t writes positions C*t .. C*t + C-1
    uint32_t mine = 0;
#pragma unroll
    for (int w = 0; w < W; w++) {
        const uint32_t v = __shfl_sync(kFull, mk[w], 0);
        if (w == (lane * C) / 32) mine = v >> ((lane * C) % 32);
    }
    uint32_t* m32 = (uint32_t*)(mask_out + p * L) + lane * (C / 4);
#pragma unroll
    for (int w = 0; w < C / 4; w++) {
        uint32_t out = 0;
#pragma unroll
        for (int b = 0; b < 4; b++) out |= ((mine >> (4 * w + b)) & 1u) << (8 * b);
        m32[w] = out;
    }
}

template <int W>
cudaError_t launch(const void* rc, const void* fc, const void* rl,
                   const void* fl, const Params& P, void* pen, void* ops,
                   void* mask, void* scratch, cudaStream_t s) {
    const int blocks = (P.B + kWarps - 1) / kWarps;
    if (ops == nullptr) {
        nw_kernel<W, false><<<blocks, kThreads, 0, s>>>(
            (const int8_t*)rc, (const int8_t*)fc, (const int*)rl,
            (const int*)fl, P, (int*)pen, nullptr, nullptr, nullptr);
    } else {
        nw_kernel<W, true><<<blocks, kThreads, 0, s>>>(
            (const int8_t*)rc, (const int8_t*)fc, (const int*)rl,
            (const int*)fl, P, (int*)pen, (int8_t*)ops, (int8_t*)mask,
            (uint32_t*)scratch);
    }
    return cudaGetLastError();
}

}  // namespace

// rc/fc: int8 codes [B, 32W] (rows 4-byte aligned); rl/fl: int32[B];
// pen: int32[B] out. ops == NULL: penalty only. Else the trace kernel:
// ops int8[B, 64W] out, mask (NULL, or bool[B, 32W] out, written when
// thr >= 0) and scratch, uint8[B, 64W, 32W] of pointer bytes. Returns the
// launch's cudaError_t (0 on success); does not synchronise.
extern "C" int asm_nw_launch(const void* rc, const void* fc, const void* rl,
                             const void* fl, int B, int W, int x, int o,
                             int e, int thr, void* pen, void* ops,
                             void* mask, void* scratch, int device,
                             void* stream) {
    if (B <= 0) return 0;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (ops != nullptr && scratch == nullptr) return (int)cudaErrorInvalidValue;
    const Params P{B, x, o, e, thr};
    cudaStream_t s = (cudaStream_t)stream;
    if (W == 4) return (int)launch<4>(rc, fc, rl, fl, P, pen, ops, mask, scratch, s);
    if (W == 8) return (int)launch<8>(rc, fc, rl, fl, P, pen, ops, mask, scratch, s);
    return (int)cudaErrorInvalidValue;
}
