// Banded NW/Gotoh penalty, one pair per BW-cell segment of a warp (sm_90a).
//
// Replaces the Pallas TPU kernel asm_tpu/kernels/nw_band.py _nw_band_kernel
// (wrapper nw_penalty_banded). Band-offset layout: cell u of a pair's band
// holds diagonal offset k = i - j = u - KB, KB = BW/2 - 1; per diagonal d,
// E reads (d-1, k-1), F reads (d-1, k+1), the substitution (d-2, k), and
// INF enters at the band's two edges. The pair's result is H at
// (d = m+n, k = m-n), min-folded with the closed form of empty reads, so
// uncertified upper bounds and INF (destination off the band) come out as
// the JAX kernel's.
//
// What bounds it on Hopper: per cell and diagonal ~20 integer ops and two
// shared-memory byte loads, plus four warp shuffles per thread and
// diagonal (the k-1 / k+1 neighbours), so instruction throughput and the
// shuffle pipe, not memory: a pair reads 64 B of planes and writes 4 B.
// The TPU kernel streamed precomputed mismatch planes of BW/4 bytes per
// diagonal per pair (512 B per pair at BW 16, 2 KB at BW 64); here the
// mismatch bit is computed in the kernel from the pair's codes, unpacked
// once from its 2-bit planes into shared memory, so no mismatch planes
// exist at all.
//
// Layout: BW <= 32 gives one cell per thread and 32/BW pairs per warp
// (BW 8: 4 pairs); BW 64 gives two adjacent cells per thread, one pair per
// warp. Shuffles run with width = the segment, so a segment's edge thread
// takes INF in place of its neighbour, exactly the TPU kernel's
// at_lo/at_hi. A warp loops to the largest m+n of its pairs; the
// band-major, difficulty-sorted order keeps those maxima close. Lanes of
// the wrong parity (d + k odd) compute values that no valid cell reads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kInf = 1 << 29;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kThreads = 128;

struct Params {
    int B, x, o, e;
};

template <int BW, int W>
__global__ void __launch_bounds__(kThreads)
band_kernel(const uint32_t* __restrict__ rp, const uint32_t* __restrict__ fp,
            const int* __restrict__ rl, const int* __restrict__ fl, Params P,
            int* __restrict__ pen_out) {
    constexpr int L = 32 * W;
    constexpr int SEG = BW < 32 ? BW : 32;  // threads per pair
    constexpr int CPL = BW / SEG;           // cells per thread
    constexpr int PPW = 32 / SEG;           // pairs per warp
    constexpr int PPB = (kThreads / 32) * PPW;
    constexpr int KB = BW / 2 - 1;
    constexpr int ROW = L + 4;  // skews the rows of a warp's pairs across banks
    __shared__ int8_t s_read[PPB][ROW];
    __shared__ int8_t s_ref[PPB][ROW];

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
    // unpack the pair's 2-bit planes (row w: bit 0 of positions 32w..,
    // row W + w: bit 1) into one code byte per position
    for (int pos = t; pos < L; pos += SEG) {
        const int w = pos >> 5, b = pos & 31;
        int rc = 0, fc = 0;
        if (live) {
            rc = ((rp[w * B + p] >> b) & 1) | (((rp[(W + w) * B + p] >> b) & 1) << 1);
            fc = ((fp[w * B + p] >> b) & 1) | (((fp[(W + w) * B + p] >> b) & 1) << 1);
        }
        s_read[slot][pos] = (int8_t)rc;
        s_ref[slot][pos] = (int8_t)fc;
    }
    __syncwarp();

    const int mn = m + n, dk = m - n;
    const int d_max = __reduce_max_sync(kFull, mn);

    int kk[CPL], h1[CPL], h2[CPL], e1[CPL], f1[CPL];
#pragma unroll
    for (int c = 0; c < CPL; c++) {
        kk[c] = t * CPL + c - KB;
        h1[c] = kk[c] == 0 ? 0 : kInf;  // diagonal 0: only cell (0, 0)
        h2[c] = kInf;
        e1[c] = kInf;
        f1[c] = kInf;
    }
    int hit = kInf;  // H at the destination

    for (int d = 1; d <= d_max; d++) {
        // neighbours on diagonal d-1: k-1 (up) and k+1 (down)
        int uh[CPL], ue[CPL], dh[CPL], df[CPL];
        {
            const int sh = __shfl_up_sync(kFull, h1[CPL - 1], 1, SEG);
            const int se = __shfl_up_sync(kFull, e1[CPL - 1], 1, SEG);
            const int dh0 = __shfl_down_sync(kFull, h1[0], 1, SEG);
            const int df0 = __shfl_down_sync(kFull, f1[0], 1, SEG);
            uh[0] = t == 0 ? kInf : sh;
            ue[0] = t == 0 ? kInf : se;
            dh[CPL - 1] = t == SEG - 1 ? kInf : dh0;
            df[CPL - 1] = t == SEG - 1 ? kInf : df0;
#pragma unroll
            for (int c = 1; c < CPL; c++) {
                uh[c] = h1[c - 1];
                ue[c] = e1[c - 1];
                dh[c - 1] = h1[c];
                df[c - 1] = f1[c];
            }
        }
        const int bp = o + (d - 1) * e;
#pragma unroll
        for (int c = 0; c < CPL; c++) {
            const int k = kk[c];
            // cell (i, j) = ((d+k)/2, (d-k)/2); out-of-range and
            // wrong-parity cells are don't-care, their indices clamped
            const int ri = min(max(((d + k) >> 1) - 1, 0), L - 1);
            const int rj = min(max(((d - k) >> 1) - 1, 0), L - 1);
            const int mis = s_read[slot][ri] != s_ref[slot][rj];
            int en = min(uh[c] + o, ue[c] + e);
            int fn = min(dh[c] + o, df[c] + e);
            int hn = min(h2[c] + x * mis, min(en, fn));
            // borders inside the band: k == d is the j == 0 column,
            // k == -d the i == 0 row
            const bool bl = k == d, bt = k == -d;
            if (bl || bt) {
                hn = bp;
                fn = kInf;
            }
            en = bl ? bp : (bt ? kInf : en);
            if (d == mn && k == dk) hit = hn;
            h2[c] = h1[c];
            h1[c] = hn;
            e1[c] = en;
            f1[c] = fn;
        }
    }

    if (!live) return;
    const int closed = mn == 0 ? 0 : (m == 0 ? o + (mn - 1) * e : kInf);
    const bool in_band = dk >= -KB && dk <= BW - 1 - KB;
    bool mine = false;
#pragma unroll
    for (int c = 0; c < CPL; c++) mine |= kk[c] == dk;
    if (in_band ? mine : t == 0) pen_out[p] = min(closed, hit);
}

template <int BW, int W>
cudaError_t launch(const void* rp, const void* fp, const void* rl,
                   const void* fl, const Params& P, void* pen,
                   cudaStream_t s) {
    constexpr int PPB = (kThreads / 32) * (32 / (BW < 32 ? BW : 32));
    const int blocks = (P.B + PPB - 1) / PPB;
    band_kernel<BW, W><<<blocks, kThreads, 0, s>>>(
        (const uint32_t*)rp, (const uint32_t*)fp, (const int*)rl,
        (const int*)fl, P, (int*)pen);
    return cudaGetLastError();
}

template <int W>
cudaError_t dispatch(int bw, const void* rp, const void* fp, const void* rl,
                     const void* fl, const Params& P, void* pen,
                     cudaStream_t s) {
    switch (bw) {
        case 8: return launch<8, W>(rp, fp, rl, fl, P, pen, s);
        case 16: return launch<16, W>(rp, fp, rl, fl, P, pen, s);
        case 32: return launch<32, W>(rp, fp, rl, fl, P, pen, s);
        case 64: return launch<64, W>(rp, fp, rl, fl, P, pen, s);
        default: return cudaErrorInvalidValue;
    }
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
    if (W == 4) return (int)dispatch<4>(bw, rp, fp, rl, fl, P, pen, s);
    if (W == 8) return (int)dispatch<8>(bw, rp, fp, rl, fl, P, pen, s);
    return (int)cudaErrorInvalidValue;
}
