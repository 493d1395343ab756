// Roofline microkernels (sm_90a): the card's integer issue rate, its
// device-memory read rate, and the probe the SASS counter is tested on.
//
// Replaces the Pallas TPU kernels of tools/roofline.py and its test:
//   issue_chain  <- vpu_peak_measure (tools/roofline.py:49): each thread
//                   runs kStreams independent dependent chains of
//                   v = (v + 1) ^ 12345, kUnroll steps per iteration, for a
//                   runtime `iters`, and writes the xor of its chains;
//   stream_fold  <- hbm_stream_measure (tools/roofline.py:119): the xor of
//                   every 32-bit word of an array, one word out;
//   probe_kernel <- the synthetic kernel of tests/test_roofline_counts.py:
//                   load, +1, ^3, store to scratch, a data-dependent loop
//                   of scratch += 1 (x[0] trips), store.
//   op_chain     <- none: added to measure the issue rate of the opcodes a
//                   Gotoh cell is made of (a DPX add-min, a min / max, a
//                   compare and select, a multiply-add, an add, add-min and
//                   multiply-add side by side, a DPX three-way min / max,
//                   an add of a uniform operand beside a xor), to tell
//                   whether they share a pipe that issues at half the
//                   card's rate.
//
// What bounds each on Hopper, and what the design does about it:
//   issue_chain is bound by integer issue. The chains are independent, so
//   a warp always has an instruction ready; the grid fills every SM (the
//   wrapper launches several 256-thread blocks per SM), so all four
//   schedulers issue every cycle they can. `iters` is a runtime argument
//   and the iteration loop is kept rolled (`#pragma unroll 1`) so that its
//   body holds exactly kStreams * kUnroll * 2 chain instructions plus the
//   trip counter, which the SASS count checks; the seeds come from memory
//   and every chain reaches the output, so ptxas can fold nothing away.
//   stream_fold is bound by device-memory bandwidth: 16-byte loads,
//   neighbouring threads on neighbouring addresses, a grid-stride loop
//   with four loads in flight per thread, a warp shuffle reduction and one
//   atomicXor per block into the single output word.
//   op_chain is bound by the issue of its one opcode (or its pipe): the
//   same grid, chains and rolled loop as issue_chain, each step of a chain
//   one operation of the opcode on its own value and its neighbour chain's
//   value of the step before (so that no two steps fold into one), kUnroll
//   steps a trip.
//   probe_kernel is bound by nothing that matters (1024 words); its
//   scratch is `volatile` shared memory so that ptxas keeps the load and
//   the store of every loop trip, as the Pallas kernel's ref get and swap
//   are; its loop is kept rolled so the SASS holds one loop.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kStreams = 8;
constexpr int kUnroll = 4;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
issue_chain(const uint32_t* __restrict__ seed, uint32_t* __restrict__ out,
            int iters) {
    const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
    uint32_t v[kStreams];
#pragma unroll
    for (int s = 0; s < kStreams; s++) v[s] = seed[t * kStreams + s];
#pragma unroll 1
    for (int i = 0; i < iters; i++) {
#pragma unroll
        for (int s = 0; s < kStreams; s++) {
#pragma unroll
            for (int u = 0; u < kUnroll; u++) v[s] = (v[s] + 1u) ^ 12345u;
        }
    }
    uint32_t acc = v[0];
#pragma unroll
    for (int s = 1; s < kStreams; s++) acc ^= v[s];
    out[t] = acc;
}

// op_chain's operations: one step of a chain from its value v and its
// neighbour's w (step u of the trip), with the runtime operand a
enum { OP_VIADDMIN = 0, OP_MINMAX = 1, OP_SETP_SEL = 2, OP_IMAD = 3, OP_IADD = 4,
       OP_MIX = 5, OP_MINMAX3 = 6, OP_ADD_XOR = 7 };

template <int OP>
__device__ __forceinline__ uint32_t op_step(uint32_t v, uint32_t w, uint32_t z, int a, int s,
                                            int u) {
    const int vi = (int)v, wi = (int)w, zi = (int)z;
    if constexpr (OP == OP_VIADDMIN) {
        return (uint32_t)__viaddmin_s32(vi, a, wi);  // min(v + a, w)
    } else if constexpr (OP == OP_MINMAX) {
        return (uint32_t)(u % 2 ? max(vi, wi) : min(vi, wi));
    } else if constexpr (OP == OP_SETP_SEL) {
        return vi < wi ? (uint32_t)a : w;
    } else if constexpr (OP == OP_IMAD) {
        return v * w + (uint32_t)a;
    } else if constexpr (OP == OP_IADD) {
        return v + w;
    } else if constexpr (OP == OP_MIX) {  // add-min on half the chains, multiply-add
        return s < kStreams / 2 ? op_step<OP_VIADDMIN>(v, w, z, a, s, u)
                                : op_step<OP_IMAD>(v, w, z, a, s, u);
    } else if constexpr (OP == OP_MINMAX3) {  // z: the chain after the neighbour
        return (uint32_t)(u % 2 ? __vimax3_s32(vi, wi, zi) : __vimin3_s32(vi, wi, zi));
    } else {  // an add of the operand, then a xor with it: the two cannot fold
        return u % 2 ? w ^ (uint32_t)a : w + (uint32_t)a;
    }
}

template <int OP>
__global__ void __launch_bounds__(kThreads)
op_chain(const uint32_t* __restrict__ seed, uint32_t* __restrict__ out, int iters, int a) {
    const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
    uint32_t v[kStreams];
#pragma unroll
    for (int s = 0; s < kStreams; s++) {
        // the add-min's values stay far from overflow: seeds of 24 bits
        const uint32_t x = seed[t * kStreams + s];
        v[s] = OP == OP_VIADDMIN || OP == OP_MIX ? (uint32_t)((int)x >> 8) : x;
    }
#pragma unroll 1
    for (int i = 0; i < iters; i++) {
#pragma unroll
        for (int u = 0; u < kUnroll; u++) {
            uint32_t w[kStreams];
#pragma unroll
            for (int s = 0; s < kStreams; s++)
                w[s] = op_step<OP>(v[s], v[(s + 1) % kStreams], v[(s + 2) % kStreams], a,
                                   s, u);
#pragma unroll
            for (int s = 0; s < kStreams; s++) v[s] = w[s];
        }
    }
    uint32_t acc = v[0];
#pragma unroll
    for (int s = 1; s < kStreams; s++) acc ^= v[s];
    out[t] = acc;
}

__device__ __forceinline__ uint32_t fold4(uint4 a) {
    return a.x ^ a.y ^ a.z ^ a.w;
}

__global__ void __launch_bounds__(kThreads)
stream_fold(const uint4* __restrict__ x, int64_t n4, uint32_t* __restrict__ out) {
    const int64_t stride = (int64_t)gridDim.x * kThreads;
    int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
    uint32_t a = 0u, b = 0u, c = 0u, d = 0u;
    for (; i + 3 * stride < n4; i += 4 * stride) {
        const uint4 p = __ldcs(x + i);
        const uint4 q = __ldcs(x + i + stride);
        const uint4 r = __ldcs(x + i + 2 * stride);
        const uint4 s = __ldcs(x + i + 3 * stride);
        a ^= fold4(p);
        b ^= fold4(q);
        c ^= fold4(r);
        d ^= fold4(s);
    }
    for (; i < n4; i += stride) a ^= fold4(__ldcs(x + i));
    uint32_t v = a ^ b ^ c ^ d;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v ^= __shfl_xor_sync(kFull, v, off);
    __shared__ uint32_t warp_acc[kThreads / 32];
    if ((threadIdx.x & 31) == 0) warp_acc[threadIdx.x >> 5] = v;
    __syncthreads();
    if (threadIdx.x == 0) {
        uint32_t acc = 0u;
#pragma unroll
        for (int w = 0; w < kThreads / 32; w++) acc ^= warp_acc[w];
        atomicXor(out, acc);
    }
}

__global__ void __launch_bounds__(kThreads)
probe_kernel(const int* __restrict__ x, int* __restrict__ out, int n) {
    __shared__ volatile int scratch[kThreads];
    const int t = blockIdx.x * kThreads + threadIdx.x;
    if (t >= n) return;
    int v = x[t];
    v = v + 1;
    v = v ^ 3;
    scratch[threadIdx.x] = v;
    int i = 0;
#pragma unroll 1
    while (i < x[0]) {
        scratch[threadIdx.x] = scratch[threadIdx.x] + 1;
        i++;
    }
    out[t] = scratch[threadIdx.x];
}

__global__ void noop_kernel() {}

}  // namespace

// seed: uint32[blocks * 256, kStreams]; out: uint32[blocks * 256].
extern "C" int asm_roofline_issue_chain(const void* seed, void* out,
                                        int blocks, int iters, int device,
                                        void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    issue_chain<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)seed, (uint32_t*)out, iters);
    return (int)cudaGetLastError();
}

template <int OP>
cudaError_t launch_op_chain(const void* seed, void* out, int blocks, int iters, int a,
                            cudaStream_t stream) {
    op_chain<OP><<<blocks, kThreads, 0, stream>>>((const uint32_t*)seed, (uint32_t*)out,
                                                   iters, a);
    return cudaGetLastError();
}

// seed: uint32[blocks * 256, kStreams]; out: uint32[blocks * 256]; op: one
// of OP_* (0 add-min, 1 min / max, 2 compare and select, 3 multiply-add,
// 4 add, 5 add-min and multiply-add, 6 three-way min / max, 7 an add of a
// and a xor with a in turns); a: the operand of add-min, select,
// multiply-add and 7.
extern "C" int asm_roofline_op_chain(const void* seed, void* out, int blocks, int iters,
                                     int a, int op, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const cudaStream_t st = (cudaStream_t)stream;
    switch (op) {
        case OP_VIADDMIN: return (int)launch_op_chain<OP_VIADDMIN>(seed, out, blocks, iters, a, st);
        case OP_MINMAX: return (int)launch_op_chain<OP_MINMAX>(seed, out, blocks, iters, a, st);
        case OP_SETP_SEL: return (int)launch_op_chain<OP_SETP_SEL>(seed, out, blocks, iters, a, st);
        case OP_IMAD: return (int)launch_op_chain<OP_IMAD>(seed, out, blocks, iters, a, st);
        case OP_IADD: return (int)launch_op_chain<OP_IADD>(seed, out, blocks, iters, a, st);
        case OP_MIX: return (int)launch_op_chain<OP_MIX>(seed, out, blocks, iters, a, st);
        case OP_MINMAX3: return (int)launch_op_chain<OP_MINMAX3>(seed, out, blocks, iters, a, st);
        case OP_ADD_XOR: return (int)launch_op_chain<OP_ADD_XOR>(seed, out, blocks, iters, a, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

// x: uint32[4 * n4], 16-byte aligned; out: uint32[1], zeroed by the caller.
extern "C" int asm_roofline_stream_fold(const void* x, long long n4, void* out,
                                        int blocks, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    stream_fold<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint4*)x, (int64_t)n4, (uint32_t*)out);
    return (int)cudaGetLastError();
}

// x, out: int32[n], n >= 1.
extern "C" int asm_roofline_probe(const void* x, void* out, int n, int device,
                                  void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    probe_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                   (cudaStream_t)stream>>>((const int*)x, (int*)out, n);
    return (int)cudaGetLastError();
}

// An empty launch: the dispatch floor.
extern "C" int asm_roofline_noop(int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    noop_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
}
