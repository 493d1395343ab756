// Exact NW/Gotoh penalty and traceback by row strips (sm_90a).
//
// Replaces the Pallas TPU kernels asm_tpu/kernels/nw_pallas.py _nw_kernel
// (wrapper nw_penalty_pallas) and _nw_trace_kernel (wrapper
// nw_align_pallas). G threads per pair (G in {8, 16, 32}, a template
// parameter: 32/G pairs per warp); thread t keeps the R = L/G consecutive
// rows i = R*t + 1 .. R*t + R in registers (H and F of the last column,
// and the read codes; off the tuned table R is rows_per_thread below)
// and sweeps the columns j = 1..n with a lag of one
// column per thread: at step s it computes column j = s - t. The strip's
// top row takes H and E of row R*t at column j from thread t-1, which
// computed them one step earlier, by one __shfl_up_sync each; the H
// received one step earlier is the diagonal input. E, the gap down the
// column, chains the R cells of the column inside the thread; F, the gap
// along the row, stays in the thread. Only cells with 1 <= j <= n are
// computed: the left border (j == 0) is the initial state, the top border
// (i == 0) enters at thread 0 in closed form (o + (j-1)*e, E infinite),
// and the ref code of column j is one shared-memory byte per step. A
// warp runs to the largest n + (m-1)/R among its pairs; H(m, n) is read
// once, after the sweep, from the thread that holds row m.
//
// What bounds it on Hopper: integer issue (the 11 operations of a Gotoh
// cell; the rows past m of a strip and the G-1 steps of lag are the
// slots spent on no real cell), and the chain of the column: each step
// waits on the row above through the R cells of the strip and a shuffle,
// so fewer rows per thread (larger G) shorten the chain and add lag.
//
// The trace kernel keeps 4 bits per cell (bits 0-1 H source 0 sub / 1 E /
// 2 F, bit 2 E opened, bit 3 F opened), column-major, L/2 bytes a column
// (thread t's R rows are R/2 bytes of it, one store per step). ROUTE
// decides where: in shared memory (PTR_SHARED, one warp per block, L*L/2
// bytes per pair beside its codes) or in a global scratch the wrapper
// sizes (PTR_GLOBAL). Only columns 1..n are written. After
// the sweep one thread per pair walks: exactly asm_tpu/kernels/nw.py's
// reverse replay (ties prefer sub, then E, then F; the left border is E,
// opened iff i == 1; the virtual i == 0 cell is F, opened iff j == 1), the
// mismatch bit recomputed from the codes in shared memory. The op of
// diagonal d goes to column 2L - d; every other column holds OP_NONE. The
// '='-run match mask is kept as an L-bit mask in registers and flushed by
// the pair's G threads at the end.
//
// Long rows (L > 512: their own kernels below, so the tuned instantiations
// are the code they were). G <= 32 and R <= 32 rows a thread in registers
// cover L <= 1024 in one sweep; above it the matrix is swept in horizontal
// blocks of 32 x R rows (two at L = 2048), each block's bottom row (8 L
// bytes a pair) parked in shared memory for the next, rather than a pair
// on more than one warp, which would trade its edge rows through shared
// memory and a barrier every step. One pair a warp, 32-thread blocks.
//
// The long full kernel (nw_long_full_kernel) is built for what bounds it
// on Hopper, integer issue: 2L + 12 bytes a pair are nothing beside its L
// x L cells, and a min-plus recurrence has no use for tensor cores.
// - The cell in 7 issue slots, the fewest the recurrence needs (utils/
//   bounds.py GOTOH_CELL_OPS): each row keeps P = H + o, which is both the
//   "up" input of the row below and the "left" input of the next column,
//   so E = min(E_up + e, P_up) and F = min(F_left + e, P_left) are one DPX
//   add-min (VIADDMNMX) each and H = min(P_diag + s', E, F) one add and
//   one three-way DPX min, with s' in {x - o, -o} chosen by one compare
//   and one select, and P = H + o one add. The card issues add-min, min,
//   compare and select on one ALU pipe at half its issue rate (csrc/
//   roofline.cu op_chain), so the cell is 5 slots there, 10 cycles a
//   warp's row, and the two adds issue off it (full_column). The
//   borders, the parked row and the read-out of H(m, n) are kept in P.
// - The step loop in three: its head (the first 31 steps, in which thread
//   t waits for column 1), a steady loop in which every thread has a
//   column of 1..n (no column test, no branch), and its tail. Thread 0's
//   top input (the top border in closed form in one block; above, the
//   parked row, which block 0 finds holding the top border) and thread
//   31's park store are selects and predicated stores, not branches.
// - The read codes 4 to a register (8 registers for 32 rows, not 32): a
//   cell's mismatch is one test of its byte of (codes ^ the ref code in
//   every byte).
// So the ALU pipe bounds it: its 5 slots a cell allow 70% of the 7-slot
// bound (an H100 80GB HBM3 at 700 W ran it with that pipe 92% busy, 59%
// of the bound; PERF.md section 6). The parked row's shared memory leaves
// 12 warps per SM at L = 2048, which cost about 1% there.
//
// The long trace kernel (nw_long_kernel<W, true>) is built for what a
// pair's L x L / 2 pointer bytes cost on Hopper: they live in device
// memory (512 KiB a pair at 1024, 2 MiB at 2048, far past the 50 MB L2
// for a card's worth of pairs), so a walk that reads one cell per step
// waits one device-memory round trip a step, ~2L of them a pair.
// - Pointer bits as planes: each 4-row group of a column is one 16-bit
//   word, bits 0-3 "H is the substitution", 4-7 "E is at most F", 8-11 "E
//   opened", 12-15 "F opened", bit r of each nibble row r of the group.
//   Each flag is one compare of values the cell computes anyway and one
//   add of a constant bit into the strip's words under it, in place of the
//   select chain and shifts of a nibble. A column keeps its L / 2 bytes (4
//   bits a cell) and a strip stores its R / 2 bytes a step as before.
// - The walk reads shared-memory tiles: 64 rows x 64 columns (32 bytes of
//   each column, 2 KiB), the tile the walk is in and the three it can step
//   into next (up, left, up-left), copied with cp.async by the warp's 32
//   lanes while the walk runs; a tile's neighbour that the next tile shares
//   is kept. A step costs a shared-memory load; a pair pays about (m + n)
//   / 64 round trips to device memory rather than m + n. The walk is one
//   sequence: its state is the same on every lane (one instruction stream
//   for the warp), and the lanes share only the copies and the mask's runs.
// - The ops (2L bytes) and the mask (L) are built in shared memory, zeroed
//   with 16-byte stores and written out with 16-byte stores. The walk's
//   tiles, ops and mask (8 KiB + 3L) take the parked row's place where a
//   pair has more than one block, so at L = 2048 a pair's shared bytes do
//   not grow.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kInf = 1 << 29;
constexpr unsigned kFull = 0xFFFFFFFFu;

enum : int8_t { OP_NONE = 0, OP_EQ = 1, OP_X = 2, OP_I = 3, OP_D = 4 };
// where the trace kernel keeps its pointer nibbles (none: the penalty)
enum { PTR_NONE = 0, PTR_GLOBAL = 1, PTR_SHARED = 2 };

struct Params {
    int B, x, o, e, thr;
};

// threads per block: one warp when the pointers take shared memory, so
// that blocks pack the SM finely
__host__ __device__ constexpr int block_threads(int route) { return route == PTR_SHARED ? 32 : 128; }

// rows per thread: ceil(L / G) rounded up to a multiple of 4 (the codes
// load as words, the pointer nibbles store as half words or words). The
// tuned table's G cut L into such strips exactly; at another L the G
// strips may cover RP = R * G > L rows, the rows past L being rows past
// every pair's end, whose cells feed no cell of the pair.
__host__ __device__ constexpr int rows_per_thread(int L, int G) {
    return ((L + G - 1) / G + 3) / 4 * 4;
}

// shared bytes per pair: its ref codes, with the trace its read codes, and
// on the shared route its L * RP / 2 pointer bytes, padded to 64 mod 128
// so that two pairs' column stores fall on different banks
__host__ __device__ constexpr int slot_bytes(int L, int RP, int route) {
    return route == PTR_NONE     ? L
           : route == PTR_GLOBAL ? 2 * L
                                 : ((2 * L + L * RP / 2 + 63) / 128) * 128 + 64;
}

template <int W, int G, int ROUTE>
constexpr size_t smem_bytes() {
    constexpr int L = 32 * W;
    return (size_t)(block_threads(ROUTE) / G) *
           slot_bytes(L, rows_per_thread(L, G) * G, ROUTE);
}

// bits [lo, hi) of word w of an L-bit mask
__device__ __forceinline__ uint32_t span_bits(int lo, int hi, int w) {
    const int a = min(max(lo - 32 * w, 0), 32);
    const int b = min(max(hi - 32 * w, 0), 32);
    const uint32_t ma = a >= 32 ? 0u : (kFull << a);
    const uint32_t mb = b >= 32 ? 0u : (kFull << b);
    return ma & ~mb;
}

// R 4-bit cells (R / 8 words; R == 4: the low half-word) to R / 2 bytes at
// dst (4-byte aligned when R % 8 == 0, else 2-byte aligned)
template <int R>
__device__ __forceinline__ void store_nibbles(uint8_t* dst, const uint32_t* w) {
    if constexpr (R == 4) {
        *(uint16_t*)dst = (uint16_t)w[0];
    } else if constexpr (R == 8) {
        *(uint32_t*)dst = w[0];
    } else if constexpr (R == 16) {
        *(uint2*)dst = make_uint2(w[0], w[1]);
    } else if constexpr (R == 32) {
        *(uint4*)dst = make_uint4(w[0], w[1], w[2], w[3]);
    } else if constexpr (R % 8 == 0) {
#pragma unroll
        for (int q = 0; q < R / 8; q++) ((uint32_t*)dst)[q] = w[q];
    } else {
#pragma unroll
        for (int q = 0; q < R / 4; q++)
            ((uint16_t*)dst)[q] = (uint16_t)(w[q / 2] >> (16 * (q % 2)));
    }
}

template <int W, int G, int ROUTE>
__global__ void __launch_bounds__(block_threads(ROUTE))
nw_kernel(const int8_t* __restrict__ rc, const int8_t* __restrict__ fc,
          const int* __restrict__ rl, const int* __restrict__ fl, Params P,
          int* __restrict__ pen_out, int8_t* __restrict__ ops_out,
          int8_t* __restrict__ mask_out, uint8_t* __restrict__ scratch) {
    constexpr int L = 32 * W;
    constexpr int R = rows_per_thread(L, G);
    constexpr int RP = R * G;  // rows the strips cover, >= L
    constexpr bool kPadded = RP > L;
    constexpr int PPB = block_threads(ROUTE) / G;  // pairs per block
    constexpr int COL = RP / 2;  // pointer bytes of a column
    constexpr bool kTrace = ROUTE != PTR_NONE;
    constexpr int SLOT = slot_bytes(L, RP, ROUTE);
    static_assert(R % 4 == 0 && R <= 32, "rows per thread");
    extern __shared__ __align__(16) uint8_t smem[];

    const int t = threadIdx.x % G;  // the thread's strip
    const int slot = threadIdx.x / G;
    const int64_t p0 = (int64_t)blockIdx.x * PPB;
    if (p0 + (threadIdx.x & ~31) / G >= P.B) return;  // the warp holds no pair
    const int64_t p = p0 + slot;
    const bool live = p < P.B;
    const int x = P.x, o = P.o, e = P.e;
    const int m = live ? min(rl[p], L) : 0, n = live ? min(fl[p], L) : 0;

    // the pair's ref (and read) codes in shared memory; this strip's read
    // codes in registers
    int8_t* s_ref = (int8_t*)smem + slot * SLOT;
    int8_t* s_read = s_ref + L;
    int a[R];
    {
        const uint32_t* src = (const uint32_t*)(rc + p * L) + t * (R / 4);
        const uint32_t* ref = (const uint32_t*)(fc + p * L) + t * (R / 4);
#pragma unroll
        for (int w = 0; w < R / 4; w++) {
            // words past the row (kPadded) read as code 0 and are not kept
            const bool in_row = !kPadded || t * (R / 4) + w < L / 4;
            const uint32_t v = live && in_row ? src[w] : 0u;
#pragma unroll
            for (int b = 0; b < 4; b++) a[4 * w + b] = (int8_t)(v >> (8 * b));
            if (in_row) {
                ((uint32_t*)s_ref)[t * (R / 4) + w] = live ? ref[w] : 0u;
                if (kTrace) ((uint32_t*)s_read)[t * (R / 4) + w] = v;
            }
        }
    }
    uint8_t* ptr = ROUTE == PTR_SHARED ? (uint8_t*)s_ref + 2 * L
                   : ROUTE == PTR_GLOBAL ? scratch + p * (L * COL)
                                         : nullptr;
    __syncwarp();

    // column 0 (the left border): H = E = o + (i-1)*e, F infinite
    int h[R], f[R];
#pragma unroll
    for (int r = 0; r < R; r++) {
        h[r] = o + (R * t + r) * e;
        f[r] = kInf;
    }
    int hb = h[R - 1], eb = h[R - 1];  // bottom row's H and E, last column
    int dg = 0;  // H(R*t, j-1); thread 0 starts at H(0, 0)
    const int steps = (m > 0 && n > 0) ? n + (m - 1) / R : 0;
    const int warp_steps = __reduce_max_sync(kFull, steps);

    for (int s = 1; s <= warp_steps; s++) {
        const int j = s - t;
        // row R*t at column j, from thread t-1's last step
        int uh = __shfl_up_sync(kFull, hb, 1, G);
        int ue = __shfl_up_sync(kFull, eb, 1, G);
        if (t == 0) {  // the top border, H(0, j)
            uh = o + (s - 1) * e;
            ue = kInf;
        }
        const int top = uh;  // the diagonal input of column j + 1
        if (j >= 1 && j <= n) {
            const int b = s_ref[j - 1];
            int hd = dg;
            uint32_t nib[(R + 7) / 8];
#pragma unroll
            for (int w = 0; w < (R + 7) / 8; w++) nib[w] = 0u;
#pragma unroll
            for (int r = 0; r < R; r++) {
                const int sub = hd + (a[r] != b ? x : 0);
                const int e_open = uh + o, e_ext = ue + e;
                const int f_open = h[r] + o, f_ext = f[r] + e;
                const int ev = min(e_open, e_ext);
                const int fv = min(f_open, f_ext);
                const int hv = min(sub, min(ev, fv));
                if (kTrace) {
                    const uint32_t ph = hv == sub ? 0u : (hv == ev ? 1u : 2u);
                    nib[r / 8] |= (ph | ((uint32_t)(e_open <= e_ext) << 2) |
                                   ((uint32_t)(f_open <= f_ext) << 3))
                                  << (4 * (r % 8));
                }
                hd = h[r];
                h[r] = hv;
                f[r] = fv;
                uh = hv;
                ue = ev;
            }
            hb = uh;
            eb = ue;
            if (kTrace) store_nibbles<R>(ptr + (j - 1) * COL + t * (R / 2), nib);
        }
        dg = top;
    }
    if (live) {
        if (m == 0) {
            if (t == 0) pen_out[p] = n == 0 ? 0 : o + (n - 1) * e;
        } else if (t == (m - 1) / R) {
            int v = 0;
#pragma unroll
            for (int r = 0; r < R; r++) v = r == (m - 1) % R ? h[r] : v;
            pen_out[p] = v;
        }
    }
    if (!kTrace) return;

    // ---- traceback ----
    int8_t* ops = ops_out + p * 2 * L;
    if (live) {
#pragma unroll
        for (int w = 0; w < R / 2; w++)
            if (!kPadded || t * (R / 2) + w < L / 2)
                ((uint32_t*)ops)[t * (R / 2) + w] = 0u;
    }
    __syncwarp();  // pointer nibbles and zeroed ops visible to the walker
    uint32_t mk[W];
#pragma unroll
    for (int w = 0; w < W; w++) mk[w] = 0u;
    if (t == 0 && live) {
        const int thr = P.thr < 0 ? 4 * L : P.thr;  // no mask: no run is long enough
        int i = m, j = n, st = 0, run = 0;
        // every move lowers i + j, and the borders lead to (0, 0); the
        // bounds only keep a corrupt nibble from walking off the matrix
        for (int step = 0; (i > 0 || j > 0) && i >= 0 && j >= 0 && step < 2 * L;
             step++) {
            const int d = i + j;
            int ptr_h, e_open, f_open, mis = 0;
            if (i == 0) {  // the virtual top cell: F, opened iff j == 1
                ptr_h = 2;
                e_open = 0;
                f_open = d == 1;
            } else if (j == 0) {  // the left border: E, opened iff i == 1
                ptr_h = 1;
                e_open = i == 1;
                f_open = 0;
            } else {
                const int byte = ptr[(j - 1) * COL + ((i - 1) >> 1)];
                const int nb = (i - 1) & 1 ? byte >> 4 : byte;
                ptr_h = nb & 3;
                e_open = (nb >> 2) & 1;
                f_open = (nb >> 3) & 1;
                mis = s_read[i - 1] != s_ref[j - 1];
            }
            const bool go_diag = st == 0 && ptr_h == 0;
            const bool go_e = (st == 0 && ptr_h == 1) || st == 1;
            const bool go_f = (st == 0 && ptr_h == 2) || st == 2;
            ops[2 * L - d] = go_diag ? (mis ? OP_X : OP_EQ) : (go_e ? OP_I : OP_D);
            // a '=' run ending at read cursor i covered [i, i + run)
            const bool is_eq = go_diag && !mis;
            if (!is_eq && run > 0 && run >= thr) {
#pragma unroll
                for (int w = 0; w < W; w++) mk[w] |= span_bits(i, i + run, w);
            }
            run = is_eq ? run + 1 : 0;
            const int new_st = go_diag ? 0 : (go_e ? (e_open ? 0 : 1) : (f_open ? 0 : 2));
            i -= (go_diag || go_e);
            j -= (go_diag || go_f);
            st = new_st;
        }
        // flush a run still open at the start of the alignment
        if (run > 0 && run >= thr) {
#pragma unroll
            for (int w = 0; w < W; w++) mk[w] |= span_bits(i, i + run, w);
        }
    }
    if (mask_out == nullptr) return;
    // the walker's mask to its pair's threads; thread t writes positions
    // R*t .. R*t + R-1, which lie in one word when R divides 32, else in
    // two
    constexpr bool kOneWord = 32 % R == 0;
    const int src = (threadIdx.x & 31) - t;
    uint32_t mine = 0, next = 0;
#pragma unroll
    for (int w = 0; w < W; w++) {
        const uint32_t v = __shfl_sync(kFull, mk[w], src);
        if (w == (R * t) / 32) mine = v >> ((R * t) % 32);
        if (!kOneWord && w == (R * t) / 32 + 1) next = v;
    }
    if (!kOneWord && (R * t) % 32) mine |= next << (32 - (R * t) % 32);
    if (!live) return;
    uint32_t* m32 = (uint32_t*)(mask_out + p * L) + t * (R / 4);
#pragma unroll
    for (int w = 0; w < R / 4; w++) {
        uint32_t out = 0;
#pragma unroll
        for (int b = 0; b < 4; b++) out |= ((mine >> (4 * w + b)) & 1u) << (8 * b);
        if (!kPadded || t * (R / 4) + w < L / 4) m32[w] = out;
    }
}

// cp.async of 16 bytes from device to shared memory (cached in L2 only),
// the commit of the copies started so far as one group, and the wait until
// at most N groups are in flight
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- the long-row path (W > kShortW): 32 threads, one warp, a pair ----
// A pair's rows are swept in NB horizontal blocks of RB = 32 * R rows
// (NB = ceil(L / 1024), so R <= 32 rows a thread stay in registers):
// block b is the strip sweep above with the top border taken from block
// b-1's bottom row, which its last thread parks in shared memory column by
// column (8 bytes a column) and the next block's thread 0 reads at the
// same column. Thread 31 writes column j at step j + 31 and thread 0 read
// it at step j, so one row buffer serves every block; a block ends with
// __syncwarp. A pair runs only the blocks down to its row m. The penalty
// is nw_long_full_kernel; the trace kernel (nw_long_kernel<W, true>)
// parks H and E, and its pointer planes go to the global scratch, each
// column RP / 2 bytes (RP = NB * RB rows, >= L); the walk (long_walk)
// follows.
constexpr int kShortW = 16;
constexpr int kLongG = 32;  // threads a pair on the long path
constexpr int kBlockRows = 1024;  // rows of a block at most: 32 x 32
// the long walk's tiles: 64 rows (32 bytes of a column) x 64 columns, four
// of them (the walk's and its neighbours up, left and up-left)
constexpr int kTileRows = 64;
constexpr int kTileCols = 64;
constexpr int kTileBytes = kTileRows / 2 * kTileCols;
constexpr int kTileSlots = 4;

__host__ __device__ constexpr int long_blocks(int L) {
    return (L + kBlockRows - 1) / kBlockRows;
}

// rows per thread of the long path: each block's share of L, in strips
__host__ __device__ constexpr int long_rows(int L) {
    return rows_per_thread((L + long_blocks(L) - 1) / long_blocks(L), kLongG);
}

// shared bytes of a pair on the long path: its ref codes, with the trace
// its read codes; then with more than one block the parked row (H, E),
// which the trace's walk buffers (tiles, ops, mask) reuse after the sweep
__host__ __device__ constexpr int long_slot_bytes(int L, bool trace) {
    const int park = long_blocks(L) > 1 ? 8 * L : 0;
    const int walk = trace ? kTileSlots * kTileBytes + 3 * L : 0;
    return (trace ? 2 * L : L) + (park > walk ? park : walk);
}

// the copy of tile (I, J) into `slot`: rows [64 I, 64 I + 64) of the
// pair's columns [64 J, 64 J + 64) below n, 32 bytes a column, two
// 16-byte copies a column spread over the warp's lanes
__device__ __forceinline__ void fetch_tile(uint8_t* slot, const uint8_t* ptr,
                                           int col_bytes, int I, int J, int n) {
    const int c0 = kTileCols * J;
    const int items = 2 * min(kTileCols, n - c0);
    const uint8_t* src = ptr + (int64_t)c0 * col_bytes + kTileRows / 2 * I;
    for (int k = threadIdx.x; k < items; k += kLongG)
        cp_async16(slot + 16 * k, src + (int64_t)(k >> 1) * col_bytes + 16 * (k & 1));
}

// the mask's bytes [lo, hi) set, the warp's lanes in turn
__device__ __forceinline__ void mark_run(int8_t* s_mask, int lo, int hi) {
    for (int q = lo + (int)threadIdx.x; q < hi; q += kLongG) s_mask[q] = 1;
}

// The long trace kernel's traceback (see the head of the file): the walk
// from (m, n) to (0, 0), exactly asm_tpu/kernels/nw.py's reverse replay as
// the short path walks it, reading the pointer planes of `ptr` (COL bytes
// a column) from shared-memory tiles in `walk`, then the ops and mask rows
// out. Every lane runs it, with the same state.
template <int L, int COL>
__device__ __forceinline__ void long_walk(const uint8_t* __restrict__ ptr,
                                          const int8_t* s_read,
                                          const int8_t* s_ref, uint8_t* walk,
                                          int m, int n, int thr_in,
                                          int8_t* __restrict__ ops,
                                          int8_t* __restrict__ mk) {
    const int lane = threadIdx.x;
    int8_t* const s_ops = (int8_t*)walk + kTileSlots * kTileBytes;
    int8_t* const s_mask = s_ops + 2 * L;
    for (int w = lane; w < 3 * L / 16; w += kLongG)
        ((uint4*)s_ops)[w] = make_uint4(0u, 0u, 0u, 0u);
    __syncwarp();
    const int thr = thr_in < 0 ? 4 * L : thr_in;  // no mask: no run is long enough
    int i = m, j = n, st = 0, run = 0;
    if (i > 0 && j > 0) {
        int I = (i - 1) / kTileRows, J = (j - 1) / kTileCols;
        // slots of the walk's tile and of its neighbours up, left, up-left
        int cur = 0, su = 1, sl = 2, sd = 3;
        fetch_tile(walk + cur * kTileBytes, ptr, COL, I, J, n);
        cp_async_commit();
        if (I > 0) fetch_tile(walk + su * kTileBytes, ptr, COL, I - 1, J, n);
        if (J > 0) fetch_tile(walk + sl * kTileBytes, ptr, COL, I, J - 1, n);
        if (I > 0 && J > 0) fetch_tile(walk + sd * kTileBytes, ptr, COL, I - 1, J - 1, n);
        cp_async_commit();
        cp_async_wait<1>();
        __syncwarp();
        int qi = i - 1 - kTileRows * I, qj = j - 1 - kTileCols * J;  // in the tile
        const uint8_t* tb = walk + cur * kTileBytes;
        while (true) {
            // the cell's 4-row group word, shifted so that its row's flags
            // are bits 0 (sub), 4 (E before F), 8 (E opened), 12 (F opened)
            const uint32_t nb =
                (uint32_t)*(const uint16_t*)(tb + qj * (kTileRows / 2) + (qi >> 2) * 2) >>
                (qi & 3);
            const bool mis = s_read[i - 1] != s_ref[j - 1];
            const bool go_diag = st == 0 && (nb & 1u);
            const bool go_e = st == 1 || (st == 0 && !(nb & 1u) && (nb & 16u));
            s_ops[2 * L - (i + j)] = go_diag ? (mis ? OP_X : OP_EQ) : (go_e ? OP_I : OP_D);
            // a '=' run ending at read cursor i covered [i, i + run)
            const bool is_eq = go_diag && !mis;
            if (!is_eq && run > 0 && run >= thr) mark_run(s_mask, i, i + run);
            run = is_eq ? run + 1 : 0;
            st = go_diag ? 0 : (go_e ? ((nb & 256u) ? 0 : 1) : ((nb & 4096u) ? 0 : 2));
            const int di = go_diag || go_e, dj = go_diag || !go_e;
            i -= di;
            j -= dj;
            qi -= di;
            qj -= dj;
            if (i == 0 || j == 0) break;
            if ((qi | qj) < 0) {  // into the tile up, left or up-left
                cp_async_wait<0>();
                __syncwarp();
                const int was = cur;
                if (qi < 0 && qj < 0) {
                    cur = sd;
                    sd = was;  // su and sl keep their slots, all three new
                    I--;
                    J--;
                } else if (qi < 0) {
                    cur = su;
                    su = was;
                    const int t = sl;
                    sl = sd;  // the old up-left is the new left
                    sd = t;
                    I--;
                } else {
                    cur = sl;
                    sl = was;
                    const int t = su;
                    su = sd;  // the old up-left is the new up
                    sd = t;
                    J--;
                }
                const bool was_diag = qi < 0 && qj < 0;
                if (I > 0 && (was_diag || qi < 0))
                    fetch_tile(walk + su * kTileBytes, ptr, COL, I - 1, J, n);
                if (J > 0 && (was_diag || qj < 0))
                    fetch_tile(walk + sl * kTileBytes, ptr, COL, I, J - 1, n);
                if (I > 0 && J > 0)
                    fetch_tile(walk + sd * kTileBytes, ptr, COL, I - 1, J - 1, n);
                cp_async_commit();
                if (qi < 0) qi += kTileRows;
                if (qj < 0) qj += kTileCols;
                tb = walk + cur * kTileBytes;
            }
        }
        cp_async_wait<0>();  // no copy outlives the walk
    }
    // the borders: at j == 0 the rest is i steps of I (E down the left
    // border), at i == 0 j steps of D; the first of them ends a '=' run
    if (run > 0 && run >= thr) mark_run(s_mask, i, i + run);
    if (i > 0 || j > 0) {
        const int8_t op = i > 0 ? OP_I : OP_D;
        for (int c = 2 * L - (i + j) + lane; c < 2 * L; c += kLongG) s_ops[c] = op;
    }
    __syncwarp();
    for (int w = lane; w < 2 * L / 16; w += kLongG) ((uint4*)ops)[w] = ((const uint4*)s_ops)[w];
    if (mk != nullptr)
        for (int w = lane; w < L / 16; w += kLongG) ((uint4*)mk)[w] = ((const uint4*)s_mask)[w];
}

// The long trace kernel (TRACE is true: the penalty alone is
// nw_long_full_kernel below)
template <int W, bool TRACE>
__global__ void __launch_bounds__(kLongG)
nw_long_kernel(const int8_t* __restrict__ rc, const int8_t* __restrict__ fc,
               const int* __restrict__ rl, const int* __restrict__ fl,
               Params P, int* __restrict__ pen_out,
               int8_t* __restrict__ ops_out, int8_t* __restrict__ mask_out,
               uint8_t* __restrict__ scratch) {
    static_assert(TRACE, "the long penalty is nw_long_full_kernel");
    constexpr int L = 32 * W;
    constexpr int G = kLongG;
    constexpr int NB = long_blocks(L);
    constexpr int R = long_rows(L);
    constexpr int RB = R * G;    // rows of a block
    constexpr int RP = NB * RB;  // rows the blocks cover, >= L
    constexpr int COL = RP / 2;  // pointer bytes of a column
    static_assert(R % 4 == 0 && R <= 32, "rows per thread");
    extern __shared__ __align__(16) uint8_t smem[];

    const int t = threadIdx.x;  // the thread's strip in every block
    const int64_t p = blockIdx.x;
    const int x = P.x, o = P.o, e = P.e;
    const int m = min(rl[p], L), n = min(fl[p], L);
    int8_t* const s_ref = (int8_t*)smem;
    int8_t* const s_read = s_ref + L;
    int* const park_h = (int*)(smem + 2 * L);
    int* const park_e = park_h + L;
    {
        const uint32_t* ref = (const uint32_t*)(fc + p * L);
        const uint32_t* src = (const uint32_t*)(rc + p * L);
        for (int w = t; w < L / 4; w += G) {
            ((uint32_t*)s_ref)[w] = ref[w];
            ((uint32_t*)s_read)[w] = src[w];
        }
    }
    uint8_t* const ptr = scratch + p * ((int64_t)L * COL);
    __syncwarp();

    const int nb = (m > 0 && n > 0) ? (m - 1) / RB + 1 : 0;
    for (int b = 0; b < nb; b++) {
        const int row0 = b * RB + R * t;  // rows row0 + 1 .. row0 + R
        int a[R];
        {
            const uint32_t* src = (const uint32_t*)(rc + p * L) + row0 / 4;
#pragma unroll
            for (int w = 0; w < R / 4; w++) {
                // words past the row read as code 0; their rows feed no
                // cell of the pair
                const uint32_t v = row0 / 4 + w < L / 4 ? src[w] : 0u;
#pragma unroll
                for (int q = 0; q < 4; q++) a[4 * w + q] = (int8_t)(v >> (8 * q));
            }
        }
        // column 0 (the left border): H = E = o + (i-1)*e, F infinite
        int h[R], f[R];
#pragma unroll
        for (int r = 0; r < R; r++) {
            h[r] = o + (row0 + r) * e;
            f[r] = kInf;
        }
        int hb = h[R - 1], eb = h[R - 1];
        // thread 0's diagonal input at column 1: H(b * RB, 0)
        int dg = b == 0 ? 0 : o + (b * RB - 1) * e;
        // the last block runs until the thread holding row m reaches
        // column n; the others until their last thread does
        const int steps = b < nb - 1 ? n + G - 1 : n + (m - 1 - b * RB) / R;
        for (int s = 1; s <= steps; s++) {
            const int j = s - t;
            int uh = __shfl_up_sync(kFull, hb, 1);
            int ue = __shfl_up_sync(kFull, eb, 1);
            if (t == 0) {
                if (b == 0) {  // the top border, H(0, j)
                    uh = o + (s - 1) * e;
                    ue = kInf;
                } else if (s <= n) {  // block b-1's bottom row
                    uh = park_h[s - 1];
                    ue = park_e[s - 1];
                }
            }
            const int top = uh;
            if (j >= 1 && j <= n) {
                const int bc = s_ref[j - 1];
                int hd = dg;
                // the trace's pointer planes: word r / 8 holds rows 8(r / 8)
                // .. +7, two 4-row groups of 16 bits (layout: head of file)
                uint32_t nib[(R + 7) / 8];
#pragma unroll
                for (int w = 0; w < (R + 7) / 8; w++) nib[w] = 0u;
#pragma unroll
                for (int r = 0; r < R; r++) {
                    const int sub = hd + (a[r] != bc ? x : 0);
                    const int e_open = uh + o, e_ext = ue + e;
                    const int f_open = h[r] + o, f_ext = f[r] + e;
                    const int ev = min(e_open, e_ext);
                    const int fv = min(f_open, f_ext);
                    // the three-way min (one DPX instruction): the flags
                    // below need the sum sub apart, so the full kernel's
                    // fused add-min does not apply
                    const int hv = __vimin3_s32(sub, ev, fv);
                    // ties: sub, then E, then F (the E flag is read only
                    // where H is not sub); a gap opens on a tie
                    const uint32_t bit = 1u << (16 * ((r >> 2) & 1) + (r & 3));
                    if (hv == sub) nib[r / 8] |= bit;
                    if (hv == ev) nib[r / 8] |= bit << 4;
                    if (e_open <= e_ext) nib[r / 8] |= bit << 8;
                    if (f_open <= f_ext) nib[r / 8] |= bit << 12;
                    hd = h[r];
                    h[r] = hv;
                    f[r] = fv;
                    uh = hv;
                    ue = ev;
                }
                hb = uh;
                eb = ue;
                if (t == G - 1 && b < nb - 1) {
                    park_h[j - 1] = hb;
                    park_e[j - 1] = eb;
                }
                store_nibbles<R>(ptr + (j - 1) * COL + (row0 >> 1), nib);
            }
            dg = top;
        }
        if (b == nb - 1 && t == (m - 1 - b * RB) / R) {
            int v = 0;
#pragma unroll
            for (int r = 0; r < R; r++) v = r == (m - 1 - b * RB) % R ? h[r] : v;
            pen_out[p] = v;
        }
        __syncwarp();
    }
    if (nb == 0 && t == 0)  // an empty side: the border's closed form
        pen_out[p] = m + n == 0 ? 0 : o + (m + n - 1) * e;
    long_walk<L, COL>(ptr, s_read, s_ref, smem + 2 * L, m, n, P.thr, ops_out + p * 2 * L,
                      mask_out == nullptr ? nullptr : mask_out + p * L);
}

// One column of a long full kernel's strip (the head of the file: 7 issue
// slots a cell): the thread's R rows at one column, top to bottom, from
// the row above's P and E at this column (up, ue) and its P at the column
// before (dp); pv and f hold each row's P and F of the column before and
// take this column's; up and ue leave as the strip's bottom row's. A row's
// diagonal sum P_diag + s' is formed for the row below before its own P is
// overwritten, so no register is copied. Both adds of a cell issue off
// the ALU pipe, which takes add-min, min, compare and select at half the
// card's rate (csrc/roofline.cu op_chain): P = H + o as VIADD, and
// P_diag + s' as a multiply-add by `one` (1, a kernel argument ptxas
// cannot see): a plain add there it fuses with the three-way min into an
// add-min and a min, both on the ALU pipe.
template <int R>
__device__ __forceinline__ void full_column(int (&pv)[R], int (&f)[R], const uint32_t (&a4)[R / 4],
                                            int bc, int& up, int& ue, int dp, int o, int e,
                                            int xo, int mo, int one) {
    const uint32_t b4 = (uint32_t)(uint8_t)bc * 0x01010101u;  // the ref code in every byte
    // s' of row r: x - o where its read code differs from the ref code, else -o
    const auto sub = [&](int r) {
        return ((a4[r / 4] ^ b4) & (0xFFu << (8 * (r % 4)))) != 0u ? xo : mo;
    };
    int ds = dp * one + sub(0);  // P_diag + s' of row 0
#pragma unroll
    for (int r = 0; r < R; r++) {
        const int ev = __viaddmin_s32(ue, e, up);       // min(E_up + e, P_up)
        const int fv = __viaddmin_s32(f[r], e, pv[r]);  // min(F_left + e, P_left)
        const int dn = r + 1 < R ? pv[r] * one + sub(r + 1) : 0;  // the row below's
        const int hv = __vimin3_s32(ds, ev, fv);         // min(P_diag + s', E, F)
        pv[r] = hv + o;
        f[r] = fv;
        up = pv[r];
        ue = ev;
        ds = dn;
    }
}

// One step s of a long full kernel's block: the row above from thread t-1
// (thread 0: the top border in closed form in one block, else the parked
// row) and, where GUARD, the test that the thread's column j = s - t is in
// 1..n; thread 31 parks its bottom row where `parks`. bp and be carry the
// strip's bottom row (P, E), dg the row above's P at the column before.
template <int R, int NB, bool GUARD>
__device__ __forceinline__ void full_step(int s, int t, int n, int o, int e, int xo, int mo,
                                          int one, const int8_t* s_ref, int2* park, bool parks,
                                          int (&pv)[R], int (&f)[R], const uint32_t (&a4)[R / 4],
                                          int& bp, int& be, int& dg) {
    int up = __shfl_up_sync(kFull, bp, 1);
    int ue = __shfl_up_sync(kFull, be, 1);
    int top_p, top_e;
    if constexpr (NB > 1) {
        // past column n (the tail) thread 0 reads a column it does not use
        const int2 v = park[(GUARD ? min(s, n) : s) - 1];
        top_p = v.x;
        top_e = v.y;
    } else {
        top_p = 2 * o + (s - 1) * e;
        top_e = kInf;
    }
    up = t == 0 ? top_p : up;
    ue = t == 0 ? top_e : ue;
    const int j = s - t;
    const int dp = dg;
    dg = up;
    if (!GUARD || (j >= 1 && j <= n)) {
        full_column<R>(pv, f, a4, s_ref[j - 1], up, ue, dp, o, e, xo, mo, one);
        bp = up;
        be = ue;
        if (parks) park[j - 1] = make_int2(bp, be);
    }
}

// The long full kernel: the Gotoh penalty above max_len 512 (the head of
// the file), one pair a 32-thread block, the blocks of rows of the long
// path. Shared memory: the ref codes (L bytes) and, with more than one
// block, the parked row (P, E) by column, which block 0 finds holding the
// top border. `one` is 1 (full_column says why).
template <int W>
__global__ void __launch_bounds__(kLongG)
nw_long_full_kernel(const int8_t* __restrict__ rc, const int8_t* __restrict__ fc,
                    const int* __restrict__ rl, const int* __restrict__ fl, Params P,
                    int* __restrict__ pen_out, int one) {
    constexpr int L = 32 * W;
    constexpr int G = kLongG;
    constexpr int NB = long_blocks(L);
    constexpr int R = long_rows(L);
    constexpr int RB = R * G;  // rows of a block
    static_assert(R % 4 == 0 && R <= 32, "rows per thread");
    extern __shared__ __align__(16) uint8_t smem[];

    const int t = threadIdx.x;  // the thread's strip in every block
    const int64_t p = blockIdx.x;
    const int o = P.o, e = P.e;
    const int xo = P.x - o, mo = -o;  // s' of a mismatch and of a match
    const int m = min(rl[p], L), n = min(fl[p], L);
    int8_t* const s_ref = (int8_t*)smem;
    int2* const park = (int2*)(smem + L);  // (P, E) of a block's bottom row, by column
    {
        const uint32_t* ref = (const uint32_t*)(fc + p * L);
        for (int w = t; w < L / 4; w += G) ((uint32_t*)s_ref)[w] = ref[w];
    }
    if constexpr (NB > 1) {  // the top border, P(0, j) = 2o + (j-1)e, E infinite
        for (int j = t; j < n; j += G) park[j] = make_int2(2 * o + j * e, kInf);
    }
    __syncwarp();

    const int nb = (m > 0 && n > 0) ? (m - 1) / RB + 1 : 0;
    for (int b = 0; b < nb; b++) {
        const int row0 = b * RB + R * t;  // rows row0 + 1 .. row0 + R
        const bool parks = t == G - 1 && b < nb - 1;
        uint32_t a4[R / 4];
        {
            const uint32_t* src = (const uint32_t*)(rc + p * L) + row0 / 4;
#pragma unroll
            for (int w = 0; w < R / 4; w++)
                // words past the row read as code 0; their rows feed no
                // cell of the pair
                a4[w] = row0 / 4 + w < L / 4 ? src[w] : 0u;
        }
        // column 0 (the left border): H = o + (i-1)*e, so P = 2o + (i-1)*e;
        // F infinite
        int pv[R], f[R];
#pragma unroll
        for (int r = 0; r < R; r++) {
            pv[r] = 2 * o + (row0 + r) * e;
            f[r] = kInf;
        }
        int bp = pv[R - 1], be = kInf;  // the bottom row's P and E, last column
        // thread 0's diagonal input at column 1: P(b * RB, 0)
        int dg = b == 0 ? o : 2 * o + (b * RB - 1) * e;
        // the last block runs until the thread holding row m reaches
        // column n; the others until their last thread does
        const int steps = b < nb - 1 ? n + G - 1 : n + (m - 1 - b * RB) / R;
        int s = 1;
        // the head: thread t waits for column 1 until step t + 1
        for (const int end = min(G - 1, steps); s <= end; s++)
            full_step<R, NB, true>(s, t, n, o, e, xo, mo, one, s_ref, park, parks, pv, f, a4,
                                   bp, be, dg);
        // the steady loop: every thread's column is in 1..n
        for (; s <= n; s++)
            full_step<R, NB, false>(s, t, n, o, e, xo, mo, one, s_ref, park, parks, pv, f, a4,
                                    bp, be, dg);
        // the tail: thread t has passed column n from step n + t + 1
        for (; s <= steps; s++)
            full_step<R, NB, true>(s, t, n, o, e, xo, mo, one, s_ref, park, parks, pv, f, a4,
                                   bp, be, dg);
        if (b == nb - 1 && t == (m - 1 - b * RB) / R) {
            int v = 0;
#pragma unroll
            for (int r = 0; r < R; r++) v = r == (m - 1 - b * RB) % R ? pv[r] : v;
            pen_out[p] = v - o;
        }
        __syncwarp();
    }
    if (nb == 0 && t == 0)  // an empty side: the border's closed form
        pen_out[p] = m + n == 0 ? 0 : o + (m + n - 1) * e;
}

// The instantiations the wrappers launch, by W = L / 32 and kernel: G
// threads per pair, each the fastest of 8, 16 and 32 on the card (PERF.md
// section 5; at L = 512 of 16 and 32: G = 8 would hold 64 rows a thread),
// and where the trace kernel keeps its pointers: in shared memory at L =
// 128 (12 warps per SM at G = 16), in the global scratch at L = 256 (32 KB
// per pair in shared memory leaves at most 6 warps per SM; the fastest
// shared-memory variant, G = 32, ran 1.5x slower there) and at L = 512
// (128 KB a pair).
template <int W, bool TRACE> struct Inst;
template <> struct Inst<4, false> { static constexpr int G = 8, ROUTE = PTR_NONE; };
template <> struct Inst<8, false> { static constexpr int G = 8, ROUTE = PTR_NONE; };
template <> struct Inst<16, false> { static constexpr int G = 16, ROUTE = PTR_NONE; };
template <> struct Inst<4, true> { static constexpr int G = 16, ROUTE = PTR_SHARED; };
template <> struct Inst<8, true> { static constexpr int G = 8, ROUTE = PTR_GLOBAL; };
template <> struct Inst<16, true> { static constexpr int G = 16, ROUTE = PTR_GLOBAL; };
// A library built for one W outside that table (kernels/shapes.py: -D
// ASM_SHAPE_W, ASM_NW_G, ASM_NW_TRACE_G, ASM_NW_TRACE_ROUTE) holds that
// W alone, its G and route chosen by the rule behind the table: G8 up to
// W = 8, G16 above; the trace pointers in shared memory up to W = 4, in
// the global scratch above. Not swept.
#ifdef ASM_SHAPE_W
template <> struct Inst<ASM_SHAPE_W, false> { static constexpr int G = ASM_NW_G, ROUTE = PTR_NONE; };
template <> struct Inst<ASM_SHAPE_W, true> {
    static constexpr int G = ASM_NW_TRACE_G, ROUTE = ASM_NW_TRACE_ROUTE;
};
#endif

struct Launch {
    const void *rc, *fc, *rl, *fl;
    Params P;
    void *pen, *ops, *mask, *scratch;
    cudaStream_t stream;
};

// the long path's launch: one 32-thread block a pair; the penalty from
// nw_long_full_kernel, the trace from nw_long_kernel with its pointers in
// the global scratch
template <int W, bool TRACE>
cudaError_t run_long(const Launch* L, int* warps) {
    const void* kernel = TRACE ? (const void*)nw_long_kernel<W, true>
                               : (const void*)nw_long_full_kernel<W>;
    constexpr size_t smem = long_slot_bytes(32 * W, TRACE);
    static const cudaError_t prepared = [&] {
        cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
        return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                    (int)cudaSharedmemCarveoutMaxShared);
    }();
    if (prepared != cudaSuccess) return prepared;
    if (L == nullptr) {
        int blocks = 0;
        const cudaError_t err =
            cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kLongG, smem);
        *warps = blocks;
        return err;
    }
    if constexpr (TRACE) {
        if (L->scratch == nullptr) return cudaErrorInvalidValue;
        nw_long_kernel<W, true><<<L->P.B, kLongG, smem, L->stream>>>(
            (const int8_t*)L->rc, (const int8_t*)L->fc, (const int*)L->rl,
            (const int*)L->fl, L->P, (int*)L->pen, (int8_t*)L->ops,
            (int8_t*)L->mask, (uint8_t*)L->scratch);
    } else {
        nw_long_full_kernel<W><<<L->P.B, kLongG, smem, L->stream>>>(
            (const int8_t*)L->rc, (const int8_t*)L->fc, (const int*)L->rl,
            (const int*)L->fl, L->P, (int*)L->pen, 1);
    }
    return cudaGetLastError();
}

// launches the instantiation of (W, TRACE), or with L == nullptr stores its
// resident warps per SM in *warps
template <int W, bool TRACE>
cudaError_t run(const Launch* L, int* warps) {
    if constexpr (W > kShortW) {
        return run_long<W, TRACE>(L, warps);
    } else {
    constexpr int G = Inst<W, TRACE>::G, ROUTE = Inst<W, TRACE>::ROUTE;
    static_assert(TRACE == (ROUTE != PTR_NONE), "route");
    auto* kernel = nw_kernel<W, G, ROUTE>;
    constexpr int threads = block_threads(ROUTE);
    constexpr size_t smem = smem_bytes<W, G, ROUTE>();
    // max dynamic shared memory and the carveout that gives shared memory
    // the most of the SM, once per instantiation
    static const cudaError_t prepared = [&] {
        cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
        return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                    (int)cudaSharedmemCarveoutMaxShared);
    }();
    if (prepared != cudaSuccess) return prepared;
    if (L == nullptr) {
        int blocks = 0;
        const cudaError_t err =
            cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
        *warps = blocks * threads / 32;
        return err;
    }
    if (ROUTE == PTR_GLOBAL && L->scratch == nullptr) return cudaErrorInvalidValue;
    constexpr int ppb = threads / G;
    const int blocks = (L->P.B + ppb - 1) / ppb;
    kernel<<<blocks, threads, smem, L->stream>>>(
        (const int8_t*)L->rc, (const int8_t*)L->fc, (const int*)L->rl,
        (const int*)L->fl, L->P, (int*)L->pen, (int8_t*)L->ops,
        (int8_t*)L->mask, (uint8_t*)L->scratch);
    return cudaGetLastError();
    }
}

cudaError_t dispatch(int W, bool trace, const Launch* L, int* warps) {
#ifdef ASM_SHAPE_W
    if (W == ASM_SHAPE_W)
        return trace ? run<ASM_SHAPE_W, true>(L, warps) : run<ASM_SHAPE_W, false>(L, warps);
#else
    if (W == 4) return trace ? run<4, true>(L, warps) : run<4, false>(L, warps);
    if (W == 8) return trace ? run<8, true>(L, warps) : run<8, false>(L, warps);
    if (W == 16) return trace ? run<16, true>(L, warps) : run<16, false>(L, warps);
#endif
    return cudaErrorInvalidValue;
}

// (G, route) of the instantiations at W
template <int W>
void instance_of(bool trace, int* G, int* route) {
    *G = trace ? Inst<W, true>::G : Inst<W, false>::G;
    *route = trace ? Inst<W, true>::ROUTE : Inst<W, false>::ROUTE;
}

}  // namespace

// rc/fc: int8 codes [B, 32W] (rows 4-byte aligned); rl/fl: int32[B]; pen:
// int32[B] out. trace 0: the penalty only (ops, mask, scratch unused).
// trace 1: ops int8[B, 64W] out, mask (NULL, or bool[B, 32W] out), and
// where the instantiation keeps its pointers in the global scratch,
// scratch uint8[B, 32W * RP / 2], RP = rows_per_thread(32W, G) * G (32W
// in the tuned table; written before it is read). Returns the
// launch's cudaError_t (0 on success); does not synchronise.
extern "C" int asm_nw_launch(const void* rc, const void* fc, const void* rl,
                             const void* fl, int B, int W, int trace, int x,
                             int o, int e, int thr, void* pen, void* ops,
                             void* mask, void* scratch, int device, void* stream) {
    if (B <= 0) return 0;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (trace && ops == nullptr) return (int)cudaErrorInvalidValue;
    const Launch L{rc, fc, rl, fl, Params{B, x, o, e, thr}, pen, ops, mask,
                   scratch, (cudaStream_t)stream};
    return (int)dispatch(W, trace != 0, &L, nullptr);
}

// the instantiation of (W, trace): G threads per pair and its route (0 the
// penalty, 1 the global scratch, 2 shared memory); 0, or cudaErrorInvalidValue
// for a W that is not built
extern "C" int asm_nw_instance(int W, int trace, int* G, int* route) {
#ifdef ASM_SHAPE_W
    if (W == ASM_SHAPE_W) instance_of<ASM_SHAPE_W>(trace, G, route);
    else return (int)cudaErrorInvalidValue;
    return 0;
#endif
    if (W == 4) instance_of<4>(trace, G, route);
    else if (W == 8) instance_of<8>(trace, G, route);
    else if (W == 16) instance_of<16>(trace, G, route);
    else return (int)cudaErrorInvalidValue;
    return 0;
}

// resident warps per SM of the instantiation of (W, trace) on the current
// device, with the shared memory its launch uses; -cudaError on failure
extern "C" int asm_nw_occupancy(int W, int trace) {
    int warps = 0;
    const cudaError_t err = dispatch(W, trace != 0, nullptr, &warps);
    return err == cudaSuccess ? warps : -(int)err;
}
