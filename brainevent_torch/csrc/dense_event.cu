// Copyright 2026 The brainevent-tpu Authors.
// Licensed under the Apache License, Version 2.0.
//
// K15 and K16: the dense event products of brainevent_torch/dense
// (pallas_kernels.py), over a row-major weight matrix W (float32, or
// float64 in the double instances, for float64 weights) and spikes
// s whose values pass through the product gate of be_load_op (common.cuh):
// a bool spike (one byte) on its truth, a float spike at > 0. An active
// spike adds the bare weight; its value never scales it.
//
// K15 `dense_event_mv` replaces brainevent_tpu/dense/binary.py:
// _densemv_pallas_kernel (:81), a tiled MXU matvec that reads all of W:
//   - transpose (s @ W, W (k, m)): y[j] = sum over active rows i of W[i, j];
//   - otherwise (W @ s, W (m, k)): y[i] = sum over active j of W[i, j].
// Only the weights of active events are read. A gate pass writes one 32-bit
// ballot word for each 32 gates into a scratch the wrapper allocates; then
// each block walks the gates in tiles of 16,384: its threads read the
// tile's words, count their set bits, take a prefix sum across the block,
// and write the tile's active indices, ascending, into shared memory.
// (Building the words in each block from the raw gates instead, with no
// gate pass, took 1.9x as long for s @ W on the H100, 1.45x for W @ s.)
//   - s @ W: a block of 64 threads owns 64 columns; each thread adds its
//     column's weights over the list in order, 32 loads in flight, so a
//     warp reads each active row as 128 contiguous bytes. Each output is
//     the plain ascending-row sum of its active weights, rounded once per
//     add: bitwise the ordered loop y += W[i] * g(s[i]) (a 0/1 gate makes
//     each product exact).
//   - W @ s: a warp owns a row; its lanes take the list's entries 32 apart,
//     8 loads in flight, and a fixed xor-shuffle tree combines them. A
//     thread per row, which would add in order, took 1.41x as long on the
//     H100 (each of its loads reads a sector in each of 32 rows).
//   Either way a repeat gives the same bits. Bound: the bytes of the active
//   rows of W (transpose) or one 32-byte sector per active weight
//   (otherwise). What it does not count: the gate pass's launch, and, for
//   s @ W, the latency of dependent loads over one thread per column.
//
// K16 `dense_event_mm` replaces _densemm_pallas_kernel (:267):
//   Y = W @ g(S) (W (m, k)) or W.T @ g(S) (transpose, W (k, m)), S (k, n),
//   Y (m, n). The TPU kernel is a tiled MXU product that skips all-zero
//   gate tiles (dense/binary.py:291); a tile product on the CUDA cores does
//   all 2 m k n operations (25.6 GFLOP at (10k, 10k, 128)) and, at 1%
//   spikes, never finds an all-zero tile. Here it is an event gather:
//   - a mask pass reads S once and writes, per 64-row k tile, one 64-bit
//     gate mask per column, the OR of each 32-column group's masks (the k
//     rows the group needs), and per 8 columns an event record: the
//     columns' active k offsets, column by column in ascending k;
//   - a block owns 64 output rows and 64 columns and walks k in tiles of
//     64 in ascending order. A tile that no column of the block needs is
//     skipped, copy and all; otherwise the 16-byte pieces of the W tile
//     that hold a needed k row (whole needed rows of W (k, m), which are
//     contiguous) are copied into shared memory through a ring of
//     cp.async stages, several tiles ahead of the sum. W is read once a
//     column range;
//   - a warp sums 2 rows a lane and 8 columns: it adds the weights of the
//     k rows its record lists (so its work follows the events, not the
//     k x n gate bits), or walks the masks' bits when a record overflows
//     (above ~20% spikes). Each output is the plain float sum of its
//     active weights in ascending k, rounded once per add: the same bits
//     as an ordered loop Y += W[:, i] * g(S[i]) over i (a 0/1 gate makes
//     each product exact and adds nothing when it is 0). k is not split
//     across blocks, so that order holds.
//   Bound: reading W once (the rows some column needs, transpose) against
//   2 * nnz(S) * m adds. What the bound does not count sets the time: the
//   per-tile copy, barrier and record work of 64 x 64 blocks at 1%, and
//   above ~5% the adds (m n k rate), which exceed a full float32 product.
#include "common.cuh"

namespace {

constexpr unsigned kFullMask = 0xffffffffu;

// K15: the gates of a tile, the loads a thread keeps in flight in s @ W,
// and a lane in W @ s; the threads and gate words a thread of the two
// kernels; the gate pass's block
constexpr int kMvTile = 16384;
constexpr int kColInFlight = 32;
constexpr int kRowInFlight = 8;
constexpr int kColThreads = 64;
constexpr int kColWords = kMvTile / 32 / kColThreads;
constexpr int kRowThreads = 256;
constexpr int kRowWords = kMvTile / 32 / kRowThreads;
constexpr int kGateBlock = 256;

// bits[w]: bit b set where gate 32 w + b is active
template <int kOp>
__global__ void __launch_bounds__(kGateBlock)
dense_gate_bits_kernel(const void* __restrict__ s, const int k,
                       unsigned* __restrict__ bits) {
    const long long i =
        static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    const bool on = i < k && be_load_op<kOp>(s, i) != 0.0f;
    const unsigned word = __ballot_sync(kFullMask, on);
    if ((threadIdx.x & 31) == 0 && i < k) bits[i >> 5] = word;
}

// The active gates of the tile of words from t0, in ascending order, as
// offsets from gate 32 t0 into list; returns their count. Each of the
// block's kThreads threads reads kWords consecutive words and counts their
// bits, a prefix sum across the block places its indices, and the block
// waits until the list is whole.
template <int kThreads, int kWords>
__device__ __forceinline__ int compact_tile(const unsigned* __restrict__ bits,
                                            const int n_words, const int t0,
                                            unsigned short* list,
                                            int* warp_total) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int w0 = t0 + tid * kWords;
    unsigned wd[kWords];
    int cnt = 0;
#pragma unroll
    for (int v = 0; v < kWords; ++v) {
        wd[v] = w0 + v < n_words ? bits[w0 + v] : 0u;
        cnt += __popc(wd[v]);
    }
    int incl = cnt;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const int up = __shfl_up_sync(kFullMask, incl, off);
        if (lane >= off) incl += up;
    }
    if (lane == 31) warp_total[warp] = incl;
    __syncthreads();
    int pos = incl - cnt, total = 0;
#pragma unroll
    for (int i = 0; i < kThreads / 32; ++i) {
        if (i < warp) pos += warp_total[i];
        total += warp_total[i];
    }
#pragma unroll
    for (int v = 0; v < kWords; ++v)
        for (unsigned b = wd[v]; b; b &= b - 1)
            list[pos++] = static_cast<unsigned short>(
                (w0 - t0 + v) * 32 + __ffs(b) - 1);
    __syncthreads();
    return total;
}

// s @ W, W (k, m): a thread per column j adds W[i, j] =
// W[j * o_stride + i * i_stride] (strides 1 and m; the 64-bit strides ran
// 1.3x faster on the H100 than an int m) over the active rows i in
// ascending order. A load past the list reads nothing and adds +0.0, which
// leaves acc as it is (acc is never -0.0: it starts at +0.0, and a sum
// rounds to -0.0 only from two -0.0 terms).
template <typename T>
__global__ void __launch_bounds__(kColThreads)
dense_event_mv_t_kernel(const T* __restrict__ W,
                        const unsigned* __restrict__ bits, const int k,
                        const int m, const long long o_stride,
                        const long long i_stride, T* __restrict__ y) {
    __shared__ unsigned short list[kMvTile];
    __shared__ int warp_total[kColThreads / 32];
    const long long j =
        static_cast<long long>(blockIdx.x) * kColThreads + threadIdx.x;
    const bool in = j < m;
    const int n_words = (k + 31) >> 5;
    T acc = T(0);
    for (int t0 = 0; t0 < n_words; t0 += kMvTile / 32) {
        const int total = compact_tile<kColThreads, kColWords>(
            bits, n_words, t0, list, warp_total);
        if (in) {
            const T* wt = W + static_cast<long long>(t0) * 32 * i_stride
                + j * o_stride;
            for (int p = 0; p < total; p += kColInFlight) {
                T val[kColInFlight];
#pragma unroll
                for (int u = 0; u < kColInFlight; ++u)
                    val[u] = p + u < total
                        ? wt[static_cast<long long>(list[p + u]) * i_stride]
                        : T(0);
#pragma unroll
                for (int u = 0; u < kColInFlight; ++u) acc += val[u];
            }
        }
        __syncthreads();                        // the next tile's list
    }
    if (in) y[j] = acc;
}

// W @ s, W (m, k): a warp per row i; its lanes take the active j of each
// tile's list 32 apart (kRowInFlight loads in flight), and a fixed
// xor-shuffle tree combines them.
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
dense_event_mv_nt_kernel(const T* __restrict__ W,
                         const unsigned* __restrict__ bits, const int m,
                         const int k, T* __restrict__ y) {
    __shared__ unsigned short list[kMvTile];
    __shared__ int warp_total[kRowThreads / 32];
    const int lane = threadIdx.x & 31;
    const long long i =
        static_cast<long long>(blockIdx.x) * (kRowThreads / 32) +
        (threadIdx.x >> 5);
    const bool in = i < m;
    const int n_words = (k + 31) >> 5;
    T acc = T(0);
    for (int t0 = 0; t0 < n_words; t0 += kMvTile / 32) {
        const int total = compact_tile<kRowThreads, kRowWords>(
            bits, n_words, t0, list, warp_total);
        if (in) {
            const T* wt = W + i * k + static_cast<long long>(t0) * 32;
            for (int p = lane; p < total; p += 32 * kRowInFlight) {
                T val[kRowInFlight];
#pragma unroll
                for (int u = 0; u < kRowInFlight; ++u)
                    val[u] = p + 32 * u < total ? wt[list[p + 32 * u]] : T(0);
#pragma unroll
                for (int u = 0; u < kRowInFlight; ++u) acc += val[u];
            }
        }
        __syncthreads();                        // the next tile's list
    }
    for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(kFullMask, acc, off);
    if (in && lane == 0) y[i] = acc;
}

// -- K16 ---------------------------------------------------------------------

typedef unsigned long long u64;

// k per tile: one 64-bit gate mask per column
constexpr int kTileK = 64;
// output rows per lane (a warp's lanes own 32 rows at a time) and per block
constexpr int kRowsPerLane = 2;
constexpr int kBandRows = 32 * kRowsPerLane;
// output columns per warp and per block: 8 warps
constexpr int kColsPerWarp = 8;
constexpr int kBlockCols = 64;
constexpr int kMmThreads = 32 * kBlockCols / kColsPerWarp;
// blocks per SM the kernel is built for (at most 85 registers a thread),
// and the depth of the W tile ring: four float stages (18 KB each) or two
// double stages a block fit three blocks in an SM's 228 KB
constexpr int kMinBlocks = 3;
template <typename T>
constexpr int kStagesOf = sizeof(T) == 4 ? 4 : 2;
// the mask pass: one warp per (k tile, group of 32 columns)
constexpr int kMaskThreads = 128;
constexpr int kGroupsPerRange = kBlockCols / 32;
// The event record of a k tile and a warp's 8 columns: 8 one-byte event
// counts, then up to kRecEvents k offsets sorted by column, then by k; the
// counts are all ones when the events do not fit (the warp then walks the
// bits of its columns' masks, read from L2).
constexpr int kRecBytes = 128;
constexpr int kRecEvents = kRecBytes - 8;
constexpr u64 kRecFull = ~0ull;

// The W tile in shared memory, copied in 16-byte pieces (kV elements):
// W (m, k) row-major, ws[r * kStride + kk], its pieces along k; W (k, m)
// k-major, ws[kk * kStride + r], its pieces along m. The strides keep the
// pieces aligned. The 32 lanes of a warp read 32 rows at one k: consecutive
// words k-major, 4 ways to a bank row-major, which only events pay.
template <bool kTrans, typename T>
struct Tile {
    static constexpr int kV = 16 / sizeof(T);
    static constexpr int kStride = (kTrans ? kBandRows : kTileK) + kV;
    static constexpr int kElems = (kTrans ? kTileK : kBandRows) * kStride;
    __device__ static int at(int kk, int r) {
        return kTrans ? kk * kStride + r : r * kStride + kk;
    }
};

// cp.async of kBytes: 16-byte pieces bypass L1 (.cg), smaller ones (ragged
// or unaligned tiles) go through it (.ca, the only form they have)
template <int kBytes>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    if (kBytes == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                     :: "r"(s), "l"(gmem) : "memory");
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                     :: "r"(s), "l"(gmem), "n"(kBytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

// Reads S once and writes, for k tile t:
// - masks[t * n + c]: bit kk set where S[64 t + kk, c] is an event;
// - need[t * n_groups + g]: the OR of the masks of the g-th group of 32
//   columns (the k rows some column of the group needs);
// - recs[(t * n_g8 + g8) * kRecBytes]: the event record of the g8-th
//   group of 8 columns.
template <int kOp>
__global__ void __launch_bounds__(kMaskThreads)
dense_event_masks_kernel(const void* __restrict__ S, const int k,
                         const int n, const int n_groups,
                         const long long n_jobs, u64* __restrict__ masks,
                         u64* __restrict__ need,
                         unsigned char* __restrict__ recs) {
    const int lane = threadIdx.x & 31;
    const long long job =
        (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
    if (job >= n_jobs) return;                  // the whole warp leaves
    const int t = static_cast<int>(job / n_groups);
    const int c = static_cast<int>(job % n_groups) * 32 + lane;
    const long long k0 = static_cast<long long>(t) * kTileK;
    u64 bits = 0;
    if (c < n) {
        const long long base = k0 * n + c;
        if (k0 + kTileK <= k) {
            // a whole tile: the 64 loads are in flight together
#pragma unroll
            for (int kk = 0; kk < kTileK; ++kk)
                if (be_load_op<kOp>(S, base + static_cast<long long>(kk) * n)
                    != 0.0f)
                    bits |= 1ull << kk;
        } else {
            for (int kk = 0; k0 + kk < k; ++kk)
                if (be_load_op<kOp>(S, base + static_cast<long long>(kk) * n)
                    != 0.0f)
                    bits |= 1ull << kk;
        }
        masks[t * static_cast<long long>(n) + c] = bits;
    }
    // the record of the lane's 8 columns: its count, and its events after
    // those of the group's lower columns
    const int j = lane & 7;
    const int cnt = __popcll(bits);
    int upto = cnt;
    for (int off = 1; off < 8; off <<= 1) {
        const int v = __shfl_up_sync(kFullMask, upto, off, 8);
        if (j >= off) upto += v;
    }
    const int total = __shfl_sync(kFullMask, upto, 7, 8);
    u64 counts = static_cast<u64>(cnt) << (8 * j);
    for (int off = 1; off < 8; off <<= 1)
        counts |= __shfl_xor_sync(kFullMask, counts, off, 8);
    const int n_g8 = (n + 7) / 8;
    if (c / 8 < n_g8) {
        unsigned char* rec =
            recs + (static_cast<long long>(t) * n_g8 + c / 8) * kRecBytes;
        if (j == 0)
            *reinterpret_cast<u64*>(rec) =
                total > kRecEvents ? kRecFull : counts;
        if (total <= kRecEvents) {
            unsigned char* out = rec + 8 + upto - cnt;
            for (u64 b = bits; b; b &= b - 1)
                *out++ = static_cast<unsigned char>(
                    __ffsll(static_cast<long long>(b)) - 1);
        }
    }
    for (int off = 16; off > 0; off >>= 1)
        bits |= __shfl_xor_sync(kFullMask, bits, off);
    if (lane == 0) need[job] = bits;
}

// One block owns kBandRows output rows and kBlockCols output columns and
// walks k in tiles of kTileK, in ascending order. A tile whose columns need
// no k row is skipped, copy and all; otherwise the 16-byte pieces of the W
// tile that hold a needed k row are copied, kStagesOf<T> - 1 tiles ahead of
// the sum, with the tile's event records. A warp sums
// kRowsPerLane rows a lane and kColsPerWarp columns: column by column it
// adds the weights of the k rows its record lists, in ascending k; when the
// record is full it walks each 32-bit half of its columns' masks, low half
// first, in rounds that take the lowest set bit left in each column. Both
// add each column's active weights in ascending k (the records and masks
// are the same across the warp, so nothing diverges): each output is the
// plain ascending-k sum of its active weights in T.
template <bool kTrans, typename T>
__global__ void __launch_bounds__(kMmThreads, kMinBlocks)
dense_event_mm_kernel(const T* __restrict__ W, const u64* __restrict__ masks,
                      const u64* __restrict__ need,
                      const unsigned char* __restrict__ recs, const int m,
                      const int k, const int n, const int n_ranges,
                      const int n_groups, const int vec,
                      T* __restrict__ Y) {
    extern __shared__ __align__(16) unsigned char smem[];
    using Ts = Tile<kTrans, T>;
    constexpr int kStages = kStagesOf<T>;
    constexpr int kRecsPerBlock = kBlockCols / kColsPerWarp;
    constexpr int kStageBytes =
        Ts::kElems * sizeof(T) + kRecsPerBlock * kRecBytes;
    static_assert(kStageBytes % 16 == 0, "stage alignment");
    u64* need_s = reinterpret_cast<u64*>(smem + kStages * kStageBytes);
    auto ws_of = [&](int s) {
        return reinterpret_cast<T*>(smem + s * kStageBytes);
    };
    auto rs_of = [&](int s) {
        return smem + s * kStageBytes + Ts::kElems * sizeof(T);
    };
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int range = static_cast<int>(blockIdx.x % n_ranges);
    const long long m0 =
        static_cast<long long>(blockIdx.x / n_ranges) * kBandRows;
    const int c0 = range * kBlockCols;
    const int n_tiles = (k + kTileK - 1) / kTileK;
    const int n_g8 = (n + 7) / 8;
    const int rows = static_cast<int>(
        min(static_cast<long long>(kBandRows), m - m0));

    // copy tile t (whose needed rows are nd) into its stage, and commit a
    // group, empty when nothing is copied
    auto issue = [&](int t, u64 nd) {
        const int s = t % kStages;
        if (tid == 0) need_s[s] = nd;
        if (nd == 0) {
            cp_async_commit();
            return;
        }
        // the records, 16 bytes a thread
        constexpr int kRecPieces = kRecBytes / 16;
        static_assert(kRecsPerBlock * kRecPieces <= kMmThreads, "records");
        if (tid < kRecsPerBlock * kRecPieces) {
            const int piece = tid;
            const int g8 = c0 / 8 + piece / kRecPieces;
            unsigned char* dst = rs_of(s) + piece * 16;
            if (g8 < n_g8)
                cp_async<16>(dst, recs + (static_cast<long long>(t) * n_g8 +
                                          g8) * kRecBytes +
                                      piece % kRecPieces * 16);
            else if (piece % kRecPieces == 0)
                *reinterpret_cast<u64*>(dst) = 0;   // no columns, no events
        }
        // the W tile: a thread keeps one piece position and steps the
        // other index by kStep
        constexpr int kV = Ts::kV;
        const long long k0 = static_cast<long long>(t) * kTileK;
        T* ws = ws_of(s);
        if (kTrans) {                           // W (k, m): pieces along m
            constexpr int kPer = kBandRows / kV;
            constexpr int kStep = kMmThreads / kPer;
            const int r = tid % kPer * kV;
            const T* src = W + (k0 + tid / kPer) * m + m0 + r;
            T* dst = ws + Ts::at(tid / kPer, r);
            const bool whole = vec && r + kV <= rows;
#pragma unroll
            for (int i = 0; i < kTileK / kStep; ++i) {
                if ((nd >> (tid / kPer + i * kStep)) & 1) {
                    if (whole) {
                        cp_async<16>(dst, src);
                    } else {
                        for (int v = 0; v < kV; ++v)
                            if (r + v < rows)
                                cp_async<sizeof(T)>(dst + v, src + v);
                    }
                }
                src += static_cast<long long>(kStep) * m;
                dst += Ts::at(kStep, 0);
            }
        } else {                                // W (m, k): pieces along k
            constexpr int kPer = kTileK / kV;
            constexpr int kStep = kMmThreads / kPer;
            const int kk = tid % kPer * kV;
            if ((nd >> kk) & ((1ull << kV) - 1)) {
                const T* src = W + (m0 + tid / kPer) * k + k0 + kk;
                T* dst = ws + Ts::at(kk, tid / kPer);
                const bool whole = vec && k0 + kk + kV <= k;
#pragma unroll 4
                for (int r = tid / kPer; r < rows; r += kStep) {
                    if (whole) {
                        cp_async<16>(dst, src);
                    } else {
                        for (int v = 0; v < kV; ++v)
                            if (k0 + kk + v < k)
                                cp_async<sizeof(T)>(dst + v, src + v);
                    }
                    src += static_cast<long long>(kStep) * k;
                    dst += Ts::at(0, kStep);
                }
            }
        }
        cp_async_commit();
    };
    auto need_at = [&](int t) -> u64 {
        if (t >= n_tiles) return 0ull;
        const u64* row = need + static_cast<long long>(t) * n_groups;
        u64 nd = 0;
#pragma unroll
        for (int g = 0; g < kGroupsPerRange; ++g)
            if (range * kGroupsPerRange + g < n_groups)
                nd |= row[range * kGroupsPerRange + g];
        return nd;
    };

    T acc[kColsPerWarp][kRowsPerLane];
#pragma unroll
    for (int j = 0; j < kColsPerWarp; ++j)
#pragma unroll
        for (int r = 0; r < kRowsPerLane; ++r) acc[j][r] = T(0);

    for (int t = 0; t < kStages - 1; ++t) issue(t, need_at(t));
    u64 nd_ahead = need_at(kStages - 1);
    for (int t = 0; t < n_tiles; ++t) {
        cp_async_wait<kStages - 2>();
        // tile t has landed for every thread, and every thread is done
        // with tile t - 1, whose stage the next issue reuses
        __syncthreads();
        issue(t + kStages - 1, nd_ahead);
        nd_ahead = need_at(t + kStages);
        const int s = t % kStages;
        if (need_s[s] == 0) continue;           // the tile's event skip
        const T* ws = ws_of(s) + Ts::at(0, lane);
        const unsigned char* rec = rs_of(s) + warp * kRecBytes;
        const u64 counts = *reinterpret_cast<const u64*>(rec);
        if (counts != kRecFull) {
            const unsigned char* ev = rec + 8;
#pragma unroll
            for (int j = 0; j < kColsPerWarp; ++j) {
                const int cnt = static_cast<int>((counts >> (8 * j)) & 0xff);
                for (int i = 0; i < cnt; ++i) {
                    const int kk = ev[i];
#pragma unroll
                    for (int r = 0; r < kRowsPerLane; ++r)
                        acc[j][r] += ws[Ts::at(kk, 32 * r)];
                }
                ev += cnt;
            }
            continue;
        }
        const int cw = c0 + warp * kColsPerWarp;
        const u64* ms = masks + static_cast<long long>(t) * n + cw;
#pragma unroll 1
        for (int h = 0; h < 2; ++h) {
            unsigned b[kColsPerWarp], left = 0;
#pragma unroll
            for (int j = 0; j < kColsPerWarp; ++j) {
                b[j] = cw + j < n ? static_cast<unsigned>(ms[j] >> (32 * h))
                                  : 0u;
                left |= b[j];
            }
            while (left) {
                left = 0;
#pragma unroll
                for (int j = 0; j < kColsPerWarp; ++j) {
                    if (b[j]) {
                        const int kk = 32 * h + __ffs(b[j]) - 1;
                        b[j] &= b[j] - 1;
                        left |= b[j];
#pragma unroll
                        for (int r = 0; r < kRowsPerLane; ++r)
                            acc[j][r] += ws[Ts::at(kk, 32 * r)];
                    }
                }
            }
        }
    }
    cp_async_wait<0>();
    __syncthreads();
    // through shared memory, so that each row of Y is written coalesced
    constexpr int kOutStride = kBlockCols + 1;
    static_assert(kBandRows * kOutStride * sizeof(T) <= kStages * kStageBytes,
                  "out tile");
    T* out = reinterpret_cast<T*>(smem);
#pragma unroll
    for (int j = 0; j < kColsPerWarp; ++j)
#pragma unroll
        for (int r = 0; r < kRowsPerLane; ++r)
            out[(lane + 32 * r) * kOutStride + warp * kColsPerWarp + j] =
                acc[j][r];
    __syncthreads();
    for (int e = tid; e < kBandRows * kBlockCols; e += kMmThreads) {
        const int r = e / kBlockCols, c = e % kBlockCols;
        if (r < rows && c0 + c < n)
            Y[(m0 + r) * n + c0 + c] = out[r * kOutStride + c];
    }
}

template <bool kTrans, typename T>
int mm_launch(const T* W, const u64* masks, const u64* need,
              const unsigned char* recs, int m, int k, int n, int n_ranges,
              int n_groups, long long blocks, T* Y, cudaStream_t st) {
    constexpr int bytes =
        kStagesOf<T> * (Tile<kTrans, T>::kElems * sizeof(T) +
                        kBlockCols / kColsPerWarp * kRecBytes + 8);
    const cudaError_t err = cudaFuncSetAttribute(
        dense_event_mm_kernel<kTrans, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    // 16-byte pieces need 16-byte aligned rows of W
    const int vec = reinterpret_cast<unsigned long long>(W) % 16 == 0 &&
                    (static_cast<long long>(kTrans ? m : k) * sizeof(T)) %
                            16 == 0;
    dense_event_mm_kernel<kTrans, T><<<static_cast<unsigned>(blocks),
                                       kMmThreads, bytes, st>>>(
        W, masks, need, recs, m, k, n, n_ranges, n_groups, vec, Y);
    return 0;
}

template <typename T>
void launch_mv(const T* W, int transpose, int rows, int cols,
               const unsigned* bits, T* y, cudaStream_t st) {
    if (transpose)
        dense_event_mv_t_kernel<T><<<(cols + kColThreads - 1) / kColThreads,
                                     kColThreads, 0, st>>>(W, bits, rows,
                                                           cols, 1, cols, y);
    else
        dense_event_mv_nt_kernel<T><<<(rows + kRowThreads / 32 - 1) /
                                          (kRowThreads / 32),
                                      kRowThreads, 0, st>>>(W, bits, rows,
                                                            cols, y);
}

}  // namespace

// op: 0 bool s (one byte per value), 1 float32 s gated at > 0. dbl: W and
// y are float64, else float32. transpose = 1: W (rows = k, cols = m),
// y (m,); transpose = 0: W (rows = m, cols = k), y (m,). bits holds
// ceil(k / 32) 32-bit words, written here (the gates as ballot words).
// y is written in full.
BE_EXPORT int dense_event_mv_launch(const void* W, const void* s, int op,
                                    int transpose, int dbl, int rows,
                                    int cols, void* bits, void* y, int device,
                                    void* stream) {
    int err = be_begin(device);
    if (err) return err;
    const int k = transpose ? rows : cols;
    const int n_out = transpose ? cols : rows;
    if (n_out <= 0) return be_end();
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    unsigned* b = static_cast<unsigned*>(bits);
    if (k > 0) {
        const unsigned blocks = (k + kGateBlock - 1) / kGateBlock;
        if (op == 0)
            dense_gate_bits_kernel<0><<<blocks, kGateBlock, 0, st>>>(s, k, b);
        else
            dense_gate_bits_kernel<1><<<blocks, kGateBlock, 0, st>>>(s, k, b);
    }
    BE_VALUE_DISPATCH(dbl, launch_mv<T>(static_cast<const T*>(W), transpose,
                                        rows, cols, b, static_cast<T*>(y),
                                        st));
    return be_end();
}

// op and dbl as above; S (k, n) row-major; Y (m, n) is written in full.
// transpose = 1: W (k, m); transpose = 0: W (m, k). scratch holds
// ceil(k / 64) * (n + ceil(n / 32) + 16 * ceil(n / 8)) + 1 64-bit words,
// written here: the gate masks of each k tile and column, the k rows each
// tile's group of 32 columns needs, and the event records of each tile's
// groups of 8 columns (from a 16-byte boundary).
BE_EXPORT int dense_event_mm_launch(const void* W, const void* S, int op,
                                    int transpose, int dbl, int m, int k,
                                    int n, void* scratch, void* Y, int device,
                                    void* stream) {
    int err = be_begin(device);
    if (err) return err;
    if (m <= 0 || n <= 0) return be_end();
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int n_tiles = (k + kTileK - 1) / kTileK;
    const int n_groups = (n + 31) / 32;
    const int n_ranges = (n + kBlockCols - 1) / kBlockCols;
    u64* masks = static_cast<u64*>(scratch);
    u64* need = masks + static_cast<long long>(n_tiles) * n;
    const long long words = static_cast<long long>(n_tiles) * (n + n_groups);
    unsigned char* recs = reinterpret_cast<unsigned char*>(
        masks + words + (words & 1));
    const long long jobs = static_cast<long long>(n_tiles) * n_groups;
    if (jobs > 0) {
        const long long blocks = (jobs * 32 + kMaskThreads - 1) / kMaskThreads;
        if (op == 0)
            dense_event_masks_kernel<0><<<static_cast<unsigned>(blocks),
                                          kMaskThreads, 0, st>>>(
                S, k, n, n_groups, jobs, masks, need, recs);
        else
            dense_event_masks_kernel<1><<<static_cast<unsigned>(blocks),
                                          kMaskThreads, 0, st>>>(
                S, k, n, n_groups, jobs, masks, need, recs);
    }
    const long long blocks =
        ((static_cast<long long>(m) + kBandRows - 1) / kBandRows) * n_ranges;
    BE_VALUE_DISPATCH(dbl, err = transpose
        ? mm_launch<true, T>(static_cast<const T*>(W), masks, need, recs, m,
                             k, n, n_ranges, n_groups, blocks,
                             static_cast<T*>(Y), st)
        : mm_launch<false, T>(static_cast<const T*>(W), masks, need, recs, m,
                              k, n, n_ranges, n_groups, blocks,
                              static_cast<T*>(Y), st));
    if (err) return err;
    return be_end();
}
