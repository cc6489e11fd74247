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
// _densemv_pallas_kernel (:81), a tiled MXU matvec that reads all of W.
//   - transpose (s @ W, W (k, m)): y[j] = sum over active rows i of W[i, j].
//     A warp owns 32 output columns and walks the k rows, taking a ballot
//     of 32 gates at a time (K5's scheme); for an active row its lanes read
//     that row's 32 weights, 128 contiguous bytes, and add them in
//     ascending row order.
//   - otherwise (W @ s, W (m, k)): y[i] = sum over active j of W[i, j]. One
//     warp per output row; the lanes stride over k, read W[i, j] only where
//     the gate is on, and a fixed xor-shuffle tree combines them (K7's
//     scheme).
//   Either way a repeat gives the same bits, and only the weights of active
//   events are read. Bound: those reads, the active rows of W (transpose)
//   or one 32-byte sector per active weight (otherwise).
//
// K16 `dense_event_mm` replaces _densemm_pallas_kernel (:267):
//   Y = W @ g(S) (W (m, k)) or W.T @ g(S) (transpose, W (k, m)), S (k, n),
//   Y (m, n). A tiled float32 product on the CUDA cores: a block owns a
//   64 x 64 tile of Y and walks k in tiles of 32, staging the gate tile and
//   then the W tile in shared memory. A k-tile whose gate tile is all zero
//   is skipped, W tile included: the TPU kernel's tile-level event skip
//   (dense/binary.py:291). The sums run in ascending k, in full float32
//   (no TF32, no bf16 split: the TPU kernel asks for Precision.HIGHEST).
//   Bound: reading W once (the blocks of one row of tiles share it through
//   L2) against 2 * nnz(S) * m operations; the dense tile product does
//   2 * m * k * n, which at 1% spikes makes it compute-bound. wgmma and TMA
//   are later work.
#include "common.cuh"

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMvBlock = 128;

template <int kOp, typename T>
__global__ void dense_event_mv_t_kernel(const T* __restrict__ W,
                                        const void* __restrict__ s,
                                        const int k, const int m,
                                        T* __restrict__ y) {
    const int lane = threadIdx.x & 31;
    const long long j =
        static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (j - lane >= m) return;                  // the whole warp leaves
    const bool in = j < m;
    T acc = T(0);
    // the loop bound is the same for every lane, so the ballot sees all 32
    for (int base = 0; base < k; base += 32) {
        const int i = base + lane;
        const bool on = i < k && be_load_op<kOp>(s, i) != 0.0f;
        unsigned mask = __ballot_sync(kFullMask, on);
        while (mask) {
            const int src = __ffs(mask) - 1;
            mask &= mask - 1;
            if (in) acc += W[static_cast<long long>(base + src) * m + j];
        }
    }
    if (in) y[j] = acc;
}

template <int kOp, typename T>
__global__ void dense_event_mv_nt_kernel(const T* __restrict__ W,
                                         const void* __restrict__ s,
                                         const int m, const int k,
                                         T* __restrict__ y) {
    const int lane = threadIdx.x & 31;
    const long long row =
        (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
    if (row >= m) return;                       // the whole warp leaves
    const T* wr = W + row * k;
    T acc = T(0);
    for (int j = lane; j < k; j += 32)
        if (be_load_op<kOp>(s, j) != 0.0f) acc += wr[j];
    for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(kFullMask, acc, off);
    if (lane == 0) y[row] = acc;
}

constexpr int kBM = 64, kBN = 64, kBK = 32, kMmThreads = 256;

// The shared tiles take 16.6 KB in float32 and 33 KB in float64, within
// the 48 KB of static shared memory.
template <int kOp, bool kTrans, typename T>
__global__ void __launch_bounds__(kMmThreads)
dense_event_mm_kernel(const T* __restrict__ W, const void* __restrict__ S,
                      const int m, const int k, const int n,
                      T* __restrict__ Y) {
    __shared__ T ws[kBK][kBM + 1];              // W tile, k-major
    __shared__ T gs[kBK][kBN];                  // gate tile
    const int t = threadIdx.x;
    const int tx = t % 16, ty = t / 16;
    const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
    T acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = T(0);
    for (int k0 = 0; k0 < k; k0 += kBK) {
        int any = 0;
        for (int e = t; e < kBK * kBN; e += kMmThreads) {
            const int kk = e / kBN, nn = e % kBN;
            const int gk = k0 + kk, gn = n0 + nn;
            T g = T(0);
            if (gk < k && gn < n)
                g = be_load_op_t<kOp, T>(S,
                                         static_cast<long long>(gk) * n + gn);
            gs[kk][nn] = g;
            any |= g != T(0);
        }
        // a barrier too: the gate tile is complete past this line
        if (!__syncthreads_or(any)) continue;   // an all-zero gate tile
        for (int e = t; e < kBK * kBM; e += kMmThreads) {
            int kk, mm;
            if (kTrans) {                       // W (k, m): along m
                kk = e / kBM;
                mm = e % kBM;
            } else {                            // W (m, k): along k
                mm = e / kBK;
                kk = e % kBK;
            }
            const int gk = k0 + kk, gm = m0 + mm;
            T w = T(0);
            if (gk < k && gm < m)
                w = kTrans ? W[static_cast<long long>(gk) * m + gm]
                           : W[static_cast<long long>(gm) * k + gk];
            ws[kk][mm] = w;
        }
        __syncthreads();
#pragma unroll 8
        for (int kk = 0; kk < kBK; ++kk) {
            T a[4], b[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = ws[kk][ty + 16 * i];
#pragma unroll
            for (int j = 0; j < 4; ++j) b[j] = gs[kk][tx + 16 * j];
            // b is 0 or 1, so a * b is exact and the FMA adds a or 0
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    acc[i][j] = be_fma(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int r = m0 + ty + 16 * i;
        if (r >= m) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int c = n0 + tx + 16 * j;
            if (c < n) Y[static_cast<long long>(r) * n + c] = acc[i][j];
        }
    }
}

template <typename T>
void launch_mv(const T* W, const void* s, int op, int transpose, int rows,
               int cols, T* y, cudaStream_t st) {
    if (transpose) {
        if (cols <= 0) return;
        const int blocks = (cols + kMvBlock - 1) / kMvBlock;
        if (op == 0)
            dense_event_mv_t_kernel<0, T><<<blocks, kMvBlock, 0, st>>>(
                W, s, rows, cols, y);
        else
            dense_event_mv_t_kernel<1, T><<<blocks, kMvBlock, 0, st>>>(
                W, s, rows, cols, y);
    } else {
        if (rows <= 0) return;
        const int blocks = static_cast<int>(
            (static_cast<long long>(rows) * 32 + BE_BLOCK - 1) / BE_BLOCK);
        if (op == 0)
            dense_event_mv_nt_kernel<0, T><<<blocks, BE_BLOCK, 0, st>>>(
                W, s, rows, cols, y);
        else
            dense_event_mv_nt_kernel<1, T><<<blocks, BE_BLOCK, 0, st>>>(
                W, s, rows, cols, y);
    }
}

template <typename T>
void launch_mm(const T* W, const void* S, int op, int transpose, int m,
               int k, int n, T* Y, cudaStream_t st) {
    const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
    if (op == 0 && transpose)
        dense_event_mm_kernel<0, true, T><<<grid, kMmThreads, 0, st>>>(
            W, S, m, k, n, Y);
    else if (op == 0)
        dense_event_mm_kernel<0, false, T><<<grid, kMmThreads, 0, st>>>(
            W, S, m, k, n, Y);
    else if (transpose)
        dense_event_mm_kernel<1, true, T><<<grid, kMmThreads, 0, st>>>(
            W, S, m, k, n, Y);
    else
        dense_event_mm_kernel<1, false, T><<<grid, kMmThreads, 0, st>>>(
            W, S, m, k, n, Y);
}

}  // namespace

// op: 0 bool s (one byte per value), 1 float32 s gated at > 0. dbl: W and
// y are float64, else float32. transpose = 1: W (rows = k, cols = m),
// y (m,); transpose = 0: W (rows = m, cols = k), y (m,). y is written in
// full.
BE_EXPORT int dense_event_mv_launch(const void* W, const void* s, int op,
                                    int transpose, int dbl, int rows,
                                    int cols, void* y, int device,
                                    void* stream) {
    int err = be_begin(device);
    if (err) return err;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    BE_VALUE_DISPATCH(dbl, launch_mv<T>(static_cast<const T*>(W), s, op,
                                        transpose, rows, cols,
                                        static_cast<T*>(y), st));
    return be_end();
}

// op and dbl as above; S (k, n) row-major; Y (m, n) is written in full.
// transpose = 1: W (k, m); transpose = 0: W (m, k). The caller keeps
// ceil(m / 64) within the grid's y limit (65535).
BE_EXPORT int dense_event_mm_launch(const void* W, const void* S, int op,
                                    int transpose, int dbl, int m, int k,
                                    int n, void* Y, int device,
                                    void* stream) {
    int err = be_begin(device);
    if (err) return err;
    if (m <= 0 || n <= 0) return be_end();
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    BE_VALUE_DISPATCH(dbl, launch_mm<T>(static_cast<const T*>(W), S, op,
                                        transpose, m, k, n,
                                        static_cast<T*>(Y), st));
    return be_end();
}
