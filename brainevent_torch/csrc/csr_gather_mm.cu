// Copyright 2026 The brainevent-tpu Authors.
// Licensed under the Apache License, Version 2.0.
//
// K10 `csr_gather_mm` (brainevent_torch/ops/mxu_gather.py) replaces
// brainevent_tpu/ops/mxu_gather.py:_make_mm_kernel (:854, `gather_matmat`):
//     Y[r, :] = sum over j in [ptr[r], ptr[r+1]) of w[slot(j)] * op(X[col[j], :])
// over an int32 row index (ptr, col), weights w of shape (1,) or one per
// entry (float32, or float64 in the double instances), an optional slot permutation perm (w[perm[j]]), and a row-major
// operand X (n_x, B) whose values pass through be_load_op (common.cuh: the
// event gate of a binary product, or the identity). It serves csrmm and
// binary_csrmm on a CSR matrix's own arrays, their transposed direction
// over the CSC mirror (perm maps a mirror slot to its CSR weight), and
// gather_matmat over a gather plan's row index (row_ptr, row_cols,
// row_slots into the plan-ordered weights).
//
// One warp per (row, 128-column tile of Y). The lanes load 32 of the row's
// (column, weight) pairs at once and pass them round with shuffles; for
// each entry, in order, every lane adds its four columns of X's row, so a
// read of an X row is 128 contiguous bytes per warp instruction. The
// entries of a row are added in their stored order: no atomics, the same
// bits on every run. Homogeneous binary products sum 0/1 gates (exact
// integers in float32) and scale once by w[0]. Column ids outside
// [0, n_x) are dropped.
//
// The TPU kernel reaches the rows of X through one-hot MXU contractions
// with bf16 splits and a VMEM-resident copy of X, because a TPU has no
// gather; none of that is needed here, and no width of X is too wide.
//
// Bound: the reads of X rows, 4 * B bytes per entry (at 1M entries and
// B = 256, 1 GB per call, mostly from L2, since X is 10 MB there).
#include "common.cuh"

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kTile = 128;                  // columns of Y per warp
constexpr int kPerLane = kTile / 32;

template <int kOp, bool kHomo, bool kPerm, typename T>
__global__ void csr_gather_mm_kernel(const int* __restrict__ ptr,
                                     const int* __restrict__ col,
                                     const int* __restrict__ perm,
                                     const T* __restrict__ w,
                                     const void* __restrict__ X,
                                     const int n_rows, const int n_x,
                                     const int B, const int n_tiles,
                                     T* __restrict__ Y) {
    constexpr bool kCount = kHomo && kOp != 2;
    const int lane = threadIdx.x & 31;
    const long long wid =
        (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
    if (wid >= static_cast<long long>(n_rows) * n_tiles) return;  // warp
    const long long row = wid / n_tiles;
    const int c0 = static_cast<int>(wid % n_tiles) * kTile + lane;
    const int begin = ptr[row];
    const int end = ptr[row + 1];
    T acc[kPerLane];
#pragma unroll
    for (int v = 0; v < kPerLane; ++v) acc[v] = T(0);
    for (int base = begin; base < end; base += 32) {
        const int j = base + lane;
        int c = -1;
        T wv = T(0);
        if (j < end) {
            const unsigned cj = static_cast<unsigned>(col[j]);
            if (cj < static_cast<unsigned>(n_x)) {
                c = static_cast<int>(cj);
                if (!kCount) wv = w[kHomo ? 0 : (kPerm ? perm[j] : j)];
            }
        }
        const int n = end - base < 32 ? end - base : 32;
        for (int t = 0; t < n; ++t) {       // the same t on every lane
            const int ct = __shfl_sync(kFullMask, c, t);
            const T wt = __shfl_sync(kFullMask, wv, t);
            if (ct < 0) continue;
            const long long off = static_cast<long long>(ct) * B;
#pragma unroll
            for (int v = 0; v < kPerLane; ++v) {
                const int cc = c0 + 32 * v;
                if (cc >= B) break;
                const T xv = be_load_op_t<kOp, T>(X, off + cc);
                if (kCount)
                    acc[v] += xv;
                else if (kOp != 2)
                    acc[v] += xv != T(0) ? wt : T(0);
                else
                    acc[v] += wt * xv;
            }
        }
    }
    const T scale = kCount ? w[0] : T(1);
#pragma unroll
    for (int v = 0; v < kPerLane; ++v) {
        const int cc = c0 + 32 * v;
        if (cc < B) Y[row * B + cc] = kCount ? acc[v] * scale : acc[v];
    }
}

template <int kOp, bool kHomo, bool kPerm, typename T>
void launch(const int* ptr, const int* col, const int* perm, const T* w,
            const void* X, int n_rows, int n_x, int B, T* Y,
            cudaStream_t st) {
    const int n_tiles = (B + kTile - 1) / kTile;
    const long long warps = static_cast<long long>(n_rows) * n_tiles;
    const long long blocks = (warps * 32 + BE_BLOCK - 1) / BE_BLOCK;
    csr_gather_mm_kernel<kOp, kHomo, kPerm, T>
        <<<static_cast<int>(blocks), BE_BLOCK, 0, st>>>(
            ptr, col, perm, w, X, n_rows, n_x, B, n_tiles, Y);
}

}  // namespace

// op: 0 bool X (one byte per value), 1 float32 X gated at > 0, 2 float X
// in the value type. dbl: w, Y (and X for op 2) are float64, else float32.
// perm may be null; it is not read for homogeneous weights. Y (n_rows, B)
// is written in full.
BE_EXPORT int csr_gather_mm_launch(const int* ptr, const int* col,
                                   const int* perm, const void* w,
                                   const void* X, int op, int homo, int dbl,
                                   int n_rows, int n_x, int B, void* Y,
                                   int device, void* stream) {
    int err = be_begin(device);
    if (err) return err;
    if (n_rows <= 0 || B <= 0) return be_end();
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    BE_VALUE_DISPATCH(dbl, BE_CSR_DISPATCH(op, homo, perm,
        launch<O, H, P, T>(ptr, col, perm, static_cast<const T*>(w), X,
                           n_rows, n_x, B, static_cast<T*>(Y), st)));
    return be_end();
}
