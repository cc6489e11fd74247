// Copyright 2026 The brainevent-tpu Authors.
// Licensed under the Apache License, Version 2.0.
//
// The row gather of K7 `csr_gather_mv` (csr_event.cu), shared with K3
// `plan_gather_mv` and K4 `plan_matvec_dw` (plan_gather.cu), which run its
// float product (kOp = 2, no permutation) over a gather plan's row index:
//     y[r] = sum over j in [ptr[r], ptr[r+1]) of w[slot(j)] * op(x[col[j]]).
// One warp per row; its lanes walk the row 32 entries apart, so the index
// and weight reads of a warp are coalesced; a lane reads a weight only for
// an active event (binary products), and a fixed xor-shuffle tree combines
// the lanes: no atomics, the same bits on every run. Homogeneous binary
// products count in int32 and scale once by w[0], so they are exact. Ids
// outside [0, n_cols) are dropped.
#pragma once

#include "common.cuh"

namespace {

// The warp of row `row` (its lanes: threadIdx.x & 31) sums the row.
template <int kOp, bool kHomo, bool kPerm, typename T>
__device__ __forceinline__ void csr_gather_mv_row(const long long row,
                                                  const int* __restrict__ ptr,
                                                  const int* __restrict__ col,
                                                  const int* __restrict__ perm,
                                                  const T* __restrict__ w,
                                                  const void* __restrict__ x,
                                                  const int n_rows,
                                                  const int n_cols,
                                                  T* __restrict__ y) {
    constexpr bool kCount = kHomo && kOp != 2;
    const int lane = threadIdx.x & 31;
    if (row >= n_rows) return;                  // the whole warp leaves
    const int begin = ptr[row];
    const int end = ptr[row + 1];
    int cnt = 0;
    T acc = T(0);
    for (int j = begin + lane; j < end; j += 32) {
        const unsigned c = static_cast<unsigned>(col[j]);
        if (c >= static_cast<unsigned>(n_cols)) continue;
        const T v = be_load_op_t<kOp, T>(x, c);
        if (kCount) {
            cnt += v != T(0);
        } else if (kOp != 2) {
            if (v != T(0)) acc += w[kHomo ? 0 : (kPerm ? perm[j] : j)];
        } else {
            acc += w[kHomo ? 0 : (kPerm ? perm[j] : j)] * v;
        }
    }
    for (int off = 16; off > 0; off >>= 1) {
        if (kCount)
            cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
        else
            acc += __shfl_xor_sync(0xffffffffu, acc, off);
    }
    if (lane == 0) y[row] = kCount ? static_cast<T>(cnt) * w[0] : acc;
}

template <int kOp, bool kHomo, bool kPerm, typename T>
__global__ void csr_gather_mv_kernel(const int* __restrict__ ptr,
                                     const int* __restrict__ col,
                                     const int* __restrict__ perm,
                                     const T* __restrict__ w,
                                     const void* __restrict__ x,
                                     const int n_rows, const int n_cols,
                                     T* __restrict__ y) {
    csr_gather_mv_row<kOp, kHomo, kPerm, T>(
        (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5,
        ptr, col, perm, w, x, n_rows, n_cols, y);
}

}  // namespace
