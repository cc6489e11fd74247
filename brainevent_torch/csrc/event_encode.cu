// Copyright 2026 The brainevent-tpu Authors.
// Licensed under the Apache License, Version 2.0.
//
// K18 `event_row_count` (brainevent_torch/events/pallas_kernels.py)
// replaces brainevent_tpu/events/compact_ops.py:
// _csr_row_count_pallas_kernel (:470):
//     counts[r] = number of c with x[r, c] != 0, over a row-major (n, b)
//     spike matrix x, bool (one byte per value) or float32,
// with the non-zero gate of be_load_nonzero (common.cuh): NaN and negative
// spikes count. It is the row count of binary_2d_csr_row_count and of the
// CSR encoder built on it.
//
// One warp per row: its lanes read 32 neighbouring entries at a time,
// coalesced, and add __popc of their ballot, an exact int32 count. Bound:
// reading x once (b bytes or 4 b bytes per row). A warp walks its row
// alone, so a few long rows (16 x 8192) leave most of the card idle; a
// block per row there is later work.
#include "common.cuh"

namespace {

constexpr unsigned kFullMask = 0xffffffffu;

template <bool kBool>
__global__ void event_row_count_kernel(const void* __restrict__ x,
                                       const int n, const int b,
                                       int* __restrict__ counts) {
    const int lane = threadIdx.x & 31;
    const long long row =
        (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
    if (row >= n) return;                       // the whole warp leaves
    const long long off = row * b;
    int cnt = 0;
    // the loop bound is the same for every lane, so the ballot sees all 32
    for (int base = 0; base < b; base += 32) {
        const int c = base + lane;
        const bool on = c < b && be_load_nonzero<kBool>(x, off + c) != 0.0f;
        cnt += __popc(__ballot_sync(kFullMask, on));
    }
    if (lane == 0) counts[row] = cnt;
}

}  // namespace

// x (n, b) row-major, bool (x_bool = 1) or float32; counts (n,) int32 is
// written in full.
BE_EXPORT int event_row_count_launch(const void* x, int x_bool, int n, int b,
                                     int* counts, int device, void* stream) {
    int err = be_begin(device);
    if (err) return err;
    if (n <= 0) return be_end();
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const long long blocks =
        (static_cast<long long>(n) * 32 + BE_BLOCK - 1) / BE_BLOCK;
    if (x_bool)
        event_row_count_kernel<true><<<static_cast<int>(blocks), BE_BLOCK, 0,
                                       st>>>(x, n, b, counts);
    else
        event_row_count_kernel<false><<<static_cast<int>(blocks), BE_BLOCK, 0,
                                        st>>>(x, n, b, counts);
    return be_end();
}
