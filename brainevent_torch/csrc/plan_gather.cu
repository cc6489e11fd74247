// Copyright 2026 The brainevent-tpu Authors.
// Licensed under the Apache License, Version 2.0.
//
// K3 and K4: float sparse matvecs over a gather plan
// (brainevent_torch/ops/mxu_gather.py).
//
// K3 `plan_gather_mv` replaces brainevent_tpu/ops/mxu_gather.py:_make_kernel
// (:288, the `gather_matvec` Pallas kernel):
//     y[r] = sum over the slots e of row r of w_sorted[e] * x[col_e].
// K4 `plan_matvec_dw` replaces :_make_mvdw_kernel (:633, `plan_matvec_dw`),
// the surrogate-training backward: K3's y plus, in the same launch,
//     dw[e] = s[row_e] * x[col_e]
// for every valid slot. dw is zeroed by the caller, so padding slots read 0.
//
// The TPU kernels walk the plan chunk by chunk and reach a row through
// one-hot MXU contractions with bf16 hi/lo splits, because a TPU has no
// gather. Here the plan is read row by row: the host builds a row index
// (row_ptr, row_slots: the valid slots of each row, in slot order, and
// row_cols: their columns), one warp takes one row, its lanes walk the
// row's entries 32 apart, gather x, and sum. The lane sums are combined by
// a fixed xor-shuffle tree, so the result does not depend on scheduling:
// the same inputs give the same bits on every run (no float atomics). Each
// row is written once, so y needs no zeroing.
//
// K3 reads the row index alone: (row_ptr, row_cols) and the weights in row
// order, w_row[j] = w_sorted[row_slots[j]] (the host reorders them once per
// weight update, GatherPlan.sort_rows). That is K7's float product, whose
// body it launches (csr_rows.cuh): 8 coalesced bytes a slot and a gather
// from x, which stays in L2. Bound: those bytes, 80 MB at the 100k x 100
// ELL's 10M slots, 0.024 ms at 3.35 TB/s. Each lane adds the same slots in
// the same order as K4 does and multiplies then adds (-fmad=false), so K3's
// y is K4's bit for bit.
//
// K4 walks the row's plan slots (row_slots) and decodes each slot's column
// from meta and b0 (bit layout mxu_gather.py:77-80), because it writes dw
// in plan order. Bound: memory latency; a slot costs three scattered 4-byte
// reads (meta[e] and w[e] lie within the row's row block of the plan; x[col]
// is a random gather from a vector that stays in L2) and one 4-byte write,
// ~120-160 MB per launch at 10M slots.
#include "csr_rows.cuh"

namespace {

constexpr unsigned kFullMask = 0xffffffffu;

// packed metadata: lane (7 bits) | block-local row (10) | window block (8)
constexpr int kColBits = 7;
constexpr int kRowBits = 10;
constexpr int kBlkBits = 8;
constexpr int kLanes = 128;

__device__ __forceinline__ float warp_sum(float v) {
    // xor butterfly: every lane ends with the same sum, in a fixed order
    for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(kFullMask, v, off);
    return v;
}

__global__ void plan_matvec_dw_kernel(const int* __restrict__ meta,
                                      const int* __restrict__ b0,
                                      const int* __restrict__ row_ptr,
                                      const int* __restrict__ row_slots,
                                      const float* __restrict__ w,
                                      const int n_rows, const int n_cols,
                                      const int chunk,
                                      const float* __restrict__ s,
                                      const float* __restrict__ x,
                                      float* __restrict__ y,
                                      float* __restrict__ dw) {
    const int lane = threadIdx.x & 31;
    const long long row =
        (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
    if (row >= n_rows) return;                  // the whole warp leaves
    const int begin = row_ptr[row];
    const int end = row_ptr[row + 1];
    const float s_row = s[row];
    float acc = 0.0f;
    for (int j = begin + lane; j < end; j += 32) {
        const int e = row_slots[j];
        const int m = meta[e];
        const int blk = (m >> (kColBits + kRowBits)) & ((1 << kBlkBits) - 1);
        int col = (b0[e / chunk] + blk) * kLanes + (m & ((1 << kColBits) - 1));
        col = min(col, n_cols - 1);
        const float xv = x[col];
        acc += w[e] * xv;
        dw[e] = s_row * xv;
    }
    acc = warp_sum(acc);
    if (lane == 0) y[row] = acc;
}

int rows_blocks(int n_rows) {
    const int warps_per_block = BE_BLOCK / 32;
    return (n_rows + warps_per_block - 1) / warps_per_block;
}

}  // namespace

// row_ptr (n_rows + 1,), row_cols (nse,): the plan's row index; w_row
// (nse,): the weights in the same (row) order; x (n_cols,); y (n_rows,).
BE_EXPORT int plan_gather_mv_launch(const int* row_ptr, const int* row_cols,
                                    const float* w_row, int n_rows,
                                    int n_cols, const float* x, float* y,
                                    int device, void* stream) {
    int err = be_begin(device);
    if (err) return err;
    if (n_rows <= 0) return be_end();
    csr_gather_mv_kernel<2, false, false, float><<<
        rows_blocks(n_rows), BE_BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
        row_ptr, row_cols, nullptr, w_row, x, n_rows, n_cols, y);
    return be_end();
}

// meta, w: the plan's (n_chunks, chunk) arrays; b0 (n_chunks,); row_ptr
// (n_rows + 1,) and row_slots (nse,): the row index; s (n_rows,), x
// (n_cols,), y (n_rows,); dw (n_chunks, chunk), zeroed by the caller.
BE_EXPORT int plan_matvec_dw_launch(const int* meta, const int* b0,
                                    const int* row_ptr, const int* row_slots,
                                    const float* w, int n_rows, int n_cols,
                                    int chunk, const float* s, const float* x,
                                    float* y, float* dw, int device,
                                    void* stream) {
    int err = be_begin(device);
    if (err) return err;
    if (n_rows <= 0) return be_end();
    plan_matvec_dw_kernel<<<rows_blocks(n_rows), BE_BLOCK, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        meta, b0, row_ptr, row_slots, w, n_rows, n_cols, chunk, s, x, y, dw);
    return be_end();
}
