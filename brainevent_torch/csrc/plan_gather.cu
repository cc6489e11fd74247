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
// the surrogate-training backward: K3's y plus, in the same call,
//     dw[e] = s[row_e] * x[col_e]
// for every valid slot, and 0 at every padding slot.
//
// The TPU kernels walk the plan chunk by chunk and reach a row through
// one-hot MXU contractions with bf16 hi/lo splits, because a TPU has no
// gather. Here each output is read in the order it wants:
//
// - y is a row gather: the host keeps a row index (row_ptr, row_cols: the
//   valid slots of each row in slot order, and their columns) and the
//   weights in that row order, w_row[j] = w_sorted[row_slots[j]] (reordered
//   once per weight update, GatherPlan.sort_rows). That is K7's float
//   product, whose body both K3 and K4 launch (csr_rows.cuh): one warp a
//   row, its lanes 32 entries apart, a fixed xor-shuffle tree, no atomics,
//   so the same inputs give the same bits on every run and K3's y is K4's.
//   8 coalesced bytes a slot and a gather from x, which stays in L2. K3 is
//   this pass alone; its bound, those bytes, is 80 MB at the 100k x 100
//   ELL's 10M slots, 0.024 ms at 3.35 TB/s;
// - dw is written in plan order, one pass over the slots: a thread takes 4
//   consecutive slots of a chunk, reads their packed metadata (16 coalesced
//   bytes), decodes row and column with the chunk's rb and b0 (bit layout
//   mxu_gather.py:77-80), gathers s[row] (a row block's 4 KB, which stays in
//   L1) and x[col] (columns ascend within a chunk), and writes 16 coalesced
//   bytes of dw. A chunk's valid slots are a prefix of it (the plan fills
//   slot `within % chunk` of each chunk in turn, and padding chunks are
//   whole), so a per-chunk count n_valid says which slots to write 0 and
//   the wrapper allocates dw without zeroing it.
//
// K4 runs both passes in one grid whose blocks alternate between them, so
// the row gather's latency-bound loads and the dw pass's streaming overlap
// (two launches, one after the other, took 1.13x as long on the H100).
// Bound: bytes, the plan's meta and w read and dw written once (12 bytes a
// slot), 0.036 ms at 10M slots; the passes move 16 bytes a slot (the row
// view's w_row and row_cols, then meta and dw).
#include "csr_rows.cuh"

namespace {

// packed metadata: lane (7 bits) | block-local row (10) | window block (8)
constexpr int kColBits = 7;
constexpr int kRowBits = 10;
constexpr int kBlkBits = 8;
constexpr int kLanes = 128;

// Threads per block and slots per thread of the dw pass.
constexpr int kDwBlock = 256;
constexpr int kDwSlots = 4;
static_assert(kDwBlock == BE_BLOCK, "K4's y blocks are K3's");

// Block `blk` of the dw pass: dw[e] for kV consecutive slots from e0 a
// thread (kV divides chunk, so they lie in one chunk; with kV = 4, meta and
// dw are 16-byte aligned).
template <int kV>
__device__ __forceinline__ void plan_dw_block(
    const long long blk, const int* __restrict__ meta,
    const int* __restrict__ b0, const int* __restrict__ rb,
    const int* __restrict__ n_valid, const long long n_slots,
    const int chunk, const int row_block, const int n_rows, const int n_cols,
    const float* __restrict__ s, const float* __restrict__ x,
    float* __restrict__ dw) {
    const long long e0 = (blk * kDwBlock + threadIdx.x) * kV;
    if (e0 >= n_slots) return;
    // a 32-bit division where the slots allow it (a 64-bit one costs ~100
    // instructions a thread)
    const long long c = n_slots <= 0xffffffffll
        ? static_cast<unsigned>(e0) / static_cast<unsigned>(chunk)
        : e0 / chunk;
    const int within = static_cast<int>(e0 - c * chunk);
    const int nv = n_valid[c];
    float out[kV];
    if (within < nv) {
        int m[kV];
        if constexpr (kV == 4) {
            const int4 v = *reinterpret_cast<const int4*>(meta + e0);
            m[0] = v.x; m[1] = v.y; m[2] = v.z; m[3] = v.w;
        } else {
#pragma unroll
            for (int i = 0; i < kV; ++i) m[i] = meta[e0 + i];
        }
        const int row0 = rb[c] * row_block;
        const int col0 = b0[c] * kLanes;
#pragma unroll
        for (int i = 0; i < kV; ++i) {
            out[i] = 0.0f;
            if (within + i < nv) {
                const int lane = m[i] & ((1 << kColBits) - 1);
                const int local = (m[i] >> kColBits) & ((1 << kRowBits) - 1);
                const int blk =
                    (m[i] >> (kColBits + kRowBits)) & ((1 << kBlkBits) - 1);
                const int row = min(row0 + local, n_rows - 1);
                const int col = min(col0 + blk * kLanes + lane, n_cols - 1);
                out[i] = s[row] * x[col];
            }
        }
    } else {
#pragma unroll
        for (int i = 0; i < kV; ++i) out[i] = 0.0f;
    }
    if constexpr (kV == 4) {
        *reinterpret_cast<float4*>(dw + e0) =
            make_float4(out[0], out[1], out[2], out[3]);
    } else {
#pragma unroll
        for (int i = 0; i < kV; ++i) dw[e0 + i] = out[i];
    }
}

// K4 in one grid: while both passes have blocks left, block 2b takes the
// y pass's block b and block 2b + 1 the dw pass's, so that the row
// gather's dependent loads and the dw pass's streaming run side by side on
// every SM; the blocks past that take the longer pass's rest. ny and ndw:
// the two passes' blocks of kDwBlock threads.
template <int kV>
__global__ void __launch_bounds__(kDwBlock)
plan_matvec_dw_kernel(const int* __restrict__ meta,
                      const int* __restrict__ b0, const int* __restrict__ rb,
                      const int* __restrict__ n_valid,
                      const int* __restrict__ row_ptr,
                      const int* __restrict__ row_cols,
                      const float* __restrict__ w_row,
                      const long long n_slots, const int chunk,
                      const int row_block, const int n_rows,
                      const int n_cols, const float* __restrict__ s,
                      const float* __restrict__ x, float* __restrict__ y,
                      float* __restrict__ dw, const long long ny,
                      const long long ndw) {
    const long long b = blockIdx.x;
    const long long pairs = min(ny, ndw);
    const bool y_pass = b < 2 * pairs ? (b & 1) == 0 : ny > ndw;
    const long long blk = b < 2 * pairs ? b >> 1 : b - pairs;
    if (y_pass)
        csr_gather_mv_row<2, false, false, float>(
            (blk * kDwBlock + threadIdx.x) >> 5, row_ptr, row_cols, nullptr,
            w_row, x, n_rows, n_cols, y);
    else
        plan_dw_block<kV>(blk, meta, b0, rb, n_valid, n_slots, chunk,
                          row_block, n_rows, n_cols, s, x, dw);
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

// meta (n_chunks, chunk): the plan's packed slots; b0, rb, n_valid
// (n_chunks,): each chunk's window start, row block and valid-slot count;
// row_ptr (n_rows + 1,), row_cols and w_row (nse,): the row index and the
// weights in row order; s (n_rows,), x (n_cols,), y (n_rows,); dw
// (n_chunks, chunk). y and dw are written in full.
BE_EXPORT int plan_matvec_dw_launch(const int* meta, const int* b0,
                                    const int* rb, const int* n_valid,
                                    const int* row_ptr, const int* row_cols,
                                    const float* w_row, int n_rows,
                                    int n_cols, int n_chunks, int chunk,
                                    int row_block, const float* s,
                                    const float* x, float* y, float* dw,
                                    int device, void* stream) {
    int err = be_begin(device);
    if (err) return err;
    const long long n_slots = static_cast<long long>(n_chunks) * chunk;
    const bool vec = chunk % kDwSlots == 0 &&
                     reinterpret_cast<unsigned long long>(meta) % 16 == 0 &&
                     reinterpret_cast<unsigned long long>(dw) % 16 == 0;
    const long long ny = n_rows > 0 ? rows_blocks(n_rows) : 0;
    const long long ndw =
        (n_slots / (vec ? kDwSlots : 1) + kDwBlock - 1) / kDwBlock;
    if (ny + ndw == 0) return be_end();
    const unsigned blocks = static_cast<unsigned>(ny + ndw);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (vec)
        plan_matvec_dw_kernel<kDwSlots><<<blocks, kDwBlock, 0, st>>>(
            meta, b0, rb, n_valid, row_ptr, row_cols, w_row, n_slots, chunk,
            row_block, n_rows, n_cols, s, x, y, dw, ny, ndw);
    else
        plan_matvec_dw_kernel<1><<<blocks, kDwBlock, 0, st>>>(
            meta, b0, rb, n_valid, row_ptr, row_cols, w_row, n_slots, chunk,
            row_block, n_rows, n_cols, s, x, y, dw, ny, ndw);
    return be_end();
}
