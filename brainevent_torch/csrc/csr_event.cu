// Copyright 2026 The brainevent-tpu Authors.
// Licensed under the Apache License, Version 2.0.
//
// K7 and K8: the CSR matvecs of brainevent_torch/csr (pallas_kernels.py),
// over a structure (ptr (n_rows + 1,), col (nse,)) of int32, weights w of
// shape (1,) (homogeneous) or one per entry, in float32 or (the double
// instances, for float64 weights) float64, an optional slot permutation
// perm (the weight of entry j is w[perm[j]]; without it, w[j]) and an
// operand x whose values pass through an op: the event gate of a binary
// product (bool x, read as bytes, or float x gated at > 0) or the identity
// of a float product.
//
// K7 `csr_gather_mv` replaces brainevent_tpu/csr/pallas_kernels.py:
// csr_event_gather_kernel (:55):
//     y[r] = sum over j in [ptr[r], ptr[r+1]) of w[slot(j)] * op(x[col[j]]).
// One warp per row; its lanes walk the row 32 entries apart, a lane reads
// a weight only for an active event (binary products), and a fixed
// xor-shuffle tree combines the lanes: no atomics, the same bits on every
// run. Homogeneous binary products count in int32 and scale once by w[0],
// so they are exact. The kernel lives in csr_rows.cuh: K3 (plan_gather.cu)
// launches its float product over a gather plan's row index.
//
// K8 `csr_scatter_mv` replaces the XLA transpose branch of
// brainevent_tpu/csr/binary.py:_binary_csrmv_jax_kernel (:57, :72-74):
//     y[col[j]] += w[slot(j)] * op(x[r]) for the rows r with op(x[r]) != 0.
// A warp reads the operand of 32 rows at once, takes a ballot of the
// active ones, and walks each active row's range in turn, its lanes 32
// entries apart (K5's scheme, over ragged rows): only the rows of active
// events are read. Homogeneous binary products add int32 counts (exact at
// any order of the atomics) and a second kernel scales them once;
// otherwise float32 atomics add in the order they land.
//
// Ids outside [0, n_cols) (K7) or [0, n_out) (K8) are dropped. The TPU
// kernel compacts the active ids and reduces rows with one-hot MXU
// contractions because a TPU has no gather; none of that is needed here.
//
// Bound: K7 by the index and weight reads of every entry (8 bytes each,
// 80 MB at 10M entries) and the random operand gather (x stays in L2);
// K8 by its atomics, one per entry of an active row (atomicAdd on double
// is native on sm_90a).
#include "csr_rows.cuh"

namespace {

constexpr unsigned kFullMask = 0xffffffffu;

template <int kOp, bool kHomo, bool kPerm, typename T>
__global__ void csr_scatter_mv_kernel(const int* __restrict__ ptr,
                                      const int* __restrict__ col,
                                      const int* __restrict__ perm,
                                      const T* __restrict__ w,
                                      const void* __restrict__ x,
                                      const int n_rows, const int n_out,
                                      int* __restrict__ counts,
                                      T* __restrict__ y) {
    constexpr bool kCount = kHomo && kOp != 2;
    const int lane = threadIdx.x & 31;
    const long long warp =
        (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
    const long long n_warps =
        (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
    // the loop bound is the same for every lane, so the ballot sees all 32
    for (long long base = warp * 32; base < n_rows; base += n_warps * 32) {
        const long long i = base + lane;
        const T v = i < n_rows ? be_load_op_t<kOp, T>(x, i) : T(0);
        unsigned mask = __ballot_sync(kFullMask, v != T(0));
        while (mask) {
            const int src = __ffs(mask) - 1;
            mask &= mask - 1;
            const T vr = __shfl_sync(kFullMask, v, src);
            const long long r = base + src;
            const int end = ptr[r + 1];
            for (int j = ptr[r] + lane; j < end; j += 32) {
                const unsigned c = static_cast<unsigned>(col[j]);
                if (c >= static_cast<unsigned>(n_out)) continue;
                if (kCount) {
                    atomicAdd(counts + c, 1);
                } else {
                    const T wv = w[kHomo ? 0 : (kPerm ? perm[j] : j)];
                    atomicAdd(y + c, kOp == 2 ? wv * vr : wv);
                }
            }
        }
    }
}

template <typename T>
__global__ void scale_counts_kernel(const int* __restrict__ counts,
                                    const T* __restrict__ w,
                                    const int n, T* __restrict__ y) {
    const T w0 = w[0];
    for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < n;
         j += gridDim.x * blockDim.x)
        y[j] = static_cast<T>(counts[j]) * w0;
}

int blocks_for_warps(long long warps, long long cap) {
    const long long blocks = (warps * 32 + BE_BLOCK - 1) / BE_BLOCK;
    return static_cast<int>(blocks < cap ? blocks : cap);
}

}  // namespace

// op: 0 bool x (one byte per value), 1 float32 x gated at > 0, 2 float x
// in the value type. dbl: w, y (and x for op 2) are float64, else float32.
// perm may be null; it is not read for homogeneous weights. y (n_rows,)
// is written in full.
BE_EXPORT int csr_gather_mv_launch(const int* ptr, const int* col,
                                   const int* perm, const void* w,
                                   const void* x, int op, int homo, int dbl,
                                   int n_rows, int n_cols, void* y,
                                   int device, void* stream) {
    int err = be_begin(device);
    if (err) return err;
    if (n_rows <= 0) return be_end();
    const int blocks = blocks_for_warps(n_rows, 1LL << 30);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    BE_VALUE_DISPATCH(dbl, BE_CSR_DISPATCH(op, homo, perm,
        csr_gather_mv_kernel<O, H, P, T><<<blocks, BE_BLOCK, 0, st>>>(
            ptr, col, perm, static_cast<const T*>(w), x, n_rows, n_cols,
            static_cast<T*>(y))));
    return be_end();
}

// As above, over the rows of x (n_rows,). Homogeneous binary products
// (homo = 1, op < 2): counts (n_out,) int32 zeroed by the caller, y written
// in full. Otherwise y (n_out,) zeroed by the caller.
BE_EXPORT int csr_scatter_mv_launch(const int* ptr, const int* col,
                                    const int* perm, const void* w,
                                    const void* x, int op, int homo, int dbl,
                                    int n_rows, int n_out, int* counts,
                                    void* y, int device, void* stream) {
    int err = be_begin(device);
    if (err) return err;
    if (n_out <= 0) return be_end();
    const int blocks = blocks_for_warps((n_rows + 31) / 32,
                                        4 * BE_MAX_BLOCKS);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (blocks > 0)
        BE_VALUE_DISPATCH(dbl, BE_CSR_DISPATCH(op, homo, perm,
            csr_scatter_mv_kernel<O, H, P, T><<<blocks, BE_BLOCK, 0, st>>>(
                ptr, col, perm, static_cast<const T*>(w), x, n_rows, n_out,
                counts, static_cast<T*>(y))));
    if (homo && op != 2) {
        int sblocks = (n_out + BE_BLOCK - 1) / BE_BLOCK;
        if (sblocks > BE_MAX_BLOCKS) sblocks = BE_MAX_BLOCKS;
        BE_VALUE_DISPATCH(dbl,
            scale_counts_kernel<T><<<sblocks, BE_BLOCK, 0, st>>>(
                counts, static_cast<const T*>(w), n_out,
                static_cast<T*>(y)));
    }
    return be_end();
}
