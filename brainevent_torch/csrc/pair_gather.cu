// Copyright 2026 The brainevent-tpu Authors.
// Licensed under the Apache License, Version 2.0.
//
// K9 `pair_gather` (brainevent_torch/ops/pair_gather.py) replaces
// brainevent_tpu/ops/pair_gather.py:_make_kernel (:72):
//     out[e] = s[rows[e]] * x[cols[e]]
// in nnz order, or one gathered side alone when the other is null, in
// float32 or (the double instance, for float64 sides) float64. An id
// outside its operand (-1 among them) gives an exact 0. It serves the CSR
// STDP updates and the weight gradients of the CSR matvecs.
//
// One thread per entry, grid-stride: two coalesced id reads, two gathers
// from operands that stay in L2, one multiply (the twin's one rounding,
// so the two are bitwise equal) and one coalesced write. The TPU kernel
// gathers through one-hot MXU contractions with bf16 splits because a TPU
// has no gather; none of that is needed here.
//
// Bound: memory bandwidth, 12 bytes per entry moved plus the gathers
// (120 MB at 10M entries).
#include "common.cuh"

namespace {

template <typename T>
__device__ __forceinline__ T side(const int* __restrict__ ids,
                                  const T* __restrict__ v, int n,
                                  long long e) {
    const unsigned i = static_cast<unsigned>(ids[e]);
    return i < static_cast<unsigned>(n) ? v[i] : T(0);
}

template <typename T>
__global__ void pair_gather_kernel(const int* __restrict__ rows,
                                   const int* __restrict__ cols,
                                   const T* __restrict__ s,
                                   const T* __restrict__ x,
                                   const int n_s, const int n_x,
                                   const long long nse,
                                   T* __restrict__ out) {
    const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
    for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
         e < nse; e += stride) {
        T v;
        if (s != nullptr && x != nullptr)
            v = side(rows, s, n_s, e) * side(cols, x, n_x, e);
        else if (s != nullptr)
            v = side(rows, s, n_s, e);
        else
            v = side(cols, x, n_x, e);
        out[e] = v;
    }
}

}  // namespace

// rows/s or cols/x may be null (not both); out (nse,) written in full.
// dbl: s, x and out are float64, else float32.
BE_EXPORT int pair_gather_launch(const int* rows, const int* cols,
                                 const void* s, const void* x, int n_s,
                                 int n_x, long long nse, int dbl, void* out,
                                 int device, void* stream) {
    int err = be_begin(device);
    if (err) return err;
    if (nse <= 0) return be_end();
    long long blocks = (nse + BE_BLOCK - 1) / BE_BLOCK;
    if (blocks > 8 * BE_MAX_BLOCKS) blocks = 8 * BE_MAX_BLOCKS;
    BE_VALUE_DISPATCH(dbl,
        pair_gather_kernel<T><<<static_cast<int>(blocks), BE_BLOCK, 0,
                                static_cast<cudaStream_t>(stream)>>>(
            rows, cols, static_cast<const T*>(s), static_cast<const T*>(x),
            n_s, n_x, nse, static_cast<T*>(out)));
    return be_end();
}
