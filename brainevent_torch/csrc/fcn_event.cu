// Copyright 2026 The brainevent-tpu Authors.
// Licensed under the Apache License, Version 2.0.
//
// K5 and K6: the event-driven binary ELL products of `binary_fcnmv`
// (brainevent_torch/fcn/binary.py), over a row-major (n_pre, n_conn) int32
// table idx, weights w of shape (1,) (homogeneous) or (n_pre, n_conn) in
// float32 or (the double instances, for float64 weights) float64, and
// spikes s (bool or float32; a float spike is active where s > 0).
//
// K5 `fcn_event_scatter` (transpose=True) replaces
// brainevent_tpu/fcn/pallas_kernels.py:fcn_event_scatter_kernel (:260):
//     y[idx[i, k]] += w[i, k] for every active i.
// Each warp reads the spikes of 32 rows at once, takes a ballot of the
// active ones, and walks each active row in turn, its lanes over the row's
// n_conn targets: only the rows of active neurons are read. Homogeneous
// weights add int32 hit counts (exact at any order of the atomics) and a
// second kernel scales them once by w[0], as the TPU kernel does
// (pallas_kernels.py:377-378). Heterogeneous weights add float32 with
// atomics, whose rounding follows the order they land in.
//
// K6 `fcn_event_gather` (transpose=False) replaces
// :fcn_event_gather_kernel (:143):
//     y[i] = sum_k w[i, k] * gate(s[idx[i, k]]).
// One warp per row; a lane reads w[i, k] only where the target is active,
// counts (homogeneous) or sums (heterogeneous) them, and a fixed shuffle
// tree combines the lanes: no atomics, the same bits on every run.
//
// Targets outside [0, n_post) are dropped by both. The TPU kernels compact
// the active ids with prefix-sum rank maps and contract one-hot factors on
// the MXU because a TPU has no atomics and no gather; none of that is
// needed here.
//
// Bound: K5 by the atomics of the active rows (n_conn per spike) and the
// 1 or 4 bytes per row of the spike read; K6 by the index table (4 bytes
// per synapse, 40 MB at 100k x 100) and the random spike gather.
#include "common.cuh"

namespace {

constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ bool active(const unsigned char* s, long long i) {
    return s[i] != 0;
}

__device__ __forceinline__ bool active(const float* s, long long i) {
    return s[i] > 0.0f;
}

template <typename S, bool kHomo, typename T>
__global__ void fcn_event_scatter_kernel(const int* __restrict__ idx,
                                         const T* __restrict__ w,
                                         const S* __restrict__ s,
                                         const int n_pre, const int n_conn,
                                         const int n_post,
                                         int* __restrict__ counts,
                                         T* __restrict__ y) {
    const int lane = threadIdx.x & 31;
    const long long warp =
        (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
    const long long n_warps =
        (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
    // the loop bound is the same for every lane, so the ballot sees all 32
    for (long long base = warp * 32; base < n_pre; base += n_warps * 32) {
        const long long i = base + lane;
        unsigned mask = __ballot_sync(kFullMask, i < n_pre && active(s, i));
        while (mask) {
            const long long row = (base + __ffs(mask) - 1) * n_conn;
            mask &= mask - 1;
            for (int k = lane; k < n_conn; k += 32) {
                const unsigned t = static_cast<unsigned>(idx[row + k]);
                if (t >= static_cast<unsigned>(n_post)) continue;
                if (kHomo)
                    atomicAdd(counts + t, 1);
                else
                    atomicAdd(y + t, w[row + k]);
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

template <typename S, bool kHomo, typename T>
__global__ void fcn_event_gather_kernel(const int* __restrict__ idx,
                                        const T* __restrict__ w,
                                        const S* __restrict__ s,
                                        const int n_pre, const int n_conn,
                                        const int n_post,
                                        T* __restrict__ y) {
    const int lane = threadIdx.x & 31;
    const long long i =
        (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
    if (i >= n_pre) return;                     // the whole warp leaves
    const long long row = i * n_conn;
    int cnt = 0;
    T acc = T(0);
    for (int k = lane; k < n_conn; k += 32) {
        const unsigned t = static_cast<unsigned>(idx[row + k]);
        if (t >= static_cast<unsigned>(n_post) || !active(s, t)) continue;
        if (kHomo)
            ++cnt;
        else
            acc += w[row + k];
    }
    for (int off = 16; off > 0; off >>= 1) {
        if (kHomo)
            cnt += __shfl_xor_sync(kFullMask, cnt, off);
        else
            acc += __shfl_xor_sync(kFullMask, acc, off);
    }
    if (lane == 0) y[i] = kHomo ? static_cast<T>(cnt) * w[0] : acc;
}

int grid_for_warps(long long warps, int cap) {
    const long long blocks = (warps * 32 + BE_BLOCK - 1) / BE_BLOCK;
    return static_cast<int>(blocks < cap ? blocks : cap);
}

template <typename S, typename T>
void launch_scatter(const int* idx, const T* w, const void* s, int homo,
                    int n_pre, int n_conn, int n_post, int* counts, T* y,
                    cudaStream_t stream) {
    const int blocks = grid_for_warps((n_pre + 31) / 32, 4 * BE_MAX_BLOCKS);
    const S* spk = static_cast<const S*>(s);
    if (blocks > 0) {
        if (homo)
            fcn_event_scatter_kernel<S, true, T>
                <<<blocks, BE_BLOCK, 0, stream>>>(idx, w, spk, n_pre, n_conn,
                                                  n_post, counts, y);
        else
            fcn_event_scatter_kernel<S, false, T>
                <<<blocks, BE_BLOCK, 0, stream>>>(idx, w, spk, n_pre, n_conn,
                                                  n_post, counts, y);
    }
    if (homo) {
        int sblocks = (n_post + BE_BLOCK - 1) / BE_BLOCK;
        if (sblocks > BE_MAX_BLOCKS) sblocks = BE_MAX_BLOCKS;
        scale_counts_kernel<T><<<sblocks, BE_BLOCK, 0, stream>>>(counts, w,
                                                                 n_post, y);
    }
}

template <typename S, typename T>
void launch_gather(const int* idx, const T* w, const void* s, int homo,
                   int n_pre, int n_conn, int n_post, T* y,
                   cudaStream_t stream) {
    const int blocks = grid_for_warps(n_pre, 1 << 30);
    const S* spk = static_cast<const S*>(s);
    if (homo)
        fcn_event_gather_kernel<S, true, T><<<blocks, BE_BLOCK, 0, stream>>>(
            idx, w, spk, n_pre, n_conn, n_post, y);
    else
        fcn_event_gather_kernel<S, false, T><<<blocks, BE_BLOCK, 0, stream>>>(
            idx, w, spk, n_pre, n_conn, n_post, y);
}

}  // namespace

// s: bool (one byte per spike) when s_is_float is 0, else float32. dbl:
// w and y are float64, else float32. Homogeneous (homo = 1): counts
// (n_post,) int32 zeroed by the caller, y written in full. Heterogeneous:
// y (n_post,) zeroed by the caller.
BE_EXPORT int fcn_event_scatter_launch(const int* idx, const void* w,
                                       const void* s, int s_is_float,
                                       int homo, int dbl, int n_pre,
                                       int n_conn, int n_post, int* counts,
                                       void* y, int device, void* stream) {
    int err = be_begin(device);
    if (err) return err;
    if (n_post <= 0) return be_end();
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    BE_VALUE_DISPATCH(dbl, {
        const T* wt = static_cast<const T*>(w);
        T* yt = static_cast<T*>(y);
        if (s_is_float)
            launch_scatter<float, T>(idx, wt, s, homo, n_pre, n_conn, n_post,
                                     counts, yt, st);
        else
            launch_scatter<unsigned char, T>(idx, wt, s, homo, n_pre, n_conn,
                                             n_post, counts, yt, st);
    });
    return be_end();
}

// y (n_pre,) written in full; dbl as above.
BE_EXPORT int fcn_event_gather_launch(const int* idx, const void* w,
                                      const void* s, int s_is_float, int homo,
                                      int dbl, int n_pre, int n_conn,
                                      int n_post, void* y, int device,
                                      void* stream) {
    int err = be_begin(device);
    if (err) return err;
    if (n_pre <= 0) return be_end();
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    BE_VALUE_DISPATCH(dbl, {
        const T* wt = static_cast<const T*>(w);
        T* yt = static_cast<T*>(y);
        if (s_is_float)
            launch_gather<float, T>(idx, wt, s, homo, n_pre, n_conn, n_post,
                                    yt, st);
        else
            launch_gather<unsigned char, T>(idx, wt, s, homo, n_pre, n_conn,
                                            n_post, yt, st);
    });
    return be_end();
}
