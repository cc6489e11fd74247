// Copyright 2026 The brainevent-tpu Authors.
// Licensed under the Apache License, Version 2.0.
//
// K17: the dense STDP updates of brainevent_torch/dense (pallas_kernels.py,
// ops `dense_stdp_pre` and `dense_stdp_post`), out of place over a
// row-major W (m, n), float32, or float64 (with a float64 trace) in the
// double instances:
//   on-pre, replacing brainevent_tpu/dense/plasticity.py:
//   _on_pre_pallas_kernel (:55):   out[i, j] = W[i, j] + g(s[i]) * t[j];
//   on-post, replacing _on_post_pallas_kernel (:95):
//                                  out[i, j] = W[i, j] + t[i] * g(s[j]);
// then, when bounds are given, clipped to [lo, hi] over the whole matrix,
// as the JAX package clips it (plasticity.py:170-193). g is the non-zero
// gate of be_load_nonzero (common.cuh): a bool spike on its truth, a float
// spike where != 0, NaN and negatives included.
//
// g is 0 or 1, so g * t is exact and one be_fma(g, t, w) is the same
// single rounding as the twin's w + outer(g, t): the result is bitwise the
// twin's and the JAX package's. The clip compares (v < lo, v > hi), so a
// NaN passes through it, as through jnp.clip and torch.clamp.
//
// One pass over W, a block per row in turn: 16 bytes per thread when the
// rows allow (float32, n % 4 == 0 and 16-byte aligned pointers), else one
// value. Bound:
// reading W and writing the output once, 8 bytes per entry (0.8 GB at
// 10k x 10k); the spikes and traces stay in L1/L2. Every entry is read,
// since the clip covers the whole matrix; an in-place update of the
// active rows alone would change that contract.
#include "common.cuh"

namespace {

template <typename T>
__device__ __forceinline__ T clip_to(T v, int has_lo, T lo, int has_hi,
                                     T hi) {
    if (has_lo && v < lo) v = lo;
    if (has_hi && v > hi) v = hi;
    return v;
}

template <bool kBool, bool kPost, bool kVec, typename T>
__global__ void dense_stdp_kernel(const T* __restrict__ W,
                                  const void* __restrict__ s,
                                  const T* __restrict__ t, const int m,
                                  const int n, const int has_lo, const T lo,
                                  const int has_hi, const T hi,
                                  T* __restrict__ out) {
    static_assert(!kVec || sizeof(T) == sizeof(float),
                  "the 16-byte path is float32's");
    for (long long r = blockIdx.x; r < m; r += gridDim.x) {
        const T* wr = W + r * n;
        T* orow = out + r * n;
        // on-pre: the row's gate times the trace along the row;
        // on-post: the row's trace times the gates along the row
        const T rv = kPost ? t[r] : T(be_load_nonzero<kBool>(s, r));
        if constexpr (kVec) {
            const int n4 = n >> 2;
            for (int c = threadIdx.x; c < n4; c += blockDim.x) {
                const float4 w = reinterpret_cast<const float4*>(wr)[c];
                float4 cv;
                if (kPost) {
                    cv.x = be_load_nonzero<kBool>(s, 4 * c);
                    cv.y = be_load_nonzero<kBool>(s, 4 * c + 1);
                    cv.z = be_load_nonzero<kBool>(s, 4 * c + 2);
                    cv.w = be_load_nonzero<kBool>(s, 4 * c + 3);
                } else {
                    cv = reinterpret_cast<const float4*>(t)[c];
                }
                float4 o;
                o.x = clip_to(__fmaf_rn(rv, cv.x, w.x), has_lo, lo, has_hi,
                              hi);
                o.y = clip_to(__fmaf_rn(rv, cv.y, w.y), has_lo, lo, has_hi,
                              hi);
                o.z = clip_to(__fmaf_rn(rv, cv.z, w.z), has_lo, lo, has_hi,
                              hi);
                o.w = clip_to(__fmaf_rn(rv, cv.w, w.w), has_lo, lo, has_hi,
                              hi);
                reinterpret_cast<float4*>(orow)[c] = o;
            }
        } else {
            for (int c = threadIdx.x; c < n; c += blockDim.x) {
                const T cv =
                    kPost ? T(be_load_nonzero<kBool>(s, c)) : t[c];
                orow[c] = clip_to(be_fma(rv, cv, wr[c]), has_lo, lo,
                                  has_hi, hi);
            }
        }
    }
}

template <bool kPost, bool kVec, typename T>
void launch(const T* W, const void* s, const T* t, int spike_bool, int m,
            int n, int has_lo, T lo, int has_hi, T hi, T* out,
            cudaStream_t st) {
    const int blocks = m < 4 * BE_MAX_BLOCKS ? m : 4 * BE_MAX_BLOCKS;
    if (spike_bool)
        dense_stdp_kernel<true, kPost, kVec, T><<<blocks, BE_BLOCK, 0, st>>>(
            W, s, t, m, n, has_lo, lo, has_hi, hi, out);
    else
        dense_stdp_kernel<false, kPost, kVec, T><<<blocks, BE_BLOCK, 0,
                                                   st>>>(
            W, s, t, m, n, has_lo, lo, has_hi, hi, out);
}

}  // namespace

// W, out (m, n) and t: float64 when dbl is set, else float32; post = 0:
// s (m,), t (n,); post = 1: t (m,), s (n,). spike_bool: s is bool (one
// byte per value), else float32. The bounds lo, hi come as doubles and are
// taken in the value type. vec (float32 only): n % 4 == 0 and W, out (and
// t for on-pre) 16-byte aligned. out is written in full.
BE_EXPORT int dense_stdp_launch(const void* W, const void* s, const void* t,
                                int spike_bool, int post, int dbl, int m,
                                int n, int has_lo, double lo, int has_hi,
                                double hi, int vec, void* out, int device,
                                void* stream) {
    int err = be_begin(device);
    if (err) return err;
    if (m <= 0 || n <= 0) return be_end();
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dbl) {
        const double* Wd = static_cast<const double*>(W);
        const double* td = static_cast<const double*>(t);
        double* od = static_cast<double*>(out);
        if (post)
            launch<true, false, double>(Wd, s, td, spike_bool, m, n, has_lo,
                                        lo, has_hi, hi, od, st);
        else
            launch<false, false, double>(Wd, s, td, spike_bool, m, n, has_lo,
                                         lo, has_hi, hi, od, st);
        return be_end();
    }
    const float* Wf = static_cast<const float*>(W);
    const float* tf = static_cast<const float*>(t);
    float* of = static_cast<float*>(out);
    const float lof = static_cast<float>(lo), hif = static_cast<float>(hi);
    if (post && vec)
        launch<true, true, float>(Wf, s, tf, spike_bool, m, n, has_lo, lof,
                                  has_hi, hif, of, st);
    else if (post)
        launch<true, false, float>(Wf, s, tf, spike_bool, m, n, has_lo, lof,
                                   has_hi, hif, of, st);
    else if (vec)
        launch<false, true, float>(Wf, s, tf, spike_bool, m, n, has_lo, lof,
                                   has_hi, hif, of, st);
    else
        launch<false, false, float>(Wf, s, tf, spike_bool, m, n, has_lo, lof,
                                    has_hi, hif, of, st);
    return be_end();
}
