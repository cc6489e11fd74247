// Copyright 2026 The brainevent-tpu Authors.
// Licensed under the Apache License, Version 2.0.
//
// The light RNG of the implicit-connectivity (JITC) sampler, as __device__
// functions in native uint32_t: brainevent_tpu/rng/light.py, bit for bit,
// and brainevent_torch/rng/light.py (the PyTorch twin, in int64). The draws
// are the sampled matrix, so each function here must give the twin's bits:
//
// - the high multiply _mulhi32 is __umulhi;
// - Acklam's Horner polynomials take one FMA per step (__fmaf_rn; the
//   library is built with -fmad=false), as XLA on the CPU contracts them;
// - log is taken in double and rounded to float, as the twin takes it;
// - the float constants are written as the exact float32 values the twin
//   and the JAX package use (hex literals).
#pragma once

#include <cstdint>

constexpr uint32_t LR_ZERO_ESCAPE = 0x6D2B79F5u;

__device__ __forceinline__ uint32_t lr_mix32(uint32_t x) {
    x ^= x >> 16;
    x *= 0x7FEB352Du;
    x ^= x >> 15;
    x *= 0x846CA68Bu;
    return x ^ (x >> 16);
}

// Map a uniform uint32 r into [0, bound) without modulo bias.
__device__ __forceinline__ uint32_t lr_bounded(uint32_t r, uint32_t bound) {
    return __umulhi(r, bound);
}

// xorshift32 (13/17/5); a zero state escapes to a constant.
__device__ __forceinline__ uint32_t lr_next(uint32_t x) {
    x ^= x << 13;
    x ^= x >> 17;
    x ^= x << 5;
    return x == 0u ? LR_ZERO_ESCAPE : x;
}

// The seed of stream (row, chunk, lane).
__device__ __forceinline__ uint32_t lr_init(uint32_t seed, uint32_t row,
                                            uint32_t chunk, uint32_t lane) {
    uint32_t x = seed ^ 0xD1B54A35u;
    x ^= row * 0x85EBCA6Bu;
    x ^= chunk * 0xC2B2AE35u;
    x ^= lane * 0x27D4EB2Du;
    x = lr_mix32(x);
    return x == 0u ? LR_ZERO_ESCAPE : x;
}

// Stateless 24-bit uniform in [0, 1) per (seed, row, col) edge.
__device__ __forceinline__ float lr_uniform01(uint32_t seed, uint32_t row,
                                              uint32_t col) {
    uint32_t h = seed ^ 0xA0761D65u;
    h ^= row * 0xE7037ED1u;
    h ^= col * 0x8EBC6AF1u;
    h = lr_mix32(h);
    return static_cast<float>(static_cast<int>(h & 0x00FFFFFFu)) *
           0x1p-24f;
}

__device__ __forceinline__ float lr_log(float x) {
    return static_cast<float>(log(static_cast<double>(x)));
}

__device__ __forceinline__ float lr_acklam_tail(float v) {
    float num = -0x1.fe30dap-8f;
    num = __fmaf_rn(num, v, -0x1.4a224cp-2f);
    num = __fmaf_rn(num, v, -0x1.334c0cp+1f);
    num = __fmaf_rn(num, v, -0x1.465da2p+1f);
    num = __fmaf_rn(num, v, 0x1.17fa80p+2f);
    num = __fmaf_rn(num, v, 0x1.7815c2p+1f);
    float den = 0x1.fe2d86p-8f;
    den = __fmaf_rn(den, v, 0x1.4a34d2p-2f);
    den = __fmaf_rn(den, v, 0x1.38fa28p+1f);
    den = __fmaf_rn(den, v, 0x1.e09076p+1f);
    den = __fmaf_rn(den, v, 1.0f);
    return num / den;
}

__device__ __forceinline__ float lr_acklam_central(float u) {
    const float v = u - 0.5f;
    const float r = v * v;
    float num = -0x1.3d931cp+5f;
    num = __fmaf_rn(num, r, 0x1.b9e466p+7f);
    num = __fmaf_rn(num, r, -0x1.13edb2p+8f);
    num = __fmaf_rn(num, r, 0x1.14b72cp+7f);
    num = __fmaf_rn(num, r, -0x1.eaa304p+4f);
    num = __fmaf_rn(num, r, 0x1.40d932p+1f);
    float den = -0x1.b3cf0cp+5f;
    den = __fmaf_rn(den, r, 0x1.432bf4p+7f);
    den = __fmaf_rn(den, r, -0x1.3765e0p+7f);
    den = __fmaf_rn(den, r, 0x1.0b348cp+6f);
    den = __fmaf_rn(den, r, -0x1.a8fb56p+3f);
    den = __fmaf_rn(den, r, 1.0f);
    return (num * v) / den;
}

// Stateless standard-normal variate per (seed, row, col) edge: Acklam's
// inverse CDF of the 24-bit uniform (the JAX package's branch signs).
__device__ __forceinline__ float lr_normal01(uint32_t seed, uint32_t row,
                                             uint32_t col) {
    float u = lr_uniform01(seed, row, col);
    u = fminf(fmaxf(u, 0x1.b7cdfep-34f), 1.0f);
    if (u < 0x1.8d4fe0p-6f)
        return -lr_acklam_tail(sqrtf(-2.0f * lr_log(fmaxf(u, 0x1.4484c0p-100f))));
    if (u > 0x1.f39582p-1f)
        return lr_acklam_tail(
            sqrtf(-2.0f * lr_log(fmaxf(1.0f - u, 0x1.4484c0p-100f))));
    return lr_acklam_central(u);
}

// The stream's stationary initial residual q and its state: rejection
// sampling, two draws per round, the state advancing to the second draw
// each round (the lockstep sampler of the JAX package, for one stream).
// cl >= 2.
__device__ __forceinline__ void lr_stream_init(uint32_t seed, uint32_t row,
                                               uint32_t chunk, uint32_t lane,
                                               uint32_t cl, uint32_t& state,
                                               uint32_t& q) {
    const uint32_t n = cl - 1u;
    uint32_t st = lr_init(seed, row, chunk, lane);
    for (;;) {
        const uint32_t s1 = lr_next(st);
        const uint32_t cand = lr_bounded(s1, n);
        st = lr_next(s1);
        if (lr_bounded(st, n) < n - cand) {
            q = cand;
            break;
        }
    }
    state = st;
}

// The weight laws of the three JITC families, at walk coordinates:
// 0 scalar a; 1 normal fma(z, b, a) (a = loc, b = scale); 2 uniform
// fma(u, b, a) (a = low, b = high - low).
template <int kLaw>
__device__ __forceinline__ float lr_weight(uint32_t seed, uint32_t row,
                                           uint32_t col, float a, float b) {
    if (kLaw == 0) return a;
    if (kLaw == 1) return __fmaf_rn(lr_normal01(seed, row, col), b, a);
    return __fmaf_rn(lr_uniform01(seed, row, col), b, a);
}
