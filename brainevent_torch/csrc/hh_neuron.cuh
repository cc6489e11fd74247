// Copyright 2026 The brainevent-tpu Authors.
// Licensed under the Apache License, Version 2.0.
//
// One Hodgkin-Huxley neuron of Brette et al. 2007's Benchmark 3 (COBAHH,
// Traub and Miles's channels, exponential conductances), the neuron model
// of K21's HH grid instance (einet_sim.cu), beside einet_neuron.cuh's LIF.
//
// The arithmetic is the plain PyTorch twin's (models/hh_net.py:hh_loop)
// and the benchmark's reference's (benchmark_torch/reference/coba_hh.py),
// one rounding a product, sum and quotient: every operation is written out
// with __fmul_rn, __fadd_rn, __fsub_rn and __fdiv_rn (IEEE division, as
// PyTorch divides two tensors on a card), no FMA; exp and expm1 are the
// CUDA library's full-accuracy expf and expm1f, which torch.exp and
// torch.expm1 call on a card (the card tests hold the two equal on every
// float32 in [-104, 89]). With d = v - V_T, each rate's argument
// a = (o - d) * s:
//   alpha_m, beta_m, alpha_n = c / exprel(a), exprel(0) = 1, else
//                              expm1(a) / a
//   alpha_h, beta_n          = c * exp(a)
//   beta_h                   = c / (1 + exp(a))
//   a gate: s = alpha + beta, x_inf = alpha / s,
//           x' = x_inf + (x - x_inf) * exp(s * -dt)
//   den = (((g_L + g_e) + g_i) + g_Na m^3 h) + g_Kd n^4
//   num = (((g_L E_L + g_e E_e) + g_i E_i) + g_Na m^3 h E_Na) + g_Kd n^4 E_K
//   v'  = v_inf + (v - v_inf) * exp(den * -dt/C_m), v_inf = num / den
//   g'  = g * decay; at the next step's fold g' + w * hits
// with m^3 h = ((m*m)*m)*h and n^4 = (n*n)*(n*n). A spike is v' > v_spike
// while armed; it disarms, and a step that ends at v' <= v_spike arms.
//
// Bound: operations. ~10 expf/expm1f and 11 divisions a neuron a step,
// each one MUFU instruction (16 a clock an SM) and a few FP32 ones, beside
// ~70 plain ones; the grid's scatter and barrier are K21's.
#pragma once

#include "common.cuh"

// The rates, in the order of the six triples below.
constexpr int HH_RATES = 6;

// Scalars of one COBAHH network, each rounded to float32 on the host
// (brainevent_torch.models.hh_net.HHSimParams builds the same struct with
// ctypes; keep the two layouts equal).
struct HHParams {
    float v_t;        // V_T (mV)
    float g_l;        // leak conductance (nS)
    float gl_el;      // g_L * E_L (pA)
    float e_e;        // reversal potentials (mV)
    float e_i;
    float e_na;
    float e_k;
    float g_na;       // maximal conductances (nS)
    float g_k;
    float neg_dt;     // -dt (ms)
    float neg_dt_c;   // -dt / C_m (ms / pF)
    float decay_e;    // float32(exp(-dt / tau_e))
    float decay_i;    // float32(exp(-dt / tau_i))
    float w_e;        // synaptic weights (nS)
    float w_i;
    float v_spike;    // the spike's threshold (mV)
    float rate_c[HH_RATES];  // alpha_m, beta_m, alpha_h, beta_h, alpha_n,
    float rate_o[HH_RATES];  // beta_n: c, o and s of each
    float rate_s[HH_RATES];
    int num;          // neurons
};

// c / exprel(a): alpha_m, beta_m and alpha_n.
__device__ __forceinline__ float be_hh_exprel_rate(const float c,
                                                   const float a) {
    const float exprel = a == 0.0f ? 1.0f : __fdiv_rn(expm1f(a), a);
    return __fdiv_rn(c, exprel);
}

// Rate r's argument (o - d) * s.
__device__ __forceinline__ float be_hh_arg(const HHParams& p, const int r,
                                           const float d) {
    return __fmul_rn(__fsub_rn(p.rate_o[r], d), p.rate_s[r]);
}

// One gate's exponential Euler step from its old value x.
__device__ __forceinline__ float be_hh_gate(const float x, const float alpha,
                                            const float beta,
                                            const float neg_dt) {
    const float s = __fadd_rn(alpha, beta);
    const float x_inf = __fdiv_rn(alpha, s);
    return __fadd_rn(x_inf, __fmul_rn(__fsub_rn(x, x_inf),
                                      expf(__fmul_rn(s, neg_dt))));
}

// The HH neuron of K21's grid instance: the registers a thread keeps of one
// neuron, the fold of a step's hits and the update.
struct BeHhNeuron {
    using Params = HHParams;
    static constexpr bool kTimes = false;  // the update reads no step time
    struct State {
        float v, m, h, n, ge, gi;
        bool armed;
    };

    // Neuron i's registers from the state arrays, or zeros (and disarmed)
    // where the thread owns no neuron i.
    static __device__ __forceinline__ void load(
        State& s, const int i, const bool own, const float* v,
        const float* m, const float* h, const float* n, const float* g_e,
        const float* g_i, const unsigned char* armed) {
        s.v = own ? v[i] : 0.0f;
        s.m = own ? m[i] : 0.0f;
        s.h = own ? h[i] : 0.0f;
        s.n = own ? n[i] : 0.0f;
        s.ge = own ? g_e[i] : 0.0f;
        s.gi = own ? g_i[i] : 0.0f;
        s.armed = own && armed[i] != 0;
    }

    static __device__ __forceinline__ void store(
        const State& s, const int i, float* v, float* m, float* h, float* n,
        float* g_e, float* g_i, unsigned char* armed) {
        v[i] = s.v;
        m[i] = s.m;
        h[i] = s.h;
        n[i] = s.n;
        g_e[i] = s.ge;
        g_i[i] = s.gi;
        armed[i] = s.armed;
    }

    // The previous step's hits into the decayed conductances: g + w * hits,
    // every step, hit or not.
    static __device__ __forceinline__ void fold(State& s, const int ce,
                                                const int ci,
                                                const Params& p) {
        s.ge = __fadd_rn(s.ge, __fmul_rn(p.w_e, static_cast<float>(ce)));
        s.gi = __fadd_rn(s.gi, __fmul_rn(p.w_i, static_cast<float>(ci)));
    }

    // Every variable from the old state; returns whether the neuron
    // spiked.
    static __device__ __forceinline__ bool update(State& s, const Params& p,
                                                  float) {
        const float v = s.v;
        const float d = __fsub_rn(v, p.v_t);
        const float am = be_hh_exprel_rate(p.rate_c[0], be_hh_arg(p, 0, d));
        const float bm = be_hh_exprel_rate(p.rate_c[1], be_hh_arg(p, 1, d));
        const float ah = __fmul_rn(p.rate_c[2], expf(be_hh_arg(p, 2, d)));
        const float bh = __fdiv_rn(
            p.rate_c[3], __fadd_rn(1.0f, expf(be_hh_arg(p, 3, d))));
        const float an = be_hh_exprel_rate(p.rate_c[4], be_hh_arg(p, 4, d));
        const float bn = __fmul_rn(p.rate_c[5], expf(be_hh_arg(p, 5, d)));

        const float m3h = __fmul_rn(__fmul_rn(__fmul_rn(s.m, s.m), s.m), s.h);
        const float n2 = __fmul_rn(s.n, s.n);
        const float gna = __fmul_rn(p.g_na, m3h);
        const float gk = __fmul_rn(p.g_k, __fmul_rn(n2, n2));
        const float den = __fadd_rn(
            __fadd_rn(__fadd_rn(__fadd_rn(p.g_l, s.ge), s.gi), gna), gk);
        const float num = __fadd_rn(
            __fadd_rn(__fadd_rn(__fadd_rn(p.gl_el, __fmul_rn(s.ge, p.e_e)),
                                __fmul_rn(s.gi, p.e_i)),
                      __fmul_rn(gna, p.e_na)),
            __fmul_rn(gk, p.e_k));
        const float v_inf = __fdiv_rn(num, den);
        const float vn = __fadd_rn(
            v_inf, __fmul_rn(__fsub_rn(v, v_inf),
                             expf(__fmul_rn(den, p.neg_dt_c))));

        s.m = be_hh_gate(s.m, am, bm, p.neg_dt);
        s.h = be_hh_gate(s.h, ah, bh, p.neg_dt);
        s.n = be_hh_gate(s.n, an, bn, p.neg_dt);
        s.ge = __fmul_rn(s.ge, p.decay_e);
        s.gi = __fmul_rn(s.gi, p.decay_i);
        s.v = vn;
        const bool spike = s.armed && vn > p.v_spike;
        s.armed = (s.armed && !spike) || vn <= p.v_spike;
        return spike;
    }
};
