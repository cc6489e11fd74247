// Copyright 2026 The brainevent-tpu Authors.
// Licensed under the Apache License, Version 2.0.
//
// One EI neuron's fold and update, shared by K1 (einet_step.cu, one step a
// launch) and K21 (einet_sim.cu, the whole run in one launch), so that the
// two kernels compute the same bits.
//
// The arithmetic is the plain PyTorch twin's (einet_step_twin), which is
// bitwise equal to brainevent_tpu's EINet.step under jax.jit on the CPU.
// XLA contracts three of its multiply-adds into FMAs; they are written out
// here with __fmaf_rn, and the library is built with -fmad=false so that
// nvcc adds no others:
//   g'   = fma(g, decay, w * count)                  (networks.py:163-176)
//   COBA current = fma(g_e*d_e, e_e - v, (g_i*d_i) * (e_i - v)) + inp
//   CUBA current = fma(g_e, d_e, -(g_i * d_i)) + inp  (networks.py:167-170)
//   v'   = fma((v_rest - v) + r*current, dt/tau, v)  (neurons.py:80-81)
// t is float32(step) * float32(dt), computed on the host: the refractory
// test (t - t_last) < tau_ref flips on its last bit.
#pragma once

#include "common.cuh"

// Fold the previous step's int32 hit counts into the synaptic state.
__device__ __forceinline__ void be_einet_fold(float& ge, float& gi, int ce,
                                              int ci, const EINetParams& p) {
    ge = __fmaf_rn(ge, p.decay_e, __fmul_rn(p.w_e, (float)ce));
    gi = __fmaf_rn(gi, p.decay_i, __fmul_rn(p.w_i, (float)ci));
}

// Decay the synapses, compute the COBA/CUBA current and run the LIF update
// with its refractory hold at time t. Updates v, and t_last on a spike;
// returns whether the neuron spiked.
__device__ __forceinline__ bool be_einet_update(float& v, float& tl,
                                                float ge, float gi,
                                                const EINetParams& p,
                                                float t) {
    const float vi = v;
    float current;
    if (p.coba) {
        const float ged = __fmul_rn(ge, p.decay_e);
        const float gid = __fmul_rn(gi, p.decay_i);
        current = __fadd_rn(
            __fmaf_rn(ged, __fsub_rn(p.e_e, vi),
                      __fmul_rn(gid, __fsub_rn(p.e_i, vi))),
            p.inp);
    } else {
        current = __fadd_rn(
            __fmaf_rn(ge, p.decay_e, -__fmul_rn(gi, p.decay_i)), p.inp);
    }
    const bool refractory = __fsub_rn(t, tl) < p.tau_ref;
    const float x = __fadd_rn(__fsub_rn(p.v_rest, vi),
                              __fmul_rn(p.r, current));
    float vn = refractory ? vi : __fmaf_rn(x, p.dt_tau, vi);
    const bool spike = vn >= p.v_th;
    if (spike) {
        vn = p.v_reset;
        tl = t;
    }
    v = vn;
    return spike;
}

// The LIF neuron of K21's grid instances (einet_sim.cu:be_sim_grid): the
// registers a thread keeps of one neuron, and the fold and update above.
// hh_neuron.cuh's BeHhNeuron is the other model.
struct BeLifNeuron {
    using Params = EINetParams;
    static constexpr bool kTimes = true;  // the update reads the step time
    struct State {
        float v, tl, ge, gi;
    };

    // Neuron i's registers from the state arrays (v, t_last, g_e, g_i),
    // or zeros where the thread owns no neuron i.
    static __device__ __forceinline__ void load(State& s, const int i,
                                                const bool own,
                                                const float* v,
                                                const float* t_last,
                                                const float* g_e,
                                                const float* g_i) {
        s.v = own ? v[i] : 0.0f;
        s.tl = own ? t_last[i] : 0.0f;
        s.ge = own ? g_e[i] : 0.0f;
        s.gi = own ? g_i[i] : 0.0f;
    }

    static __device__ __forceinline__ void store(const State& s, const int i,
                                                 float* v, float* t_last,
                                                 float* g_e, float* g_i) {
        v[i] = s.v;
        t_last[i] = s.tl;
        g_e[i] = s.ge;
        g_i[i] = s.gi;
    }

    static __device__ __forceinline__ void fold(State& s, const int ce,
                                                const int ci,
                                                const Params& p) {
        be_einet_fold(s.ge, s.gi, ce, ci, p);
    }

    static __device__ __forceinline__ bool update(State& s, const Params& p,
                                                  const float t) {
        return be_einet_update(s.v, s.tl, s.ge, s.gi, p, t);
    }
};
