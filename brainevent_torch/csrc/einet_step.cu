// Copyright 2026 The brainevent-tpu Authors.
// Licensed under the Apache License, Version 2.0.
//
// K1 `einet_step`: one step of the EI network's neurons, one thread per
// neuron.
//
// Replaces, together with K2 (event_scatter.cu), the whole-simulation TPU
// kernels brainevent_tpu/models/pallas_sim.py:einet_pallas_sim_mxu3 (:639)
// and :einet_pallas_sim_mxu6 (:1368). Those kernels compact spike ids with
// prefix sums and count hits with one-hot matrix products because a TPU has
// no atomics; here the ids are appended with one atomicAdd per warp and the
// counts are integer atomics (K2).
//
// Per launch, each thread
//   1. (fold) folds the previous step's int32 hit counts into its synaptic
//      state, g = fma(g, decay, w * count), and zeroes the counts;
//   2. (step) decays g, computes the COBA/CUBA current, runs the LIF update
//      with its refractory hold, writes v, t_last and spike_count, and
//      appends its id to the step's spike list.
// A run launches (step) for step 0, (fold, step) for every later step, and
// a last (fold) alone; see brainevent_torch/models/networks.py.
//
// Bound: device-memory bandwidth. A step moves about 44 bytes per neuron:
// it reads v, t_last, g_e, g_i and two counts (24 B) and writes v, g_e, g_i
// and two counts (20 B); t_last and spike_count are touched again only on a
// spike. The spike list costs one atomicAdd per warp
// that holds a spike.
//
// Exactness: the arithmetic is the plain PyTorch twin's
// (einet_step_twin), which is bitwise equal to brainevent_tpu's
// EINet.step under jax.jit on the CPU. XLA contracts three of its
// multiply-adds into FMAs; they are written out here with __fmaf_rn, and
// the library is built with -fmad=false so that nvcc adds no others:
//   g'   = fma(g, decay, w * count)                  (networks.py:163-176)
//   COBA current = fma(g_e*d_e, e_e - v, (g_i*d_i) * (e_i - v)) + inp
//   CUBA current = fma(g_e, d_e, -(g_i * d_i)) + inp  (networks.py:167-170)
//   v'   = fma((v_rest - v) + r*current, dt/tau, v)  (neurons.py:80-81)
// t is float32(step) * float32(dt), computed on the host: the refractory
// test (t - t_last) < tau_ref flips on its last bit.
#include "common.cuh"

namespace {

__global__ void einet_step_kernel(float* __restrict__ v,
                                  float* __restrict__ t_last,
                                  float* __restrict__ g_e,
                                  float* __restrict__ g_i,
                                  int* __restrict__ counts,
                                  int* __restrict__ spike_count,
                                  int* __restrict__ ids,
                                  int* __restrict__ n_ids,
                                  const EINetParams p, const float t,
                                  const int parity, const int fold,
                                  const int step) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    const int num = p.num;
    // The other parity's list was read by the previous step's K2, which
    // has finished (stream order): clear it for the next step.
    if (step && i == 0) n_ids[parity ^ 1] = 0;

    bool spike = false;
    if (i < num) {
        float ge = g_e[i];
        float gi = g_i[i];
        if (fold) {
            const int ce = counts[i];
            const int ci = counts[num + i];
            ge = __fmaf_rn(ge, p.decay_e, __fmul_rn(p.w_e, (float)ce));
            gi = __fmaf_rn(gi, p.decay_i, __fmul_rn(p.w_i, (float)ci));
            g_e[i] = ge;
            g_i[i] = gi;
            counts[i] = 0;
            counts[num + i] = 0;
        }
        if (step) {
            const float vi = v[i];
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
                    __fmaf_rn(ge, p.decay_e, -__fmul_rn(gi, p.decay_i)),
                    p.inp);
            }
            const float tl = t_last[i];
            const bool refractory = __fsub_rn(t, tl) < p.tau_ref;
            const float x = __fadd_rn(__fsub_rn(p.v_rest, vi),
                                      __fmul_rn(p.r, current));
            float vn = refractory ? vi : __fmaf_rn(x, p.dt_tau, vi);
            spike = vn >= p.v_th;
            if (spike) {
                vn = p.v_reset;
                t_last[i] = t;
                spike_count[i] += 1;
            }
            v[i] = vn;
        }
    }

    if (step) {
        // Warp-aggregated append: one atomicAdd per warp that holds a spike.
        // Every thread of the block reaches this point (no early return),
        // so the full-warp ballot and shuffle are safe.
        const unsigned mask = __ballot_sync(0xffffffffu, spike);
        if (mask) {
            const int lane = threadIdx.x & 31;
            const int leader = __ffs(mask) - 1;
            int base = 0;
            if (lane == leader) base = atomicAdd(&n_ids[parity], __popc(mask));
            base = __shfl_sync(0xffffffffu, base, leader);
            const int pos = base + __popc(mask & ((1u << lane) - 1u));
            if (spike && pos < num) ids[pos] = i;   // ids holds num entries
        }
    }
}

}  // namespace

BE_EXPORT const char* be_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// counts: (2, num) int32, row 0 excitatory and row 1 inhibitory hits.
// ids: (num,) int32 spike list; n_ids: (2,) int32 list lengths by parity.
BE_EXPORT int einet_step_launch(float* v, float* t_last, float* g_e,
                                float* g_i, int* counts, int* spike_count,
                                int* ids, int* n_ids, const EINetParams* p,
                                float t, int parity, int fold, int step,
                                int device, void* stream) {
    int err = be_begin(device);
    if (err) return err;
    if (p->num <= 0) return be_end();
    const int blocks = (p->num + BE_BLOCK - 1) / BE_BLOCK;
    einet_step_kernel<<<blocks, BE_BLOCK, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        v, t_last, g_e, g_i, counts, spike_count, ids, n_ids, *p, t,
        parity & 1, fold, step);
    return be_end();
}
