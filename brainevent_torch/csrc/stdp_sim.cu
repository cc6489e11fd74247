// Copyright 2026 The brainevent-tpu Authors.
// Licensed under the Apache License, Version 2.0.
//
// K24 `stdp_sim`: a whole trial of NEST's HPC benchmark network with
// power-law STDP (Morrison, Aertsen & Diesmann 2007; models/hpc_stdp.py),
// n steps, in one launch. No TPU kernel precedes it: the JAX package has no
// network whose synapses change while it runs.
//
// The network: NE excitatory and NI inhibitory iaf_psc_alpha neurons (one
// current channel), every synapse of one delay d (steps), in two CSRs by
// source over one targets array: the plastic E->E synapses first
// (positions [0, P), rows plastic_ptr, float32 weights in pA), then the
// static ones (positions [P, P + S), rows static_ptr: E->I of w_e units,
// then I->E and I->I of w_i units). A CSC of the plastic synapses (col_ptr,
// and each entry's position col_pos and source col_src) gives each E
// neuron's incoming plastic synapses.
//
// Step t, neuron i (V relative to E_L), in NEST's order, every product and
// sum rounded once (__fmul_rn, __fadd_rn: the same bits as the plain loop,
// whatever the compiler contracts):
//   s = ring[t mod D][i] + w_ext * poisson;  ring[t mod D][i] = 0
//   if ref == 0: V = ((P31 dI + P32 I) + em1 V) + V  else ref -= 1
//   I = P21 dI + P11 I;  dI = P11 dI + pa float(s)
//   E: K+ = kp_decay K+, K- = km_decay K-, khist[t mod D] = K-
//   if V >= v_th: V = v_reset, ref = ref_steps, count += 1
// then, for the E->E synapses:
//   1. each j that spiked at t - d, each i -> j:
//        w = w + (lam w^mu) K+_i           (K+_i before i's spike at t)
//   2. each i that spikes at t, each i -> j:
//        w = max(w - (lam_alpha w) khist[(t - d) mod D][j], 0)
//      and every synapse of a spike at t adds its units (a plastic one
//      rint(w units)) to ring[(t + d) mod D][j]
//   3. the spikes of t add 1 to their K+ and K-.
// A step is two phases between grid barriers. Phase A: each thread's
// neurons' update, then the facilitation (1) as a grid pass over the list
// of the columns of step t - d's E spikes. Phase B: the depression and the
// delivery (2) as a grid pass over the list of step t's spiking rows.
// Within a phase a weight is written by one thread at most (a synapse is
// in one column and one row, and a neuron spikes once a step), and the
// phases are ordered as NEST's send() orders a synapse's updates, so the
// weights are the same on every run; no weight is written with atomics.
// Phase A reads K+ of step t - 1 from a buffer by the step's parity
// (kbuf), which phase A of step t + 1 writes; step t's K- history slot is
// not the slot (t - d) mod D that phase B reads (1 <= d < D). A step's
// lists: the rows' list by parity (the counters zeroed in phase B of the
// step before they are next appended to), the columns' by step mod D
// (kept for d steps). A launch rebuilds the column lists of its first d
// steps from `spiked` (each E neuron's spikes of the last D steps), and
// K- from khist and `spiked`, so a trial chains on from its state.
//
// The shape is K23's (sim_grid.cuh): a persistent cooperative grid of
// blocks of SG_BLOCK threads; thread g owns neurons g and g + G (G the
// grid's threads) and keeps their state in registers for the whole trial.
#include "common.cuh"
#include "sim_grid.cuh"

// The scalars of one network and trial; the same layout as StdpParams in
// brainevent_torch/models/hpc_stdp.py (ctypes). The floats are rounded to
// float32 on the host.
struct StdpParams {
    float p11;         // float32(exp(-h / tau_syn)): P11 = P22
    float p21;         // float32(h exp(-h / tau_syn))
    float em1;         // float32(expm1(-h / tau_m))
    float p31;         // NEST's propagator_31, float32
    float p32;         // NEST's propagator_32, float32
    float pa;          // float32(e / tau_syn * q): dI's jump of one unit
    float v_th;        // threshold, relative to E_L
    float v_reset;     // reset, relative to E_L
    float kp_decay;    // float32(exp(-h / tau_plus))
    float km_decay;    // float32(exp(-h / tau_minus))
    float lam;         // lambda
    float lam_alpha;   // float32(lambda alpha)
    float mu;          // the facilitation's exponent
    float units;       // float32(weight_units / JE_pA): units of a pA
    int num;           // neurons
    int n_exc;         // excitatory neurons, the first n_exc
    int n_plastic;     // P: positions below it are plastic
    int static_e_end;  // static positions below it have an E source
    int depth;         // D: the ring's and the histories' slots
    int delay;         // d, 1 <= d < D
    int ref_steps;     // refractory steps
    int w_ext;         // units of a Poisson event
    int w_e;           // units of a static E synapse
    int w_i;           // units of an I synapse
    unsigned key;      // the Poisson stream of this state
    unsigned step0;    // the trial's first step, modulo 2^32
    unsigned thr[SG_KMAX];
};

namespace {

// Neurons a thread of K24 owns at most.
constexpr int STDP_NPT = 2;
// Entries a thread of a grid pass loads before it updates them.
constexpr int STDP_UNROLL = 2;

// w^mu, the one transcendental function of the step (full-accuracy powf).
__device__ __forceinline__ float stdp_pow(const float w, const float mu) {
    return powf(w, mu);
}

// A thread's entries of one round of its share [.., hi) of a chunk: c[u]
// the entry's position (s_beg of its row plus its offset), -1 past hi.
__device__ __forceinline__ void stdp_round(const int e0, const int hi,
                                           const int m, const int* s_off,
                                           const int* s_beg, int* c) {
#pragma unroll
    for (int u = 0; u < STDP_UNROLL; ++u) {
        const int e = e0 + SG_BLOCK * u;
        c[u] = -1;
        if (e < hi) {
            const int r = sg_find(e, m, s_off);
            c[u] = s_beg[r] + (e - s_off[r]);
        }
    }
}

// The facilitation of one step: the list's n columns, each entry's weight
// w += (lam w^mu) (kp_decay K+_src), K+ of the step before from kprev.
// Block 0 adds each chunk's entries to *count where count is given.
__device__ __forceinline__ void stdp_facilitate(
    const int2* list, const int n, int* s_off, int* s_beg, int* s_wsum,
    const int* __restrict__ col_pos, const int* __restrict__ col_src,
    float* weights, const float* kprev, unsigned long long* count,
    const StdpParams& p) {
    const int j = threadIdx.x;
    for (int c0 = 0; c0 < n; c0 += SG_BLOCK) {
        const int m = min(n - c0, SG_BLOCK);
        const int2 col = j < m ? __ldcg(list + c0 + j) : make_int2(0, 0);
        const int total = sg_scan(col, m, s_off, s_beg, s_wsum);
        if (count && blockIdx.x == 0 && j == 0)
            atomicAdd(count, static_cast<unsigned long long>(total));
        int lo, hi;
        sg_share(total, &lo, &hi);
        for (int e0 = lo + j; e0 < hi; e0 += SG_BLOCK * STDP_UNROLL) {
            int c[STDP_UNROLL], pos[STDP_UNROLL];
            float w[STDP_UNROLL], k[STDP_UNROLL];
            stdp_round(e0, hi, m, s_off, s_beg, c);
#pragma unroll
            for (int u = 0; u < STDP_UNROLL; ++u) {
                pos[u] = c[u] >= 0 ? __ldg(col_pos + c[u]) : 0;
                const int src = c[u] >= 0 ? __ldg(col_src + c[u]) : 0;
                w[u] = c[u] >= 0 ? __ldcg(weights + pos[u]) : 0.0f;
                k[u] = c[u] >= 0 ? __ldcg(kprev + src) : 0.0f;
            }
#pragma unroll
            for (int u = 0; u < STDP_UNROLL; ++u) {
                if (c[u] < 0) continue;
                const float kp = __fmul_rn(p.kp_decay, k[u]);
                const float f =
                    __fmul_rn(__fmul_rn(p.lam, stdp_pow(w[u], p.mu)), kp);
                weights[pos[u]] = __fadd_rn(w[u], f);
            }
        }
    }
}

// The depression and the delivery of one step: the list's n rows; a
// plastic entry's weight w = max(w - (lam_alpha w) K-_target, 0), K- from
// kh (the history's slot of step t - d), then every entry adds its units
// to its target in the ring's slot late.
__device__ __forceinline__ void stdp_deliver(
    const int2* list, const int n, int* s_off, int* s_beg, int* s_wsum,
    const int* __restrict__ targets, float* weights, const float* kh,
    int* late, const StdpParams& p) {
    const int j = threadIdx.x;
    for (int c0 = 0; c0 < n; c0 += SG_BLOCK) {
        const int m = min(n - c0, SG_BLOCK);
        const int2 row = j < m ? __ldcg(list + c0 + j) : make_int2(0, 0);
        int lo, hi;
        sg_share(sg_scan(row, m, s_off, s_beg, s_wsum), &lo, &hi);
        for (int e0 = lo + j; e0 < hi; e0 += SG_BLOCK * STDP_UNROLL) {
            int c[STDP_UNROLL], tg[STDP_UNROLL];
            float w[STDP_UNROLL], km[STDP_UNROLL];
            stdp_round(e0, hi, m, s_off, s_beg, c);
#pragma unroll
            for (int u = 0; u < STDP_UNROLL; ++u) {
                const bool plastic = c[u] >= 0 && c[u] < p.n_plastic;
                tg[u] = c[u] >= 0 ? __ldg(targets + c[u]) : 0;
                w[u] = plastic ? __ldcg(weights + c[u]) : 0.0f;
                km[u] = plastic ? __ldcg(kh + tg[u]) : 0.0f;
            }
#pragma unroll
            for (int u = 0; u < STDP_UNROLL; ++u) {
                if (c[u] < 0) continue;
                int units;
                if (c[u] < p.n_plastic) {
                    const float d = __fmul_rn(__fmul_rn(p.lam_alpha, w[u]),
                                              km[u]);
                    float x = __fsub_rn(w[u], d);
                    x = x > 0.0f ? x : 0.0f;
                    weights[c[u]] = x;
                    units = __float2int_rn(__fmul_rn(x, p.units));
                } else {
                    units = c[u] < p.static_e_end ? p.w_e : p.w_i;
                }
                atomicAdd(late + tg[u], units);
            }
        }
    }
}

__global__ void __launch_bounds__(SG_BLOCK, 3)
stdp_sim_kernel(float* __restrict__ v, float* __restrict__ i_syn,
                float* __restrict__ di, int* __restrict__ ref, int* ring,
                int* __restrict__ spike_count, float* weights, float* kplus,
                float* khist, unsigned char* spiked,
                const int* __restrict__ targets,
                const int* __restrict__ plastic_ptr,
                const int* __restrict__ static_ptr,
                const int* __restrict__ col_ptr,
                const int* __restrict__ col_pos,
                const int* __restrict__ col_src, int2* dlists, int2* flists,
                int* counts, float* kbuf, unsigned long long* counters,
                const int n_steps, const StdpParams p) {
    __shared__ unsigned s_thr[SG_KMAX];
    // The grid passes' view of a chunk of a list (sg_scan).
    __shared__ int s_off[SG_BLOCK + 1];
    __shared__ int s_beg[SG_BLOCK];
    __shared__ int s_wsum[SG_WARPS];
    if (threadIdx.x < SG_KMAX) s_thr[threadIdx.x] = p.thr[threadIdx.x];
    cg::grid_group grid = cg::this_grid();
    const int num = p.num, ne = p.n_exc;
    const unsigned dmask = static_cast<unsigned>(p.depth) - 1u;
    const unsigned d = static_cast<unsigned>(p.delay);
    const int g = blockIdx.x * SG_BLOCK + threadIdx.x;
    const int gsize = gridDim.x * SG_BLOCK;
    // the rows' lists' counters by parity, then the columns' by slot
    int* dcount = counts;
    int* fcount = counts + 2;
    const long long dcap = 2ll * num;
    const unsigned t0 = p.step0;
    const unsigned last = (t0 - 1u) & dmask;

    if (g < 2 + p.depth) counts[g] = 0;
    if (counters && g < 2) counters[g] = 0;
    float rv[STDP_NPT], ri[STDP_NPT], rd[STDP_NPT], kp[STDP_NPT],
        km[STDP_NPT];
    int rr[STDP_NPT], rc[STDP_NPT];
#pragma unroll
    for (int q = 0; q < STDP_NPT; ++q) {
        const int i = g + q * gsize;
        const bool own = i < num, exc = i < ne;
        rv[q] = own ? v[i] : 0.0f;
        ri[q] = own ? i_syn[i] : 0.0f;
        rd[q] = own ? di[i] : 0.0f;
        rr[q] = own ? ref[i] : 0;
        rc[q] = own ? spike_count[i] : 0;
        kp[q] = exc ? kplus[i] : 0.0f;
        const long long at = static_cast<long long>(last) * ne + i;
        const float h = exc ? khist[at] : 0.0f;
        km[q] = exc && spiked[at] ? __fadd_rn(h, 1.0f) : h;
        if (exc) kbuf[static_cast<long long>((t0 - 1u) & 1u) * ne + i] = kp[q];
    }
    grid.sync();  // the counters are zeroed
    // The column lists of the launch's first d steps: the E spikes of the
    // d steps before it.
#pragma unroll
    for (int q = 0; q < STDP_NPT; ++q) {
        const int i = g + q * gsize;
        if (i >= ne) continue;
        const int2 col = make_int2(__ldg(col_ptr + i), __ldg(col_ptr + i + 1));
        if (col.y == col.x) continue;
        for (unsigned s = 1; s <= d; ++s) {
            const unsigned slot = (t0 - s) & dmask;
            if (spiked[static_cast<long long>(slot) * ne + i])
                sg_append(flists + static_cast<long long>(slot) * ne,
                          fcount + slot, col);
        }
    }
    grid.sync();

    for (int k = 0; k < n_steps; ++k) {
        const unsigned t = t0 + static_cast<unsigned>(k);
        const unsigned slot = t & dmask;
        const int par = static_cast<int>(t & 1u);
        int2* dlist = dlists + par * dcap;
        int2* flist = flists + static_cast<long long>(slot) * ne;
        // Phase A: the update of the thread's neurons.
        int* now = sg_slot(ring, t, dmask, num);
        const unsigned h = sg_step_hash(p.key, t);
#pragma unroll
        for (int q = 0; q < STDP_NPT; ++q) {
            const int i = g + q * gsize;
            if (i >= num) continue;
            int in = __ldcg(now + i);
            if (in) now[i] = 0;
            in += sg_poisson(h, i, s_thr) * p.w_ext;
            if (rr[q] == 0)
                rv[q] = __fadd_rn(
                    __fadd_rn(__fadd_rn(__fmul_rn(p.p31, rd[q]),
                                        __fmul_rn(p.p32, ri[q])),
                              __fmul_rn(p.em1, rv[q])),
                    rv[q]);
            else
                rr[q] -= 1;
            ri[q] = __fadd_rn(__fmul_rn(p.p21, rd[q]), __fmul_rn(p.p11, ri[q]));
            rd[q] = __fadd_rn(__fmul_rn(p.p11, rd[q]),
                              __fmul_rn(p.pa, __int2float_rn(in)));
            const bool spike = rv[q] >= p.v_th;
            if (spike) {
                rv[q] = p.v_reset;
                rr[q] = p.ref_steps;
                rc[q] += 1;
            }
            if (i < ne) {
                const long long at = static_cast<long long>(slot) * ne + i;
                kp[q] = __fmul_rn(p.kp_decay, kp[q]);
                if (spike) kp[q] = __fadd_rn(kp[q], 1.0f);
                kbuf[static_cast<long long>(par) * ne + i] = kp[q];
                km[q] = __fmul_rn(p.km_decay, km[q]);
                khist[at] = km[q];
                if (spike) km[q] = __fadd_rn(km[q], 1.0f);
                spiked[at] = spike;
            }
            if (spike) {
                if (i < ne) {
                    const int2 pr = make_int2(__ldg(plastic_ptr + i),
                                              __ldg(plastic_ptr + i + 1));
                    if (pr.y > pr.x) {
                        // read by phase B's pass, after the barrier
                        sg_prefetch(targets + pr.x, targets + pr.y);
                        sg_prefetch(weights + pr.x, weights + pr.y);
                        sg_append(dlist, dcount + par, pr);
                        if (counters)
                            atomicAdd(counters,
                                      static_cast<unsigned long long>(
                                          pr.y - pr.x));
                    }
                    const int2 col = make_int2(__ldg(col_ptr + i),
                                               __ldg(col_ptr + i + 1));
                    if (col.y > col.x) sg_append(flist, fcount + slot, col);
                }
                const int2 sr = make_int2(__ldg(static_ptr + i),
                                          __ldg(static_ptr + i + 1));
                if (sr.y > sr.x) {
                    sg_prefetch(targets + sr.x, targets + sr.y);
                    sg_append(dlist, dcount + par, sr);
                }
            }
        }
        // Phase A: the facilitation for step t - d's E spikes.
        {
            const unsigned fs = (t - d) & dmask;
            stdp_facilitate(flists + static_cast<long long>(fs) * ne,
                            __ldcg(fcount + fs), s_off, s_beg, s_wsum,
                            col_pos, col_src, weights,
                            kbuf + static_cast<long long>(par ^ 1) * ne,
                            counters ? counters + 1 : nullptr, p);
        }
        grid.sync();
        // Phase B: the depression and the delivery of step t's spikes.
        stdp_deliver(dlist, __ldcg(dcount + par), s_off, s_beg, s_wsum,
                     targets, weights,
                     khist + static_cast<long long>((t - d) & dmask) * ne,
                     sg_slot(ring, t + d, dmask, num), p);
        // The rows' counter of step t + 1 was last read in step t - 1;
        // the columns' of slot t + 1 by the facilitation of step t + 1 -
        // D + d <= t. Both are appended to next in step t + 1.
        if (blockIdx.x == 0 && threadIdx.x == 0) {
            dcount[par ^ 1] = 0;
            fcount[(t + 1u) & dmask] = 0;
        }
        grid.sync();
    }

#pragma unroll
    for (int q = 0; q < STDP_NPT; ++q) {
        const int i = g + q * gsize;
        if (i >= num) continue;
        v[i] = rv[q];
        i_syn[i] = ri[q];
        di[i] = rd[q];
        ref[i] = rr[q];
        spike_count[i] = rc[q];
        if (i < ne) kplus[i] = kp[q];
    }
}

// y = stdp_pow(x, mu) elementwise: K24's w^mu, for the check against the
// plain loop's torch.pow.
__global__ void stdp_pow_kernel(const float* __restrict__ x,
                                float* __restrict__ y, const long long n,
                                const float mu) {
    for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                       threadIdx.x;
         i < n; i += static_cast<long long>(gridDim.x) * blockDim.x)
        y[i] = stdp_pow(x[i], mu);
}

}  // namespace

// Blocks of SG_BLOCK threads of K24 that can be co-resident on the device:
// the largest grid a cooperative launch of it takes.
BE_EXPORT int stdp_sim_max_blocks(int device, int* blocks) {
    int err = be_begin(device);
    if (err) return err;
    return be_coresident_blocks(reinterpret_cast<const void*>(stdp_sim_kernel),
                                SG_BLOCK, device, blocks);
}

// v, i_syn, di: (num,) float32; ref, spike_count: (num,) int32; kplus:
// (n_exc,) float32; all read at the start and written at the end. ring:
// (depth, num) int32, khist: (depth, n_exc) float32, spiked: (depth, n_exc)
// uint8, weights: (n_plastic,) float32, read and written in place.
// targets: int32 (P + S); plastic_ptr: (n_exc + 1,) int32 into [0, P);
// static_ptr: (num + 1,) int32 into [P, P + S); col_ptr: (n_exc + 1,)
// int32, col_pos and col_src: (P,) int32. Scratch: dlists (2, 2 num) int2,
// flists (depth, n_exc) int2, counts (2 + depth,) int32, kbuf (2, n_exc)
// float32. counters: (2,) uint64, set to the launch's depressions and
// facilitations, or null.
// blocks * SG_BLOCK * STDP_NPT must cover num; a grid larger than can be
// co-resident is refused (cudaErrorCooperativeLaunchTooLarge).
BE_EXPORT int stdp_sim_launch(
    float* v, float* i_syn, float* di, int* ref, int* ring, int* spike_count,
    float* weights, float* kplus, float* khist, unsigned char* spiked,
    const int* targets, const int* plastic_ptr, const int* static_ptr,
    const int* col_ptr, const int* col_pos, const int* col_src, int* dlists,
    int* flists, int* counts, float* kbuf, unsigned long long* counters,
    int n_steps, const StdpParams* p, int blocks, int device, void* stream) {
    int err = be_begin(device);
    if (err) return err;
    if (p->num <= 0) return be_end();
    if (blocks <= 0 ||
        static_cast<long long>(blocks) * SG_BLOCK * STDP_NPT < p->num ||
        p->n_exc < 0 || p->n_exc > p->num || p->depth < 2 ||
        (p->depth & (p->depth - 1)) || p->delay < 1 || p->delay >= p->depth ||
        static_cast<long long>(blocks) * SG_BLOCK < 2 + p->depth)
        return static_cast<int>(cudaErrorInvalidValue);
    const void* kernel = reinterpret_cast<const void*>(stdp_sim_kernel);
    StdpParams params = *p;
    int2* d2 = reinterpret_cast<int2*>(dlists);
    int2* f2 = reinterpret_cast<int2*>(flists);
    void* args[] = {&v,       &i_syn,      &di,         &ref,     &ring,
                    &spike_count, &weights, &kplus,     &khist,   &spiked,
                    &targets, &plastic_ptr, &static_ptr, &col_ptr, &col_pos,
                    &col_src, &d2,         &f2,         &counts,  &kbuf,
                    &counters, &n_steps,   &params};
    return be_refused(static_cast<int>(cudaLaunchCooperativeKernel(
        kernel, dim3(blocks), dim3(SG_BLOCK), args, 0,
        static_cast<cudaStream_t>(stream))));
}

// y = w^mu of every x (n float32), as K24 computes it.
BE_EXPORT int stdp_pow_launch(const float* x, float* y, long long n,
                              float mu, int device, void* stream) {
    int err = be_begin(device);
    if (err) return err;
    if (n <= 0) return be_end();
    stdp_pow_kernel<<<BE_MAX_BLOCKS * 2, BE_BLOCK, 0,
                      static_cast<cudaStream_t>(stream)>>>(x, y, n, mu);
    return be_end();
}
