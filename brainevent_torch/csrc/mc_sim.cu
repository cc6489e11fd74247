// Copyright 2026 The brainevent-tpu Authors.
// Licensed under the Apache License, Version 2.0.
//
// K23 `mc_sim`: a whole trial of the Potjans-Diesmann cortical
// microcircuit (models/microcircuit.py), n steps, in one launch.
//
// The network: P <= MC_MAX_POPS populations of iaf_psc_exp neurons (one
// current channel, tau_syn the same for E and I), each neuron a CSR row of
// per-synapse int16 weights (units of q pA) and uint8 delays (steps, 1 <=
// d < D), and a Poisson background drawn on the device every step. No TPU
// kernel precedes it: the JAX package has no such network.
//
// Each step t, for neuron i (V relative to E_L), in NEST's order:
//   s = ring[t mod D][i]; ring[t mod D][i] = 0
//   u = mix(mix(key ^ t * 0x9E3779B9) ^ i * 0x85EBCA6B)   (lr_mix32)
//   s += w_ext * #{m < 16 : u >= thr[pop(i)][m]}           (the Poisson draw)
//   if ref == 0: V = fma(I, P21, V * P22) else ref -= 1
//   I = fma(I, P11, q * float(s))
//   if V >= v_th: V = v_reset, ref = ref_steps, count += 1, and each
//       synapse (target, w, d) of row i adds w to ring[(t + d) mod D][target]
// The input of a step is an int32 sum, exact at any order of the atomics,
// and every multiply-add is one __fmaf_rn (the library is built with
// -fmad=false), so the result is bitwise the plain twin's (mc_loop).
//
// The shape is K21's grid instance (einet_sim.cu) at one neuron a
// thread: a persistent, cooperative grid (every block co-resident, or the
// launch is refused) crossed by one grid.sync() a step; thread i owns
// neuron i and keeps its V, I, ref, spike count and row bounds in
// registers for the whole trial. At most 80 registers (launch bounds of
// three blocks an SM) fit three blocks of MC_BLOCK an SM, 396 blocks
// (101,376 neurons, scale 1.31) on an H100's 132 SMs. One barrier a step
// is enough: since d >= 1 and D > d, no scatter of step t writes the slot
// step t reads and clears, and every write into that slot came before the
// previous barrier. The ring, which other blocks' atomics wrote in this
// launch, is read past L1 (__ldcg); the rows through the read-only path.
//
// Rows are long (~3.9k synapses a neuron at full scale, 6.5k from L4I,
// against K21's 80), and the rows (2.09 GB) lie past L2; ~25 spikes and
// 97k synapse events a step move ~680 KB, 0.2 us at HBM's rate, and the
// step waits for the block with the most synapses to add. A warp walking
// its own spikes' rows took 13 trips to HBM for an L4I row, in turn for
// two spikes of one warp, while the block's other warps waited at the
// barrier (15.0 of 17.1 us a step on an H100). So after its update each
// spiking thread takes a slot in the block's list in shared memory (its
// row's bounds), and after one __syncthreads() the whole block walks each
// listed row, thread j the synapses beg + j + MC_BLOCK u, MC_UNROLL a round,
// loading its next round before the int32 atomicAdds of this one; a block
// with no spike skips the walk on a uniform branch. What bounds it now is
// one SM's rate of atomics to scattered addresses, about one a ns on an
// H100 (6,500 alone took 6.8 us from one block), over the busiest block's
// ~6.7k synapses (the median step): 7.9 us a step. MC_UNROLL 8 at 80
// registers keeps 396 blocks co-resident; 4 took 8.1 us, 16 spills (14.2),
// and without the early loads 8 and 16 took 9.3 and 9.4.
#include <cooperative_groups.h>

#include <cstdint>

#include "common.cuh"
#include "light_rng.cuh"

namespace cg = cooperative_groups;

// The most populations, and the Poisson table's thresholds a population.
constexpr int MC_MAX_POPS = 8;
constexpr int MC_KMAX = 16;

// The scalars of one network and trial; the same layout as McParams in
// brainevent_torch/models/microcircuit.py (ctypes). The floats are
// rounded to float32 on the host.
struct McParams {
    float p11;        // float32(exp(-dt / tau_syn))
    float p21;        // float32(tau_m tau_s / (C (tau_s - tau_m)) (P11 - P22))
    float p22;        // float32(exp(-dt / tau_m))
    float q;          // pA of one weight unit
    float v_th;       // threshold, relative to E_L
    float v_reset;    // reset, relative to E_L
    int num;          // neurons
    int depth;        // D: the ring's slots, a power of two
    int ref_steps;    // refractory steps
    int w_ext;        // weight units of one Poisson event
    unsigned key;     // the Poisson stream of this state
    unsigned step0;   // the trial's first step, modulo 2^32
    int n_pops;
    int pop_start[MC_MAX_POPS + 1];
    unsigned thr[MC_MAX_POPS * MC_KMAX];
};

namespace {

constexpr int MC_BLOCK = 256;
constexpr int MC_UNROLL = 8;
constexpr unsigned MC_T_MUL = 0x9E3779B9u;
constexpr unsigned MC_I_MUL = 0x85EBCA6Bu;

// One round of a thread's walk: the synapses c0 + MC_BLOCK u below end.
__device__ __forceinline__ void mc_load(
    const int c0, const int end, const int* __restrict__ targets,
    const short* __restrict__ weights, const unsigned char* __restrict__ delays,
    int* tg, int* w, unsigned* d) {
#pragma unroll
    for (int u = 0; u < MC_UNROLL; ++u) {
        const int c = c0 + MC_BLOCK * u;
        const bool in = c < end;
        tg[u] = in ? __ldg(targets + c) : -1;
        w[u] = in ? __ldg(weights + c) : 0;
        d[u] = in ? __ldg(delays + c) : 0u;
    }
}

// The block adds the synapses [beg, end) of one row into the ring's slots
// after step t; each thread loads its next round before the atomics of
// this one.
__device__ __forceinline__ void mc_scatter_row(
    const int beg, const int end, const int* __restrict__ targets,
    const short* __restrict__ weights, const unsigned char* __restrict__ delays,
    int* ring, const unsigned t, const unsigned dmask, const int num) {
    int c0 = beg + static_cast<int>(threadIdx.x);
    if (c0 >= end) return;
    int tg[MC_UNROLL], w[MC_UNROLL];
    unsigned d[MC_UNROLL];
    mc_load(c0, end, targets, weights, delays, tg, w, d);
    while (true) {
        const int c1 = c0 + MC_BLOCK * MC_UNROLL;
        int tg2[MC_UNROLL], w2[MC_UNROLL];
        unsigned d2[MC_UNROLL];
        mc_load(c1, end, targets, weights, delays, tg2, w2, d2);
#pragma unroll
        for (int u = 0; u < MC_UNROLL; ++u) {
            if (static_cast<unsigned>(tg[u]) >= static_cast<unsigned>(num))
                continue;
            const unsigned slot = (t + d[u]) & dmask;
            atomicAdd(ring + static_cast<long long>(slot) * num + tg[u], w[u]);
        }
        if (c1 >= end) break;
#pragma unroll
        for (int u = 0; u < MC_UNROLL; ++u) {
            tg[u] = tg2[u];
            w[u] = w2[u];
            d[u] = d2[u];
        }
        c0 = c1;
    }
}

__global__ void __launch_bounds__(MC_BLOCK, 3)
mc_sim_kernel(float* __restrict__ v, float* __restrict__ i_syn,
              int* __restrict__ ref, int* ring, int* __restrict__ spike_count,
              const int* __restrict__ row_ptr, const int* __restrict__ targets,
              const short* __restrict__ weights,
              const unsigned char* __restrict__ delays, const int n_steps,
              const McParams p) {
    __shared__ unsigned s_thr[MC_MAX_POPS * MC_KMAX];
    // The step's spiking rows, [beg, end), and their count: two counters,
    // by the step's parity, so that one is cleared while the other is read.
    __shared__ int2 s_rows[MC_BLOCK];
    __shared__ int s_n[2];
    for (int q = threadIdx.x; q < MC_MAX_POPS * MC_KMAX; q += blockDim.x)
        s_thr[q] = p.thr[q];
    if (threadIdx.x < 2) s_n[threadIdx.x] = 0;
    __syncthreads();
    cg::grid_group grid = cg::this_grid();
    const int num = p.num;
    const unsigned dmask = static_cast<unsigned>(p.depth) - 1u;
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    const bool own = i < num;

    float rv = own ? v[i] : 0.0f;
    float ri = own ? i_syn[i] : 0.0f;
    int rr = own ? ref[i] : 0;
    int rc = own ? spike_count[i] : 0;
    const int2 row =
        own ? make_int2(__ldg(row_ptr + i), __ldg(row_ptr + i + 1))
            : make_int2(0, 0);
    // the offset of the neuron's population in the threshold table
    int pop = 0;
    while (pop + 1 < p.n_pops && i >= p.pop_start[pop + 1]) ++pop;
    const int rp = pop * MC_KMAX;

    for (int k = 0; k < n_steps; ++k) {
        const unsigned t = p.step0 + static_cast<unsigned>(k);
        int* now = ring + static_cast<long long>(t & dmask) * num;
        const unsigned h = lr_mix32(p.key ^ (t * MC_T_MUL));
        if (own) {
            int in = __ldcg(now + i);
            if (in) now[i] = 0;
            const unsigned u =
                lr_mix32(h ^ (static_cast<unsigned>(i) * MC_I_MUL));
            int events = 0;
#pragma unroll
            for (int m = 0; m < MC_KMAX; ++m) events += u >= s_thr[rp + m];
            in += events * p.w_ext;
            if (rr == 0)
                rv = __fmaf_rn(ri, p.p21, __fmul_rn(rv, p.p22));
            else
                rr -= 1;
            ri = __fmaf_rn(ri, p.p11, __fmul_rn(p.q, __int2float_rn(in)));
            if (rv >= p.v_th) {
                rv = p.v_reset;
                rr = p.ref_steps;
                rc += 1;
                s_rows[atomicAdd(s_n + (k & 1), 1)] = row;
            }
        }
        // The next step's counter was last read before the previous
        // grid.sync(), and is next added to after this step's.
        if (threadIdx.x == 0) s_n[(k & 1) ^ 1] = 0;
        __syncthreads();
        const int n = s_n[k & 1];
        for (int r = 0; r < n; ++r)
            mc_scatter_row(s_rows[r].x, s_rows[r].y, targets, weights, delays,
                           ring, t, dmask, num);
        grid.sync();
    }

    if (own) {
        v[i] = rv;
        i_syn[i] = ri;
        ref[i] = rr;
        spike_count[i] = rc;
    }
}

// The barrier alone: n_syncs grid barriers on the grid K23 would run.
__global__ void __launch_bounds__(MC_BLOCK)
mc_sim_barriers_kernel(const int n_syncs) {
    cg::grid_group grid = cg::this_grid();
    for (int k = 0; k < n_syncs; ++k) grid.sync();
}

}  // namespace

// Blocks of MC_BLOCK threads of K23 that can be co-resident on the
// device: the largest grid a cooperative launch of it takes.
BE_EXPORT int mc_sim_max_blocks(int device, int* blocks) {
    int err = be_begin(device);
    if (err) return err;
    return be_coresident_blocks(reinterpret_cast<const void*>(mc_sim_kernel),
                                MC_BLOCK, device, blocks);
}

// v, i_syn: (num,) float32; ref, spike_count: (num,) int32, read at the
// start and written at the end; ring: (depth, num) int32, read, cleared
// and added into in place; row_ptr: (num + 1,) int32; targets: int32,
// weights: int16, delays: uint8, row_ptr[num] each. blocks * MC_BLOCK
// must cover num; a grid larger than can be co-resident is refused
// (cudaErrorCooperativeLaunchTooLarge).
BE_EXPORT int mc_sim_launch(float* v, float* i_syn, int* ref, int* ring,
                            int* spike_count, const int* row_ptr,
                            const int* targets, const short* weights,
                            const unsigned char* delays, int n_steps,
                            const McParams* p, int blocks, int device,
                            void* stream) {
    int err = be_begin(device);
    if (err) return err;
    if (p->num <= 0) return be_end();
    if (blocks <= 0 || static_cast<long long>(blocks) * MC_BLOCK < p->num ||
        p->n_pops < 1 || p->n_pops > MC_MAX_POPS || p->depth < 2 ||
        (p->depth & (p->depth - 1)))
        return static_cast<int>(cudaErrorInvalidValue);
    const void* kernel = reinterpret_cast<const void*>(mc_sim_kernel);
    McParams params = *p;
    void* args[] = {&v,       &i_syn,   &ref,     &ring,   &spike_count,
                    &row_ptr, &targets, &weights, &delays, &n_steps,
                    &params};
    return be_refused(static_cast<int>(cudaLaunchCooperativeKernel(
        kernel, dim3(blocks), dim3(MC_BLOCK), args, 0,
        static_cast<cudaStream_t>(stream))));
}

// n_syncs grid barriers on a cooperative grid of blocks x MC_BLOCK.
BE_EXPORT int mc_sim_barriers_launch(int n_syncs, int blocks, int device,
                                     void* stream) {
    int err = be_begin(device);
    if (err) return err;
    void* args[] = {&n_syncs};
    return be_refused(static_cast<int>(cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(mc_sim_barriers_kernel), dim3(blocks),
        dim3(MC_BLOCK), args, 0, static_cast<cudaStream_t>(stream))));
}
