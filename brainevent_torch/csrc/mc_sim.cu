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
// registers for the whole trial. The launch bounds (three blocks an SM)
// cap a thread at 80 registers, so that at least 396 blocks of MC_BLOCK
// (101,376 neurons, scale 1.31) are co-resident on an H100's 132 SMs;
// mc_sim_max_blocks reads how many (528 at its 56). One barrier a step
// is enough: since d >= 1 and D > d, no scatter of step t writes the slot
// step t reads and clears, and every write into that slot came before the
// previous barrier. The ring, which other blocks' atomics wrote in this
// launch, is read past L1 (__ldcg); the rows through the read-only path.
//
// Rows are long (~3.9k synapses a neuron at full scale, 6.5k from L4I,
// against K21's 80), and the rows (2.09 GB) lie past L2; ~25 spikes and
// 97k synapse events a step move ~680 KB. When a spike's block added its
// whole row in the step of the spike, the step waited for one SM's
// atomics over the busiest block's rows (~6.7k synapses, ~1 atomic a ns:
// 7.9 us a step on an H100). So a spike's synapses are split by delay:
// - delay 1 (~0.75% of them, a CSR of their own that MicrocircuitNet
//   builds once, models/microcircuit.py:mc_plan): the spike's block adds
//   them in the step of the spike, as they are read in the next one. The spike is known a step ahead (the update's own
//   arithmetic on the state the last step left, mc_spikes_next), so the
//   block lists its next step's delay-1 rows in shared memory in the step
//   before, and loads its first round of them before the update;
// - delay >= 2: the spiking thread appends its row's bounds to the step's
//   list in global memory (a slot from the list's counter) and brings the
//   row into L2 (a bulk prefetch); in the next step, every block reads
//   the list (its count and first rows before the update), scans the
//   rows' lengths in shared memory and adds its contiguous 1/B of their
//   synapses. A synapse of delay d >= 2 from step t is read in step t + d
//   >= t + 2, so adding it in step t + 1 keeps one grid.sync() a step; and
//   the last step's are added after the loop, so the ring a launch
//   returns holds every pending input, as before.
// Three lists and counters, by step mod 3: list k is appended in step k,
// read in step k + 1, and its counter cleared in step k + 2, between two
// barriers from both; the launcher zeroes the counters. What bounds the
// step now (H100, full scale): the barrier (1.36 us), the update (0.73),
// and the grid's ~97k atomics a step into the L2-resident ring (adding
// each twice costs ~1.0 us more), behind the latencies of the delay-1
// walk, the list's scan and the rows' loads: 4.6-4.7 us a step.
// The ring, the Poisson draw, the lists and the grid pass's scan, share
// and search are sim_grid.cuh's, which K24 (stdp_sim.cu) shares.
//
// Two instances (kPhases): the plain one, and the clocked one that the
// launcher takes where it is given a buffer for the phases. The clocked
// one times each warp's launch in three phases (phase_clock.cuh): update
// (the update and the Poisson draw, and the state's load and store),
// scatter (the delay-1 walk and the grid pass, and the last step's pass
// after the loop) and barrier (from arriving at the grid.sync() to leaving
// it); its outputs are the plain one's.
#include "common.cuh"
#include "phase_clock.cuh"
#include "sim_grid.cuh"

// The most populations, and the Poisson table's thresholds a population.
constexpr int MC_MAX_POPS = 8;
constexpr int MC_KMAX = SG_KMAX;

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

constexpr int MC_BLOCK = SG_BLOCK;
// The spiking-row lists (and their counters) K23 keeps, by step mod 3.
constexpr int MC_LISTS = 3;
// Synapses a thread of the grid pass loads before it adds them.
constexpr int MC_PASS_UNROLL = 2;
// The phases of the clocked instance.
enum McPhase { MC_UPDATE, MC_SCATTER, MC_BARRIER, MC_PHASES };

// Whether a neuron in state (v, i, ref) spikes at its next step: the
// update's own arithmetic (mc_sim_kernel) on that state.
__device__ __forceinline__ bool mc_spikes_next(const float v, const float i,
                                               const int ref,
                                               const McParams& p) {
    return (ref == 0 ? __fmaf_rn(i, p.p21, __fmul_rn(v, p.p22)) : v) >= p.v_th;
}

// One round of a thread's share of a chunk: the chunk's synapses e0 +
// MC_BLOCK u below hi, each found in its row by sg_find over the chunk's
// m rows; a synapse past hi reads as delay 0.
__device__ __forceinline__ void mc_pass_load(
    const int e0, const int hi, const int m, const int* s_off,
    const int* s_beg, const int* __restrict__ targets,
    const short* __restrict__ weights, const unsigned char* __restrict__ delays,
    int* tg, int* w, unsigned* d) {
#pragma unroll
    for (int u = 0; u < MC_PASS_UNROLL; ++u) {
        const int e = e0 + MC_BLOCK * u;
        tg[u] = 0;
        w[u] = 0;
        d[u] = 0u;
        if (e < hi) {
            const int r = sg_find(e, m, s_off);
            const int c = s_beg[r] + (e - s_off[r]);
            tg[u] = __ldg(targets + c);
            w[u] = __ldg(weights + c);
            d[u] = __ldg(delays + c);
        }
    }
}

// The round's synapses of delay >= 2 from a spike at step ts, into their
// slots (ts + d) mod D.
__device__ __forceinline__ void mc_pass_add(
    const int* tg, const int* w, const unsigned* d, int* ring,
    const unsigned ts, const unsigned dmask, const int num) {
#pragma unroll
    for (int u = 0; u < MC_PASS_UNROLL; ++u)
        if (d[u] >= 2u)
            atomicAdd(ring + static_cast<long long>((ts + d[u]) & dmask) * num +
                          tg[u],
                      w[u]);
}

// The rest of a thread's share of a chunk, from round e0 on.
__device__ __forceinline__ void mc_pass_rounds(
    int e0, const int hi, const int m, const int* s_off, const int* s_beg,
    const int* __restrict__ targets, const short* __restrict__ weights,
    const unsigned char* __restrict__ delays, int* ring, const unsigned ts,
    const unsigned dmask, const int num) {
    for (; e0 < hi; e0 += MC_BLOCK * MC_PASS_UNROLL) {
        int tg[MC_PASS_UNROLL], w[MC_PASS_UNROLL];
        unsigned d[MC_PASS_UNROLL];
        mc_pass_load(e0, hi, m, s_off, s_beg, targets, weights, delays, tg, w,
                     d);
        mc_pass_add(tg, w, d, ring, ts, dmask, num);
    }
}

// The grid pass over a step's list of n spiking rows from row c0 on, in
// chunks of MC_BLOCK rows: each block adds its share of each chunk's
// synapses of delay >= 2 from a spike at step ts.
__device__ __forceinline__ void mc_pass_chunks(
    const int2* list, int c0, const int n, int* s_off, int* s_beg,
    int* s_wsum, const int* __restrict__ targets,
    const short* __restrict__ weights, const unsigned char* __restrict__ delays,
    int* ring, const unsigned ts, const unsigned dmask, const int num) {
    const int j = threadIdx.x;
    for (; c0 < n; c0 += MC_BLOCK) {
        const int m = min(n - c0, MC_BLOCK);
        const int2 row = j < m ? __ldcg(list + c0 + j) : make_int2(0, 0);
        int lo, hi;
        sg_share(sg_scan(row, m, s_off, s_beg, s_wsum), &lo, &hi);
        mc_pass_rounds(lo + j, hi, m, s_off, s_beg, targets, weights, delays,
                       ring, ts, dmask, num);
    }
}

// kPhases: the clocked instance, which adds to phases (the plain one reads
// it not).
template <bool kPhases>
__global__ void __launch_bounds__(MC_BLOCK, 3)
mc_sim_kernel(float* __restrict__ v, float* __restrict__ i_syn,
              int* __restrict__ ref, int* ring, int* __restrict__ spike_count,
              const int* __restrict__ row_ptr, const int* __restrict__ targets,
              const short* __restrict__ weights,
              const unsigned char* __restrict__ delays,
              const int* __restrict__ near_ptr,
              const int* __restrict__ near_targets,
              const short* __restrict__ near_weights, int2* lists,
              int* counts, const int n_steps, const McParams p,
              unsigned long long* phases) {
    constexpr int W = MC_BLOCK / 32;
    BePhaseClock<kPhases, MC_PHASES, W> clk;
    clk.start();
    __shared__ unsigned s_thr[MC_MAX_POPS * MC_KMAX];
    // The delay-1 rows, [beg, end), of the block's spikes of a step, listed
    // in the step before, and their count; by the step's parity, so that
    // one step's list is walked while the next one's is made.
    __shared__ int2 s_rows[2][MC_BLOCK];
    __shared__ int s_n[2];
    // The grid pass's view of a chunk of the last step's list (sg_scan).
    __shared__ int s_off[MC_BLOCK + 1];
    __shared__ int s_beg[MC_BLOCK];
    __shared__ int s_wsum[SG_WARPS];
    for (int q = threadIdx.x; q < MC_MAX_POPS * MC_KMAX; q += blockDim.x)
        s_thr[q] = p.thr[q];
    if (threadIdx.x < 2) s_n[threadIdx.x] = 0;
    __syncthreads();
    cg::grid_group grid = cg::this_grid();
    const int num = p.num;
    const unsigned dmask = static_cast<unsigned>(p.depth) - 1u;
    const int j = threadIdx.x;
    const int i = blockIdx.x * blockDim.x + j;
    const bool own = i < num;

    float rv = own ? v[i] : 0.0f;
    float ri = own ? i_syn[i] : 0.0f;
    int rr = own ? ref[i] : 0;
    int rc = own ? spike_count[i] : 0;
    const int2 row =
        own ? make_int2(__ldg(row_ptr + i), __ldg(row_ptr + i + 1))
            : make_int2(0, 0);
    const int2 near =
        own ? make_int2(__ldg(near_ptr + i), __ldg(near_ptr + i + 1))
            : make_int2(0, 0);
    // the offset of the neuron's population in the threshold table
    int pop = 0;
    while (pop + 1 < p.n_pops && i >= p.pop_start[pop + 1]) ++pop;
    const int rp = pop * MC_KMAX;
    if (own && near.y > near.x && mc_spikes_next(rv, ri, rr, p))
        s_rows[0][atomicAdd(s_n, 1)] = near;
    __syncthreads();

    int cur = 0;  // k mod MC_LISTS
    for (int k = 0; k < n_steps; ++k) {
        const unsigned t = p.step0 + static_cast<unsigned>(k);
        const int last = cur == 0 ? MC_LISTS - 1 : cur - 1;
        const int next = cur == MC_LISTS - 1 ? 0 : cur + 1;
        // The last step's list, complete since the last grid.sync(): its
        // count and its first MC_BLOCK rows, read before the update.
        const int2* plist = lists + static_cast<long long>(last) * num;
        const int2 prow =
            j < min(num, MC_BLOCK) ? __ldcg(plist + j) : make_int2(0, 0);
        const int pn = __ldcg(counts + last);
        // The delay-1 rows of the block's spikes of this step: this
        // thread's first synapse of the first, loaded before the update.
        const int n = s_n[k & 1];
        const int2 q0 = n ? s_rows[k & 1][0] : make_int2(0, 0);
        const int c0 = q0.x + j;
        const int tg0 = c0 < q0.y ? __ldg(near_targets + c0) : 0;
        const int w0 = c0 < q0.y ? __ldg(near_weights + c0) : 0;

        int* now = sg_slot(ring, t, dmask, num);
        const unsigned h = sg_step_hash(p.key, t);
        if (own) {
            int in = __ldcg(now + i);
            if (in) now[i] = 0;
            in += sg_poisson(h, i, s_thr + rp) * p.w_ext;
            if (rr == 0)
                rv = __fmaf_rn(ri, p.p21, __fmul_rn(rv, p.p22));
            else
                rr -= 1;
            ri = __fmaf_rn(ri, p.p11, __fmul_rn(p.q, __int2float_rn(in)));
            if (rv >= p.v_th) {
                rv = p.v_reset;
                rr = p.ref_steps;
                rc += 1;
                if (row.y > row.x) {
                    // read by the grid pass in the next step
                    sg_prefetch(targets + row.x, targets + row.y);
                    sg_prefetch(weights + row.x, weights + row.y);
                    sg_prefetch(delays + row.x, delays + row.y);
                    sg_append(lists + static_cast<long long>(cur) * num,
                              counts + cur, row);
                }
            }
            if (near.y > near.x && mc_spikes_next(rv, ri, rr, p))
                s_rows[(k + 1) & 1][atomicAdd(s_n + ((k + 1) & 1), 1)] = near;
        }
        clk.edge(MC_UPDATE);
        // The counter of step k - 2, read in step k - 1, is next added to
        // in step k + 1, after this step's grid.sync().
        if (blockIdx.x == 0 && j == 0) counts[next] = 0;
        __syncthreads();
        // This step's count was read by every thread before the update.
        if (j == 0) s_n[k & 1] = 0;
        // The block's spikes' delay-1 synapses, read by step k + 1.
        int* soon = sg_slot(ring, t + 1u, dmask, num);
        if (c0 < q0.y) atomicAdd(soon + tg0, w0);
        for (int c = c0 + MC_BLOCK; c < q0.y; c += MC_BLOCK)
            atomicAdd(soon + __ldg(near_targets + c),
                      static_cast<int>(__ldg(near_weights + c)));
        for (int r = 1; r < n; ++r) {
            const int2 q = s_rows[k & 1][r];
            for (int c = q.x + j; c < q.y; c += MC_BLOCK)
                atomicAdd(soon + __ldg(near_targets + c),
                          static_cast<int>(__ldg(near_weights + c)));
        }
        // The grid pass: the last step's synapses of delay >= 2, the first
        // round of the first chunk loaded before any is added.
        if (pn) {
            const int pm = min(pn, MC_BLOCK);
            int lo, hi;
            sg_share(sg_scan(prow, pm, s_off, s_beg, s_wsum), &lo, &hi);
            int tg[MC_PASS_UNROLL], w[MC_PASS_UNROLL];
            unsigned d[MC_PASS_UNROLL];
            mc_pass_load(lo + j, hi, pm, s_off, s_beg, targets, weights,
                         delays, tg, w, d);
            mc_pass_add(tg, w, d, ring, t - 1u, dmask, num);
            mc_pass_rounds(lo + j + MC_BLOCK * MC_PASS_UNROLL, hi, pm, s_off,
                           s_beg, targets, weights, delays, ring, t - 1u,
                           dmask, num);
            mc_pass_chunks(plist, MC_BLOCK, pn, s_off, s_beg, s_wsum, targets,
                           weights, delays, ring, t - 1u, dmask, num);
        }
        clk.edge(MC_SCATTER);
        grid.sync();
        clk.edge(MC_BARRIER);
        clk.tick(k);
        cur = next;
    }
    // The last step's synapses of delay >= 2, so that the ring holds every
    // pending input and the next launch goes on from this state.
    if (n_steps > 0) {
        clk.edge(MC_UPDATE);
        const int last = cur == 0 ? MC_LISTS - 1 : cur - 1;
        mc_pass_chunks(lists + static_cast<long long>(last) * num, 0,
                       __ldcg(counts + last), s_off, s_beg, s_wsum, targets,
                       weights, delays, ring,
                       p.step0 + static_cast<unsigned>(n_steps - 1), dmask,
                       num);
        clk.edge(MC_SCATTER);
    }

    if (own) {
        v[i] = rv;
        i_syn[i] = ri;
        ref[i] = rr;
        spike_count[i] = rc;
    }
    clk.edge(MC_UPDATE);
    clk.finish(phases);
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
    return be_coresident_blocks(
        reinterpret_cast<const void*>(mc_sim_kernel<false>), MC_BLOCK, device,
        blocks);
}

// v, i_syn: (num,) float32; ref, spike_count: (num,) int32, read at the
// start and written at the end; ring: (depth, num) int32, read, cleared
// and added into in place; row_ptr: (num + 1,) int32; targets: int32,
// weights: int16, delays: uint8, row_ptr[num] each; near_ptr: (num + 1,)
// int32, near_targets: int32, near_weights: int16, near_ptr[num] each:
// the rows' synapses of delay 1, in their order; lists: (MC_LISTS, num)
// int2 and counts: (MC_LISTS,) int32, scratch (counts zeroed here);
// phases: null (the plain instance), or (3,) uint64, zeroed by the caller,
// that the clocked instance adds the grid's warps' ns in update, scatter
// and barrier to. blocks * MC_BLOCK must cover num; a grid larger than can
// be co-resident is refused (cudaErrorCooperativeLaunchTooLarge).
BE_EXPORT int mc_sim_launch(float* v, float* i_syn, int* ref, int* ring,
                            int* spike_count, const int* row_ptr,
                            const int* targets, const short* weights,
                            const unsigned char* delays, const int* near_ptr,
                            const int* near_targets, const short* near_weights,
                            int* lists, int* counts,
                            unsigned long long* phases, int n_steps,
                            const McParams* p, int blocks, int device,
                            void* stream) {
    int err = be_begin(device);
    if (err) return err;
    if (p->num <= 0) return be_end();
    if (blocks <= 0 || static_cast<long long>(blocks) * MC_BLOCK < p->num ||
        p->n_pops < 1 || p->n_pops > MC_MAX_POPS || p->depth < 2 ||
        (p->depth & (p->depth - 1)))
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    err = static_cast<int>(
        cudaMemsetAsync(counts, 0, MC_LISTS * sizeof(int), s));
    if (err) return err;
    const void* kernel =
        phases ? reinterpret_cast<const void*>(mc_sim_kernel<true>)
               : reinterpret_cast<const void*>(mc_sim_kernel<false>);
    McParams params = *p;
    int2* list2 = reinterpret_cast<int2*>(lists);
    void* args[] = {&v,           &i_syn,    &ref,          &ring,
                    &spike_count, &row_ptr,  &targets,      &weights,
                    &delays,      &near_ptr, &near_targets, &near_weights,
                    &list2,       &counts,   &n_steps,      &params,
                    &phases};
    return be_refused(static_cast<int>(
        cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(MC_BLOCK), args,
                                    0, s)));
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
