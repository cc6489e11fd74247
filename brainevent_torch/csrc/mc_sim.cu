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
// registers for the whole trial. The launch bounds (four blocks an SM)
// cap a thread at 64 registers, so that 528 blocks of MC_BLOCK (135,168
// neurons, scale 1.75) are co-resident on an H100's 132 SMs, as
// mc_sim_max_blocks reads (396 at the 72 that three blocks an SM let the
// compiler take, and ran no faster). The ring, which other
// blocks' atomics wrote in this launch, is read past L1 (__ldcg); the rows
// through the read-only path.
//
// Rows are long (~3.9k synapses a neuron at full scale, 6.5k from L4I,
// against K21's 80), and the rows (2.09 GB) lie past L2; ~25 spikes and
// 97k synapse events a step move ~680 KB. When a spike's block added its
// whole row in the step of the spike, the step waited for one SM's
// atomics over the busiest block's rows (~6.7k synapses, ~1 atomic a ns:
// 7.9 us a step on an H100). So the whole grid adds every row in the step
// of the spike, each block a contiguous 1/B of each row (mc_row_part).
// That needs the step's rows before its update: a spike at step t is
// known at the end of step t - 1, since the update reads only the state
// the last step left (mc_spikes_next, the update's own arithmetic).
// - Step t - 1, after its update: a thread whose neuron will spike at t
//   appends its row's bounds to step t's list in global memory (a slot
//   from the list's counter) and brings the row into L2 (a bulk prefetch).
//   The list of a launch's first step is made from its initial state
//   before the loop, behind one more grid.sync().
// - Step t, from its top: one warp of each block reads step t's list,
//   complete since the last grid.sync(), MC_CHUNK rows at a time, and each
//   warp takes rows warp, warp + SG_WARPS, ... of the chunk, its lanes over
//   the block's part of each row. The first chunk's first synapse a lane
//   is loaded before the update, and added after it: each synapse of delay
//   d into slot (t + d) mod D. Since 1 <= d < D, no add of step t writes
//   the slot step t reads and clears, and every write into that slot came
//   before the previous barrier: one grid.sync() a step is enough; and the
//   ring a launch returns holds every pending input, the launch's last
//   step's too.
// Three lists and counters, by step mod 3: list k is appended in step
// k - 1 (or before the loop), read in step k, and its counter cleared in
// step k + 1, between two barriers from both; the launcher zeroes the
// counters. The ring, the Poisson draw and the lists are sim_grid.cuh's,
// which K24 (stdp_sim.cu) shares. What bounds the step (H100, full scale):
// the barrier (1.36 us), the two round trips to L2 after it (the list,
// then the rows' synapses), and the grid's ~97k atomics a step into the
// L2-resident ring, which the barrier waits for.
//
// Two instances (kPhases): the plain one, and the clocked one that the
// launcher takes where it is given a buffer for the phases. The clocked
// one times each warp's launch in three phases (phase_clock.cuh): update
// (the update and the Poisson draw, the listing of the next step's rows,
// the state's load and store and the first step's list), scatter (the
// grid pass: the list's read and the first loads before the update, the
// adds and the rest after it) and barrier (from arriving at a grid.sync()
// to leaving it); and counts the rows it lists ahead. Its outputs are the
// plain one's.
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
// A list is read a warp's width of rows at a time, and each warp takes
// MC_ROUNDS rows of such a chunk: rows warp, warp + SG_WARPS, ...
constexpr int MC_CHUNK = 32;
constexpr int MC_ROUNDS = MC_CHUNK / SG_WARPS;
// The phases of the clocked instance, and the slot of its count of the
// rows listed ahead after them.
enum McPhase { MC_UPDATE, MC_SCATTER, MC_BARRIER, MC_PHASES };

// Whether a neuron in state (v, i, ref) spikes at its next step: the
// update's own arithmetic (mc_sim_kernel) on that state.
__device__ __forceinline__ bool mc_spikes_next(const float v, const float i,
                                               const int ref,
                                               const McParams& p) {
    return (ref == 0 ? __fmaf_rn(i, p.p21, __fmul_rn(v, p.p22)) : v) >= p.v_th;
}

// Lists the row [row.x, row.y) of a neuron that spikes at the list's step
// and brings it into L2, where the grid pass of that step reads it.
__device__ __forceinline__ void mc_list_ahead(
    int2* list, int* count, const int2 row, const int* __restrict__ targets,
    const short* __restrict__ weights,
    const unsigned char* __restrict__ delays) {
    sg_prefetch(targets + row.x, targets + row.y);
    sg_prefetch(weights + row.x, weights + row.y);
    sg_prefetch(delays + row.x, delays + row.y);
    sg_append(list, count, row);
}

// This block's contiguous part [*lo, *hi) of the row [row.x, row.y), empty
// where the row is not listed. Block b's part of a row of len synapses
// starts at umulhi(len, f_lo), f_lo = floor(2^32 b / B), and ends where
// block b + 1's starts (the row's end at the last block, last), so that the
// blocks' parts tile the row.
__device__ __forceinline__ void mc_row_part(const int2 row, const bool listed,
                                            const unsigned f_lo,
                                            const unsigned f_hi,
                                            const bool last, int* lo,
                                            int* hi) {
    const unsigned len = listed ? static_cast<unsigned>(row.y - row.x) : 0u;
    *lo = row.x + static_cast<int>(__umulhi(len, f_lo));
    *hi = row.x + static_cast<int>(last ? len : __umulhi(len, f_hi));
}

// Synapse e of the rows if e < hi; else delay 0.
__device__ __forceinline__ void mc_syn_load(
    const int e, const int hi, const int* __restrict__ targets,
    const short* __restrict__ weights, const unsigned char* __restrict__ delays,
    int* tg, int* w, unsigned* d) {
    *tg = 0;
    *w = 0;
    *d = 0u;
    if (e < hi) {
        *tg = __ldg(targets + e);
        *w = __ldg(weights + e);
        *d = __ldg(delays + e);
    }
}

// A synapse from a spike at step ts into its slot (ts + d) mod D (none of
// delay 0: past its part's end).
__device__ __forceinline__ void mc_syn_add(const int tg, const int w,
                                           const unsigned d, int* ring,
                                           const unsigned ts,
                                           const unsigned dmask,
                                           const int num) {
    if (d)
        atomicAdd(ring + static_cast<long long>((ts + d) & dmask) * num + tg,
                  w);
}

// A warp's lanes over the synapses [e, hi), a warp's width apart.
__device__ __forceinline__ void mc_syn_walk(
    int e, const int hi, const int* __restrict__ targets,
    const short* __restrict__ weights, const unsigned char* __restrict__ delays,
    int* ring, const unsigned ts, const unsigned dmask, const int num) {
    for (; e < hi; e += MC_CHUNK) {
        int tg, w;
        unsigned d;
        mc_syn_load(e, hi, targets, weights, delays, &tg, &w, &d);
        mc_syn_add(tg, w, d, ring, ts, dmask, num);
    }
}

// kPhases: the clocked instance, which adds to phases (the plain one reads
// it not).
template <bool kPhases>
__global__ void __launch_bounds__(MC_BLOCK, 4)
mc_sim_kernel(float* __restrict__ v, float* __restrict__ i_syn,
              int* __restrict__ ref, int* ring, int* __restrict__ spike_count,
              const int* __restrict__ row_ptr, const int* __restrict__ targets,
              const short* __restrict__ weights,
              const unsigned char* __restrict__ delays, int2* lists,
              int* counts, const int n_steps, const McParams p,
              unsigned long long* phases) {
    constexpr int W = MC_BLOCK / 32;
    BePhaseClock<kPhases, MC_PHASES, W> clk;
    clk.start();
    __shared__ unsigned s_thr[MC_MAX_POPS * MC_KMAX];
    // The first chunk of the step's list and its count, read by warp 0.
    __shared__ int2 s_rows[MC_CHUNK];
    __shared__ int s_n;
    for (int q = threadIdx.x; q < MC_MAX_POPS * MC_KMAX; q += blockDim.x)
        s_thr[q] = p.thr[q];
    __syncthreads();
    cg::grid_group grid = cg::this_grid();
    const int num = p.num;
    const unsigned dmask = static_cast<unsigned>(p.depth) - 1u;
    // the block's part of each row (mc_row_part)
    const unsigned f_lo = static_cast<unsigned>(
        (static_cast<unsigned long long>(blockIdx.x) << 32) / gridDim.x);
    const unsigned f_hi = static_cast<unsigned>(
        (static_cast<unsigned long long>(blockIdx.x + 1u) << 32) / gridDim.x);
    const bool last = blockIdx.x + 1u == gridDim.x;
    const int j = threadIdx.x;
    const int lane = j & 31, warp = j >> 5;
    const int i = blockIdx.x * blockDim.x + j;
    const bool own = i < num;

    float rv = own ? v[i] : 0.0f;
    float ri = own ? i_syn[i] : 0.0f;
    int rr = own ? ref[i] : 0;
    int rc = own ? spike_count[i] : 0;
    const int2 row =
        own ? make_int2(__ldg(row_ptr + i), __ldg(row_ptr + i + 1))
            : make_int2(0, 0);
    const bool sends = row.y > row.x;
    // the offset of the neuron's population in the threshold table
    int pop = 0;
    while (pop + 1 < p.n_pops && i >= p.pop_start[pop + 1]) ++pop;
    const int rp = pop * MC_KMAX;
    [[maybe_unused]] int ahead = 0;  // rows listed (the clocked instance)
    // The list of the launch's first step, from its initial state.
    if (n_steps > 0) {
        if (sends && mc_spikes_next(rv, ri, rr, p)) {
            mc_list_ahead(lists, counts, row, targets, weights, delays);
            if constexpr (kPhases) ++ahead;
        }
        clk.edge(MC_UPDATE);
        grid.sync();
        clk.edge(MC_BARRIER);
    }

    int cur = 0;  // k mod MC_LISTS
    for (int k = 0; k < n_steps; ++k) {
        const unsigned t = p.step0 + static_cast<unsigned>(k);
        const int next = cur == MC_LISTS - 1 ? 0 : cur + 1;
        const int after = next == MC_LISTS - 1 ? 0 : next + 1;
        // The step's input and its list, complete since the last
        // grid.sync(): the list's count and its first chunk, read together
        // before the update, by one warp of the block (every block reads
        // them: a warp each put 8x the requests on their lines).
        int* now = sg_slot(ring, t, dmask, num);
        int in = own ? __ldcg(now + i) : 0;
        const int2* list = lists + static_cast<long long>(cur) * num;
        if (warp == 0) {
            s_rows[lane] = lane < min(num, MC_CHUNK) ? __ldcg(list + lane)
                                                     : make_int2(0, 0);
            if (lane == 0) s_n = __ldcg(counts + cur);
        }
        __syncthreads();
        const int n = s_n;
        // The grid pass: each warp's rows of the first chunk, the block's
        // part of each, the first synapse a lane loaded before the update.
        int lo[MC_ROUNDS], hi[MC_ROUNDS], tg[MC_ROUNDS], w[MC_ROUNDS];
        unsigned d[MC_ROUNDS];
#pragma unroll
        for (int q = 0; q < MC_ROUNDS; ++q) {
            const int r = warp + SG_WARPS * q;
            mc_row_part(s_rows[r], r < n, f_lo, f_hi, last, lo + q, hi + q);
            mc_syn_load(lo[q] + lane, hi[q], targets, weights, delays, tg + q,
                        w + q, d + q);
        }
        clk.edge(MC_SCATTER);

        const unsigned h = sg_step_hash(p.key, t);
        if (own) {
            if (in) now[i] = 0;
            in += sg_poisson(h, i, s_thr + rp) * p.w_ext;
            if (rr == 0)
                rv = __fmaf_rn(ri, p.p21, __fmul_rn(rv, p.p22));
            else
                rr -= 1;
            ri = __fmaf_rn(ri, p.p11, __fmul_rn(p.q, __int2float_rn(in)));
            // a spike of this step, listed in the last one
            if (rv >= p.v_th) {
                rv = p.v_reset;
                rr = p.ref_steps;
                rc += 1;
            }
            // a spike of the next step, added by the grid pass there
            if (k + 1 < n_steps && sends && mc_spikes_next(rv, ri, rr, p)) {
                mc_list_ahead(lists + static_cast<long long>(next) * num,
                              counts + next, row, targets, weights, delays);
                if constexpr (kPhases) ++ahead;
            }
        }
        clk.edge(MC_UPDATE);
        // The counter of step k - 1, read in step k - 1, is next added to
        // in step k + 1, after this step's grid.sync().
        if (blockIdx.x == 0 && j == 0) counts[after] = 0;
        // The rest of the grid pass: the step's synapses, all delays, into
        // the slots of the steps to come.
#pragma unroll
        for (int q = 0; q < MC_ROUNDS; ++q)
            mc_syn_add(tg[q], w[q], d[q], ring, t, dmask, num);
#pragma unroll
        for (int q = 0; q < MC_ROUNDS; ++q)
            mc_syn_walk(lo[q] + lane + MC_CHUNK, hi[q], targets, weights,
                        delays, ring, t, dmask, num);
        for (int c0 = MC_CHUNK; c0 < n; c0 += MC_CHUNK) {
            const int2 crow = lane < min(n - c0, MC_CHUNK)
                                  ? __ldcg(list + c0 + lane)
                                  : make_int2(0, 0);
#pragma unroll
            for (int q = 0; q < MC_ROUNDS; ++q) {
                const int r = warp + SG_WARPS * q;
                const int2 rw = make_int2(__shfl_sync(0xffffffffu, crow.x, r),
                                          __shfl_sync(0xffffffffu, crow.y, r));
                int clo, chi;
                mc_row_part(rw, c0 + r < n, f_lo, f_hi, last, &clo, &chi);
                mc_syn_walk(clo + lane, chi, targets, weights, delays, ring, t,
                            dmask, num);
            }
        }
        clk.edge(MC_SCATTER);
        grid.sync();
        clk.edge(MC_BARRIER);
        clk.tick(k);
        cur = next;
    }

    if (own) {
        v[i] = rv;
        i_syn[i] = ri;
        ref[i] = rr;
        spike_count[i] = rc;
    }
    clk.edge(MC_UPDATE);
    if constexpr (kPhases) {
        const int warp_ahead = __reduce_add_sync(0xffffffffu, ahead);
        if (lane == 0 && warp_ahead)
            atomicAdd(phases + MC_PHASES,
                      static_cast<unsigned long long>(warp_ahead));
    }
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
// weights: int16, delays: uint8, row_ptr[num] each; lists: (MC_LISTS, num)
// int2 and counts: (MC_LISTS,) int32, scratch (counts zeroed here);
// phases: null (the plain instance), or (4,) uint64, zeroed by the caller,
// that the clocked instance adds the grid's warps' ns in update, scatter
// and barrier to, and then the rows it listed ahead (the launch's spikes
// of non-empty rows). blocks * MC_BLOCK must cover num; a grid larger than
// can be co-resident is refused (cudaErrorCooperativeLaunchTooLarge).
BE_EXPORT int mc_sim_launch(float* v, float* i_syn, int* ref, int* ring,
                            int* spike_count, const int* row_ptr,
                            const int* targets, const short* weights,
                            const unsigned char* delays, int* lists,
                            int* counts, unsigned long long* phases,
                            int n_steps, const McParams* p, int blocks,
                            int device, void* stream) {
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
    void* args[] = {&v,       &i_syn,   &ref,     &ring,   &spike_count,
                    &row_ptr, &targets, &weights, &delays, &list2,
                    &counts,  &n_steps, &params,  &phases};
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
