// Copyright 2026 The brainevent-tpu Authors.
// Licensed under the Apache License, Version 2.0.
//
// K21 `einet_sim`: the whole EI simulation, n steps, in one launch.
//
// Replaces the whole-simulation TPU kernels
// brainevent_tpu/models/pallas_sim.py:einet_pallas_sim_mxu3 (:639, its
// pallas_call at :988 runs a fori_loop over the steps inside the kernel)
// and :einet_pallas_sim_mxu6 (:1368), on the main path where K1
// (einet_step.cu) and K2 (event_scatter.cu) took 2n + 1 launches. Its
// result is bitwise theirs: the fold and the neuron update are
// einet_neuron.cuh's, shared with K1, and the hit counts are int32 sums,
// exact at any order of the atomics.
//
// Bound: neither bytes nor operations, but the grid barrier between steps
// and the latency of a step's dependent loads. A step's work is small (at
// 4k neurons ~8 spikes x 80 atomic adds); the K1 + K2 loop paid ~3 us of
// device time a launch and the host's launch path on top. Here:
//   - a persistent, cooperative grid (cudaLaunchCooperativeKernel: every
//     block is co-resident, or the launch is refused) sized to the work,
//     crossed by a grid-wide barrier (cooperative groups' grid.sync(),
//     which carries the device-scope fence);
//   - thread j owns neurons j, j + G, ... (G threads in the grid), NPT of
//     them, and keeps their v, t_last, g_e, g_i and spike_count in
//     registers for the whole run: state is read once and written once;
//   - hit counts are double-buffered by parity, int32 (2, 2, num): step k
//     folds (and zeroes) the buffer step k - 1 filled and adds into the
//     other one, so one barrier a step orders the two;
//   - no spike list: each warp, right after the update, adds the targets
//     of its own spiking neurons (a ballot, then its lanes walk one row at
//     a time, as K2's do) into this step's counts. The design of K1 + K2
//     in one grid (append to a list, barrier, a warp an event over the
//     list, barrier) took 1.5-1.7 us a step more at 4k and 3.1-3.3 at
//     400k on an H100 (PERF.md, PR 11).
// Loads of the counts, which other blocks wrote in this launch, bypass L1
// (__ldcg); conn and times, which nothing writes, go through the
// read-only path.
#include <cooperative_groups.h>

#include "einet_neuron.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int BE_SIM_BLOCK = 256;

// One warp adds 1 to counts[ch][target] for every target of neuron id
// (ch = id >= n_exc); targets outside [0, num) are dropped, as K2 drops
// them.
__device__ __forceinline__ void be_sim_scatter_row(const int id,
                                                   const int* __restrict__ conn,
                                                   const int n_conn,
                                                   const int n_exc,
                                                   const int num, int* counts,
                                                   const int lane) {
    int* dst = counts + (id >= n_exc ? num : 0);
    const int* row = conn + static_cast<long long>(id) * n_conn;
    for (int c = lane; c < n_conn; c += 32) {
        const unsigned target = static_cast<unsigned>(__ldg(row + c));
        if (target < static_cast<unsigned>(num)) atomicAdd(dst + target, 1);
    }
}

// NPT = 8 is held to three blocks an SM (78 registers a thread on an
// H100, no spills): at its free allocation (95) it ran two, and so held
// no more neurons than NPT = 4.
template <int NPT>
__global__ void __launch_bounds__(BE_SIM_BLOCK, NPT == 8 ? 3 : 1)
einet_sim_kernel(float* __restrict__ v, float* __restrict__ t_last,
                 float* __restrict__ g_e, float* __restrict__ g_i,
                 int* __restrict__ spike_count,
                 const int* __restrict__ conn,
                 const float* __restrict__ times, const int n_steps,
                 const int n_conn, const int n_exc, int* counts,
                 const EINetParams p) {
    cg::grid_group grid = cg::this_grid();
    const int num = p.num;
    const int n_threads = gridDim.x * blockDim.x;
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    const int lane = threadIdx.x & 31;
    const long long plane = 2LL * num;

    float rv[NPT], rt[NPT], re[NPT], ri[NPT];
    int rc[NPT];
#pragma unroll
    for (int s = 0; s < NPT; ++s) {
        const int i = j + s * n_threads;
        const bool own = i < num;
        rv[s] = own ? v[i] : 0.0f;
        rt[s] = own ? t_last[i] : 0.0f;
        re[s] = own ? g_e[i] : 0.0f;
        ri[s] = own ? g_i[i] : 0.0f;
        rc[s] = own ? spike_count[i] : 0;
    }

    for (int k = 0; k < n_steps; ++k) {
        const float t = __ldg(times + k);
        const int parity = k & 1;
        int* fold_ct = counts + (parity ^ 1) * plane;
        int* add_ct = counts + parity * plane;
#pragma unroll
        for (int s = 0; s < NPT; ++s) {
            const int i = j + s * n_threads;
            bool spike = false;
            if (i < num) {
                if (k > 0) {
                    const int ce = __ldcg(fold_ct + i);
                    const int ci = __ldcg(fold_ct + num + i);
                    be_einet_fold(re[s], ri[s], ce, ci, p);
                    // zeroed for step k + 1, which adds into this buffer
                    // after the barrier
                    if (ce) fold_ct[i] = 0;
                    if (ci) fold_ct[num + i] = 0;
                }
                spike = be_einet_update(rv[s], rt[s], re[s], ri[s], p, t);
                rc[s] += spike;
            }
            // Every thread reaches the ballot: no early return.
            unsigned mask = __ballot_sync(0xffffffffu, spike);
            const int first = j - lane + s * n_threads;
            while (mask) {
                const int src = __ffs(mask) - 1;
                mask &= mask - 1;
                be_sim_scatter_row(first + src, conn, n_conn, n_exc, num,
                                   add_ct, lane);
            }
        }
        grid.sync();
    }

    // The last step's counts, folded (the K1 + K2 loop's final fold).
    const int* last_ct = counts + ((n_steps - 1) & 1) * plane;
#pragma unroll
    for (int s = 0; s < NPT; ++s) {
        const int i = j + s * n_threads;
        if (i >= num) continue;
        if (n_steps > 0)
            be_einet_fold(re[s], ri[s], __ldcg(last_ct + i),
                          __ldcg(last_ct + num + i), p);
        v[i] = rv[s];
        t_last[i] = rt[s];
        g_e[i] = re[s];
        g_i[i] = ri[s];
        spike_count[i] = rc[s];
    }
}

// The barrier alone: n_syncs grid barriers on the grid K21 would run,
// nothing else. Its time is the floor under K21's.
__global__ void __launch_bounds__(BE_SIM_BLOCK)
einet_sim_barriers_kernel(const int n_syncs) {
    cg::grid_group grid = cg::this_grid();
    for (int k = 0; k < n_syncs; ++k) grid.sync();
}

// The kernel of the instance npt (1, 2, 4 or 8), or nullptr.
const void* be_sim_kernel(int npt) {
    switch (npt) {
        case 1: return reinterpret_cast<const void*>(einet_sim_kernel<1>);
        case 2: return reinterpret_cast<const void*>(einet_sim_kernel<2>);
        case 4: return reinterpret_cast<const void*>(einet_sim_kernel<4>);
        case 8: return reinterpret_cast<const void*>(einet_sim_kernel<8>);
        default: return nullptr;
    }
}

// The result of a cooperative launch: a refusal (a grid too large to be
// co-resident) is returned and cleared, so that the next launch's
// cudaGetLastError() does not report it again.
int be_refused(int err) {
    if (err) {
        cudaGetLastError();
        return err;
    }
    return be_end();
}

}  // namespace

// Blocks of BE_SIM_BLOCK threads of the instance npt that can be
// co-resident on the device: the largest grid a cooperative launch takes.
BE_EXPORT int einet_sim_max_blocks(int npt, int device, int* blocks) {
    int err = be_begin(device);
    if (err) return err;
    const void* kernel = be_sim_kernel(npt);
    if (!kernel) return static_cast<int>(cudaErrorInvalidValue);
    int per_sm = 0, sms = 0;
    err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, BE_SIM_BLOCK, 0));
    if (err) return err;
    err = static_cast<int>(
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device));
    if (err) return err;
    *blocks = per_sm * sms;
    return 0;
}

// v, t_last, g_e, g_i: (num,) float32 and spike_count (num,) int32, read
// at the start and written at the end; conn: (num, n_conn) int32; times:
// (n_steps,) float32; counts: (2, 2, num) int32, zeroed by the caller.
// blocks * BE_SIM_BLOCK * npt
// must cover num; a grid larger than can be co-resident is refused
// (cudaErrorCooperativeLaunchTooLarge).
BE_EXPORT int einet_sim_launch(float* v, float* t_last, float* g_e,
                               float* g_i, int* spike_count, const int* conn,
                               const float* times, int n_steps, int n_conn,
                               int n_exc, int* counts, const EINetParams* p,
                               int npt, int blocks, int device,
                               void* stream) {
    int err = be_begin(device);
    if (err) return err;
    if (p->num <= 0) return be_end();
    if (blocks <= 0 ||
        static_cast<long long>(blocks) * BE_SIM_BLOCK * npt < p->num)
        return static_cast<int>(cudaErrorInvalidValue);
    const void* kernel = be_sim_kernel(npt);
    if (!kernel) return static_cast<int>(cudaErrorInvalidValue);
    EINetParams params = *p;
    void* args[] = {&v,     &t_last,  &g_e,    &g_i,   &spike_count, &conn,
                    &times, &n_steps, &n_conn, &n_exc, &counts,      &params};
    return be_refused(static_cast<int>(cudaLaunchCooperativeKernel(
        kernel, dim3(blocks), dim3(BE_SIM_BLOCK), args, 0,
        static_cast<cudaStream_t>(stream))));
}

// n_syncs grid barriers on a cooperative grid of blocks x BE_SIM_BLOCK.
BE_EXPORT int einet_sim_barriers_launch(int n_syncs, int blocks, int device,
                                        void* stream) {
    int err = be_begin(device);
    if (err) return err;
    void* args[] = {&n_syncs};
    err = static_cast<int>(cudaLaunchCooperativeKernel(
        reinterpret_cast<void*>(einet_sim_barriers_kernel), dim3(blocks),
        dim3(BE_SIM_BLOCK), args, 0, static_cast<cudaStream_t>(stream)));
    return be_refused(err);
}
