// Copyright 2026 The brainevent-tpu Authors.
// Licensed under the Apache License, Version 2.0.
//
// What the whole-trial kernels of stored networks share: K23 `mc_sim`
// (mc_sim.cu, the Potjans-Diesmann microcircuit) and K24 `stdp_sim`
// (stdp_sim.cu, NEST's HPC benchmark network with STDP).
//
// Both run a trial in one cooperative launch of blocks of SG_BLOCK threads
// (every block co-resident, or the launch is refused), crossed by grid
// barriers (cg::this_grid().sync()); both add their spikes' synapses into
// an int32 delay ring of D slots, D a power of two: slot t mod D holds the
// input of step t, an exact int32 sum whatever the order of the atomics,
// read and cleared by its neuron's thread in step t.
//
// - The Poisson drive: each neuron's events of step t are the number of a
//   population's 16 uint32 thresholds that its uniform u reaches, u =
//   mix(mix(key ^ t * SG_T_MUL) ^ i * SG_I_MUL) (lr_mix32): sg_step_hash,
//   sg_poisson.
// - The spike lists: a spiking thread appends its row's bounds [beg, end)
//   (int2) to a list in global memory at a slot from the list's counter
//   (sg_append), and brings the row into L2 without waiting (sg_prefetch).
// - The grid pass over a list: after a barrier every block reads the list
//   in chunks of SG_BLOCK rows, scans the rows' lengths in shared memory
//   (sg_scan), and takes a contiguous 1/gridDim.x of each chunk's entries
//   (sg_share); an entry finds its row by a binary search of the scan
//   (sg_find). So a step's spikes are spread over the whole grid, not
//   left to the blocks that own the spiking neurons.
#pragma once

#include <cooperative_groups.h>

#include <cstdint>

#include "light_rng.cuh"

namespace cg = cooperative_groups;

// Threads a block of the whole-trial kernels.
constexpr int SG_BLOCK = 256;
constexpr int SG_WARPS = SG_BLOCK / 32;
// Thresholds of a population's Poisson table.
constexpr int SG_KMAX = 16;
// The hash's step and neuron multipliers.
constexpr unsigned SG_T_MUL = 0x9E3779B9u;
constexpr unsigned SG_I_MUL = 0x85EBCA6Bu;

// Brings the bytes [a, b) into L2, in 16-byte bounds, without waiting.
__device__ __forceinline__ void sg_prefetch(const void* a, const void* b) {
    const unsigned long long lo =
        reinterpret_cast<unsigned long long>(a) & ~15ull;
    const unsigned long long hi =
        (reinterpret_cast<unsigned long long>(b) + 15ull) & ~15ull;
    asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" ::"l"(lo),
                 "r"(static_cast<unsigned>(hi - lo))
                 : "memory");
}

// The ring's slot of step t: D slots of num neurons, dmask = D - 1.
__device__ __forceinline__ int* sg_slot(int* ring, const unsigned t,
                                        const unsigned dmask, const int num) {
    return ring + static_cast<long long>(t & dmask) * num;
}

// The hash of step t of the Poisson stream key, shared by the neurons.
__device__ __forceinline__ unsigned sg_step_hash(const unsigned key,
                                                 const unsigned t) {
    return lr_mix32(key ^ (t * SG_T_MUL));
}

// Neuron i's Poisson events of the step of hash h: the thresholds (16,
// ascending, in shared memory) that its uniform reaches.
__device__ __forceinline__ int sg_poisson(const unsigned h, const int i,
                                          const unsigned* thr) {
    const unsigned u = lr_mix32(h ^ (static_cast<unsigned>(i) * SG_I_MUL));
    int events = 0;
#pragma unroll
    for (int m = 0; m < SG_KMAX; ++m) events += u >= thr[m];
    return events;
}

// Appends the row [beg, end) to a list whose counter is *count.
__device__ __forceinline__ void sg_append(int2* list, int* count,
                                          const int2 row) {
    list[atomicAdd(count, 1)] = row;
}

// The block's shared view of one chunk of a list, of m rows (row: this
// thread's, read by the caller): each row's first entry in s_beg and the
// exclusive sums of their lengths in s_off (s_off[m] the chunk's entries,
// returned).
__device__ __forceinline__ int sg_scan(const int2 row, const int m,
                                       int* s_off, int* s_beg, int* s_wsum) {
    const int j = threadIdx.x, lane = j & 31, warp = j >> 5;
    int x = j < m ? row.y - row.x : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
    }
    __syncthreads();  // the last chunk's view has been read
    if (lane == 31) s_wsum[warp] = x;
    s_beg[j] = row.x;
    __syncthreads();
    int pre = 0;
#pragma unroll
    for (int q = 0; q < SG_WARPS; ++q) pre += q < warp ? s_wsum[q] : 0;
    s_off[j + 1] = pre + x;
    if (j == 0) s_off[0] = 0;
    __syncthreads();
    return s_off[m];
}

// This block's contiguous 1/gridDim.x of a chunk's *total* entries.
__device__ __forceinline__ void sg_share(const int total, int* lo, int* hi) {
    const long long b = blockIdx.x, nb = gridDim.x;
    *lo = static_cast<int>(total * b / nb);
    *hi = static_cast<int>(total * (b + 1) / nb);
}

// The row, of a chunk's m, that holds the chunk's entry e (0 <= e <
// s_off[m]): the last whose offset is at most e.
__device__ __forceinline__ int sg_find(const int e, const int m,
                                       const int* s_off) {
    int lo = 0, up = m;
    while (up - lo > 1) {
        const int mid = (lo + up) >> 1;
        if (s_off[mid] <= e) lo = mid; else up = mid;
    }
    return lo;
}
