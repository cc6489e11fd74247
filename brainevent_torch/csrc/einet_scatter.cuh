// Copyright 2026 The brainevent-tpu Authors.
// Licensed under the Apache License, Version 2.0.
//
// The hit scatter of a warp's spiking neurons, shared by K21
// (einet_sim.cu, the whole run in one launch) and K22 (einet_shard.cu, one
// sharded step a launch), so that both count alike.
//
// Right after a neuron update each lane holds whether its neuron spiked;
// the warp ballots, then walks the rows of its spiking neurons one at a
// time, a lane a target, and adds 1 to the count of the neuron's class at
// each target with an int32 atomicAdd. Integer sums do not depend on the
// order of the adds, so the counts are exact and bitwise K2's
// (event_scatter.cu) and K20's (mega_counts.cu) for the same spikes.
// Targets outside [0, num) are dropped, as K2 and K20 drop them.
//
// The counts are laid out as (num / seg, 2, seg) blocks:
//     counts[(t / seg) * 2 * seg + ch * seg + t % seg]
// kSeg = false is seg = num, the (2, num) counts of K21; kSeg = true the
// shard-major (n_dev, 2, n_loc) partials of K22 (seg = n_loc), as K20
// lays them out.
#pragma once

#include "common.cuh"

// One warp adds the targets of row (n_conn int32 entries) into class ch.
template <bool kSeg>
__device__ __forceinline__ void be_scatter_row(const int* __restrict__ row,
                                               const int n_conn, const int ch,
                                               const int num, const int seg,
                                               int* counts, const int lane) {
    int* dst = counts + (kSeg ? 0 : ch * num);
    for (int c = lane; c < n_conn; c += 32) {
        const unsigned t = static_cast<unsigned>(__ldg(row + c));
        if (t >= static_cast<unsigned>(num)) continue;
        if (kSeg) {
            const unsigned s = t / static_cast<unsigned>(seg);
            const unsigned r = t - s * static_cast<unsigned>(seg);
            atomicAdd(dst + (2LL * s + ch) * seg + r, 1);
        } else {
            atomicAdd(dst + t, 1);
        }
    }
}

// The warp's spikes of one ballot: bit b of mask is the spike of neuron
// id = first + b, whose targets are row id of conn (n_conn a row) and
// whose class is id + class_off >= n_exc (class_off: the global id of
// row 0). Every lane of the warp calls it with the same mask.
template <bool kSeg>
__device__ __forceinline__ void be_scatter_spikes(
    unsigned mask, const int first, const int* __restrict__ conn,
    const int n_conn, const int class_off, const int n_exc, const int num,
    const int seg, int* counts, const int lane) {
    while (mask) {
        const int id = first + __ffs(mask) - 1;
        mask &= mask - 1;
        be_scatter_row<kSeg>(conn + static_cast<long long>(id) * n_conn,
                             n_conn, id + class_off >= n_exc ? 1 : 0, num,
                             seg, counts, lane);
    }
}
