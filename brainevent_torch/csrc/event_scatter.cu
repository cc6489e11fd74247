// Copyright 2026 The brainevent-tpu Authors.
// Licensed under the Apache License, Version 2.0.
//
// K2: event scatter with atomics, in two forms.
//
// `event_count_scatter` (int32) is the EI network's propagation. It
// replaces, together with K1 (einet_step.cu), the compaction and one-hot
// count phases of brainevent_tpu/models/pallas_sim.py:einet_pallas_sim_mxu3
// (:639) and :einet_pallas_sim_mxu6 (:1368). A fixed grid strides over the
// step's spike list, whose length it reads from device memory (no host
// sync). Each warp takes one event; its lanes walk that neuron's n_conn
// targets in the row-major int32 table conn and add 1 to
// counts[ch][target] with ch = (id >= n_exc). Integer sums do not depend
// on the order of the adds, so the counts are exact and need no capacity
// and no overflow path.
//
// `event_scatter_float` is the float form out[c, t] += values[c, e] for the
// scatter ops (brainevent_torch/ops/scatter.py): one thread per event,
// targets outside [0, n_out) dropped. For 0/1 values the float sums stay
// integers below 2^24 and are exact at any add order; other values round
// in the order the atomics land.
//
// Bound: atomic throughput. A spike costs n_conn (80) atomic adds into a
// table that stays in L2 at 4k neurons (32 KB of counts) and spreads over
// device memory at 400k (3.2 MB of counts, 128 MB of conn).
#include "common.cuh"

namespace {

__global__ void event_count_scatter_kernel(const int* __restrict__ ids,
                                           const int* __restrict__ n_ids,
                                           const int* __restrict__ conn,
                                           const int num, const int n_conn,
                                           const int n_exc,
                                           int* __restrict__ counts) {
    // The list holds at most num ids; ids outside [0, num) are dropped.
    const int n_events = min(*n_ids, num);
    const int lane = threadIdx.x & 31;
    const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const int n_warps = (gridDim.x * blockDim.x) >> 5;
    for (int e = warp; e < n_events; e += n_warps) {
        const int id = ids[e];
        if (static_cast<unsigned>(id) >= static_cast<unsigned>(num)) continue;
        int* dst = counts + (id >= n_exc ? num : 0);
        const int* row = conn + static_cast<long long>(id) * n_conn;
        for (int k = lane; k < n_conn; k += 32) {
            const unsigned target = static_cast<unsigned>(row[k]);
            if (target < static_cast<unsigned>(num)) atomicAdd(dst + target, 1);
        }
    }
}

__global__ void event_scatter_float_kernel(const int* __restrict__ targets,
                                           const float* __restrict__ values,
                                           const long long n_events,
                                           const int n_chan, const int n_out,
                                           float* __restrict__ out) {
    const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
    for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
         e < n_events; e += stride) {
        const unsigned target = static_cast<unsigned>(targets[e]);
        if (target >= static_cast<unsigned>(n_out)) continue;
        for (int c = 0; c < n_chan; ++c) {
            const float val = values[c * n_events + e];
            if (val != 0.0f)
                atomicAdd(out + static_cast<long long>(c) * n_out + target,
                          val);
        }
    }
}

}  // namespace

// n_ids points at the length of the list (one int32 on the device).
BE_EXPORT int event_count_scatter_launch(const int* ids, const int* n_ids,
                                         const int* conn, int num, int n_conn,
                                         int n_exc, int* counts, int device,
                                         void* stream) {
    int err = be_begin(device);
    if (err) return err;
    if (num <= 0) return be_end();
    // Eight warps a block; one block per 256 neurons up to the cap, so that
    // a 4k network runs 128 warps and a 400k network 4224.
    int blocks = (num + BE_BLOCK - 1) / BE_BLOCK;
    if (blocks > BE_MAX_BLOCKS) blocks = BE_MAX_BLOCKS;
    event_count_scatter_kernel<<<blocks, BE_BLOCK, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
        ids, n_ids, conn, num, n_conn, n_exc, counts);
    return be_end();
}

// targets: (E,) int32; values: (C, E) float32; out: (C, n_out) float32,
// zeroed by the caller.
BE_EXPORT int event_scatter_float_launch(const int* targets,
                                         const float* values,
                                         long long n_events, int n_chan,
                                         int n_out, float* out, int device,
                                         void* stream) {
    int err = be_begin(device);
    if (err) return err;
    if (n_events <= 0) return be_end();
    long long blocks = (n_events + BE_BLOCK - 1) / BE_BLOCK;
    if (blocks > 2 * BE_MAX_BLOCKS) blocks = 2 * BE_MAX_BLOCKS;
    event_scatter_float_kernel<<<static_cast<int>(blocks), BE_BLOCK, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
        targets, values, n_events, n_chan, n_out, out);
    return be_end();
}
