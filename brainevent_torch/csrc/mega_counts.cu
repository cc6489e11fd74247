// Copyright 2026 The brainevent-tpu Authors.
// Licensed under the Apache License, Version 2.0.
//
// K20 `mega_counts`: the per-device E/I hit counts of the sharded EI
// network (brainevent_torch/parallel/mega.py). It replaces
// brainevent_tpu/parallel/mega.py:_make_counts_kernel (:122, pallas_call at
// :238), the single-step mxu6 scatter that each device of the JAX
// ShardedEINet runs on its own rows of the connection table before one
// reduce-scatter, at mega_local_counts; the sharded network's step runs
// the same counts inside K22 (einet_shard.cu, through einet_scatter.cuh).
//
// A device holds n_loc neurons, the global rows [row0, row0 + n_loc) of
// the row-major int32 table conn (n_loc, n_conn), and this step's spike
// list: local ids in [0, n_loc) whose length the kernel reads from device
// memory (K1's list, no host sync). For each spiking id and each of its
// targets t < num it adds 1 to the count of class ch = (row0 + id >= n_exc)
// (0 excitatory, 1 inhibitory) at target t, into counts laid out as
// (num / seg, 2, seg) blocks:
//     counts[(t / seg) * 2 * seg + ch * seg + t % seg] += 1.
// seg = num gives the full (2, num) partials of mega_local_counts; seg =
// n_loc gives the shard-major (n_dev, 2, n_loc) buffer whose one
// reduce-scatter hands every device its (2, n_loc) counts.
//
// The TPU kernel gathers the spiking rows into VMEM and counts hits with a
// two-level one-hot MXU contraction over a build-time target-partitioned
// table whose fields pack three counts into one float, because a TPU has
// no atomics; that packing is why it refuses an in-degree above 255 and a
// shard width that is not a multiple of 128. None of it is carried over:
// K2's warp-per-event scheme walks each spiking row, one lane per target,
// with int32 atomicAdd. Integer sums do not depend on the order of the
// adds, so the counts are exact at any in-degree, with no capacity and no
// overflow rounds. K2 ties the spike ids and the targets to one bound,
// num; here the ids are bounded by n_loc and the targets by num.
//
// Bound: the atomics, n_conn per spike (80 at the COBA networks), into a
// buffer of 8 * num bytes (3.2 MB at 400k, in L2), and the spiking rows of
// conn (320 bytes each).
#include "common.cuh"

namespace {

__global__ void mega_counts_kernel(const int* __restrict__ ids,
                                   const int* __restrict__ n_ids,
                                   const int* __restrict__ conn,
                                   const int n_loc, const int n_conn,
                                   const int num, const int row0,
                                   const int n_exc, const int seg,
                                   int* __restrict__ counts) {
    // The list holds at most n_loc ids; ids outside [0, n_loc) are dropped.
    const int n_events = min(*n_ids, n_loc);
    const int lane = threadIdx.x & 31;
    const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const int n_warps = (gridDim.x * blockDim.x) >> 5;
    for (int e = warp; e < n_events; e += n_warps) {
        const int id = ids[e];
        if (static_cast<unsigned>(id) >= static_cast<unsigned>(n_loc)) continue;
        const int ch = row0 + id >= n_exc ? 1 : 0;
        const int* row = conn + static_cast<long long>(id) * n_conn;
        for (int k = lane; k < n_conn; k += 32) {
            const unsigned t = static_cast<unsigned>(row[k]);
            if (t >= static_cast<unsigned>(num)) continue;
            const unsigned s = t / static_cast<unsigned>(seg);
            const unsigned r = t - s * static_cast<unsigned>(seg);
            atomicAdd(counts + (2LL * s + ch) * seg + r, 1);
        }
    }
}

}  // namespace

// ids: (n_loc,) int32 spike list, n_ids: its length (one int32 on the
// device); conn: (n_loc, n_conn) int32, the global rows [row0, row0 +
// n_loc); counts: (num / seg, 2, seg) int32, added to (the caller zeroes
// it); seg divides num.
BE_EXPORT int mega_counts_launch(const int* ids, const int* n_ids,
                                 const int* conn, int n_loc, int n_conn,
                                 int num, int row0, int n_exc, int seg,
                                 int* counts, int device, void* stream) {
    int err = be_begin(device);
    if (err) return err;
    if (n_loc <= 0 || num <= 0) return be_end();
    // Eight warps a block, one warp per 32 local neurons up to the cap
    // (K2's grid over the shard).
    int blocks = (n_loc + BE_BLOCK - 1) / BE_BLOCK;
    if (blocks > BE_MAX_BLOCKS) blocks = BE_MAX_BLOCKS;
    mega_counts_kernel<<<blocks, BE_BLOCK, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        ids, n_ids, conn, n_loc, n_conn, num, row0, n_exc, seg, counts);
    return be_end();
}
