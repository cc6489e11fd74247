// Copyright 2026 The brainevent-tpu Authors.
// Licensed under the Apache License, Version 2.0.
//
// K19: einet_dense_hits, the EI network's propagation over a dense
// connection-count table.
//
// It replaces the count product of
// brainevent_tpu/models/pallas_sim.py:einet_pallas_sim_dense (:532), which
// multiplies the (2, num) E/I spike masks by the (num, num) bf16 count table
// on the MXU every step (:601-607), on the route above the capacity of
// K21's table instance (einet_sim.cu), which runs the dense strategy's
// whole simulation in one launch below it. Only the rows of neurons that
// spiked contribute to that product, and K1 (einet_step.cu) already writes
// their ids to a device list, so here each step sums those rows of the
// table:
//
//   counts[0, j] += sum over listed ids i <  n_exc of table[i, j]
//   counts[1, j] += sum over listed ids i >= n_exc of table[i, j]
//
// One thread owns one target column j: it reads the list's length from
// device memory (no host sync), caps it at num, walks this step's ids, drops
// ids outside [0, num), and sums the table entries into two int32 registers.
// A warp reads 32 consecutive entries of one row. The thread owns its two
// outputs, so it adds without atomics. Integer sums do not depend on their
// order, so the counts are bitwise K2's (event_scatter.cu) for the same list
// and connectivity; K1 folds them as it folds K2's.
//
// Bound: bytes. A step reads n_act rows of num entries (uint8 while every
// multiplicity is <= 255, else int32) and its ids, and writes the 2 x num
// counts: n_act * (num * itemsize + 4) + 8 * num bytes. The rate of the run sets
// n_act; at 4k neurons a step has ~9 spikes over 16 blocks, so the launch
// latency dominates.
#include "common.cuh"

namespace {

template <typename T>
__global__ void einet_dense_hits_kernel(const int* __restrict__ ids,
                                        const int* __restrict__ n_ids,
                                        const T* __restrict__ table,
                                        const int num, const int n_exc,
                                        int* __restrict__ counts) {
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= num) return;
    const int n_events = min(*n_ids, num);
    int hits_e = 0, hits_i = 0;
    for (int e = 0; e < n_events; ++e) {
        const int id = ids[e];
        if (static_cast<unsigned>(id) >= static_cast<unsigned>(num)) continue;
        const int c = static_cast<int>(
            table[static_cast<long long>(id) * num + j]);
        if (id < n_exc)
            hits_e += c;
        else
            hits_i += c;
    }
    counts[j] += hits_e;
    counts[num + j] += hits_i;
}

}  // namespace

// ids: (num,) int32, the first *n_ids valid; table: (num, num) uint8
// (table_int32 == 0) or int32; counts: (2, num) int32, added to.
BE_EXPORT int einet_dense_hits_launch(const int* ids, const int* n_ids,
                                      const void* table, int table_int32,
                                      int num, int n_exc, int* counts,
                                      int device, void* stream) {
    int err = be_begin(device);
    if (err) return err;
    if (num <= 0) return be_end();
    const int blocks = (num + BE_BLOCK - 1) / BE_BLOCK;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (table_int32)
        einet_dense_hits_kernel<int><<<blocks, BE_BLOCK, 0, s>>>(
            ids, n_ids, static_cast<const int*>(table), num, n_exc, counts);
    else
        einet_dense_hits_kernel<unsigned char><<<blocks, BE_BLOCK, 0, s>>>(
            ids, n_ids, static_cast<const unsigned char*>(table), num, n_exc,
            counts);
    return be_end();
}
