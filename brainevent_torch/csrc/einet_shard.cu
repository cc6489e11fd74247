// Copyright 2026 The brainevent-tpu Authors.
// Licensed under the Apache License, Version 2.0.
//
// K22 `einet_shard_step`: one step of the sharded EI network on one rank,
// the neuron update and the rank's hit partials in one launch.
//
// Replaces brainevent_tpu/parallel/mega.py:_make_counts_kernel (:122,
// pallas_call at :238), the single-step scatter each device of the JAX
// ShardedEINet runs on its rows of the connection table before one
// reduce-scatter, on the path where a rank's step took three launches: K1
// (einet_step.cu), a memset of the partials and K20 (mega_counts.cu).
//
// A rank holds n_loc neurons, the global ids [row0, row0 + n_loc), and
// their rows of the connection table conn (n_loc, n_conn). Thread i owns
// local neuron i. Per launch, each thread
//   1. (fold) folds the (2, n_loc) counts that the previous step's
//      reduce-scatter wrote into its synaptic state (be_einet_fold);
//   2. (step) runs the neuron update (be_einet_update), writes v, g_e,
//      g_i and, on a spike, t_last and spike_count; its warp ballots and
//      adds the targets t < num of its spiking rows, class row0 + id >=
//      n_exc, into the shard-major partials (n_dev, 2, n_loc) of parity k
//      & 1 (einet_scatter.cuh, shared with K21); and the grid zeroes the
//      partials of the other parity, which step k - 1's reduce-scatter
//      read before this launch (stream order) and step k + 1 adds into.
// The fold and the update are K1's (einet_neuron.cuh) and the counts are
// int32 sums, so a step is bitwise K1's, a memset and K20's. It keeps no
// spike list. A run launches (step) for step 0, (fold, step) for every
// later step, each followed by one reduce-scatter of the partials, and a
// last (fold) alone; see brainevent_torch/parallel/sharding.py.
//
// Bound: bytes. About 36 bytes a neuron (v, t_last, g_e, g_i and two
// counts read, v, g_e and g_i written), the spiking rows of conn (4 *
// n_conn bytes each) and their atomics (8 bytes a hit), and the zeroing
// of the other parity's 8 * num bytes.
//
// A persistent form of the whole sharded run would need the partials
// exchanged from inside the kernel (NVLink peer stores between cards);
// here the exchange is a collective between launches.
#include "einet_neuron.cuh"
#include "einet_scatter.cuh"

namespace {

__global__ void einet_shard_step_kernel(float* __restrict__ v,
                                        float* __restrict__ t_last,
                                        float* __restrict__ g_e,
                                        float* __restrict__ g_i,
                                        const int* __restrict__ counts,
                                        int* __restrict__ spike_count,
                                        int* partials,
                                        const int* __restrict__ conn,
                                        const int n_conn, const int num,
                                        const int row0, const int n_exc,
                                        const EINetParams p, const float t,
                                        const int parity, const int fold,
                                        const int step) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    const int n_loc = p.num;
    bool spike = false;
    if (i < n_loc) {
        float ge = g_e[i];
        float gi = g_i[i];
        if (fold) {
            be_einet_fold(ge, gi, counts[i], counts[n_loc + i], p);
            g_e[i] = ge;
            g_i[i] = gi;
        }
        if (step) {
            float vi = v[i];
            float tl = t_last[i];
            spike = be_einet_update(vi, tl, ge, gi, p, t);
            if (spike) {
                t_last[i] = tl;
                spike_count[i] += 1;
            }
            v[i] = vi;
        }
    }
    if (!step) return;    // the whole grid takes the same branch

    // the other parity's partials, zeroed for step k + 1
    const long long plane = 2LL * num;
    int* other = partials + (parity ^ 1) * plane;
    const long long n_threads =
        static_cast<long long>(gridDim.x) * blockDim.x;
    if ((plane & 3) == 0 &&
        reinterpret_cast<unsigned long long>(other) % 16 == 0) {
        int4* o4 = reinterpret_cast<int4*>(other);
        for (long long q = i; q < plane / 4; q += n_threads)
            o4[q] = make_int4(0, 0, 0, 0);
    } else {
        for (long long q = i; q < plane; q += n_threads) other[q] = 0;
    }

    // Every thread of the block reaches the ballot (no early return).
    const int lane = threadIdx.x & 31;
    const unsigned mask = __ballot_sync(0xffffffffu, spike);
    be_scatter_spikes<true>(mask, i - lane, conn, n_conn, row0, n_exc, num,
                            n_loc, partials + parity * plane, lane);
}

}  // namespace

// v, t_last, g_e, g_i: (n_loc,) float32 and spike_count (n_loc,) int32
// (p->num = n_loc); counts: (2, n_loc) int32, this rank's summed hits of
// the previous step; partials: (2, num / n_loc, 2, n_loc) int32, by
// parity, both zero before a run's first launch; conn: (n_loc, n_conn)
// int32, the global rows [row0, row0 + n_loc). n_loc divides num.
BE_EXPORT int einet_shard_step_launch(float* v, float* t_last, float* g_e,
                                      float* g_i, const int* counts,
                                      int* spike_count, int* partials,
                                      const int* conn, int n_conn, int num,
                                      int row0, int n_exc,
                                      const EINetParams* p, float t,
                                      int parity, int fold, int step,
                                      int device, void* stream) {
    int err = be_begin(device);
    if (err) return err;
    if (p->num <= 0) return be_end();
    if (num % p->num) return static_cast<int>(cudaErrorInvalidValue);
    const int blocks = (p->num + BE_BLOCK - 1) / BE_BLOCK;
    einet_shard_step_kernel<<<blocks, BE_BLOCK, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        v, t_last, g_e, g_i, counts, spike_count, partials, conn, n_conn, num,
        row0, n_exc, *p, t, parity & 1, fold, step);
    return be_end();
}
