// Copyright 2026 The brainevent-tpu Authors.
// Licensed under the Apache License, Version 2.0.
//
// K21 `einet_sim`: the whole EI simulation, n steps, in one launch.
//
// Replaces the whole-simulation TPU kernels
// brainevent_tpu/models/pallas_sim.py:einet_pallas_sim_mxu3 (:639, its
// pallas_call at :988 runs a fori_loop over the steps inside the kernel)
// and :einet_pallas_sim_mxu6 (:1368), on the main path where K1
// (einet_step.cu) and K2 (event_scatter.cu) took 2n + 1 launches; and, in
// its table instances, :einet_pallas_sim_dense (:532, pallas_call at
// :618), which multiplies the (2, num) E/I spike masks by the (num, num)
// count table every step, where K1 and K19 (einet_dense.cu) took 2n + 1
// launches. Its result is bitwise theirs: the fold and the neuron update
// are einet_neuron.cuh's, shared with K1, and the hit counts are int32
// sums, exact at any order of the atomics.
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
//   - no spike list in device memory. Where a spike's targets come from
//     is the instance's SRC:
//       SRC 0, the rows of conn (num, n_conn): each warp, right after the
//       update, adds the targets of its own spiking neurons (a ballot,
//       then its lanes walk one row at a time; einet_scatter.cuh, shared
//       with K22) into this step's counts. The design of K1 + K2 in one
//       grid (append to a list, barrier, a warp an event over the list,
//       barrier) took 1.5-1.7 us a step more at 4k and 3.1-3.3 at 400k on
//       an H100 (PERF.md, section 6);
//       SRC 1 and 2, the rows of the (num, num) count table, uint8 or
//       int32 (dense_count_table): a row is num entries (4 KB at 4k, 40 KB
//       at 40k), not 80, so a warp alone would walk it in ~80 dependent
//       rounds of 16-byte loads at 40k. Instead each warp appends its
//       spikes to a list, and the list's rows are walked by many threads
//       together: item q of the n_spk x n_vec items is 16-byte piece
//       q % n_vec of row q / n_vec, U pieces in flight a thread, and every
//       non-zero entry m at column c adds m to counts[ch][c]. The pieces
//       are 16 bytes where the row length num * itemsize and the table's
//       address are multiples of 16, else 4 (uint8) or one entry. Bytes a
//       step: the spikes' rows, from L2 at 4k (a 16 MB table), from HBM
//       at 40k (1.6 GB). Two walks, chosen by the caller by the bytes of
//       a row (networks.table_grid_walk: by block up to 8 KB):
//         block walk: the list is the block's, in shared memory, and
//         after one __syncthreads the block walks its own rows; no second
//         barrier, but a block with several spiking rows walks them alone;
//         grid walk: the list is the grid's, in device memory, and after
//         a grid barrier every thread of the grid takes its share of all
//         the rows; a second barrier a step, and every SM's loads in
//         flight.
// Loads of the counts, which other blocks wrote in this launch, bypass L1
// (__ldcg); conn, the table and times, which nothing writes, go through
// the read-only path.
//
// Over conn rows, a network that one thread-block cluster holds (~11k
// neurons of 80 targets on an H100) runs the cluster instance below
// instead: the counts and the rows in shared memory, the cluster's
// barrier in place of the grid's.
#include <cooperative_groups.h>

#include <cstring>
#include <type_traits>

#include "einet_neuron.cuh"
#include "einet_scatter.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int BE_SIM_BLOCK = 256;

__device__ __forceinline__ bool be_nonzero(const uint4& b) {
    return (b.x | b.y | b.z | b.w) != 0;
}
template <typename V>
__device__ __forceinline__ bool be_nonzero(const V& b) {
    return b != 0;
}

// Add the entries of one piece b of a table row (sizeof(V) / sizeof(T)
// entries of type T, the first at column dst's) to the counts.
template <typename T, typename V>
__device__ __forceinline__ void be_add_piece(const V& b, int* dst) {
    constexpr int E = sizeof(V) / sizeof(T);
    if (!be_nonzero(b)) return;
    T e[E];
    memcpy(e, &b, sizeof(V));
#pragma unroll
    for (int q = 0; q < E; ++q)
        if (e[q]) atomicAdd(dst + q, static_cast<int>(e[q]));
}

// The n_spk rows ids[0..n_spk) of the (num, num) table, walked by the
// threads tid, tid + stride, ... in pieces of type V, U pieces in flight a
// thread, into add_ct (2, num). kGrid: ids lie in device memory, written
// by other blocks in this launch (loaded past L1), else in shared memory.
// The rows go in batches whose item index q < 2^30 + n_vec fits 32 bits.
template <typename T, typename V, int U, bool kGrid>
__device__ __forceinline__ void be_table_walk(const T* __restrict__ table,
                                              const int* ids,
                                              const unsigned n_spk,
                                              const int num, const int n_exc,
                                              int* add_ct, const unsigned tid,
                                              const unsigned stride) {
    constexpr unsigned E = sizeof(V) / sizeof(T);
    const unsigned n_vec = static_cast<unsigned>(num) / E;
    const unsigned batch = max(1u, (1u << 30) / n_vec);
    for (unsigned s0 = 0; s0 < n_spk; s0 += batch) {
        const unsigned total = min(batch, n_spk - s0) * n_vec;
        for (unsigned q0 = tid; q0 < total; q0 += stride * U) {
            V buf[U];
            int row[U];
            unsigned col[U];
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const unsigned q = q0 + u * stride;
                row[u] = -1;
                col[u] = 0;
                buf[u] = V{};
                if (q < total) {
                    const unsigned s = q / n_vec;
                    col[u] = q - s * n_vec;
                    row[u] = kGrid ? __ldcg(ids + s0 + s) : ids[s0 + s];
                    buf[u] = __ldg(reinterpret_cast<const V*>(
                                       table + static_cast<long long>(row[u]) *
                                                   num) +
                                   col[u]);
                }
            }
#pragma unroll
            for (int u = 0; u < U; ++u)
                if (row[u] >= 0)
                    be_add_piece<T>(buf[u],
                                    add_ct + (row[u] >= n_exc ? num : 0) +
                                        col[u] * E);
        }
    }
}

// be_table_walk in the widest piece the launch allows (vec bytes).
template <typename T, int U, bool kGrid>
__device__ __forceinline__ void be_table_walk_vec(
    const T* __restrict__ table, const int* ids, const unsigned n_spk,
    const int num, const int n_exc, int* add_ct, const unsigned tid,
    const unsigned stride, const int vec) {
    if (vec == 16)
        be_table_walk<T, uint4, U, kGrid>(table, ids, n_spk, num, n_exc,
                                          add_ct, tid, stride);
    else if (sizeof(T) == 1 && vec == 4)
        be_table_walk<T, unsigned, U, kGrid>(table, ids, n_spk, num, n_exc,
                                             add_ct, tid, stride);
    else
        be_table_walk<T, T, U, kGrid>(table, ids, n_spk, num, n_exc, add_ct,
                                      tid, stride);
}

// Append the warp's spikes of one ballot (mask; lane's neuron i) to the
// list ids behind the counter *n: one atomicAdd a warp.
__device__ __forceinline__ void be_append(const unsigned mask, const int i,
                                          const bool spike, const int lane,
                                          unsigned* n, int* ids) {
    if (!mask) return;
    const int leader = __ffs(mask) - 1;
    unsigned base = 0;
    if (lane == leader) base = atomicAdd(n, static_cast<unsigned>(__popc(mask)));
    base = __shfl_sync(0xffffffffu, base, leader);
    if (spike) ids[base + __popc(mask & ((1u << lane) - 1u))] = i;
}

// NPT = 8 is held to three blocks an SM (78 registers a thread on an
// H100, no spills): at its free allocation (95) it ran two, and so held
// no more neurons than NPT = 4. So are the table instances of NPT 2 and
// 4, which at two blocks an SM held fewer neurons than the largest table
// that fits an 80 GB card (be_sim_max_npt). SRC: 0 conn rows, 1 a uint8
// table, 2 an int32 table; vec: the bytes of a table piece (16, 4 or the entry's);
// grid_walk: the table instances' walk by the whole grid, over a list
// (2, num) by parity in device memory with its two counters behind it
// (lists), a second barrier a step, in place of each block's walk of its
// own spikes.
template <int NPT, int SRC>
__global__ void __launch_bounds__(BE_SIM_BLOCK,
                                  NPT == 8 || (SRC && NPT > 1) ? 3 : 1)
einet_sim_kernel(float* __restrict__ v, float* __restrict__ t_last,
                 float* __restrict__ g_e, float* __restrict__ g_i,
                 int* __restrict__ spike_count,
                 const void* __restrict__ targets,
                 const float* __restrict__ times, const int n_steps,
                 const int n_conn, const int n_exc, int* counts,
                 int* lists, const int vec, const int grid_walk,
                 const EINetParams p) {
    using T = typename std::conditional<SRC == 2, int, unsigned char>::type;
    constexpr int U = NPT >= 4 ? 4 : 8;
    // the block's spiking neurons of a step (table instances)
    __shared__ int s_ids[SRC ? BE_SIM_BLOCK * NPT : 1];
    __shared__ unsigned s_n[2];
    cg::grid_group grid = cg::this_grid();
    const int num = p.num;
    const int n_threads = gridDim.x * blockDim.x;
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    const int lane = threadIdx.x & 31;
    const long long plane = 2LL * num;
    if constexpr (SRC != 0) {
        if (threadIdx.x < 2) s_n[threadIdx.x] = 0;
        __syncthreads();
    }

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
        // The other parity's list length was read by step k - 1's walk,
        // which every thread finished before the barrier.
        int* list = lists + parity * num;
        unsigned* n_list = reinterpret_cast<unsigned*>(lists + plane);
        if (SRC != 0 && threadIdx.x == 0) {
            if (grid_walk) {
                if (blockIdx.x == 0) n_list[parity ^ 1] = 0;
            } else {
                s_n[parity ^ 1] = 0;
            }
        }
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
            const unsigned mask = __ballot_sync(0xffffffffu, spike);
            const int first = j - lane + s * n_threads;
            if constexpr (SRC == 0) {
                be_scatter_spikes<false>(mask, first,
                                         static_cast<const int*>(targets),
                                         n_conn, 0, n_exc, num, num, add_ct,
                                         lane);
            } else if (grid_walk) {
                be_append(mask, i, spike, lane, n_list + parity, list);
            } else {
                be_append(mask, i, spike, lane, &s_n[parity], s_ids);
            }
        }
        if constexpr (SRC != 0) {
            const T* table = static_cast<const T*>(targets);
            if (grid_walk) {
                grid.sync();
                be_table_walk_vec<T, U, true>(
                    table, list, __ldcg(n_list + parity), num, n_exc, add_ct,
                    j, n_threads, vec);
            } else {
                __syncthreads();
                be_table_walk_vec<T, U, false>(table, s_ids, s_n[parity],
                                               num, n_exc, add_ct,
                                               threadIdx.x, BE_SIM_BLOCK, vec);
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

// -- the cluster instance ----------------------------------------------------
//
// K21 over conn rows for a network that one thread-block cluster holds
// whole (networks.einet_sim_cluster: C = 1-16 blocks, a power of two, the
// fewest whose share of the neurons, their counts and their conn rows fit
// a block's shared memory; 8 blocks of 500 neurons at Brette's 4,000 with
// 80 targets). The grid is that one cluster (cudaLaunchKernelEx with a
// cluster dimension, not a cooperative launch), so a step's exchange and
// its barrier stay on chip. At 4k the grid instance's step was half its
// grid barrier (1.11 of 2.13-2.15 us) and half a chain of dependent L2
// trips: the two counts past L1, then a spiking warp's conn row, then 80
// L2 atomics that the next barrier's fence drains. Here:
//   - block b owns neurons [b * share, (b + 1) * share) and holds their
//     int32 hit counts, (2 parities, 2 classes, share), in its shared
//     memory; a spike's target t is added into block t / share's counts
//     with a distributed shared memory (DSMEM) atomic, and the fold reads
//     and zeroes the block's own counts;
//   - before step 0 each block stages its own rows of conn (share x
//     n_conn) in shared memory, each target as its owner block and slot
//     (-1 outside [0, num): dropped, as K2 drops it), so a spiking warp
//     reads its row from its own SM;
//   - one cluster.sync() a step in place of grid.sync(): its release and
//     acquire over the cluster's shared memory order the adds and the
//     fold, with the grid instance's parity double buffering. The barrier
//     that ends the last step (the one after the staging, at n_steps = 0)
//     is also the last DSMEM access's: no block leaves while a peer may
//     still add into its counts.
// The grid instance keeps its counts in device memory (no DSMEM spans the
// 391 blocks of 400k); the two share einet_neuron.cuh's fold and update.

// The most blocks of a cluster (non-portable above 8 on an H100) and the
// most threads of its block.
constexpr int BE_CLUSTER_MAX = 16;
constexpr int BE_CLUSTER_THREADS = 1024;

// A staged target: its owner block (rank) and its slot in that block's
// counts; share <= BE_CLUSTER_THREADS * 4 < 2^16.
__device__ __forceinline__ int be_cluster_slot(const unsigned t,
                                               const int share) {
    const unsigned rank = t / static_cast<unsigned>(share);
    return static_cast<int>((rank << 16) | (t - rank * share));
}

// The warp's spikes of one ballot, in the cluster instance: bit b of mask
// is the spike of the block's neuron first + b (global id gbase + first +
// b), whose staged row of n_conn targets lies at rows + (first + b) *
// n_conn. Each target adds 1 to the count of the spike's class at its
// slot in its owner block's add_ct (the same offset in every block): a
// DSMEM atomic.
__device__ __forceinline__ void be_cluster_scatter(
    unsigned mask, const int first, const int* rows, const int n_conn,
    const int gbase, const int n_exc, int* add_ct, const int share,
    const int lane) {
    while (mask) {
        const int li = first + __ffs(mask) - 1;
        mask &= mask - 1;
        const int* row = rows + li * n_conn;
        int* dst = add_ct + (gbase + li >= n_exc ? share : 0);
        for (int c = lane; c < n_conn; c += 32) {
            const int e = row[c];
            if (e < 0) continue;
            atomicAdd(cg::cluster_group::map_shared_rank(dst + (e & 0xffff),
                                                         e >> 16),
                      1);
        }
    }
}

// v ... spike_count, conn, times, n_steps, n_conn, n_exc as the grid
// instance's; share: the neurons a block owns (the last block may own
// fewer, or none). Thread x keeps the block's neurons x, x + blockDim.x,
// ... (NPT of them) in registers. Dynamic shared memory: 4 * share counts,
// then share * n_conn staged targets.
template <int NPT>
__global__ void __launch_bounds__(BE_CLUSTER_THREADS, 1)
einet_sim_cluster_kernel(float* __restrict__ v, float* __restrict__ t_last,
                         float* __restrict__ g_e, float* __restrict__ g_i,
                         int* __restrict__ spike_count,
                         const int* __restrict__ conn,
                         const float* __restrict__ times, const int n_steps,
                         const int n_conn, const int n_exc, const int share,
                         const EINetParams p) {
    extern __shared__ int s_mem[];
    int* s_ct = s_mem;                // (2, 2, share)
    int* s_rows = s_mem + 4 * share;  // (share, n_conn)
    const int num = p.num;
    const int nt = blockDim.x;
    const int base = blockIdx.x * share;  // one cluster is the grid
    const int own = max(0, min(share, num - base));
    const int lane = threadIdx.x & 31;

    for (int q = threadIdx.x; q < 4 * share; q += nt) s_ct[q] = 0;
    const int* rows = conn + static_cast<long long>(base) * n_conn;
    for (int q = threadIdx.x; q < own * n_conn; q += nt) {
        const unsigned t = static_cast<unsigned>(__ldg(rows + q));
        s_rows[q] = t < static_cast<unsigned>(num) ? be_cluster_slot(t, share)
                                                   : -1;
    }
    float rv[NPT], rt[NPT], re[NPT], ri[NPT];
    int rc[NPT];
#pragma unroll
    for (int s = 0; s < NPT; ++s) {
        const int li = threadIdx.x + s * nt;
        const int i = base + li;
        const bool mine = li < own;
        rv[s] = mine ? v[i] : 0.0f;
        rt[s] = mine ? t_last[i] : 0.0f;
        re[s] = mine ? g_e[i] : 0.0f;
        ri[s] = mine ? g_i[i] : 0.0f;
        rc[s] = mine ? spike_count[i] : 0;
    }
    // every block's counts zeroed before any peer adds into them
    cg::cluster_group::sync();

    for (int k = 0; k < n_steps; ++k) {
        const float t = __ldg(times + k);
        const int parity = k & 1;
        int* fold_ct = s_ct + (parity ^ 1) * 2 * share;
        int* add_ct = s_ct + parity * 2 * share;
#pragma unroll
        for (int s = 0; s < NPT; ++s) {
            const int li = threadIdx.x + s * nt;
            bool spike = false;
            if (li < own) {
                if (k > 0) {
                    const int ce = fold_ct[li];
                    const int ci = fold_ct[share + li];
                    be_einet_fold(re[s], ri[s], ce, ci, p);
                    // zeroed for step k + 1, which adds into this buffer
                    // after the barrier
                    if (ce) fold_ct[li] = 0;
                    if (ci) fold_ct[share + li] = 0;
                }
                spike = be_einet_update(rv[s], rt[s], re[s], ri[s], p, t);
                rc[s] += spike;
            }
            // Every thread reaches the ballot: no early return.
            const unsigned mask = __ballot_sync(0xffffffffu, spike);
            be_cluster_scatter(mask, li - lane, s_rows, n_conn, base, n_exc,
                               add_ct, share, lane);
        }
        cg::cluster_group::sync();
    }

    // The last step's counts, folded (the K1 + K2 loop's final fold).
    const int* last_ct = s_ct + ((n_steps - 1) & 1) * 2 * share;
#pragma unroll
    for (int s = 0; s < NPT; ++s) {
        const int li = threadIdx.x + s * nt;
        if (li >= own) continue;
        const int i = base + li;
        if (n_steps > 0)
            be_einet_fold(re[s], ri[s], last_ct[li], last_ct[share + li], p);
        v[i] = rv[s];
        t_last[i] = rt[s];
        g_e[i] = re[s];
        g_i[i] = ri[s];
        spike_count[i] = rc[s];
    }
}

// The cluster's barrier alone: n_syncs cluster barriers, nothing else; its
// time is the floor under the cluster instance's.
__global__ void __launch_bounds__(BE_CLUSTER_THREADS, 1)
einet_sim_cluster_barriers_kernel(const int n_syncs) {
    for (int k = 0; k < n_syncs; ++k) cg::cluster_group::sync();
}

// The cluster instances built (networks.SIM_CLUSTER_NPT): NPT 4 holds the
// 4,096 neurons of a block's 1,024 threads, more than a block's shared
// memory holds at 11 targets a neuron or more.
const void* be_cluster_kernel(int npt) {
    switch (npt) {
        case 1: return reinterpret_cast<const void*>(einet_sim_cluster_kernel<1>);
        case 2: return reinterpret_cast<const void*>(einet_sim_cluster_kernel<2>);
        case 4: return reinterpret_cast<const void*>(einet_sim_cluster_kernel<4>);
        default: return nullptr;
    }
}

// Let kernel take smem bytes of dynamic shared memory and clusters above
// the portable 8 blocks.
int be_cluster_attributes(const void* kernel, int smem) {
    int err = static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
    if (err) return err;
    return static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1));
}

// A launch of blocks x threads, smem bytes of dynamic shared memory, as
// one cluster of all the blocks.
struct BeClusterLaunch {
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    BeClusterLaunch(int blocks, int threads, int smem, void* stream) {
        cfg.gridDim = dim3(blocks);
        cfg.blockDim = dim3(threads);
        cfg.dynamicSmemBytes = static_cast<size_t>(smem);
        cfg.stream = static_cast<cudaStream_t>(stream);
        attr[0].id = cudaLaunchAttributeClusterDimension;
        attr[0].val.clusterDim.x = blocks;
        attr[0].val.clusterDim.y = 1;
        attr[0].val.clusterDim.z = 1;
        cfg.attrs = attr;
        cfg.numAttrs = 1;
    }
};

// The largest NPT built for each source. Held to three blocks an SM, a
// table instance of NPT 4 holds ~405k neurons on an H100, more than the
// ~292k of the largest uint8 table an 80 GB card holds, and NPT 2 ~203k,
// more than the ~146k of the largest int32 one; larger instances would
// only lengthen the build (networks.SIM_SOURCE_NPT).
template <int SRC>
constexpr int be_sim_max_npt = SRC == 0 ? 8 : (SRC == 1 ? 4 : 2);

template <int NPT, int SRC>
const void* be_sim_instance() {
    if constexpr (NPT <= be_sim_max_npt<SRC>)
        return reinterpret_cast<const void*>(einet_sim_kernel<NPT, SRC>);
    else
        return nullptr;
}

template <int SRC>
const void* be_sim_kernel_of(int npt) {
    switch (npt) {
        case 1: return be_sim_instance<1, SRC>();
        case 2: return be_sim_instance<2, SRC>();
        case 4: return be_sim_instance<4, SRC>();
        case 8: return be_sim_instance<8, SRC>();
        default: return nullptr;
    }
}

// The kernel of the instance (npt 1, 2, 4 or 8 over conn, src 0; up to 4
// over a uint8 table, src 1; up to 2 over an int32 one, src 2), or
// nullptr.
const void* be_sim_kernel(int npt, int src) {
    switch (src) {
        case 0: return be_sim_kernel_of<0>(npt);
        case 1: return be_sim_kernel_of<1>(npt);
        case 2: return be_sim_kernel_of<2>(npt);
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

// Blocks of BE_SIM_BLOCK threads of the instance (npt, src) that can be
// co-resident on the device: the largest grid a cooperative launch takes.
BE_EXPORT int einet_sim_max_blocks(int npt, int src, int device,
                                   int* blocks) {
    int err = be_begin(device);
    if (err) return err;
    const void* kernel = be_sim_kernel(npt, src);
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
// at the start and written at the end; targets: conn (num, n_conn) int32
// (src 0), or the (num, num) count table, uint8 (src 1) or int32 (src 2),
// read in pieces of vec bytes (16, 4 or the entry's; the row length in
// bytes and the table's address are multiples of it), by each block's
// threads (grid_walk 0) or by the whole grid over lists: 2 * num + 2 int32,
// the last two zeroed by the caller (grid_walk 1); times: (n_steps,)
// float32; counts: (2, 2, num) int32, zeroed by the caller. blocks *
// BE_SIM_BLOCK * npt must cover num; a grid larger than can be co-resident
// is refused (cudaErrorCooperativeLaunchTooLarge).
BE_EXPORT int einet_sim_launch(float* v, float* t_last, float* g_e,
                               float* g_i, int* spike_count,
                               const void* targets, const float* times,
                               int n_steps, int n_conn, int n_exc,
                               int* counts, const EINetParams* p, int npt,
                               int blocks, int src, int vec, int* lists,
                               int grid_walk, int device, void* stream) {
    int err = be_begin(device);
    if (err) return err;
    if (p->num <= 0) return be_end();
    if (blocks <= 0 ||
        static_cast<long long>(blocks) * BE_SIM_BLOCK * npt < p->num)
        return static_cast<int>(cudaErrorInvalidValue);
    const int item = src == 2 ? 4 : 1;
    if (src && (vec < item || vec % item ||
                (static_cast<long long>(p->num) * item) % vec ||
                reinterpret_cast<unsigned long long>(targets) % vec ||
                (grid_walk && !lists)))
        return static_cast<int>(cudaErrorInvalidValue);
    const void* kernel = be_sim_kernel(npt, src);
    if (!kernel) return static_cast<int>(cudaErrorInvalidValue);
    EINetParams params = *p;
    grid_walk = src && grid_walk;
    void* args[] = {&v,      &t_last,  &g_e,       &g_i,    &spike_count,
                    &targets, &times,  &n_steps,   &n_conn, &n_exc,
                    &counts, &lists,  &vec,       &grid_walk, &params};
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

// The largest cluster (a power of two up to BE_CLUSTER_MAX; 0: none) in
// which every cluster instance runs at its largest block, BE_CLUSTER_THREADS
// threads with all the shared memory a block may take (*smem bytes, the
// device's opt-in limit): cudaOccupancyMaxPotentialClusterSize, confirmed
// by cudaOccupancyMaxActiveClusters >= 1. A smaller block fits wherever
// that one does.
BE_EXPORT int einet_sim_cluster_limits(int device, int* most, int* smem) {
    int err = be_begin(device);
    if (err) return err;
    int optin = 0;
    err = static_cast<int>(cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
    if (err) return err;
    int best = BE_CLUSTER_MAX;
    for (int npt : {1, 2, 4}) {
        const void* kernel = be_cluster_kernel(npt);
        err = be_cluster_attributes(kernel, optin);
        if (err) return be_refused(err);
        BeClusterLaunch launch(BE_CLUSTER_MAX, BE_CLUSTER_THREADS, optin,
                               nullptr);
        int size = 0;
        err = static_cast<int>(
            cudaOccupancyMaxPotentialClusterSize(&size, kernel, &launch.cfg));
        if (err) return be_refused(err);
        int c = 0;
        while (c < best && (c ? 2 * c : 1) <= size) c = c ? 2 * c : 1;
        for (; c > 0; c /= 2) {
            BeClusterLaunch at(c, BE_CLUSTER_THREADS, optin, nullptr);
            int active = 0;
            err = static_cast<int>(
                cudaOccupancyMaxActiveClusters(&active, kernel, &at.cfg));
            if (err) return be_refused(err);
            if (active >= 1) break;
        }
        best = c;
    }
    *most = best;
    *smem = optin;
    return be_end();
}

// The cluster instance npt (1, 2 or 4) over conn on one cluster of blocks
// blocks (1-16, a power of two), block b owning neurons [b * share, (b +
// 1) * share); the state, conn, times, n_steps, n_conn and n_exc as
// einet_sim_launch's, no counts (they live in shared memory). Its blocks
// take the fewest warps that hold share neurons at npt each, and share *
// (n_conn + 4) * 4 bytes of shared memory; a cluster the device cannot
// schedule is refused and reported.
BE_EXPORT int einet_sim_cluster_launch(float* v, float* t_last, float* g_e,
                                       float* g_i, int* spike_count,
                                       const int* conn, const float* times,
                                       int n_steps, int n_conn, int n_exc,
                                       const EINetParams* p, int npt,
                                       int blocks, int share, int device,
                                       void* stream) {
    int err = be_begin(device);
    if (err) return err;
    if (p->num <= 0) return be_end();
    const void* kernel = be_cluster_kernel(npt);
    const int threads = (share + npt - 1) / npt;
    const long long smem = 4LL * share * (n_conn + 4LL);
    if (!kernel || blocks < 1 || blocks > BE_CLUSTER_MAX ||
        (blocks & (blocks - 1)) || share < 1 || n_conn < 0 ||
        static_cast<long long>(blocks) * share < p->num ||
        threads > BE_CLUSTER_THREADS || smem > (1 << 30))
        return static_cast<int>(cudaErrorInvalidValue);
    err = be_cluster_attributes(kernel, static_cast<int>(smem));
    if (err) return be_refused(err);
    EINetParams params = *p;
    void* args[] = {&v,       &t_last, &g_e,    &g_i,    &spike_count,
                    &conn,    &times,  &n_steps, &n_conn, &n_exc,
                    &share,   &params};
    BeClusterLaunch launch(blocks, (threads + 31) / 32 * 32,
                           static_cast<int>(smem), stream);
    return be_refused(
        static_cast<int>(cudaLaunchKernelExC(&launch.cfg, kernel, args)));
}

// n_syncs cluster barriers on one cluster of blocks x threads, each block
// holding smem bytes of dynamic shared memory (the cluster instance's, so
// that its blocks spread over as many SMs).
BE_EXPORT int einet_sim_cluster_barriers_launch(int n_syncs, int blocks,
                                                int threads, int smem,
                                                int device, void* stream) {
    int err = be_begin(device);
    if (err) return err;
    const void* kernel =
        reinterpret_cast<const void*>(einet_sim_cluster_barriers_kernel);
    err = be_cluster_attributes(kernel, smem);
    if (err) return be_refused(err);
    void* args[] = {&n_syncs};
    BeClusterLaunch launch(blocks, threads, smem, stream);
    return be_refused(
        static_cast<int>(cudaLaunchKernelExC(&launch.cfg, kernel, args)));
}
