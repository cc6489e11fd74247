// Copyright 2026 The brainevent-tpu Authors.
// Licensed under the Apache License, Version 2.0.
//
// K24 `stdp_sim`: a whole trial of NEST's HPC benchmark network with
// power-law STDP (Morrison, Aertsen & Diesmann 2007; models/hpc_stdp.py),
// n steps, in one launch. No TPU kernel precedes it: the JAX package has no
// network whose synapses change while it runs.
//
// The network: NE excitatory and NI inhibitory iaf_psc_alpha neurons (one
// current channel), every synapse of one delay d (steps), in two CSRs by
// source over one targets array: the plastic E->E synapses first
// (positions [0, P), rows plastic_ptr, float32 weights in pA), then the
// static ones (positions [P, P + S), rows static_ptr: E->I of w_e units,
// then I->E and I->I of w_i units).
//
// Step t, neuron i (V relative to E_L), in NEST's order, every product and
// sum rounded once (__fmul_rn, __fadd_rn: the same bits as the plain loop,
// whatever the compiler contracts):
//   s = ring[t mod D][i] + w_ext * poisson;  ring[t mod D][i] = 0
//   if ref == 0: V = ((P31 dI + P32 I) + em1 V) + V  else ref -= 1
//   I = P21 dI + P11 I;  dI = P11 dI + pa float(s)
//   E: K+ = kp_decay K+, K- = km_decay K-, khist[t mod D] = K-
//   if V >= v_th: V = v_reset, ref = ref_steps, count += 1
// then, for the E->E synapses, as NEST's stdp_pl_synapse_hom::send() makes
// them, at the spikes of their source: each i that spikes at t, each
// i -> j, in turn
//   1. each spike of j at a step s with t_lw < s + d <= t, oldest first
//      (t_lw: the step of i's walk before, or the launch's step before its
//      first):  w = w + (lam w^mu) K+_i(s + d), where K+_i(u) is
//      kp_decay times K+_i after step u - 1: i's K+ in step u before i's
//      spike in u;
//   2. w = max(w - (lam_alpha w) khist[(t - d) mod D][j], 0), and every
//      synapse of a spike at t adds its units (a plastic one rint(w
//      units)) to ring[(t + d) mod D][j];
//   3. the spikes of t add 1 to their K+ and K-.
// A synapse i -> j is written by nothing else between two spikes of i, and
// K+_i only decays there, so 1 makes the facilitations that the eager rule
// (stdp_loop: each in step s + d, before that step's depressions) makes in
// (t_lw, t], in its order and on its operands: the same bits. After its
// last step the launch makes the facilitations still owed (t_lw < s + d <=
// its last step) in one pass over every E row (the flush), so the state it
// leaves is the eager one and launches chain on it.
//
// A step is two phases between grid barriers. Phase A: each thread's
// neurons' update; an E neuron's thread writes its K+_i(t) into the
// launch's K+ history (kph, in tiles of STDP_HTILE steps), and at a spike
// appends the step to the neuron's spike list (spikes, cap a neuron,
// seeded at the launch's start with its spikes of the d steps before, from
// `spiked`) and to its record (recent: the count and the STDP_RECENT
// newest steps, 64 bytes, 5.8 MB at scale 10, in L2: its first int4
// settles whether a synapse owes anything, and the list is read only for
// a synapse that owes more than the record holds), and appends its rows to
// the step's list with its t_lw. Phase B: the walk (1 and 2) as a grid
// pass over the list of step t's spiking rows. Within a phase a weight is
// written by one thread at most (a neuron spikes once a step), and no
// weight is written with atomics. Steps are counted from the launch's
// first, 0; the history and the lists hold such steps.
//
// What bounds it: a synapse's facilitations are a chain (each reads the
// weight the one before wrote), as long as its target spiked since its
// source's last spike, so an entry costs from nothing to dozens of powf.
// The walk and the flush therefore share their entries among the blocks in
// ranges that each block takes from a counter as it finishes the one
// before (stdp_pass): a slow range delays only its own block. Split
// evenly, each chunk's entries left a step at its slowest block's time,
// about twice the blocks' mean (an H100 at scale 10).
//
// The shape is K23's (sim_grid.cuh): a persistent cooperative grid of
// blocks of SG_BLOCK threads; thread g owns neurons g and g + G (G the
// grid's threads) and keeps their state in registers for the whole trial.
#include "common.cuh"
#include "sim_grid.cuh"

// The scalars of one network and trial; the same layout as StdpParams in
// brainevent_torch/models/hpc_stdp.py (ctypes). The floats are rounded to
// float32 on the host.
struct StdpParams {
    float p11;         // float32(exp(-h / tau_syn)): P11 = P22
    float p21;         // float32(h exp(-h / tau_syn))
    float em1;         // float32(expm1(-h / tau_m))
    float p31;         // NEST's propagator_31, float32
    float p32;         // NEST's propagator_32, float32
    float pa;          // float32(e / tau_syn * q): dI's jump of one unit
    float v_th;        // threshold, relative to E_L
    float v_reset;     // reset, relative to E_L
    float kp_decay;    // float32(exp(-h / tau_plus))
    float km_decay;    // float32(exp(-h / tau_minus))
    float lam;         // lambda
    float lam_alpha;   // float32(lambda alpha)
    float mu;          // the facilitation's exponent
    float units;       // float32(weight_units / JE_pA): units of a pA
    int num;           // neurons
    int n_exc;         // excitatory neurons, the first n_exc
    int n_plastic;     // P: positions below it are plastic
    int static_e_end;  // static positions below it have an E source
    int depth;         // D: the ring's and the histories' slots
    int delay;         // d, 1 <= d < D
    int ref_steps;     // refractory steps
    int w_ext;         // units of a Poisson event
    int w_e;           // units of a static E synapse
    int w_i;           // units of an I synapse
    unsigned key;      // the Poisson stream of this state
    unsigned step0;    // the trial's first step, modulo 2^32
    unsigned thr[SG_KMAX];
};

namespace {

// Neurons a thread of K24 owns at most.
constexpr int STDP_NPT = 2;
// Steps of a tile of the K+ history: a neuron's K+ of STDP_HTILE steps in
// one 32-byte sector, so that the steps a row's entries look up share
// sectors (HPC_HTILE in models/hpc_stdp.py).
constexpr int STDP_HTILE = 8;
// The newest spike steps of an E neuron's record (four int4s with its
// count): its list is read only for a synapse that owes more.
constexpr int STDP_RECENT = 15;
// Entries of a range that a block of the walk and of the flush takes at a
// time (stdp_pass).
constexpr int STDP_WALK_GRAB = SG_BLOCK;
constexpr int STDP_FLUSH_GRAB = 2 * SG_BLOCK;
// The step of a record's empty slot: s + d is past no walk.
constexpr int STDP_NONE = -(1 << 30);

// w^mu, the one transcendental function of the step (full-accuracy powf).
__device__ __forceinline__ float stdp_pow(const float w, const float mu) {
    return powf(w, mu);
}

// The position of K+_i(u) in the history: tiles of STDP_HTILE steps of
// every E neuron (u >= 0, a step of the launch).
__device__ __forceinline__ long long stdp_hidx(const int u, const int i,
                                               const int ne) {
    const unsigned x = static_cast<unsigned>(u);
    return (static_cast<long long>(x / STDP_HTILE) * ne + i) * STDP_HTILE +
           x % STDP_HTILE;
}

// One facilitation: w + (lam w^mu) kp.
__device__ __forceinline__ float stdp_fac(const float w, const float kp,
                                          const StdpParams& p) {
    return __fadd_rn(w, __fmul_rn(__fmul_rn(p.lam, stdp_pow(w, p.mu)), kp));
}

// The facilitations among j's spike steps s0..s3 (oldest first) that
// i -> j owes by step tr, its row walked last at step lw (lw < s + d <=
// tr): each K+_i(s + d) read from the history first, then applied in
// turn. *n counts them.
__device__ __forceinline__ float stdp_four(
    float w, const int s0, const int s1, const int s2, const int s3,
    const int i, const int lw, const int tr, const float* kph,
    const StdpParams& p, int* n) {
    const int d = p.delay;
    const int u[4] = {s0 + d, s1 + d, s2 + d, s3 + d};
    float k[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
        k[q] = u[q] > lw && u[q] <= tr
                   ? __ldcg(kph + stdp_hidx(u[q], i, p.n_exc))
                   : 0.0f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        if (u[q] > lw && u[q] <= tr) {
            w = stdp_fac(w, k[q], p);
            ++*n;
        }
    }
    return w;
}

// The facilitations i -> j owes by step tr for the spikes of j's list
// [.., end) (all older than its record's): from the first owed, four at a
// time. A row not walked yet in the launch (lw < 0) owes every one.
__device__ __forceinline__ float stdp_list(
    float w, const int* list, const int end, const int i, const int lw,
    const int tr, const float* kph, const StdpParams& p, int* n) {
    const int d = p.delay;
    int k = 0;
    if (lw >= 0) {
        k = end - 1;
        while (k >= 0 && __ldcg(list + k) + d > lw) --k;
        ++k;
    }
    for (; k < end; k += 4) {
        int s[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
            s[q] = k + q < end ? __ldcg(list + k + q) : STDP_NONE;
        w = stdp_four(w, s[0], s[1], s[2], s[3], i, lw, tr, kph, p, n);
    }
    return w;
}

// The facilitations that i -> j owes by step tr, its row walked last at
// step lw: one for each spike of j at a step s with lw < s + d <= tr,
// oldest first, with K+_i(s + d) from the history. j's record is four
// int4s (rec): its count and its STDP_RECENT newest steps, newest first,
// STDP_NONE past the count; a (its first, loaded by the caller) settles
// the common case. The record's further int4s are read only where the last
// of the one before is owed, and j's list where the oldest of the record
// is owed and j has spiked more.
__device__ __forceinline__ float stdp_catch_up(
    float w, const int4 a, const int j, const int i, const int lw,
    const int tr, const int4* rec, const int* spikes, const int cap,
    const float* kph, const StdpParams& p, int* n) {
    const int d = p.delay;
    if (a.y + d <= lw) return w;  // no spike since the walk
    const int4* r = rec + 4ll * j;
    // the deepest of the record's int4s with a spike owed
    int q = 0;
    int4 x = a;
    while (q < 3 && x.w + d > lw) x = __ldcg(r + ++q);
    if (q == 3 && x.w + d > lw && a.x > STDP_RECENT)
        w = stdp_list(w, spikes + static_cast<long long>(j) * cap,
                      a.x - STDP_RECENT, i, lw, tr, kph, p, n);
    for (int m = q; m > 0; --m) {
        const int4 y = m == q ? x : __ldcg(r + m);
        w = stdp_four(w, y.w, y.z, y.y, y.x, i, lw, tr, kph, p, n);
    }
    return stdp_four(w, STDP_NONE, a.w, a.z, a.y, i, lw, tr, kph, p, n);
}

// Puts step s first in a record (its count one more), its oldest out.
__device__ __forceinline__ void stdp_push(int4* r, const int s) {
    const int4 a = __ldcg(r), b = __ldcg(r + 1), c = __ldcg(r + 2),
               e = __ldcg(r + 3);
    r[0] = make_int4(a.x + 1, s, a.y, a.z);
    r[1] = make_int4(a.w, b.x, b.y, b.z);
    r[2] = make_int4(b.w, c.x, c.y, c.z);
    r[3] = make_int4(c.w, e.x, e.y, e.z);
}

// Appends a row (beg, end, source, the source's walk before) to a list
// whose counter is *count.
__device__ __forceinline__ void stdp_append(int4* list, int* count,
                                            const int4 row) {
    list[atomicAdd(count, 1)] = row;
}

// Adds the warp's n to *sum (every lane of the warp calls it).
__device__ __forceinline__ void stdp_count(unsigned long long* sum,
                                           const int n) {
    const unsigned total = __reduce_add_sync(0xffffffffu,
                                             static_cast<unsigned>(n));
    if ((threadIdx.x & 31) == 0 && total)
        atomicAdd(sum, static_cast<unsigned long long>(total));
}

// A block's view of a chunk of rows: for sg_find over its entries, each
// row's first entry of the chunk's (off) and first position (beg), its
// source (src) and its walk before (lw).
struct StdpView {
    int off[SG_BLOCK + 1];
    int beg[SG_BLOCK];
    int src[SG_BLOCK];
    int lw[SG_BLOCK];
    int wsum[SG_WARPS];
    int next;  // the block's next range
};

// The block's view of a chunk of m rows, thread j's [beg, end) of source
// src walked last at step lw; returns the chunk's entries.
__device__ __forceinline__ int stdp_view(const int beg, const int end,
                                         const int src, const int lw,
                                         const int m, StdpView& v) {
    const int total = sg_scan(make_int2(beg, end), m, v.off, v.beg, v.wsum);
    // every thread has passed the scan's first barrier: the last chunk's
    // rows are read
    v.src[threadIdx.x] = src;
    v.lw[threadIdx.x] = lw;
    __syncthreads();
    return total;
}

// A grid pass over a chunk's total entries in ranges of grab: each block
// takes the range of its index, then the next from the counter *taken
// (zero before the pass), fetched while it makes the one before, until
// none is left; body(lo, hi) makes a range. The blocks so share the
// chunk's work as it comes, whatever an entry costs: an entry of a row
// whose synapses owe many facilitations costs many times one that owes
// none.
template <typename Body>
__device__ __forceinline__ void stdp_pass(const int total, const int grab,
                                          int* taken, StdpView& v,
                                          const Body& body) {
    const int first = gridDim.x * grab;
    int lo = blockIdx.x * grab;
    while (lo < total) {
        int next = 0;
        if (threadIdx.x == 0) next = first + atomicAdd(taken, grab);
        body(lo, min(lo + grab, total));
        if (threadIdx.x == 0) v.next = next;
        __syncthreads();
        lo = v.next;
        __syncthreads();
    }
}

// The walk of step tr: the list's n rows, in chunks of SG_BLOCK, each over
// the grid (stdp_pass, its counter taken[chunk]). A plastic entry i -> j
// makes the facilitations it owes (stdp_catch_up), then w = max(w -
// (lam_alpha w) K-_j, 0), K- from kh (the history's slot of step t - d);
// then every entry adds its units to its target in the ring's slot late.
// *nfac counts the facilitations.
__device__ __forceinline__ void stdp_walk(
    const int4* list, const int n, int* taken, StdpView& v,
    const int* __restrict__ targets, float* weights, const float* kh,
    int* late, const int4* recent, const int* spikes, const int cap,
    const float* kph, const int tr, int* nfac, const StdpParams& p) {
    const int j = threadIdx.x;
    for (int c0 = 0; c0 < n; c0 += SG_BLOCK) {
        const int m = min(n - c0, SG_BLOCK);
        const int4 row = j < m ? __ldcg(list + c0 + j) : make_int4(0, 0, 0, 0);
        const int total = stdp_view(row.x, row.y, row.z, row.w, m, v);
        stdp_pass(total, STDP_WALK_GRAB, taken + c0 / SG_BLOCK, v,
                  [&](const int lo, const int hi) {
            for (int e = lo + j; e < hi; e += SG_BLOCK) {
                const int r = sg_find(e, m, v.off);
                const int c = v.beg[r] + (e - v.off[r]);
                const int tg = __ldg(targets + c);
                int units;
                if (c < p.n_plastic) {
                    const float w = __ldcg(weights + c);
                    const float km = __ldcg(kh + tg);
                    const float x0 = stdp_catch_up(
                        w, __ldcg(recent + 4ll * tg), tg, v.src[r], v.lw[r],
                        tr, recent, spikes, cap, kph, p, nfac);
                    const float dep = __fmul_rn(__fmul_rn(p.lam_alpha, x0),
                                                km);
                    float x = __fsub_rn(x0, dep);
                    x = x > 0.0f ? x : 0.0f;
                    weights[c] = x;
                    units = __float2int_rn(__fmul_rn(x, p.units));
                } else {
                    units = c < p.static_e_end ? p.w_e : p.w_i;
                }
                atomicAdd(late + tg, units);
            }
        });
    }
}

// The flush: the facilitations that the E rows' entries owe by the
// launch's last step tr (each row's walk last at last_walk), in chunks of
// SG_BLOCK rows, each over the grid as the walk's (its counter
// taken[chunk]). *nfac counts them.
__device__ __forceinline__ void stdp_flush(
    const int* __restrict__ targets, const int* __restrict__ plastic_ptr,
    float* weights, int* taken, StdpView& v, const int4* recent,
    const int* spikes, const int cap, const float* kph,
    const int* last_walk, const int tr, int* nfac, const StdpParams& p) {
    const int j = threadIdx.x, ne = p.n_exc;
    for (int c0 = 0; c0 < ne; c0 += SG_BLOCK) {
        const int m = min(ne - c0, SG_BLOCK), i = c0 + j;
        int beg = 0, end = 0, lw = tr;
        if (j < m) {
            beg = __ldg(plastic_ptr + i);
            lw = __ldcg(last_walk + i);
            // walked in the last step, the row owes nothing
            end = lw < tr ? __ldg(plastic_ptr + i + 1) : beg;
        }
        const int total = stdp_view(beg, end, i, lw, m, v);
        stdp_pass(total, STDP_FLUSH_GRAB, taken + c0 / SG_BLOCK, v,
                  [&](const int lo, const int hi) {
            for (int e = lo + j; e < hi; e += SG_BLOCK) {
                const int r = sg_find(e, m, v.off);
                const int c = v.beg[r] + (e - v.off[r]);
                const int tg = __ldg(targets + c);
                const float w = __ldcg(weights + c);
                const int before = *nfac;
                const float x = stdp_catch_up(
                    w, __ldcg(recent + 4ll * tg), tg, v.src[r], v.lw[r], tr,
                    recent, spikes, cap, kph, p, nfac);
                if (*nfac != before) weights[c] = x;
            }
        });
    }
}

__global__ void __launch_bounds__(SG_BLOCK, 3)
stdp_sim_kernel(float* __restrict__ v, float* __restrict__ i_syn,
                float* __restrict__ di, int* __restrict__ ref, int* ring,
                int* __restrict__ spike_count, float* weights, float* kplus,
                float* khist, unsigned char* spiked,
                const int* __restrict__ targets,
                const int* __restrict__ plastic_ptr,
                const int* __restrict__ static_ptr, int4* dlists, int* counts,
                float* kph, int* spikes, int4* recent, int* last_walk,
                unsigned long long* counters, const int n_steps,
                const int cap, const StdpParams p) {
    __shared__ unsigned s_thr[SG_KMAX];
    // The grid passes' view of a chunk of rows.
    __shared__ StdpView s_view;
    // The block's facilitations: in the walks, in the flush.
    __shared__ unsigned long long s_fac[2];
    if (threadIdx.x < SG_KMAX) s_thr[threadIdx.x] = p.thr[threadIdx.x];
    if (threadIdx.x < 2) s_fac[threadIdx.x] = 0;
    cg::grid_group grid = cg::this_grid();
    const int num = p.num, ne = p.n_exc;
    const unsigned dmask = static_cast<unsigned>(p.depth) - 1u;
    const unsigned d = static_cast<unsigned>(p.delay);
    const int g = blockIdx.x * SG_BLOCK + threadIdx.x;
    const int gsize = gridDim.x * SG_BLOCK;
    const long long dcap = 2ll * num;
    const unsigned t0 = p.step0;
    const unsigned last = (t0 - 1u) & dmask;

    // counts: the rows' lists' counters by parity, then the walks' ranges'
    // counters (by parity, one a chunk of the list), then the flush's
    const int wchunks = (2 * num + SG_BLOCK - 1) / SG_BLOCK;
    int* wtaken = counts + 2;
    int* ftaken = wtaken + 2 * wchunks;
    const int n_counts = 2 + 2 * wchunks + (ne + SG_BLOCK - 1) / SG_BLOCK;
    for (int c = g; c < n_counts; c += gsize) counts[c] = 0;
    if (counters && g < 3) counters[g] = 0;
    float rv[STDP_NPT], ri[STDP_NPT], rd[STDP_NPT], kp[STDP_NPT],
        km[STDP_NPT];
    int rr[STDP_NPT], rc[STDP_NPT], lw[STDP_NPT];
#pragma unroll
    for (int q = 0; q < STDP_NPT; ++q) {
        const int i = g + q * gsize;
        const bool own = i < num, exc = i < ne;
        rv[q] = own ? v[i] : 0.0f;
        ri[q] = own ? i_syn[i] : 0.0f;
        rd[q] = own ? di[i] : 0.0f;
        rr[q] = own ? ref[i] : 0;
        rc[q] = own ? spike_count[i] : 0;
        kp[q] = exc ? kplus[i] : 0.0f;
        lw[q] = -1;
        const long long at = static_cast<long long>(last) * ne + i;
        const float h = exc ? khist[at] : 0.0f;
        km[q] = exc && spiked[at] ? __fadd_rn(h, 1.0f) : h;
        if (!exc) continue;
        // the list and the record of the spikes of the d steps before the
        // launch, oldest first
        int4* r = recent + 4ll * i;
        const int4 none = make_int4(STDP_NONE, STDP_NONE, STDP_NONE, STDP_NONE);
        r[0] = make_int4(0, STDP_NONE, STDP_NONE, STDP_NONE);
        r[1] = r[2] = r[3] = none;
        int count = 0;
        for (int s = p.delay; s >= 1; --s) {
            if (spiked[static_cast<long long>((t0 - s) & dmask) * ne + i]) {
                spikes[static_cast<long long>(i) * cap + count++] = -s;
                stdp_push(r, -s);
            }
        }
    }
    grid.sync();  // the counters are zeroed, the lists seeded

    for (int k = 0; k < n_steps; ++k) {
        const unsigned t = t0 + static_cast<unsigned>(k);
        const unsigned slot = t & dmask;
        const int par = static_cast<int>(t & 1u);
        int4* dlist = dlists + par * dcap;
        int* dcount = counts + par;
        // Phase A: the update of the thread's neurons.
        int* now = sg_slot(ring, t, dmask, num);
        const unsigned h = sg_step_hash(p.key, t);
#pragma unroll
        for (int q = 0; q < STDP_NPT; ++q) {
            const int i = g + q * gsize;
            if (i >= num) continue;
            int in = __ldcg(now + i);
            if (in) now[i] = 0;
            in += sg_poisson(h, i, s_thr) * p.w_ext;
            if (rr[q] == 0)
                rv[q] = __fadd_rn(
                    __fadd_rn(__fadd_rn(__fmul_rn(p.p31, rd[q]),
                                        __fmul_rn(p.p32, ri[q])),
                              __fmul_rn(p.em1, rv[q])),
                    rv[q]);
            else
                rr[q] -= 1;
            ri[q] = __fadd_rn(__fmul_rn(p.p21, rd[q]), __fmul_rn(p.p11, ri[q]));
            rd[q] = __fadd_rn(__fmul_rn(p.p11, rd[q]),
                              __fmul_rn(p.pa, __int2float_rn(in)));
            const bool spike = rv[q] >= p.v_th;
            if (spike) {
                rv[q] = p.v_reset;
                rr[q] = p.ref_steps;
                rc[q] += 1;
            }
            if (i < ne) {
                const long long at = static_cast<long long>(slot) * ne + i;
                kp[q] = __fmul_rn(p.kp_decay, kp[q]);
                kph[stdp_hidx(k, i, ne)] = kp[q];
                if (spike) kp[q] = __fadd_rn(kp[q], 1.0f);
                km[q] = __fmul_rn(p.km_decay, km[q]);
                khist[at] = km[q];
                if (spike) km[q] = __fadd_rn(km[q], 1.0f);
                spiked[at] = spike;
            }
            if (spike) {
                if (i < ne) {
                    const int count = __ldcg(&recent[4ll * i].x);
                    if (count < cap)
                        spikes[static_cast<long long>(i) * cap + count] = k;
                    stdp_push(recent + 4ll * i, k);
                    const int2 pr = make_int2(__ldg(plastic_ptr + i),
                                              __ldg(plastic_ptr + i + 1));
                    if (pr.y > pr.x) {
                        // read by phase B's pass, after the barrier
                        sg_prefetch(targets + pr.x, targets + pr.y);
                        sg_prefetch(weights + pr.x, weights + pr.y);
                        stdp_append(dlist, dcount,
                                    make_int4(pr.x, pr.y, i, lw[q]));
                        if (counters)
                            atomicAdd(counters,
                                      static_cast<unsigned long long>(
                                          pr.y - pr.x));
                    }
                    lw[q] = k;
                }
                const int2 sr = make_int2(__ldg(static_ptr + i),
                                          __ldg(static_ptr + i + 1));
                if (sr.y > sr.x) {
                    sg_prefetch(targets + sr.x, targets + sr.y);
                    stdp_append(dlist, dcount, make_int4(sr.x, sr.y, i, 0));
                }
            }
        }
        grid.sync();
        // Phase B: the walk of step t's spiking rows.
        int n = 0;
        stdp_walk(dlist, __ldcg(dcount), wtaken + par * wchunks, s_view,
                  targets, weights,
                  khist + static_cast<long long>((t - d) & dmask) * ne,
                  sg_slot(ring, t + d, dmask, num), recent, spikes, cap, kph,
                  k, &n, p);
        if (counters) stdp_count(s_fac, n);
        // The rows' counter of step t + 1 and its ranges' counters were
        // last used in step t - 1.
        if (blockIdx.x == 0) {
            for (int c = threadIdx.x; c < wchunks; c += SG_BLOCK)
                wtaken[(par ^ 1) * wchunks + c] = 0;
            if (threadIdx.x == 0) counts[par ^ 1] = 0;
        }
        grid.sync();
    }

#pragma unroll
    for (int q = 0; q < STDP_NPT; ++q) {
        const int i = g + q * gsize;
        if (i >= num) continue;
        v[i] = rv[q];
        i_syn[i] = ri[q];
        di[i] = rd[q];
        ref[i] = rr[q];
        spike_count[i] = rc[q];
        if (i < ne) {
            kplus[i] = kp[q];
            last_walk[i] = lw[q];
        }
    }
    if (n_steps > 0) {
        grid.sync();  // every row's last walk is written
        int n = 0;
        stdp_flush(targets, plastic_ptr, weights, ftaken, s_view, recent,
                   spikes, cap, kph, last_walk, n_steps - 1, &n, p);
        if (counters) stdp_count(s_fac + 1, n);
    }
    if (counters) {
        __syncthreads();
        if (threadIdx.x == 0) {
            if (s_fac[0] + s_fac[1])
                atomicAdd(counters + 1, s_fac[0] + s_fac[1]);
            if (s_fac[1]) atomicAdd(counters + 2, s_fac[1]);
        }
    }
}

// y = stdp_pow(x, mu) elementwise: K24's w^mu, for the check against the
// plain loop's torch.pow.
__global__ void stdp_pow_kernel(const float* __restrict__ x,
                                float* __restrict__ y, const long long n,
                                const float mu) {
    for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                       threadIdx.x;
         i < n; i += static_cast<long long>(gridDim.x) * blockDim.x)
        y[i] = stdp_pow(x[i], mu);
}

}  // namespace

// Blocks of SG_BLOCK threads of K24 that can be co-resident on the device:
// the largest grid a cooperative launch of it takes.
BE_EXPORT int stdp_sim_max_blocks(int device, int* blocks) {
    int err = be_begin(device);
    if (err) return err;
    return be_coresident_blocks(reinterpret_cast<const void*>(stdp_sim_kernel),
                                SG_BLOCK, device, blocks);
}

// v, i_syn, di: (num,) float32; ref, spike_count: (num,) int32; kplus:
// (n_exc,) float32; all read at the start and written at the end. ring:
// (depth, num) int32, khist: (depth, n_exc) float32, spiked: (depth, n_exc)
// uint8, weights: (n_plastic,) float32, read and written in place.
// targets: int32 (P + S); plastic_ptr: (n_exc + 1,) int32 into [0, P);
// static_ptr: (num + 1,) int32 into [P, P + S). Scratch: dlists (2, 2 num,
// 4) int32; counts (2 + 2 ceil(2 num / SG_BLOCK) + ceil(n_exc / SG_BLOCK),)
// int32; kph: the K+ history of hist_steps steps (hist_steps /
// STDP_HTILE, n_exc, STDP_HTILE) float32; spikes (n_exc,
// cap) int32; recent (n_exc, 16) int32; last_walk (n_exc,) int32. counters:
// (3,) uint64, set to the launch's depressions, facilitations and the
// flush's facilitations, or null. n_steps <= hist_steps, and cap must hold
// an E neuron's spikes of the d steps before the launch and of its n_steps.
// blocks * SG_BLOCK * STDP_NPT must cover num; a grid larger than can be
// co-resident is refused (cudaErrorCooperativeLaunchTooLarge).
BE_EXPORT int stdp_sim_launch(
    float* v, float* i_syn, float* di, int* ref, int* ring, int* spike_count,
    float* weights, float* kplus, float* khist, unsigned char* spiked,
    const int* targets, const int* plastic_ptr, const int* static_ptr,
    int* dlists, int* counts, float* kph, int* spikes, int* recent,
    int* last_walk, unsigned long long* counters, int n_steps,
    int hist_steps, int cap, const StdpParams* p, int blocks, int device,
    void* stream) {
    int err = be_begin(device);
    if (err) return err;
    if (p->num <= 0) return be_end();
    if (blocks <= 0 ||
        static_cast<long long>(blocks) * SG_BLOCK * STDP_NPT < p->num ||
        p->n_exc < 0 || p->n_exc > p->num || p->depth < 2 ||
        (p->depth & (p->depth - 1)) || p->delay < 1 || p->delay >= p->depth ||
        n_steps < 0 || n_steps > hist_steps || hist_steps % STDP_HTILE ||
        cap < p->delay)
        return static_cast<int>(cudaErrorInvalidValue);
    const void* kernel = reinterpret_cast<const void*>(stdp_sim_kernel);
    StdpParams params = *p;
    int4* d4 = reinterpret_cast<int4*>(dlists);
    int4* r4 = reinterpret_cast<int4*>(recent);
    void* args[] = {&v,       &i_syn,     &di,         &ref,       &ring,
                    &spike_count, &weights, &kplus,   &khist,     &spiked,
                    &targets, &plastic_ptr, &static_ptr, &d4,     &counts,
                    &kph,     &spikes,    &r4,         &last_walk, &counters,
                    &n_steps, &cap,       &params};
    return be_refused(static_cast<int>(cudaLaunchCooperativeKernel(
        kernel, dim3(blocks), dim3(SG_BLOCK), args, 0,
        static_cast<cudaStream_t>(stream))));
}

// y = w^mu of every x (n float32), as K24 computes it.
BE_EXPORT int stdp_pow_launch(const float* x, float* y, long long n,
                              float mu, int device, void* stream) {
    int err = be_begin(device);
    if (err) return err;
    if (n <= 0) return be_end();
    stdp_pow_kernel<<<BE_MAX_BLOCKS * 2, BE_BLOCK, 0,
                      static_cast<cudaStream_t>(stream)>>>(x, y, n, mu);
    return be_end();
}
