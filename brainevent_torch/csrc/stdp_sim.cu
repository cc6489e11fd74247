// Copyright 2026 The brainevent-tpu Authors.
// Licensed under the Apache License, Version 2.0.
//
// K24 `stdp_sim`: a whole trial of NEST's HPC benchmark network with
// power-law STDP (Morrison, Aertsen & Diesmann 2007; models/hpc_stdp.py),
// n steps, in one launch. No TPU kernel precedes it: the JAX package has no
// network whose synapses change while it runs. The file's second half is
// K24's iSTDP instance `istdp_sim` (Vogels et al. 2011's inhibitory
// plasticity; models/istdp_net.py), on the same grid, rows' lists, split
// plan and walk by target (see its own comment).
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
// the step's list with its t_lw (the plastic rows at the list's front, the
// static ones at its back, so that the chains start first). Phase B: the
// walk (1 and 2) of the list of step t's spiking rows, split by target:
// block b of the G owns the E neurons [b NE / G, (b + 1) NE / G) and the I
// neurons NE + [b NI / G, (b + 1) NI / G) (both populations, since only E
// targets have plastic entries), and walks the part of each listed row
// whose targets it owns: a row's targets ascend, so that part is [line[b],
// line[b + 1]) of the row's line in the split plan (`split`, built with
// the network: models/hpc_stdp.py stdp_split). The block stages the first
// int4 of its E targets' records and their K- in shared memory, adds every
// entry's units into a shared sum of its targets, and then adds the sums
// into the ring with plain stores: a target has one writer, and the walk
// no global atomic. Within a phase a weight is written by one thread at
// most (a neuron spikes once a step), and no weight is written with
// atomics. Steps are counted from the launch's first, 0; the history and
// the lists hold such steps.
//
// What bounds it: a synapse's facilitations are a chain (each reads the
// weight the one before wrote), as long as its target spiked since its
// source's last spike, so an entry costs from nothing to dozens of powf
// and the loads of its steps' K+, and a warp waits for its longest lane;
// a step lasts as long as its slowest block's walk. Each block walks a
// slice of every listed row, so a row that owes many spreads over the
// whole grid; the rest of the slowest block's walk is the other blocks'
// wait at the grid barrier, which the clocked instance (below) times.
// Within a block the warps take entries 32 at a time from a counter, and
// an entry that owes its target's whole first record int4 (three or more)
// waits for the walk's end, where the warps run such
// chains side by side: in place, one lane's chain held the 31 others of
// its warp in nearly every warp's turn (an H100 at scale 10). The flush
// shares its entries among the blocks in ranges that each takes from a
// counter as it finishes the one before (stdp_pass): a slow range delays
// only its own block.
//
// The shape is K23's (sim_grid.cuh): a persistent cooperative grid of
// blocks of SG_BLOCK threads; thread g owns neurons g and g + G (G the
// grid's threads) and keeps their state in registers for the whole trial.
//
// Two instances (kPhases): the plain one, and the clocked one that the
// launcher takes where it is given a counters buffer. The clocked one also
// counts the depressions and the facilitations (those of the walks and
// those of the flush), and times each warp's launch in four phases
// (phase_clock.cuh): update (phase A, and the state's load and store),
// walk (phase B), barrier (from arriving at a grid.sync() to leaving it)
// and flush; its outputs are the plain one's, on the same grid.
#include "common.cuh"
#include "phase_clock.cuh"
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
// Entries of a range that a block of the flush takes at a time
// (stdp_pass).
constexpr int STDP_FLUSH_GRAB = 2 * SG_BLOCK;
// The E (or I) targets a block owns at most: a grid covers num neurons at
// STDP_NPT a thread, so NE / G and NI / G are at most STDP_NPT SG_BLOCK.
constexpr int STDP_OWN = STDP_NPT * SG_BLOCK;
// The deep entries a block's walk of a step defers to its end at most.
constexpr int STDP_DEEP = 2 * SG_BLOCK;
// The step of a record's empty slot: s + d is past no walk.
constexpr int STDP_NONE = -(1 << 30);
// The counters of the clocked instance, then its phases (phase_clock.cuh).
constexpr int STDP_COUNTERS = 3;
enum StdpPhase { STDP_UPDATE, STDP_WALK, STDP_BARRIER, STDP_FLUSH,
                 STDP_PHASES };

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

// Whether i -> j, its row walked last at step lw, owes by step tr the
// facilitation of j's spike at step s: lw < s + d <= tr.
__device__ __forceinline__ bool stdp_owed(const int s, const int lw,
                                          const int tr, const int d) {
    return s + d > lw && s + d <= tr;
}

// K+_i(s + d) from the history for each of four steps s that is owed, 0
// for the others.
__device__ __forceinline__ float4 stdp_kp4(const int4 s, const int i,
                                           const int lw, const int tr,
                                           const float* kph,
                                           const StdpParams& p) {
    const int d = p.delay, ne = p.n_exc;
    float4 k;
    k.x = stdp_owed(s.x, lw, tr, d) ? __ldcg(kph + stdp_hidx(s.x + d, i, ne))
                                    : 0.0f;
    k.y = stdp_owed(s.y, lw, tr, d) ? __ldcg(kph + stdp_hidx(s.y + d, i, ne))
                                    : 0.0f;
    k.z = stdp_owed(s.z, lw, tr, d) ? __ldcg(kph + stdp_hidx(s.z + d, i, ne))
                                    : 0.0f;
    k.w = stdp_owed(s.w, lw, tr, d) ? __ldcg(kph + stdp_hidx(s.w + d, i, ne))
                                    : 0.0f;
    return k;
}

// The facilitations of four steps s (x oldest) that are owed, in turn,
// with their K+ k (stdp_kp4). *n counts them.
__device__ __forceinline__ float stdp_fac4(float w, const int4 s,
                                           const float4 k, const int lw,
                                           const int tr, const StdpParams& p,
                                           int* n) {
    const int d = p.delay;
    if (stdp_owed(s.x, lw, tr, d)) { w = stdp_fac(w, k.x, p); ++*n; }
    if (stdp_owed(s.y, lw, tr, d)) { w = stdp_fac(w, k.y, p); ++*n; }
    if (stdp_owed(s.z, lw, tr, d)) { w = stdp_fac(w, k.z, p); ++*n; }
    if (stdp_owed(s.w, lw, tr, d)) { w = stdp_fac(w, k.w, p); ++*n; }
    return w;
}

// The steps list[k .. k + 4) of a spike list of end entries, oldest first,
// STDP_NONE past its end.
__device__ __forceinline__ int4 stdp_steps(const int* list, const int k,
                                           const int end) {
    return make_int4(k < end ? __ldcg(list + k) : STDP_NONE,
                     k + 1 < end ? __ldcg(list + k + 1) : STDP_NONE,
                     k + 2 < end ? __ldcg(list + k + 2) : STDP_NONE,
                     k + 3 < end ? __ldcg(list + k + 3) : STDP_NONE);
}

// A record's int4 of steps (newest first) oldest first.
__device__ __forceinline__ int4 stdp_oldest_first(const int4 y) {
    return make_int4(y.w, y.z, y.y, y.x);
}

// The facilitations i -> j owes by step tr for the spikes of j's list
// [.., end) (ascending, all older than its record's): from the first owed,
// found by a binary search, four at a time, each four's steps loaded while
// the four before are made. A row not walked yet in the launch (lw < 0)
// owes every one.
__device__ __forceinline__ float stdp_list(
    float w, const int* list, const int end, const int i, const int lw,
    const int tr, const float* kph, const StdpParams& p, int* n) {
    const int d = p.delay;
    int k = 0;
    if (lw >= 0) {
        int hi = end;
        while (k < hi) {
            const int mid = (k + hi) >> 1;
            if (__ldcg(list + mid) + d > lw) hi = mid; else k = mid + 1;
        }
    }
    if (k >= end) return w;
    int4 s = stdp_steps(list, k, end);
    float4 kp = stdp_kp4(s, i, lw, tr, kph, p);
    for (; k < end; k += 4) {
        const int4 next = stdp_steps(list, k + 4, end);
        w = stdp_fac4(w, s, kp, lw, tr, p, n);
        s = next;
        kp = stdp_kp4(s, i, lw, tr, kph, p);
    }
    return w;
}

// The facilitations that i -> j owes by step tr, its row walked last at
// step lw: one for each spike of j at a step s with lw < s + d <= tr,
// oldest first, with K+_i(s + d) from the history. j's record is four
// int4s (rec): its count and its STDP_RECENT newest steps, newest first,
// STDP_NONE past the count; a (its first, loaded by the caller) settles
// the common case. Where the oldest of a's steps is owed, the record's
// three further int4s are read at once, and j's list where the oldest of
// the record is owed and j has spiked more; each four's K+ is read while
// the four before are made.
__device__ __forceinline__ float stdp_catch_up(
    float w, const int4 a, const int j, const int i, const int lw,
    const int tr, const int4* rec, const int* spikes, const int cap,
    const float* kph, const StdpParams& p, int* n) {
    const int d = p.delay;
    if (a.y + d <= lw) return w;  // no spike since the walk
    const int4 s0 = make_int4(STDP_NONE, a.w, a.z, a.y);
    if (a.w + d <= lw)  // only a's steps are owed
        return stdp_fac4(w, s0, stdp_kp4(s0, i, lw, tr, kph, p), lw, tr, p,
                         n);
    const int4* r = rec + 4ll * j;
    const int4 s1 = stdp_oldest_first(__ldcg(r + 1)),
               s2 = stdp_oldest_first(__ldcg(r + 2)),
               s3 = stdp_oldest_first(__ldcg(r + 3));
    if (s3.x + d > lw && a.x > STDP_RECENT)
        w = stdp_list(w, spikes + static_cast<long long>(j) * cap,
                      a.x - STDP_RECENT, i, lw, tr, kph, p, n);
    const float4 k3 = stdp_kp4(s3, i, lw, tr, kph, p),
                 k2 = stdp_kp4(s2, i, lw, tr, kph, p);
    w = stdp_fac4(w, s3, k3, lw, tr, p, n);
    const float4 k1 = stdp_kp4(s1, i, lw, tr, kph, p);
    w = stdp_fac4(w, s2, k2, lw, tr, p, n);
    const float4 k0 = stdp_kp4(s0, i, lw, tr, kph, p);
    w = stdp_fac4(w, s1, k1, lw, tr, p, n);
    return stdp_fac4(w, s0, k0, lw, tr, p, n);
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

// Appends a row (its line of the split plan, its source, the source's walk
// before, 0) to a list whose counter is *count: at its front, or
// (stdp_append_back, last the list's last slot) at its back.
__device__ __forceinline__ void stdp_append(int4* list, int* count,
                                            const int4 row) {
    list[atomicAdd(count, 1)] = row;
}
__device__ __forceinline__ void stdp_append_back(int4* last, int* count,
                                                 const int4 row) {
    last[-atomicAdd(count, 1)] = row;
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

// A block's targets in the walk: the E neurons [e_lo, e_lo + n_e) and the
// I neurons [i_lo, i_lo + n_i) it owns; the first int4 of its E targets'
// records and their K- (staged at the walk's start), and the units of the
// walk into each of its targets, E then I (zero between walks). The walk's
// warps take a chunk's entries 32 at a time from a counter (grab, by the
// chunk's parity); the entries it defers (deep: position, target, source,
// source's walk before; n_deep of them) they take from deep_grab.
struct StdpOwn {
    int4 rec[STDP_OWN];
    float km[STDP_OWN];
    int acc[STDP_OWN + 2];
    int4 deep[STDP_DEEP];
    int e_lo, n_e, i_lo, n_i;
    int grab[2];
    int n_deep, deep_grab;
};

// Block b's targets of a grid of G blocks (see the file's comment).
__device__ __forceinline__ void stdp_own(StdpOwn& o, const int ne,
                                         const int num) {
    const long long b = blockIdx.x, nb = gridDim.x, ni = num - ne;
    o.e_lo = static_cast<int>(b * ne / nb);
    o.n_e = static_cast<int>((b + 1) * ne / nb) - o.e_lo;
    o.i_lo = ne + static_cast<int>(b * ni / nb);
    o.n_i = ne + static_cast<int>((b + 1) * ni / nb) - o.i_lo;
    o.grab[0] = o.grab[1] = o.n_deep = o.deep_grab = 0;
}

// The next 32 of a counter's entries for the calling warp (every lane
// calls it): the first.
__device__ __forceinline__ int stdp_grab(int* counter) {
    int e0 = 0;
    if ((threadIdx.x & 31) == 0) e0 = atomicAdd(counter, 32);
    return __shfl_sync(0xffffffffu, e0, 0);
}

// The plastic entry c, i -> j (slot q of the block's targets; i's row
// walked last at step lw): the facilitations it owes (stdp_catch_up, from
// j's record staged in o), then w = max(w - (lam_alpha w) K-_j, 0), K-
// staged in o; returns its units.
__device__ __forceinline__ int stdp_plastic(
    const int c, const int q, const int j, const int i, const int lw,
    float* weights, const StdpOwn& o, const int4* recent, const int* spikes,
    const int cap, const float* kph, const int tr, int* nfac,
    const StdpParams& p) {
    const float x0 = stdp_catch_up(__ldcg(weights + c), o.rec[q], j, i, lw,
                                   tr, recent, spikes, cap, kph, p, nfac);
    const float dep = __fmul_rn(__fmul_rn(p.lam_alpha, x0), o.km[q]);
    float x = __fsub_rn(x0, dep);
    x = x > 0.0f ? x : 0.0f;
    weights[c] = x;
    return __float2int_rn(__fmul_rn(x, p.units));
}

// The walk of step tr by the block: the list's n rows (each its line of
// the split plan, source, walk before; the first nf from its front, the
// plastic ones, the rest from its back, lcap rows on), in chunks of
// SG_BLOCK, each row's part [line[b], line[b + 1]) whose targets the block
// owns. A plastic entry makes its facilitations and its depression
// (stdp_plastic); every entry adds its units into its target's shared
// sum, and the block adds the sums into the ring's slot late. A plastic
// entry that owes every spike of its target's record's first int4 waits
// for the end of the walk (up to STDP_DEEP of them), so that the warps run
// such chains side by side and not beside entries that owe one or none.
// *nfac counts the facilitations.
__device__ __forceinline__ void stdp_walk(
    const int4* list, const int n, const int nf, const long long lcap,
    const int* __restrict__ split, StdpView& v, StdpOwn& o,
    const int* __restrict__ targets, float* weights, const float* kh,
    int* late, const int4* recent, const int* spikes, const int cap,
    const float* kph, const int tr, int* nfac, const StdpParams& p) {
    if (n == 0) return;
    const int j = threadIdx.x, lane = j & 31;
    const long long stride = gridDim.x + 1;
    const int e_lo = o.e_lo, n_e = o.n_e;
    // an I target's sum is o.acc[tg + i_off]
    const int i_off = n_e - o.i_lo;
    for (int c0 = 0; c0 < n; c0 += SG_BLOCK) {
        const int m = min(n - c0, SG_BLOCK);
        const long long at = c0 + j < nf ? c0 + j : lcap - 1 - (c0 + j - nf);
        const int4 row = j < m ? __ldcg(list + at) : make_int4(0, 0, 0, 0);
        if (c0 == 0) {
            // read by the entries after the scan's barriers
            for (int q = j; q < n_e; q += SG_BLOCK) {
                o.rec[q] = __ldcg(recent + 4ll * (e_lo + q));
                o.km[q] = __ldcg(kh + e_lo + q);
            }
        }
        int beg = 0, end = 0;
        if (j < m) {
            const int* line = split + row.x * stride + blockIdx.x;
            beg = __ldg(line);
            end = __ldg(line + 1);
        }
        // the chunk's counter, free since the chunk before the last
        int* grab = o.grab + ((c0 / SG_BLOCK) & 1);
        if (j == 0) *grab = 0;
        const int total = stdp_view(beg, end, row.y, row.z, m, v);
        for (int e0 = stdp_grab(grab); e0 < total; e0 = stdp_grab(grab)) {
            const int e = e0 + lane;
            if (e >= total) continue;
            const int r = sg_find(e, m, v.off);
            const int c = v.beg[r] + (e - v.off[r]);
            const int tg = __ldg(targets + c);
            int units;
            if (c < p.n_plastic) {
                const int q = tg - e_lo, lw = v.lw[r];
                if (o.rec[q].w + p.delay > lw) {
                    const int k = atomicAdd(&o.n_deep, 1);
                    if (k < STDP_DEEP) {
                        o.deep[k] = make_int4(c, tg, v.src[r], lw);
                        continue;
                    }
                }
                units = stdp_plastic(c, q, tg, v.src[r], lw, weights, o,
                                     recent, spikes, cap, kph, tr, nfac, p);
            } else {
                units = c < p.static_e_end ? p.w_e : p.w_i;
            }
            atomicAdd(o.acc + (tg < p.n_exc ? tg - e_lo : tg + i_off), units);
        }
    }
    __syncthreads();  // the deferred entries are listed
    const int n_deep = min(o.n_deep, STDP_DEEP);
    for (int e0 = stdp_grab(&o.deep_grab); e0 < n_deep;
         e0 = stdp_grab(&o.deep_grab)) {
        if (e0 + lane >= n_deep) continue;
        const int4 d = o.deep[e0 + lane];
        atomicAdd(o.acc + d.y - e_lo,
                  stdp_plastic(d.x, d.y - e_lo, d.y, d.z, d.w, weights, o,
                               recent, spikes, cap, kph, tr, nfac, p));
    }
    __syncthreads();  // the block's sums are whole
    if (j == 0) o.n_deep = o.deep_grab = 0;
    for (int q = j; q < n_e + o.n_i; q += SG_BLOCK) {
        const int x = o.acc[q];
        if (x) {
            o.acc[q] = 0;
            int* a = late + (q < n_e ? e_lo + q : q - i_off);
            *a = __ldcg(a) + x;
        }
    }
}

// The flush: the facilitations that the E rows' entries owe by the
// launch's last step tr (each row's walk last at last_walk), in chunks of
// SG_BLOCK rows, each a grid pass (stdp_pass, its counter taken[chunk]).
// *nfac counts them.
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

// kPhases: the clocked instance (see the file's comment), which fills
// counters; the plain one reads no counters.
template <bool kPhases>
__global__ void __launch_bounds__(SG_BLOCK, 3)
stdp_sim_kernel(float* __restrict__ v, float* __restrict__ i_syn,
                float* __restrict__ di, int* __restrict__ ref, int* ring,
                int* __restrict__ spike_count, float* weights, float* kplus,
                float* khist, unsigned char* spiked,
                const int* __restrict__ targets,
                const int* __restrict__ plastic_ptr,
                const int* __restrict__ static_ptr,
                const int* __restrict__ split, int4* dlists, int* counts,
                float* kph, int* spikes, int4* recent, int* last_walk,
                unsigned long long* counters, const int n_steps,
                const int cap, const StdpParams p) {
    BePhaseClock<kPhases, STDP_PHASES, SG_WARPS> clk;
    clk.start();
    __shared__ unsigned s_thr[SG_KMAX];
    // The walk's and the flush's view of a chunk of rows.
    __shared__ StdpView s_view;
    // The block's targets in the walk.
    __shared__ StdpOwn s_own;
    // The block's facilitations (the clocked instance): in the walks, in
    // the flush.
    __shared__ unsigned long long s_fac[2];
    if (threadIdx.x < SG_KMAX) s_thr[threadIdx.x] = p.thr[threadIdx.x];
    if (kPhases && threadIdx.x < 2) s_fac[threadIdx.x] = 0;
    if (threadIdx.x == 0) stdp_own(s_own, p.n_exc, p.num);
    for (int q = threadIdx.x; q < STDP_OWN + 2; q += SG_BLOCK)
        s_own.acc[q] = 0;
    cg::grid_group grid = cg::this_grid();
    const int num = p.num, ne = p.n_exc;
    const unsigned dmask = static_cast<unsigned>(p.depth) - 1u;
    const unsigned d = static_cast<unsigned>(p.delay);
    const int g = blockIdx.x * SG_BLOCK + threadIdx.x;
    const int gsize = gridDim.x * SG_BLOCK;
    const long long dcap = 2ll * num;
    const unsigned t0 = p.step0;
    const unsigned last = (t0 - 1u) & dmask;
    // a line of the split plan
    const long long stride = gridDim.x + 1;

    // counts, by parity: the counters of the rows' lists' fronts (the
    // plastic rows), the counters of the lists' backs (the static rows);
    // then the flush's ranges' counters
    int* backs = counts + 2;
    int* ftaken = counts + 4;
    const int n_counts = 4 + (ne + SG_BLOCK - 1) / SG_BLOCK;
    for (int c = g; c < n_counts; c += gsize) counts[c] = 0;
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
    clk.edge(STDP_UPDATE);
    grid.sync();  // the counters are zeroed, the lists seeded
    clk.edge(STDP_BARRIER);

    for (int k = 0; k < n_steps; ++k) {
        const unsigned t = t0 + static_cast<unsigned>(k);
        const unsigned slot = t & dmask;
        const int par = static_cast<int>(t & 1u);
        int4* dlist = dlists + par * dcap;
        int* dcount = counts + par;
        int* dback = backs + par;
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
                        // read by phase B's walk, after the barrier
                        sg_prefetch(targets + pr.x, targets + pr.y);
                        sg_prefetch(weights + pr.x, weights + pr.y);
                        sg_prefetch(split + i * stride,
                                    split + (i + 1) * stride);
                        stdp_append(dlist, dcount,
                                    make_int4(i, i, lw[q], 0));
                        if (kPhases)
                            atomicAdd(counters,
                                      static_cast<unsigned long long>(
                                          pr.y - pr.x));
                    }
                    lw[q] = k;
                }
                const int2 sr = make_int2(__ldg(static_ptr + i),
                                          __ldg(static_ptr + i + 1));
                if (sr.y > sr.x) {
                    // the row's line (an I neuron's: by its E targets),
                    // and an I neuron's line by its I targets
                    sg_prefetch(targets + sr.x, targets + sr.y);
                    sg_prefetch(split + (ne + i) * stride,
                                split + (ne + i + 1) * stride);
                    stdp_append_back(dlist + dcap - 1, dback,
                                     make_int4(ne + i, i, 0, 0));
                    if (i >= ne) {
                        sg_prefetch(split + (num + i) * stride,
                                    split + (num + i + 1) * stride);
                        stdp_append_back(dlist + dcap - 1, dback,
                                         make_int4(num + i, i, 0, 0));
                    }
                }
            }
        }
        clk.edge(STDP_UPDATE);
        grid.sync();
        clk.edge(STDP_BARRIER);
        // Phase B: the walk of step t's spiking rows.
        int n = 0;
        const int nf = __ldcg(dcount);
        stdp_walk(dlist, nf + __ldcg(dback), nf, dcap, split, s_view, s_own,
                  targets, weights,
                  khist + static_cast<long long>((t - d) & dmask) * ne,
                  sg_slot(ring, t + d, dmask, num), recent, spikes, cap, kph,
                  k, &n, p);
        if (kPhases) stdp_count(s_fac, n);
        // The rows' counters of step t + 1 were last used in step t - 1.
        if (blockIdx.x == 0 && threadIdx.x == 0) {
            counts[par ^ 1] = 0;
            backs[par ^ 1] = 0;
        }
        clk.edge(STDP_WALK);
        grid.sync();
        clk.edge(STDP_BARRIER);
        clk.tick(k);
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
        clk.edge(STDP_UPDATE);
        grid.sync();  // every row's last walk is written
        clk.edge(STDP_BARRIER);
        int n = 0;
        stdp_flush(targets, plastic_ptr, weights, ftaken, s_view, recent,
                   spikes, cap, kph, last_walk, n_steps - 1, &n, p);
        if (kPhases) stdp_count(s_fac + 1, n);
        clk.edge(STDP_FLUSH);
    } else {
        clk.edge(STDP_UPDATE);
    }
    if constexpr (kPhases) {
        clk.finish(counters + STDP_COUNTERS);
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
    return be_coresident_blocks(
        reinterpret_cast<const void*>(stdp_sim_kernel<false>), SG_BLOCK,
        device, blocks);
}

// v, i_syn, di: (num,) float32; ref, spike_count: (num,) int32; kplus:
// (n_exc,) float32; all read at the start and written at the end. ring:
// (depth, num) int32, khist: (depth, n_exc) float32, spiked: (depth, n_exc)
// uint8, weights: (n_plastic,) float32, read and written in place.
// targets: int32 (P + S); plastic_ptr: (n_exc + 1,) int32 into [0, P);
// static_ptr: (num + 1,) int32 into [P, P + S); split: (2 num, blocks + 1)
// int32, the split plan of these rows for this grid (models/hpc_stdp.py
// stdp_split; each row's targets ascending). Scratch: dlists (2, 2 num, 4)
// int32; counts (4 + ceil(n_exc / SG_BLOCK),) int32; kph: the K+ history of
// hist_steps steps (hist_steps / STDP_HTILE, n_exc, STDP_HTILE) float32;
// spikes (n_exc, cap) int32; recent (n_exc, 16) int32; last_walk (n_exc,)
// int32. counters: null (the plain instance), or (7,) uint64, zeroed by
// the caller, that the clocked instance adds to: the launch's depressions,
// facilitations and the flush's facilitations, then the grid's warps' ns
// in update, walk, barrier and flush. n_steps <= hist_steps, and cap must
// hold an E neuron's spikes of the d steps before the launch and of its
// n_steps.
// blocks * SG_BLOCK * STDP_NPT must cover num; a grid larger than can be
// co-resident is refused (cudaErrorCooperativeLaunchTooLarge).
BE_EXPORT int stdp_sim_launch(
    float* v, float* i_syn, float* di, int* ref, int* ring, int* spike_count,
    float* weights, float* kplus, float* khist, unsigned char* spiked,
    const int* targets, const int* plastic_ptr, const int* static_ptr,
    const int* split, int* dlists, int* counts, float* kph, int* spikes,
    int* recent,
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
        cap < p->delay || !split)
        return static_cast<int>(cudaErrorInvalidValue);
    const void* kernel =
        counters ? reinterpret_cast<const void*>(stdp_sim_kernel<true>)
                 : reinterpret_cast<const void*>(stdp_sim_kernel<false>);
    StdpParams params = *p;
    int4* d4 = reinterpret_cast<int4*>(dlists);
    int4* r4 = reinterpret_cast<int4*>(recent);
    void* args[] = {&v,       &i_syn,     &di,         &ref,       &ring,
                    &spike_count, &weights, &kplus,   &khist,     &spiked,
                    &targets, &plastic_ptr, &static_ptr, &split,  &d4,
                    &counts,
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

// ---------------------------------------------------------------------------
// K24's iSTDP instance `istdp_sim`: a whole trial of Vogels, Sprekeler,
// Zenke, Clopath & Gerstner 2011's recurrent network with inhibitory
// plasticity (models/istdp_net.py), n steps, in one launch, on K24's grid
// with its rows' lists and its walk by target over a split plan.
//
// The network: NE excitatory and NI inhibitory conductance-based LIF
// neurons, every synapse of delay 1 step (a ring of D = 2 slots, two
// channels: AMPA and GABA), in two CSRs by source over one targets array:
// the plastic I->E synapses first (positions [0, P), rows plastic_ptr, one
// a row of an I neuron, float32 weights w in nS), then the static ones
// (positions [P, P + S), rows static_ptr: each E neuron's row onto E and I
// targets, w_e units of AMPA, then each I neuron's row onto I targets, w_ii
// units of GABA). A row's targets ascend.
//
// Step t, neuron i, every product and sum rounded once (Euler, as Brian's
// method='euler', in float32):
//   ga = ga + float(ring[t mod D][AMPA][i]) q;  gg likewise (GABA); the
//   slots cleared
//   if ref > 0: ref -= 1;  live = ref == 0
//   if live: v = v + dt_c (((i_bg - g_l (v - e_l)) - ga v) - gg (v - e_r))
//   ga = da ga;  gg = dg gg
//   if live and v > v_t: v = e_l, ref = ref_steps, count += 1
//   E: A_post = kd A_post (before the spike);  I: A_pre = kd A_pre, + 1
//   at a spike
// then Brian's synapses, the pre pathway before the post one:
//   1. each I neuron i that spikes at t, each I -> E synapse i -> j:
//      w = min(max(w + eta (A_post_j - alpha), 0), g_max), and rint(w
//      units) units into ring[(t + 1) mod D][GABA][j]; every static
//      synapse of a spike adds its units into its channel's slot;
//   2. each E neuron j that spikes at t, each I -> E synapse i -> j:
//      w = min(max(w + eta A_pre_i, 0), g_max), A_pre_i counting i's
//      spike at t;
//   3. the E spikes of t add 1 to their A_post.
// Every update is eager: a synapse's pre and post updates are made in the
// step of their spikes, in that order.
//
// A step is two phases between grid barriers, as the HPC instance's. Phase
// A: each thread's neurons' update; an E neuron writes its A_post before
// its spike and whether it spiked (fired), an I neuron its A_pre; a
// spiking neuron lists its static row, and an I neuron its plastic row, on
// the step's two lists, a block's rows at one place of each list that the
// block takes with one atomic. Phase B: the grid's warps scatter the
// static rows whole, a warp a row, with global atomics into the ring's
// next slot (AMPA from an E source, GABA onto I targets from an I one):
// a row of ~200 targets over the grid's ~400 blocks is too short to split
// by target, where each block would read a row's two bounds for ~0.5 of
// its entries. The plastic rows go by target, as the HPC instance's walk:
// block b owns the E neurons [b NE / G, (b + 1) NE / G), stages eta
// (A_post - alpha) of them and lists those that spiked, walks its part of
// each plastic row ([line[b], line[b + 1]) of the row's line in the split
// plan, models/istdp_net.py istdp_split), making the pre updates and
// summing the units into shared sums of its targets, adds the sums into the
// GABA slot of its E targets with plain stores (no other writer: the
// static GABA rows have I targets), and then walks the columns (the I -> E
// synapses by target: col_ptr, col_pos, col_src) of its spiking E targets
// (post updates). A synapse i -> j is written only by j's block, so the
// block's barrier between the walk and the columns orders its pre and
// post updates.
//
// Two instances (kPhases), as the HPC instance's: the clocked one counts the
// pre and the post updates and times each warp's launch in five phases:
// update (phase A, and the state's load and store), scatter (the static
// rows), walk (the staging, the plastic rows and the sums), post (the
// columns) and barrier.

// The scalars of one network and trial; the same layout as IstdpParams in
// brainevent_torch/models/istdp_net.py (ctypes), the floats rounded to
// float32 on the host.
struct IstdpParams {
    float dt_c;        // float32(dt / C_m): mV a pA a step
    float g_l;         // leak conductance (nS)
    float e_l;         // leak reversal and reset (mV)
    float e_r;         // GABA reversal (mV)
    float i_bg;        // the constant drive (pA)
    float v_t;         // threshold (mV)
    float da;          // float32(1 - dt / tau_ampa)
    float dg;          // float32(1 - dt / tau_gaba)
    float q;           // float32(1 / weight_units): nS of a unit
    float kd;          // float32(exp(-dt / tau_stdp))
    float eta;         // learning rate
    float alpha;       // float32(2 rho0 tau_stdp)
    float g_max;       // the weights' ceiling
    float units;       // float32(weight_units): units of a nS
    int num;           // neurons
    int n_exc;         // excitatory neurons, the first n_exc
    int n_plastic;     // P: positions below it are plastic
    int static_e_end;  // static positions below it have an E source
    int depth;         // D: the ring's slots
    int ref_steps;     // refractory steps
    int w_e;           // units of an E synapse (AMPA)
    int w_ii;          // units of an I -> I synapse (GABA)
    unsigned step0;    // the trial's first step, modulo 2^32
};

namespace {

// The counters of the clocked instance, then its phases (phase_clock.cuh).
constexpr int ISTDP_COUNTERS = 2;
enum IstdpPhase { ISTDP_UPDATE, ISTDP_SCATTER, ISTDP_WALK, ISTDP_POST,
                  ISTDP_BARRIER, ISTDP_PHASES };

// A block's E targets in phase B, [e_lo, e_lo + n_e): eta (A_post - alpha)
// of each (staged at the phase's start), those that spiked in the step
// (n_post of them), and the units of the plastic walk into each (zero
// between walks). n_lines and base: the rows its threads list in phase A on
// the plastic and the static list, and their first slots there.
struct IstdpOwn {
    int acc[STDP_OWN];
    float dpre[STDP_OWN];
    int post[STDP_OWN];
    int e_lo, n_e, n_post;
    int n_lines[2], base[2];
};

// One update of a plastic weight: min(max(w + x, 0), g_max).
__device__ __forceinline__ float istdp_clip(const float w, const float x,
                                            const float g_max) {
    float y = __fadd_rn(w, x);
    y = y > 0.0f ? y : 0.0f;
    return y < g_max ? y : g_max;
}

// The grid's scatter of step t's static rows (the n neurons of list): a
// warp a row, its lanes over the row's entries, each adding its units with
// a global atomic into the ring's slot late, AMPA from an E source, GABA
// (num on) from an I one.
__device__ __forceinline__ void istdp_scatter(
    const int* list, const int n, const int* __restrict__ static_ptr,
    const int* __restrict__ targets, int* late, const IstdpParams& p) {
    const int lane = threadIdx.x & 31;
    const int warps = gridDim.x * SG_WARPS;
    for (int k = blockIdx.x * SG_WARPS + (threadIdx.x >> 5); k < n;
         k += warps) {
        const int i = __ldcg(list + k);
        const int beg = __ldg(static_ptr + i), end = __ldg(static_ptr + i + 1);
        const bool exc = i < p.n_exc;
        int* slot = exc ? late : late + p.num;
        const int units = exc ? p.w_e : p.w_ii;
        for (int c = beg + lane; c < end; c += 32)
            atomicAdd(slot + __ldg(targets + c), units);
    }
}

// The block's walk of step t's plastic rows (n, from list: I neurons less
// NE) by target: each row's part [line[b], line[b + 1]) whose targets the
// block owns; each entry makes its pre update with its target's staged eta
// (A_post - alpha) and adds rint(w units) into its target's shared sum;
// then the block adds its sums into the GABA slot of its E targets (late).
// *npre counts the pre updates.
__device__ __forceinline__ void istdp_walk(
    const int* list, const int n, const int* __restrict__ split,
    StdpView& v, IstdpOwn& o, const int* __restrict__ targets,
    float* weights, int* late, int* npre, const IstdpParams& p) {
    const int j = threadIdx.x;
    const long long stride = gridDim.x + 1;
    const int e_lo = o.e_lo;
    for (int c0 = 0; c0 < n; c0 += SG_BLOCK) {
        const int m = min(n - c0, SG_BLOCK);
        int beg = 0, end = 0;
        if (j < m) {
            const int* line = split + __ldcg(list + c0 + j) * stride +
                              blockIdx.x;
            beg = __ldg(line);
            end = __ldg(line + 1);
        }
        const int total = sg_scan(make_int2(beg, end), m, v.off, v.beg,
                                  v.wsum);
        for (int e = j; e < total; e += SG_BLOCK) {
            const int r = sg_find(e, m, v.off);
            const int c = v.beg[r] + (e - v.off[r]);
            const int q = __ldg(targets + c) - e_lo;
            const float x = istdp_clip(__ldcg(weights + c), o.dpre[q],
                                       p.g_max);
            weights[c] = x;
            atomicAdd(o.acc + q, __float2int_rn(__fmul_rn(x, p.units)));
            ++*npre;
        }
    }
    __syncthreads();  // the block's sums are whole
    for (int q = j; q < o.n_e; q += SG_BLOCK) {
        const int x = o.acc[q];
        if (x) {
            o.acc[q] = 0;
            int* a = late + e_lo + q;
            *a = __ldcg(a) + x;
        }
    }
}

// The block's post updates of step t: the columns of its E targets that
// spiked (o.post, o.n_post of them), each entry w = clip(w + eta A_pre_i)
// with A_pre_i of the step (its spike counted). *npost counts them.
__device__ __forceinline__ void istdp_post(
    StdpView& v, IstdpOwn& o, const int* __restrict__ col_ptr,
    const int* __restrict__ col_pos, const int* __restrict__ col_src,
    float* weights, const float* apre, int* npost, const IstdpParams& p) {
    const int j = threadIdx.x, n = o.n_post;
    for (int c0 = 0; c0 < n; c0 += SG_BLOCK) {
        const int m = min(n - c0, SG_BLOCK);
        int beg = 0, end = 0;
        if (j < m) {
            const int jj = o.post[c0 + j];
            beg = __ldg(col_ptr + jj);
            end = __ldg(col_ptr + jj + 1);
        }
        const int total = sg_scan(make_int2(beg, end), m, v.off, v.beg,
                                  v.wsum);
        for (int e = j; e < total; e += SG_BLOCK) {
            const int r = sg_find(e, m, v.off);
            const int c = v.beg[r] + (e - v.off[r]);
            const int pos = __ldg(col_pos + c);
            // a plain load: the block's walk may have written it before
            // the block's barrier, which orders it for the block alone
            const float x = istdp_clip(
                weights[pos],
                __fmul_rn(p.eta, __ldcg(apre + __ldg(col_src + c))),
                p.g_max);
            weights[pos] = x;
            ++*npost;
        }
    }
}

template <bool kPhases>
__global__ void __launch_bounds__(SG_BLOCK, 3)
istdp_sim_kernel(float* __restrict__ v, float* __restrict__ g_ampa,
                 float* __restrict__ g_gaba, int* __restrict__ ref, int* ring,
                 int* __restrict__ spike_count, float* weights, float* apre,
                 float* apost, const int* __restrict__ targets,
                 const int* __restrict__ plastic_ptr,
                 const int* __restrict__ static_ptr,
                 const int* __restrict__ col_ptr,
                 const int* __restrict__ col_pos,
                 const int* __restrict__ col_src,
                 const int* __restrict__ split, int* lists, int* counts,
                 unsigned char* fired, unsigned long long* counters,
                 const int n_steps, const IstdpParams p) {
    BePhaseClock<kPhases, ISTDP_PHASES, SG_WARPS> clk;
    clk.start();
    // The walk's and the columns' view of a chunk of rows.
    __shared__ StdpView s_view;
    // The block's E targets in phase B.
    __shared__ IstdpOwn s_own;
    // The block's pre and post updates (the clocked instance).
    __shared__ unsigned long long s_upd[ISTDP_COUNTERS];
    if (kPhases && threadIdx.x < ISTDP_COUNTERS) s_upd[threadIdx.x] = 0;
    const int num = p.num, ne = p.n_exc, ni = num - ne;
    if (threadIdx.x == 0) {
        const long long b = blockIdx.x, nb = gridDim.x;
        s_own.e_lo = static_cast<int>(b * ne / nb);
        s_own.n_e = static_cast<int>((b + 1) * ne / nb) - s_own.e_lo;
        s_own.n_post = s_own.n_lines[0] = s_own.n_lines[1] = 0;
    }
    for (int q = threadIdx.x; q < STDP_OWN; q += SG_BLOCK) s_own.acc[q] = 0;
    cg::grid_group grid = cg::this_grid();
    const unsigned dmask = static_cast<unsigned>(p.depth) - 1u;
    const int g = blockIdx.x * SG_BLOCK + threadIdx.x;
    const int gsize = gridDim.x * SG_BLOCK;
    // a parity's lists: the plastic rows (I neurons less NE, ni slots),
    // then the static rows (neurons, num slots)
    const long long lcap = static_cast<long long>(ni) + num;
    const long long stride = gridDim.x + 1;
    if (g < 4) counts[g] = 0;
    float rv[STDP_NPT], ra[STDP_NPT], rg[STDP_NPT], tr[STDP_NPT];
    int rr[STDP_NPT], rc[STDP_NPT];
#pragma unroll
    for (int q = 0; q < STDP_NPT; ++q) {
        const int i = g + q * gsize;
        const bool own = i < num;
        rv[q] = own ? v[i] : 0.0f;
        ra[q] = own ? g_ampa[i] : 0.0f;
        rg[q] = own ? g_gaba[i] : 0.0f;
        rr[q] = own ? ref[i] : 0;
        rc[q] = own ? spike_count[i] : 0;
        tr[q] = !own ? 0.0f : i < ne ? apost[i] : apre[i - ne];
    }
    clk.edge(ISTDP_UPDATE);
    grid.sync();  // the lists' counters are zeroed
    clk.edge(ISTDP_BARRIER);

    for (int k = 0; k < n_steps; ++k) {
        const unsigned t = p.step0 + static_cast<unsigned>(k);
        const int par = static_cast<int>(t & 1u);
        int* plist = lists + par * lcap;
        int* slist = plist + ni;
        int* pcount = counts + 2 * par;
        // Phase A: the update of the thread's neurons.
        int* now = ring + static_cast<long long>(t & dmask) * 2 * num;
        int rp[STDP_NPT], rs[STDP_NPT];
        int np = 0, ns = 0;
#pragma unroll
        for (int q = 0; q < STDP_NPT; ++q) {
            const int i = g + q * gsize;
            rp[q] = rs[q] = -1;
            if (i >= num) continue;
            const int sa = __ldcg(now + i), sg = __ldcg(now + num + i);
            if (sa) now[i] = 0;
            if (sg) now[num + i] = 0;
            const float ga = __fadd_rn(ra[q], __fmul_rn(__int2float_rn(sa),
                                                         p.q));
            const float gg = __fadd_rn(rg[q], __fmul_rn(__int2float_rn(sg),
                                                         p.q));
            if (rr[q] > 0) rr[q] -= 1;
            const bool live = rr[q] == 0;
            if (live) {
                const float x = rv[q];
                const float cur = __fsub_rn(
                    __fsub_rn(__fsub_rn(p.i_bg,
                                        __fmul_rn(p.g_l, __fsub_rn(x, p.e_l))),
                              __fmul_rn(ga, x)),
                    __fmul_rn(gg, __fsub_rn(x, p.e_r)));
                rv[q] = __fadd_rn(x, __fmul_rn(p.dt_c, cur));
            }
            ra[q] = __fmul_rn(p.da, ga);
            rg[q] = __fmul_rn(p.dg, gg);
            const bool spike = live && rv[q] > p.v_t;
            if (spike) {
                rv[q] = p.e_l;
                rr[q] = p.ref_steps;
                rc[q] += 1;
            }
            tr[q] = __fmul_rn(p.kd, tr[q]);
            if (i < ne) {
                apost[i] = tr[q];
                fired[i] = spike;
                if (spike) tr[q] = __fadd_rn(tr[q], 1.0f);
            } else {
                const int ii = i - ne;
                if (spike) tr[q] = __fadd_rn(tr[q], 1.0f);
                apre[ii] = tr[q];
                if (spike) {
                    const int2 pr = make_int2(__ldg(plastic_ptr + ii),
                                              __ldg(plastic_ptr + ii + 1));
                    if (pr.y > pr.x) {
                        // read by phase B's walk, after the barrier
                        sg_prefetch(targets + pr.x, targets + pr.y);
                        sg_prefetch(weights + pr.x, weights + pr.y);
                        sg_prefetch(split + ii * stride,
                                    split + (ii + 1) * stride);
                        rp[q] = ii;
                        np += 1;
                    }
                }
            }
            if (spike) {
                const int2 sr = make_int2(__ldg(static_ptr + i),
                                          __ldg(static_ptr + i + 1));
                if (sr.y > sr.x) {
                    sg_prefetch(targets + sr.x, targets + sr.y);
                    rs[q] = i;
                    ns += 1;
                }
            }
        }
        // the block's rows at one place of each of the step's lists
        const int op = np ? atomicAdd(&s_own.n_lines[0], np) : 0;
        const int os = ns ? atomicAdd(&s_own.n_lines[1], ns) : 0;
        __syncthreads();
        if (threadIdx.x < 2) {
            const int c = s_own.n_lines[threadIdx.x];
            s_own.base[threadIdx.x] = c ? atomicAdd(pcount + threadIdx.x, c)
                                        : 0;
            s_own.n_lines[threadIdx.x] = 0;
        }
        __syncthreads();
        if (np | ns) {
            int* at_p = plist + s_own.base[0] + op;
            int* at_s = slist + s_own.base[1] + os;
#pragma unroll
            for (int q = 0; q < STDP_NPT; ++q) {
                if (rp[q] >= 0) *at_p++ = rp[q];
                if (rs[q] >= 0) *at_s++ = rs[q];
            }
        }
        clk.edge(ISTDP_UPDATE);
        grid.sync();
        clk.edge(ISTDP_BARRIER);
        // Phase B: the static rows' scatter, the plastic rows' walk by
        // target, then the columns.
        int* late = ring + static_cast<long long>((t + 1u) & dmask) * 2 * num;
        for (int q = threadIdx.x; q < s_own.n_e; q += SG_BLOCK) {
            const int i = s_own.e_lo + q;
            s_own.dpre[q] = __fmul_rn(p.eta,
                                      __fsub_rn(__ldcg(apost + i), p.alpha));
            if (__ldcg(fired + i))
                s_own.post[atomicAdd(&s_own.n_post, 1)] = i;
        }
        clk.edge(ISTDP_WALK);
        istdp_scatter(slist, __ldcg(pcount + 1), static_ptr, targets, late, p);
        clk.edge(ISTDP_SCATTER);
        __syncthreads();  // the block's targets are staged
        int npre = 0, npost = 0;
        istdp_walk(plist, __ldcg(pcount), split, s_view, s_own, targets,
                   weights, late + num, &npre, p);
        clk.edge(ISTDP_WALK);
        istdp_post(s_view, s_own, col_ptr, col_pos, col_src, weights, apre,
                   &npost, p);
        if (kPhases) {
            stdp_count(s_upd, npre);
            stdp_count(s_upd + 1, npost);
        }
        __syncthreads();  // every thread has read n_post
        if (threadIdx.x == 0) s_own.n_post = 0;
        // The lists' counters of step t + 1 were last used in step t - 1.
        if (blockIdx.x == 0 && threadIdx.x < 2)
            counts[2 * (par ^ 1) + threadIdx.x] = 0;
        clk.edge(ISTDP_POST);
        grid.sync();
        clk.edge(ISTDP_BARRIER);
        clk.tick(k);
    }

#pragma unroll
    for (int q = 0; q < STDP_NPT; ++q) {
        const int i = g + q * gsize;
        if (i >= num) continue;
        v[i] = rv[q];
        g_ampa[i] = ra[q];
        g_gaba[i] = rg[q];
        ref[i] = rr[q];
        spike_count[i] = rc[q];
        if (i < ne)
            apost[i] = tr[q];
        else
            apre[i - ne] = tr[q];
    }
    clk.edge(ISTDP_UPDATE);
    if constexpr (kPhases) {
        clk.finish(counters + ISTDP_COUNTERS);
        if (threadIdx.x < ISTDP_COUNTERS && s_upd[threadIdx.x])
            atomicAdd(counters + threadIdx.x, s_upd[threadIdx.x]);
    }
}

}  // namespace

// Blocks of SG_BLOCK threads of K24's iSTDP instance that can be
// co-resident on the device: the largest grid a cooperative launch of
// either instance takes (the clocked one may hold more registers), so that
// both run on one grid.
BE_EXPORT int istdp_sim_max_blocks(int device, int* blocks) {
    int err = be_begin(device);
    if (err) return err;
    int plain = 0, clocked = 0;
    err = be_coresident_blocks(
        reinterpret_cast<const void*>(istdp_sim_kernel<false>), SG_BLOCK,
        device, &plain);
    if (err) return err;
    err = be_coresident_blocks(
        reinterpret_cast<const void*>(istdp_sim_kernel<true>), SG_BLOCK,
        device, &clocked);
    if (err) return err;
    *blocks = plain < clocked ? plain : clocked;
    return 0;
}

// v, g_ampa, g_gaba: (num,) float32; ref, spike_count: (num,) int32; apre:
// (num - n_exc,) and apost: (n_exc,) float32; all read at the start and
// written at the end. ring: (depth, 2, num) int32 and weights: (n_plastic,)
// float32, read and written in place. targets: int32 (P + S); plastic_ptr:
// (num - n_exc + 1,) int32 into [0, P); static_ptr: (num + 1,) int32 into
// [P, P + S); col_ptr (n_exc + 1,), col_pos and col_src (P,) int32: the
// plastic synapses by target (their positions and I sources); split:
// (num - n_exc, blocks + 1) int32, the split plan of the plastic rows for
// this grid (models/istdp_net.py istdp_split). Scratch: lists (2, 2 num -
// n_exc) int32, counts (4,) int32, fired (n_exc,) uint8. counters: null
// (the plain instance), or (7,) uint64, zeroed by the caller, that the
// clocked instance adds to: the launch's pre and post updates, then the
// grid's warps' ns in update, scatter, walk, post and barrier.
// blocks * SG_BLOCK * STDP_NPT must cover num; a grid larger than can be
// co-resident is refused (cudaErrorCooperativeLaunchTooLarge).
BE_EXPORT int istdp_sim_launch(
    float* v, float* g_ampa, float* g_gaba, int* ref, int* ring,
    int* spike_count, float* weights, float* apre, float* apost,
    const int* targets, const int* plastic_ptr, const int* static_ptr,
    const int* col_ptr, const int* col_pos, const int* col_src,
    const int* split, int* lists, int* counts, unsigned char* fired,
    unsigned long long* counters, int n_steps, const IstdpParams* p,
    int blocks, int device, void* stream) {
    int err = be_begin(device);
    if (err) return err;
    if (p->num <= 0) return be_end();
    if (blocks <= 0 ||
        static_cast<long long>(blocks) * SG_BLOCK * STDP_NPT < p->num ||
        p->n_exc < 0 || p->n_exc > p->num || p->depth < 2 ||
        (p->depth & (p->depth - 1)) || n_steps < 0 || !split)
        return static_cast<int>(cudaErrorInvalidValue);
    const void* kernel =
        counters ? reinterpret_cast<const void*>(istdp_sim_kernel<true>)
                 : reinterpret_cast<const void*>(istdp_sim_kernel<false>);
    IstdpParams params = *p;
    void* args[] = {&v,          &g_ampa,      &g_gaba,     &ref,
                    &ring,       &spike_count, &weights,    &apre,
                    &apost,      &targets,     &plastic_ptr, &static_ptr,
                    &col_ptr,    &col_pos,     &col_src,    &split,
                    &lists,      &counts,      &fired,      &counters,
                    &n_steps,    &params};
    return be_refused(static_cast<int>(cudaLaunchCooperativeKernel(
        kernel, dim3(blocks), dim3(SG_BLOCK), args, 0,
        static_cast<cudaStream_t>(stream))));
}
