// Copyright 2026 The brainevent-tpu Authors.
// Licensed under the Apache License, Version 2.0.
//
// Phase clocks of the whole-trial kernels: K21's grid body (einet_sim.cu
// be_sim_grid, which K21's HH instance runs), K23 (mc_sim.cu) and K24
// (stdp_sim.cu). Each kernel holds a BePhaseClock<kOn, P, W>; with kOn
// false it is empty and each of its calls is nothing, so that instance
// compiles as it would without it, and with kOn true it times where each
// warp spends the launch, in P phases.
//
// A clocked warp reads the SM's clock at each edge between two phases of
// the step, once its lanes meet there (__syncwarp), and adds the cycles
// since its last edge to its running sum of the phase that ended: no
// branch, no memory access and no wait, since every lane of the warp keeps
// the same 32-bit sums. Every BE_CLOCK_SPAN steps lane 0 adds them into
// its warp's 64-bit slots in shared memory (so no 32-bit sum wraps,
// whatever the launch's length).
//
// The edges tile the warp's launch from its start (at the kernel's entry)
// to its last edge, so a warp's phases sum to its whole time. At the end
// each block measures its SM's clock against %globaltimer over the launch
// (thread 0 reads both at the start and after the block's last edge), each
// warp converts its cycles to ns at that rate and adds them, one atomicAdd
// a phase, to the launch's buffer of P uint64 words: the grid's warps' ns
// in each phase. Over the grid's warps and the launch's steps that is the
// mean warp's time a step in each phase, and the phases together the
// kernel's time a step.
//
// The sums live in registers (P + 1 a thread), not in shared memory: a
// stamp that loads and stores a shared slot put a shared memory round trip
// into the warp's path at every edge, and cost K21's HH instance ~7% and
// K23 ~5.5% (an H100); 64-bit shared atomics cost more. The __syncwarp
// keeps each read where its phase ends: without it the compiler put reads
// that follow a grid barrier just past the barrier's first bar.sync, ahead
// of the wait for the other blocks (its SASS), and K24's walk read 26.3 us
// a step and its barrier 4.9, against 22.5 and 8.9 with it (as with lane
// 0's shared slots).
#pragma once

// Steps between two adds of a warp's 32-bit sums into its 64-bit slots: a
// step of up to ~4 M cycles (2 ms) keeps them from wrapping.
constexpr int BE_CLOCK_SPAN = 1024;

// A block's slots: each warp's cycles (ns, at the end) in each phase, the
// block's first stamp (cycles and globaltimer ns) and, at the end, its ns a
// cycle.
template <int P, int W>
struct BePhaseSlots {
    unsigned long long sum[W][P];
    unsigned long long clk0, gt0;
    double ns_per_clk;
};

template <int P, int W>
__device__ __forceinline__ BePhaseSlots<P, W>& be_phase_slots() {
    static __shared__ BePhaseSlots<P, W> s;
    return s;
}

// The SM's clock, its low 32 bits.
__device__ __forceinline__ unsigned be_clock32() {
    unsigned t;
    asm volatile("mov.u32 %0, %%clock;" : "=r"(t));
    return t;
}

__device__ __forceinline__ unsigned long long be_globaltimer() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}

template <bool kOn, int P, int W>
struct BePhaseClock {
    __device__ __forceinline__ void start() {}
    __device__ __forceinline__ void edge(int) {}
    __device__ __forceinline__ void tick(int) {}
    __device__ __forceinline__ void finish(unsigned long long*) {}
};

template <int P, int W>
struct BePhaseClock<true, P, W> {
    unsigned last;
    unsigned acc[P];

    // The warp's start, at the kernel's entry (every thread calls it).
    __device__ __forceinline__ void start() {
        BePhaseSlots<P, W>& s = be_phase_slots<P, W>();
        if (threadIdx.x == 0) {
            s.clk0 = clock64();
            s.gt0 = be_globaltimer();
        }
        if ((threadIdx.x & 31) == 0) {
#pragma unroll
            for (int q = 0; q < P; ++q) s.sum[threadIdx.x >> 5][q] = 0;
        }
#pragma unroll
        for (int q = 0; q < P; ++q) acc[q] = 0;
        last = be_clock32();
    }

    // The end of the warp's phase *phase*, a constant at each call (every
    // thread calls it, where the warp is done with the phase).
    __device__ __forceinline__ void edge(const int phase) {
        __syncwarp();
        const unsigned now = be_clock32();
        acc[phase] += now - last;
        last = now;
    }

    // After step k: every BE_CLOCK_SPAN steps, the sums into the slots.
    __device__ __forceinline__ void tick(const int k) {
        if (k % BE_CLOCK_SPAN == BE_CLOCK_SPAN - 1) spill();
    }

    // The end of the launch, after the warp's last edge: the block's warps
    // add their ns in each phase to out[0 .. P) (every thread of the block
    // calls it, at the kernel's end).
    __device__ __forceinline__ void finish(unsigned long long* out) {
        spill();
        BePhaseSlots<P, W>& s = be_phase_slots<P, W>();
        __syncthreads();  // every warp's sums are in its slots
        if (threadIdx.x == 0) {
            const unsigned long long clk = clock64() - s.clk0;
            const unsigned long long ns = be_globaltimer() - s.gt0;
            s.ns_per_clk = clk ? static_cast<double>(ns) / clk : 0.0;
        }
        __syncthreads();
        if ((threadIdx.x & 31) == 0) {
            const int w = threadIdx.x >> 5;
#pragma unroll
            for (int q = 0; q < P; ++q) {
                const unsigned long long ns = __double2ull_rn(
                    static_cast<double>(s.sum[w][q]) * s.ns_per_clk);
                if (ns) atomicAdd(out + q, ns);
            }
        }
    }

  private:
    __device__ __forceinline__ void spill() {
        if ((threadIdx.x & 31) == 0) {
            BePhaseSlots<P, W>& s = be_phase_slots<P, W>();
#pragma unroll
            for (int q = 0; q < P; ++q) s.sum[threadIdx.x >> 5][q] += acc[q];
        }
#pragma unroll
        for (int q = 0; q < P; ++q) acc[q] = 0;
    }
};
