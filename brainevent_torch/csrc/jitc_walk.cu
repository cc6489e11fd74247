// Copyright 2026 The brainevent-tpu Authors.
// Licensed under the Apache License, Version 2.0.
//
// K11-K14: the implicit-connectivity (JITC) walk of brainevent_torch/jitc
// (pallas_kernels.py), one thread per light-RNG stream, as the reference
// CUDA runs it.
//
// A walk of n_rows x n_cols has a stream per (row, chunk, lane), lane <
// stride (32 in mv mode, 4 in mm mode); stream s = (row * n_chunks + chunk)
// * stride + lane, the layout of a plan's (state, q) arrays. A stream
// starts at its stationary residual q (lr_stream_init, or the plan's
// arrays when given) and visits col = chunk * chunk_size + local_j for
// local_j = lane + stride * q < width = min(chunk_size, n_cols - chunk *
// chunk_size), advancing state = next(state), q += 1 + bounded(state,
// cl - 1) after each visit. The weight of a visit is lr_weight<law> at
// (row, col). corder = 1: walk rows are output rows and walk columns the
// operand's (gather); corder = 0: the reverse (scatter). row0 offsets the
// walk rows (K11, K12): a launch walks the global rows [row0, row0 +
// n_rows), its streams and weights keyed on the global ids, while the plan,
// the operand (scatter) and the output (gather) stay in local rows. Each
// shard of brainevent_torch/parallel walks its own rows so; the sampled
// matrix does not depend on the split.
//
// K11 `jitc_walk_setup` builds a plan's (state, q): the XLA stream setup
//     of brainevent_tpu/jitc/pallas_kernels.py:walk_plan_setup (:117),
//     which on the TPU is a lockstep rejection loop over every stream.
// K12 `jitc_walk_mv` replaces _make_kernel (:142, jitc_matvec_pallas):
//     gather out[row] = sum w * op(x[col]), a warp per row, each lane
//     summing its own streams and a fixed xor-shuffle tree combining the
//     lanes (the same bits on a repeat); scatter out[col] += w * op(x[row])
//     by float atomics. The event scatter (op 0, 1; the path of JITCNet,
//     1-200 Hz at dt = 0.1 ms, 0.01-2% of the rows a step) walks only the
//     active rows: a block ballots 64 rows of x, compacts the active ones
//     in shared memory and spreads their (row, chunk) pairs over its 16
//     warps, a warp a pair, lane = the stream's lane, with no division; a
//     grid of n_rows / 64 blocks, against a thread per stream of every
//     row (8.2M at the 80k E projection) before. The float
//     scatter (op 2, every row active) keeps a thread per stream, and a
//     stream of a row with x[row] == 0 leaves before its first draw.
// K13 `jitc_walk_mm` replaces _make_mm_kernel (:194, stride 32) and
//     _make_mm_layout_kernel (:699, stride 4): the same walk, each visit
//     serving a tile of 32 operand columns, a warp per (row, tile) whose
//     lanes are the columns; the gather is fixed-order, the scatter adds
//     float atomics.
// K14 `jitc_walk_todense` replaces _make_todense_kernel (:378, stride 32)
//     and _make_todense_mm_kernel (:925, stride 4): the same walk writing w
//     with plain stores (each (row, col) has one stream and one visit).
//
// The TPU's lockstep slot scan, sublane tiling and row packing are not
// carried over. Bound: the draws, not the bytes. A visit costs ~20 integer
// operations (plus Acklam's ~40 for the normal law) and a stream's setup
// ~2 rounds of 2 draws; the scatter adds one atomic per visit, the mat-mat
// reads a 128-byte operand row per visit and tile.
#include "common.cuh"
#include "light_rng.cuh"

namespace {

constexpr unsigned kFullMask = 0xffffffffu;

struct WalkGeom {
    uint32_t seed, cl;
    int n_rows, n_cols, chunk_size, stride, n_chunks;
    uint32_t row0;   // global id of local walk row 0
};

// The state and residual of stream (row, sub), sub = chunk * stride + lane.
__device__ __forceinline__ void stream_start(const WalkGeom& g,
                                             const uint32_t* state2,
                                             const uint32_t* q2, int row,
                                             int sub, uint32_t& state,
                                             uint32_t& q) {
    if (state2 != nullptr) {
        const long long s = static_cast<long long>(row) * g.n_chunks * g.stride
                            + sub;
        state = state2[s];
        q = q2[s];
    } else {
        lr_stream_init(g.seed, g.row0 + row, sub / g.stride, sub % g.stride,
                       g.cl, state, q);
    }
}

// Walk a stream of (chunk, lane) from its start (state, q), calling
// visit(col) for each of its columns.
template <typename Visit>
__device__ __forceinline__ void walk_from(const WalkGeom& g, uint32_t state,
                                          uint32_t q, uint32_t chunk,
                                          uint32_t lane, Visit visit) {
    const uint32_t start = chunk * g.chunk_size;
    const uint32_t rest = static_cast<uint32_t>(g.n_cols) - start;
    const uint32_t width = rest < static_cast<uint32_t>(g.chunk_size)
                               ? rest : static_cast<uint32_t>(g.chunk_size);
    const uint32_t stride = g.stride, bound = g.cl - 1u;
    for (uint32_t j = lane + stride * q; j < width; j = lane + stride * q) {
        visit(start + j);
        state = lr_next(state);
        q += 1u + lr_bounded(state, bound);
    }
}

// Walk stream (row, sub), calling visit(col) for each of its columns.
template <typename Visit>
__device__ __forceinline__ void walk_stream(const WalkGeom& g,
                                            const uint32_t* state2,
                                            const uint32_t* q2, int row,
                                            int sub, Visit visit) {
    uint32_t state, q;
    stream_start(g, state2, q2, row, sub, state, q);
    walk_from(g, state, q, sub / g.stride, sub % g.stride, visit);
}

__global__ void walk_setup_kernel(WalkGeom g, uint32_t* __restrict__ state2,
                                  uint32_t* __restrict__ q2) {
    const long long L = static_cast<long long>(g.n_chunks) * g.stride;
    const long long s = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
    if (s >= g.n_rows * L) return;
    const int row = static_cast<int>(s / L), sub = static_cast<int>(s % L);
    lr_stream_init(g.seed, g.row0 + row, sub / g.stride, sub % g.stride, g.cl,
                   state2[s], q2[s]);
}

template <int kLaw, int kOp>
__global__ void walk_mv_gather_kernel(WalkGeom g, const uint32_t* state2,
                                      const uint32_t* q2, const void* x,
                                      float a, float b,
                                      float* __restrict__ out) {
    const int lane = threadIdx.x & 31;
    const long long row =
        (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
    if (row >= g.n_rows) return;                // the whole warp leaves
    const int L = g.n_chunks * g.stride;
    float acc = 0.0f;
    for (int sub = lane; sub < L; sub += 32)
        walk_stream(g, state2, q2, static_cast<int>(row), sub,
                    [&](uint32_t col) {
                        acc += lr_weight<kLaw>(g.seed, g.row0 + row, col, a,
                                               b) *
                               be_load_op<kOp>(x, col);
                    });
    for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(kFullMask, acc, off);
    if (lane == 0) out[row] = acc;
}

template <int kLaw, int kOp>
__global__ void walk_mv_scatter_kernel(WalkGeom g, const uint32_t* state2,
                                       const uint32_t* q2, const void* x,
                                       float a, float b,
                                       float* __restrict__ out) {
    const long long L = static_cast<long long>(g.n_chunks) * g.stride;
    const long long s = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
    if (s >= g.n_rows * L) return;
    const int row = static_cast<int>(s / L), sub = static_cast<int>(s % L);
    const float v = be_load_op<kOp>(x, row);
    if (v == 0.0f) return;                      // before the first draw
    walk_stream(g, state2, q2, row, sub, [&](uint32_t col) {
        atomicAdd(out + col,
                  v * lr_weight<kLaw>(g.seed, g.row0 + row, col, a, b));
    });
}

// The event scatter (op 0 and 1: every active row's value is 1): a block
// reads kEventRows rows of x, a warp's 32 with one coalesced load and a
// ballot, compacts the active ones in shared memory, and its 16 warps
// share the (active row, chunk) pairs, a warp a pair with lane = the
// stream's lane in its chunk, so the plan reads are coalesced. Only the
// active rows' streams are set up and walked. (Of 32-128 rows and
// 128-512 threads a block, 64 and 512 were the fastest at 10% and 100%
// spiking on an H100, and within 10% of the fastest at 1%.)
constexpr int kEventRows = 64;
constexpr int kEventThreads = 512;

template <int kLaw, int kOp>
__global__ void __launch_bounds__(kEventThreads)
walk_mv_event_scatter_kernel(WalkGeom g, const uint32_t* state2,
                             const uint32_t* q2, const void* x, float a,
                             float b, float* __restrict__ out) {
    __shared__ int active[kEventRows];
    __shared__ int n_active;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (threadIdx.x == 0) n_active = 0;
    __syncthreads();
    if (warp < kEventRows / 32) {
        const int row = blockIdx.x * kEventRows + warp * 32 + lane;
        const bool on = row < g.n_rows && be_load_op<kOp>(x, row) != 0.0f;
        const unsigned m = __ballot_sync(kFullMask, on);
        int at = 0;
        if (lane == 0 && m != 0u) at = atomicAdd(&n_active, __popc(m));
        at = __shfl_sync(kFullMask, at, 0);
        if (on) active[at + __popc(m & ((1u << lane) - 1u))] = row;
    }
    __syncthreads();
    const int n_items = n_active * g.n_chunks;
    for (int i = warp; i < n_items; i += kEventThreads / 32) {
        const int row = active[i / g.n_chunks], chunk = i % g.n_chunks;
        for (int ln = lane; ln < g.stride; ln += 32) {
            uint32_t state, q;
            if (state2 != nullptr) {
                const long long s = (static_cast<long long>(row) *
                                     g.n_chunks + chunk) * g.stride + ln;
                state = state2[s];
                q = q2[s];
            } else {
                lr_stream_init(g.seed, g.row0 + row, chunk, ln, g.cl, state,
                               q);
            }
            walk_from(g, state, q, chunk, ln, [&](uint32_t col) {
                atomicAdd(out + col,
                          lr_weight<kLaw>(g.seed, g.row0 + row, col, a, b));
            });
        }
    }
}

// A warp per (row, tile of 32 operand columns); lane = column in the tile.
template <int kLaw, int kOp>
__global__ void walk_mm_kernel(WalkGeom g, const uint32_t* state2,
                               const uint32_t* q2, const void* B,
                               int n_batch, int corder, float a, float b,
                               float* __restrict__ out) {
    const int lane = threadIdx.x & 31;
    const long long warp =
        (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
    const int n_tiles = (n_batch + 31) / 32;
    if (warp >= static_cast<long long>(g.n_rows) * n_tiles) return;
    const int row = static_cast<int>(warp / n_tiles);
    const int col_b = static_cast<int>(warp % n_tiles) * 32 + lane;
    const bool in_tile = col_b < n_batch;
    const int L = g.n_chunks * g.stride;
    if (corder) {
        float acc = 0.0f;
        for (int sub = 0; sub < L; ++sub)
            walk_stream(g, state2, q2, row, sub, [&](uint32_t col) {
                const float w = lr_weight<kLaw>(g.seed, row, col, a, b);
                if (in_tile)
                    acc += w * be_load_op<kOp>(
                        B, static_cast<long long>(col) * n_batch + col_b);
            });
        if (in_tile) out[static_cast<long long>(row) * n_batch + col_b] = acc;
        return;
    }
    const float v = in_tile ? be_load_op<kOp>(
        B, static_cast<long long>(row) * n_batch + col_b) : 0.0f;
    if (__ballot_sync(kFullMask, v != 0.0f) == 0u) return;
    for (int sub = 0; sub < L; ++sub)
        walk_stream(g, state2, q2, row, sub, [&](uint32_t col) {
            const float w = lr_weight<kLaw>(g.seed, row, col, a, b);
            if (v != 0.0f)
                atomicAdd(out + static_cast<long long>(col) * n_batch + col_b,
                          w * v);
        });
}

template <int kLaw>
__global__ void walk_todense_kernel(WalkGeom g, const uint32_t* state2,
                                    const uint32_t* q2, int corder, int k,
                                    float a, float b,
                                    float* __restrict__ out) {
    const long long L = static_cast<long long>(g.n_chunks) * g.stride;
    const long long s = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
    if (s >= g.n_rows * L) return;
    const int row = static_cast<int>(s / L), sub = static_cast<int>(s % L);
    walk_stream(g, state2, q2, row, sub, [&](uint32_t col) {
        const long long at = corder
            ? static_cast<long long>(row) * k + col
            : static_cast<long long>(col) * k + row;
        out[at] = lr_weight<kLaw>(g.seed, row, col, a, b);
    });
}

WalkGeom geom(unsigned seed, unsigned cl, int n_rows, int n_cols,
              int chunk_size, int stride, unsigned row0 = 0) {
    return WalkGeom{seed, cl, n_rows, n_cols, chunk_size, stride,
                    (n_cols + chunk_size - 1) / chunk_size, row0};
}

int blocks_for(long long threads) {
    return static_cast<int>((threads + BE_BLOCK - 1) / BE_BLOCK);
}

}  // namespace

// Run the statement given last with K (law) and O (op) set from runtime
// values: law 0 scalar, 1 normal, 2 uniform; op as be_load_op.
#define JITC_CASE(K_, O_, law, op, ...)                                    \
    if ((law) == K_ && (op) == O_) {                                       \
        constexpr int K = K_, O = O_;                                      \
        __VA_ARGS__;                                                       \
    }
#define JITC_LAW_OP(law, op, ...)                                          \
    do {                                                                   \
        JITC_CASE(0, 0, law, op, __VA_ARGS__)                              \
        JITC_CASE(0, 1, law, op, __VA_ARGS__)                              \
        JITC_CASE(0, 2, law, op, __VA_ARGS__)                              \
        JITC_CASE(1, 0, law, op, __VA_ARGS__)                              \
        JITC_CASE(1, 1, law, op, __VA_ARGS__)                              \
        JITC_CASE(1, 2, law, op, __VA_ARGS__)                              \
        JITC_CASE(2, 0, law, op, __VA_ARGS__)                              \
        JITC_CASE(2, 1, law, op, __VA_ARGS__)                              \
        JITC_CASE(2, 2, law, op, __VA_ARGS__)                              \
    } while (0)

// state and q: (n_rows, n_chunks * stride) uint32, written in full; cl >= 2.
// The streams are those of the global rows [row0, row0 + n_rows).
BE_EXPORT int jitc_walk_setup_launch(unsigned seed, unsigned cl, int n_rows,
                                     int n_cols, int chunk_size, int stride,
                                     unsigned row0, unsigned* state,
                                     unsigned* q, int device, void* stream) {
    int err = be_begin(device);
    if (err) return err;
    const WalkGeom g = geom(seed, cl, n_rows, n_cols, chunk_size, stride,
                            row0);
    const long long n = static_cast<long long>(n_rows) * g.n_chunks * stride;
    if (n > 0)
        walk_setup_kernel<<<blocks_for(n), BE_BLOCK, 0,
                            static_cast<cudaStream_t>(stream)>>>(g, state, q);
    return be_end();
}

// state and q: a plan of the walk's layout, or both null (each stream
// draws its own setup). corder = 1: out (n_rows,) written in full, x
// (n_cols,); corder = 0: out (n_cols,) zeroed by the caller, x (n_rows,).
// The walk rows are the global rows [row0, row0 + n_rows).
BE_EXPORT int jitc_walk_mv_launch(const unsigned* state, const unsigned* q,
                                  const void* x, int op, int law, float a,
                                  float b, unsigned seed, unsigned cl,
                                  int n_rows, int n_cols, int chunk_size,
                                  int stride, int corder, unsigned row0,
                                  float* out, int device, void* stream) {
    int err = be_begin(device);
    if (err) return err;
    const WalkGeom g = geom(seed, cl, n_rows, n_cols, chunk_size, stride,
                            row0);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (n_rows <= 0) return be_end();
    if (corder) {
        JITC_LAW_OP(law, op,
                    walk_mv_gather_kernel<K, O>
                    <<<blocks_for(32LL * n_rows), BE_BLOCK, 0, st>>>(
                        g, state, q, x, a, b, out));
    } else if (op != 2) {
        const int blocks = (n_rows + kEventRows - 1) / kEventRows;
        JITC_LAW_OP(law, op,
                    walk_mv_event_scatter_kernel<K, O>
                    <<<blocks, kEventThreads, 0, st>>>(g, state, q, x, a, b,
                                                  out));
    } else {
        const long long n = static_cast<long long>(n_rows) * g.n_chunks *
                            stride;
        JITC_LAW_OP(law, op,
                    walk_mv_scatter_kernel<K, O>
                    <<<blocks_for(n), BE_BLOCK, 0, st>>>(g, state, q, x, a,
                                                         b, out));
    }
    return be_end();
}

// B (in_len, n_batch) row-major, in_len = n_cols (corder = 1) or n_rows.
// corder = 1: out (n_rows, n_batch) written in full; corder = 0: out
// (n_cols, n_batch) zeroed by the caller.
BE_EXPORT int jitc_walk_mm_launch(const unsigned* state, const unsigned* q,
                                  const void* B, int op, int law, float a,
                                  float b, unsigned seed, unsigned cl,
                                  int n_rows, int n_cols, int chunk_size,
                                  int stride, int corder, int n_batch,
                                  float* out, int device, void* stream) {
    int err = be_begin(device);
    if (err) return err;
    const WalkGeom g = geom(seed, cl, n_rows, n_cols, chunk_size, stride);
    if (n_rows <= 0 || n_batch <= 0) return be_end();
    const long long warps = static_cast<long long>(n_rows) *
                            ((n_batch + 31) / 32);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    JITC_LAW_OP(law, op,
                walk_mm_kernel<K, O><<<blocks_for(32 * warps), BE_BLOCK, 0,
                                       st>>>(g, state, q, B, n_batch, corder,
                                             a, b, out));
    return be_end();
}

// out: the logical (m, k) matrix, zeroed by the caller; the walk is (m, k)
// for corder = 1 and (k, m) for corder = 0.
BE_EXPORT int jitc_walk_todense_launch(const unsigned* state,
                                       const unsigned* q, int law, float a,
                                       float b, unsigned seed, unsigned cl,
                                       int n_rows, int n_cols,
                                       int chunk_size, int stride,
                                       int corder, int k, float* out,
                                       int device, void* stream) {
    int err = be_begin(device);
    if (err) return err;
    const WalkGeom g = geom(seed, cl, n_rows, n_cols, chunk_size, stride);
    const long long n = static_cast<long long>(n_rows) * g.n_chunks * stride;
    if (n <= 0) return be_end();
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    JITC_LAW_OP(law, 0,
                walk_todense_kernel<K><<<blocks_for(n), BE_BLOCK, 0, st>>>(
                    g, state, q, corder, k, a, b, out));
    return be_end();
}
