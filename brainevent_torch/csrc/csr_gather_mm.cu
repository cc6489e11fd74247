// Copyright 2026 The brainevent-tpu Authors.
// Licensed under the Apache License, Version 2.0.
//
// K10 `csr_gather_mm` (brainevent_torch/ops/mxu_gather.py) replaces
// brainevent_tpu/ops/mxu_gather.py:_make_mm_kernel (:854, `gather_matmat`):
//     Y[r, :] = sum over j in [ptr[r], ptr[r+1]) of w[slot(j)] * op(X[col[j], :])
// over an int32 row index (ptr, col), weights w of shape (1,) or one per
// entry (float32, or float64 in the double instances), an optional slot
// permutation perm (w[perm[j]]), and a row-major operand X (n_x, B) whose
// values pass through the op of be_load_op_t (common.cuh: the event gate
// of a binary product, or the identity). It serves csrmm and binary_csrmm
// on a CSR matrix's own arrays, their transposed direction over the CSC
// mirror (perm maps a mirror slot to its CSR weight), and gather_matmat
// over a gather plan's row index (row_ptr, row_cols, row_slots into the
// plan-ordered weights).
//
// Exactness: each element of Y adds its row's entries in their stored
// order, one rounding for the multiply and one for the add, no atomics:
// the same bits on every run, and the bits of the stored-order plain sum
// (csr_gather_mm_ordered). Homogeneous binary products sum 0/1 gates
// (exact integers) and scale once by w[0]. Column ids outside [0, n_x)
// are dropped. So the work is split over rows and columns of Y, never
// over a row's entries.
//
// Layout. A lane holds a piece of 4 columns of one row of Y. Two layouts,
// one for each width a measured workload runs: for B <= 16 a row takes a
// group of 4 lanes and a warp takes 8 rows (the CSR slice's B = 16, no
// lane idle; narrower B idles the lanes past its last piece); wider B
// takes the whole warp with two pieces a lane (the csrmm cell's B = 256
// in one pass; B <= 128 idles lanes), and more 256-column tiles above
// B = 256. Where
// B % 4 == 0 and X is 16-byte aligned, a piece is one 16-byte load (two
// for double, 4 bytes for a bool operand), else four scalar loads. The
// group reads a batch of its row's (column, weight) pairs, one lane an
// entry, and passes them round with shuffles, so a pair is read once per
// tile; then, 16 entries at a time (4 at two pieces a lane, half that for
// double), it issues the X loads of all of them before it adds them in
// order. X, col, w and perm go through the read-only path (__ldg). Blocks
// are 2 warps. (Chosen on an H100 among 8-32 entries in flight, 64-256
// threads a block and reading the next round's pairs ahead: 32 in flight
// spilled; with 16 in flight a 256-thread block fills an SM's registers,
// so the B = 16 grid's 157 such blocks ran in two waves; reading ahead
// gained under 1%.)
//
// The transposed direction keeps perm, a random 4-byte weight read per
// entry: the CSR slice changes its weights every step (STDP), so a
// mirror-ordered weight copy would cost a full gather of the weights per
// step.
//
// The TPU kernel reaches the rows of X through one-hot MXU contractions
// with bf16 splits and a VMEM-resident copy of X, because a TPU has no
// gather; none of that is needed here, and no width of X is too wide.
//
// Bound: the reads of X rows, 4 * B bytes per entry (at 1M entries and
// B = 256, 1 GB per call, mostly from L2, since X is 10 MB there); the
// HBM bound counts X, the index and Y once.
#include "common.cuh"

#include <cstdint>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
// Threads a block: small blocks spread a grid of few warps (the 1,250 of a
// 10k-row product at B = 16) evenly over the 132 SMs.
constexpr int kMmBlock = 64;

// The values op(X[off + k]), k < 4, as T; n_valid of them are read (the
// rest are 0). vec: one load of the whole piece where all four are valid
// (off % 4 == 0, X 16-byte aligned).
template <int kOp, typename T>
__device__ __forceinline__ void load_piece(const void* X, long long off,
                                           int n_valid, bool vec, T (&v)[4]) {
    if (vec && n_valid == 4) {
        if constexpr (kOp == 0) {
            const unsigned u = __ldg(reinterpret_cast<const unsigned*>(
                static_cast<const unsigned char*>(X) + off));
#pragma unroll
            for (int k = 0; k < 4; ++k)
                v[k] = (u >> (8 * k)) & 0xffu ? T(1) : T(0);
        } else if constexpr (kOp == 1 || sizeof(T) == 4) {
            const float4 f = __ldg(reinterpret_cast<const float4*>(
                static_cast<const float*>(X) + off));
            const float f4[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
            for (int k = 0; k < 4; ++k)
                v[k] = kOp == 1 ? (f4[k] > 0.0f ? T(1) : T(0)) : T(f4[k]);
        } else {
            const double* p = static_cast<const double*>(X) + off;
            const double2 a = __ldg(reinterpret_cast<const double2*>(p));
            const double2 b = __ldg(reinterpret_cast<const double2*>(p + 2));
            v[0] = T(a.x);
            v[1] = T(a.y);
            v[2] = T(b.x);
            v[3] = T(b.y);
        }
        return;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        v[k] = T(0);
        if (k < n_valid) {
            if constexpr (kOp == 0)
                v[k] = __ldg(static_cast<const unsigned char*>(X) + off + k)
                           ? T(1) : T(0);
            else if constexpr (kOp == 1)
                v[k] = __ldg(static_cast<const float*>(X) + off + k) > 0.0f
                           ? T(1) : T(0);
            else
                v[k] = __ldg(static_cast<const T*>(X) + off + k);
        }
    }
}

template <typename T>
__device__ __forceinline__ void store_piece(T* Y, long long off, int n_valid,
                                            bool vec, const T (&v)[4]) {
    if (vec && n_valid == 4) {
        if constexpr (sizeof(T) == 4) {
            *reinterpret_cast<float4*>(Y + off) =
                make_float4(v[0], v[1], v[2], v[3]);
        } else {
            reinterpret_cast<double2*>(Y + off)[0] = make_double2(v[0], v[1]);
            reinterpret_cast<double2*>(Y + off)[1] = make_double2(v[2], v[3]);
        }
        return;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
        if (k < n_valid) Y[off + k] = v[k];
}

// kG lanes a row (a power of two), kP pieces a lane; a tile of Y's
// columns is kG * kP pieces.
template <int kG, int kP, int kOp, bool kHomo, bool kPerm, typename T>
__global__ void __launch_bounds__(kMmBlock)
csr_gather_mm_kernel(const int* __restrict__ ptr, const int* __restrict__ col,
                     const int* __restrict__ perm, const T* __restrict__ w,
                     const void* __restrict__ X, const int n_rows,
                     const int n_x, const int B, const int n_tiles,
                     const bool vec, T* __restrict__ Y) {
    constexpr bool kCount = kHomo && kOp != 2;
    constexpr int kSlots = 32 / kG < 8 ? 32 / kG : 8;  // pairs a lane holds
    constexpr int kBatch = kG * kSlots;                // entries a round
    // entries whose X loads are in flight at once (half for double)
    constexpr int kAhead0 = (kP == 1 ? 16 : 4) / (sizeof(T) / 4);
    constexpr int kAhead = kAhead0 < kBatch ? kAhead0 : kBatch;
    static_assert(kBatch % kAhead == 0, "a round is whole steps");
    const int lane = threadIdx.x & 31;
    const int sub = lane & (kG - 1);
    const unsigned gmask = kG == 32
        ? kFullMask : ((1u << kG) - 1u) << (lane & ~(kG - 1));
    const long long item =
        ((static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >>
         5) * (32 / kG) + lane / kG;
    if (item >= static_cast<long long>(n_rows) * n_tiles) return;  // group
    const long long row = item / n_tiles;
    const int piece0 = static_cast<int>(item % n_tiles) * (kG * kP) + sub;
    int c0[kP], nv[kP];
#pragma unroll
    for (int p = 0; p < kP; ++p) {
        c0[p] = (piece0 + kG * p) * 4;
        nv[p] = B - c0[p] < 4 ? (B - c0[p] > 0 ? B - c0[p] : 0) : 4;
    }
    const int begin = __ldg(ptr + row);
    const int end = __ldg(ptr + row + 1);
    T acc[kP][4];
#pragma unroll
    for (int p = 0; p < kP; ++p)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[p][k] = T(0);
    for (int base = begin; base < end; base += kBatch) {
        int cs[kSlots];
        T ws[kSlots];
#pragma unroll
        for (int s = 0; s < kSlots; ++s) {
            const int j = base + sub + kG * s;
            cs[s] = -1;
            ws[s] = T(0);
            if (j < end) {
                const unsigned cj = static_cast<unsigned>(__ldg(col + j));
                if (cj < static_cast<unsigned>(n_x)) {
                    cs[s] = static_cast<int>(cj);
                    if (!kCount)
                        ws[s] = __ldg(w + (kHomo ? 0
                                           : (kPerm ? __ldg(perm + j) : j)));
                }
            }
        }
#pragma unroll
        for (int t0 = 0; t0 < kBatch; t0 += kAhead) {
            if (base + t0 >= end) break;        // the same on the group
            int ct[kAhead];
            T wt[kAhead];
            T xv[kAhead][kP][4];
#pragma unroll
            for (int u = 0; u < kAhead; ++u) {
                const int t = t0 + u;
                ct[u] = __shfl_sync(gmask, cs[t / kG], t % kG, kG);
                wt[u] = kCount ? T(0)
                               : __shfl_sync(gmask, ws[t / kG], t % kG, kG);
                const long long off = static_cast<long long>(ct[u]) * B;
#pragma unroll
                for (int p = 0; p < kP; ++p)
                    load_piece<kOp, T>(X, off + c0[p],
                                       ct[u] >= 0 ? nv[p] : 0, vec,
                                       xv[u][p]);
            }
#pragma unroll
            for (int u = 0; u < kAhead; ++u) {   // in stored order
                if (ct[u] < 0) continue;
#pragma unroll
                for (int p = 0; p < kP; ++p)
#pragma unroll
                    for (int k = 0; k < 4; ++k) {
                        const T xk = xv[u][p][k];
                        if (kCount)
                            acc[p][k] += xk;
                        else if (kOp != 2)
                            acc[p][k] += xk != T(0) ? wt[u] : T(0);
                        else
                            acc[p][k] += wt[u] * xk;
                    }
            }
        }
    }
    const T scale = kCount ? __ldg(w) : T(1);
#pragma unroll
    for (int p = 0; p < kP; ++p) {
        if (kCount)
#pragma unroll
            for (int k = 0; k < 4; ++k) acc[p][k] *= scale;
        store_piece<T>(Y, row * B + c0[p], nv[p], vec, acc[p]);
    }
}

template <int kG, int kP, int kOp, bool kHomo, bool kPerm, typename T>
void launch_layout(const int* ptr, const int* col, const int* perm,
                   const T* w, const void* X, int n_rows, int n_x, int B,
                   bool vec, T* Y, cudaStream_t st) {
    const int pieces = (B + 3) / 4;
    const int n_tiles = (pieces + kG * kP - 1) / (kG * kP);
    const long long items = static_cast<long long>(n_rows) * n_tiles;
    const long long warps = (items + 32 / kG - 1) / (32 / kG);
    const long long blocks = (warps * 32 + kMmBlock - 1) / kMmBlock;
    csr_gather_mm_kernel<kG, kP, kOp, kHomo, kPerm, T>
        <<<static_cast<unsigned>(blocks), kMmBlock, 0, st>>>(
            ptr, col, perm, w, X, n_rows, n_x, B, n_tiles, vec, Y);
}

// The layout for width B: 4 lanes a row up to B = 16, else the whole warp
// with two pieces a lane.
template <int kOp, bool kHomo, bool kPerm, typename T>
void launch(const int* ptr, const int* col, const int* perm, const T* w,
            const void* X, int n_rows, int n_x, int B, bool vec, T* Y,
            cudaStream_t st) {
    if (B <= 16)
        launch_layout<4, 1, kOp, kHomo, kPerm, T>(ptr, col, perm, w, X,
                                                  n_rows, n_x, B, vec, Y, st);
    else
        launch_layout<32, 2, kOp, kHomo, kPerm, T>(ptr, col, perm, w, X,
                                                   n_rows, n_x, B, vec, Y, st);
}

}  // namespace

// op: 0 bool X (one byte per value), 1 float32 X gated at > 0, 2 float X
// in the value type. dbl: w, Y (and X for op 2) are float64, else float32.
// perm may be null; it is not read for homogeneous weights. Y (n_rows, B)
// is written in full. The 16-byte pieces are taken where B % 4 == 0 and X
// is 16-byte aligned.
BE_EXPORT int csr_gather_mm_launch(const int* ptr, const int* col,
                                   const int* perm, const void* w,
                                   const void* X, int op, int homo, int dbl,
                                   int n_rows, int n_x, int B, void* Y,
                                   int device, void* stream) {
    int err = be_begin(device);
    if (err) return err;
    if (n_rows <= 0 || B <= 0) return be_end();
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const bool vec = B % 4 == 0 &&
                     reinterpret_cast<std::uintptr_t>(X) % 16 == 0;
    BE_VALUE_DISPATCH(dbl, BE_CSR_DISPATCH(op, homo, perm,
        launch<O, H, P, T>(ptr, col, perm, static_cast<const T*>(w), X,
                           n_rows, n_x, B, vec, static_cast<T*>(Y), st)));
    return be_end();
}
