// Copyright 2026 The brainevent-tpu Authors.
// Licensed under the Apache License, Version 2.0.
//
// Shared declarations of the brainevent_torch CUDA kernels.
//
// The kernels are built by nvcc into one shared library with a plain C
// interface (brainevent_torch/ops/cuda_build.py) and called through ctypes.
// Each C entry point selects the device, launches on the stream it is
// given, allocates nothing and does not synchronise. It returns
// cudaGetLastError() so that the Python wrapper can raise on a refused
// launch.
#pragma once

#include <cuda_runtime.h>

#define BE_EXPORT extern "C" __attribute__((visibility("default")))

// Scalars of one EI network, each already rounded to float32 on the host
// (brainevent_torch.models.networks.StepParams builds the same struct with
// ctypes; keep the two layouts equal).
struct EINetParams {
    float decay_e;   // float32(exp(-dt / tau_e))
    float decay_i;   // float32(exp(-dt / tau_i))
    float w_e;       // excitatory weight
    float w_i;       // inhibitory weight
    float e_e;       // COBA reversal potentials
    float e_i;
    float inp;       // constant drive
    float v_rest;
    float v_th;
    float v_reset;
    float tau_ref;
    float dt_tau;    // float32(dt / tau)
    float r;         // membrane resistance
    int num;         // neurons
    int coba;        // 1: conductance-based, 0: current-based
};

// Threads per block of the elementwise kernels.
constexpr int BE_BLOCK = 256;
// Upper bound on the blocks of the grid-stride kernels: four per SM of an
// H100 (132 SMs).
constexpr int BE_MAX_BLOCKS = 4 * 132;

// The op a CSR kernel applies to each operand value it reads
// (brainevent_torch/ops/operand.py): 0 the event gate of a bool operand
// (one byte per value), 1 the event gate of a float operand (> 0),
// 2 the identity of a float product.
template <int kOp>
__device__ __forceinline__ float be_load_op(const void* x, long long i) {
    if (kOp == 0) return static_cast<const unsigned char*>(x)[i] ? 1.0f : 0.0f;
    const float v = static_cast<const float*>(x)[i];
    if (kOp == 1) return v > 0.0f ? 1.0f : 0.0f;
    return v;
}

// be_load_op in the value type T of a kernel's instance (float, or double
// for float64 weights): an event gate reads bool bytes or float32 spikes
// (the entries bring spikes of any other dtype to a bool gate), the
// identity of a float product reads T.
template <int kOp, typename T>
__device__ __forceinline__ T be_load_op_t(const void* x, long long i) {
    if (kOp == 0) return static_cast<const unsigned char*>(x)[i] ? T(1) : T(0);
    if (kOp == 1) return static_cast<const float*>(x)[i] > 0.0f ? T(1) : T(0);
    return static_cast<const T*>(x)[i];
}

// One rounding of a * b + c in the value type.
__device__ __forceinline__ float be_fma(float a, float b, float c) {
    return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double be_fma(double a, double b, double c) {
    return __fma_rn(a, b, c);
}

// Run the statement given last with T the value type: double where dbl is
// set (float64 weights), else float.
#define BE_VALUE_DISPATCH(dbl, ...)                                        \
    do {                                                                   \
        if (dbl) {                                                         \
            using T = double;                                              \
            __VA_ARGS__;                                                   \
        } else {                                                           \
            using T = float;                                               \
            __VA_ARGS__;                                                   \
        }                                                                  \
    } while (0)

// The other event gate: an entry is an event where it is non-zero (a bool
// byte that is set, or a float != 0, NaN and negatives included). The dense
// STDP updates (K17) and the event encoders (K18) gate so; the products
// gate at > 0 (be_load_op).
template <bool kBool>
__device__ __forceinline__ float be_load_nonzero(const void* x, long long i) {
    if (kBool) return static_cast<const unsigned char*>(x)[i] ? 1.0f : 0.0f;
    return static_cast<const float*>(x)[i] != 0.0f ? 1.0f : 0.0f;
}

// Run the statement given last with the kernel template arguments O (op),
// H (homogeneous) and P (permuted slots) set from runtime flags: the nine
// instances of a CSR kernel (a homogeneous weight reads no permutation).
#define BE_CSR_DISPATCH(op, homo, perm, ...)                               \
    do {                                                                   \
        const bool be_h = (homo) != 0, be_p = (perm) != nullptr && !be_h;  \
        BE_CSR_CASE(0, true, false, op, be_h, be_p, __VA_ARGS__)           \
        BE_CSR_CASE(0, false, false, op, be_h, be_p, __VA_ARGS__)          \
        BE_CSR_CASE(0, false, true, op, be_h, be_p, __VA_ARGS__)           \
        BE_CSR_CASE(1, true, false, op, be_h, be_p, __VA_ARGS__)           \
        BE_CSR_CASE(1, false, false, op, be_h, be_p, __VA_ARGS__)          \
        BE_CSR_CASE(1, false, true, op, be_h, be_p, __VA_ARGS__)           \
        BE_CSR_CASE(2, true, false, op, be_h, be_p, __VA_ARGS__)           \
        BE_CSR_CASE(2, false, false, op, be_h, be_p, __VA_ARGS__)          \
        BE_CSR_CASE(2, false, true, op, be_h, be_p, __VA_ARGS__)           \
    } while (0)
#define BE_CSR_CASE(O_, H_, P_, op, h, p, ...)                             \
    if ((op) == O_ && (h) == H_ && (p) == P_) {                           \
        constexpr int O = O_;                                              \
        constexpr bool H = H_, P = P_;                                     \
        __VA_ARGS__;                                                       \
    }

static inline int be_begin(int device) {
    cudaError_t err = cudaSetDevice(device);
    return static_cast<int>(err);
}

static inline int be_end() {
    return static_cast<int>(cudaGetLastError());
}

// The result of a cooperative launch: a refusal (a grid too large to be
// co-resident) is returned and cleared, so that the next launch's
// cudaGetLastError() does not report it again.
static inline int be_refused(int err) {
    if (err) {
        cudaGetLastError();
        return err;
    }
    return be_end();
}

// Blocks of `threads` threads of `kernel` that can be co-resident on the
// device: the largest grid a cooperative launch of it takes.
static inline int be_coresident_blocks(const void* kernel, int threads,
                                       int device, int* blocks) {
    int per_sm = 0, sms = 0;
    int err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, threads, 0));
    if (err) return err;
    err = static_cast<int>(
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device));
    if (err) return err;
    *blocks = per_sm * sms;
    return 0;
}
