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

static inline int be_begin(int device) {
    cudaError_t err = cudaSetDevice(device);
    return static_cast<int>(err);
}

static inline int be_end() {
    return static_cast<int>(cudaGetLastError());
}
