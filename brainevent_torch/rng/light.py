# Copyright 2026 The brainevent-tpu Authors.
#
# Licensed under the Apache License, Version 2.0 (the "License");
# you may not use this file except in compliance with the License.
# You may obtain a copy of the License at
#
#     http://www.apache.org/licenses/LICENSE-2.0
#
# Unless required by applicable law or agreed to in writing, software
# distributed under the License is distributed on an "AS IS" BASIS,
# WITHOUT WARRANTIES OR CONDITIONS OF ANY KIND, either express or implied.
# See the License for the specific language governing permissions and
# limitations under the License.
# ==============================================================================

"""light-RNG: the stateless connectivity sampler (``brainevent_tpu.rng.light``).

The implicit-connectivity matrices regenerate their structure and weights
from these draws on every product, so the draws are part of the sampled
matrix: every function here is bitwise the JAX package's. The CUDA kernels
hold the same functions in native ``uint32_t`` (``csrc/light_rng.cuh``).

PyTorch on the CPU has no uint32 shift, add or remainder, so this twin
works on int64 tensors that hold uint32 values, masked back to 32 bits
after each step that can leave them. Two products would overflow int64:

- ``x * C`` (a uint32 times a uint32 constant, modulo 2^32) is taken from
  16-bit limbs of ``x``: ``((x_hi * C) mod 2^16) * 2^16 + x_lo * C``,
  whose terms stay below 2^49;
- :func:`_mulhi32` (the high word of a 32 x 32-bit product) from 16-bit
  limbs of the second factor: ``(a * b_hi + (a * b_lo) >> 16) >> 16``,
  below 2^49 as well.

Every function takes ints or tensors (any integer dtype; int32 tensors are
read as uint32 bit patterns) and returns int64 tensors in ``[0, 2^32)``,
except the two float draws, which return float32.
"""

from typing import Tuple

import torch

__all__ = [
    'light_rng_mix32',
    'light_rng_bounded',
    'light_rng_next',
    'light_rng_init',
    'light_rng_uniform01',
    'light_rng_normal01',
    'light_rng_initial_q',
]

M32 = 0xFFFFFFFF
_ZERO_ESCAPE = 0x6D2B79F5


def _u32(x, device=None) -> torch.Tensor:
    """*x* as an int64 tensor of uint32 values."""
    return torch.as_tensor(x, device=device).to(torch.int64) & M32


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c`` modulo 2^32 for uint32 values *x* and a constant *c*."""
    return ((x & 0xFFFF) * c + (((x >> 16) * c) & 0xFFFF) * 65536) & M32


def _mulhi32(a, b) -> torch.Tensor:
    """High 32 bits of the 64-bit product of two uint32 values."""
    a, b = _u32(a), _u32(b)
    return (a * (b >> 16) + ((a * (b & 0xFFFF)) >> 16)) >> 16


def light_rng_mix32(x) -> torch.Tensor:
    """Finalizing bit-mixer."""
    x = _u32(x)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def light_rng_bounded(r, bound) -> torch.Tensor:
    """Map a uniform uint32 *r* into ``[0, bound)`` (the ``__umulhi``
    trick)."""
    return _mulhi32(r, bound)


def light_rng_next(state) -> torch.Tensor:
    """Advance xorshift32 streams; a zero state escapes to a constant."""
    x = _u32(state)
    x = x ^ ((x << 13) & M32)
    x = x ^ (x >> 17)
    x = x ^ ((x << 5) & M32)
    return torch.where(x == 0, _ZERO_ESCAPE, x)


def light_rng_init(seed, row, chunk_id, lane) -> torch.Tensor:
    """Seed one stream per ``(row, chunk_id, lane)`` (broadcasting)."""
    row = _u32(row)
    device = row.device
    x = _u32(seed, device) ^ 0xD1B54A35
    x = x ^ _mul32(row, 0x85EBCA6B)
    x = x ^ _mul32(_u32(chunk_id, device), 0xC2B2AE35)
    x = x ^ _mul32(_u32(lane, device), 0x27D4EB2D)
    x = light_rng_mix32(x)
    return torch.where(x == 0, _ZERO_ESCAPE, x)


def light_rng_uniform01(seed, row, col) -> torch.Tensor:
    """Stateless 24-bit uniform in [0, 1) per ``(seed, row, col)`` edge."""
    row = _u32(row)
    h = _u32(seed, row.device) ^ 0xA0761D65
    h = h ^ _mul32(row, 0xE7037ED1)
    h = h ^ _mul32(_u32(col, row.device), 0x8EBC6AF1)
    h = light_rng_mix32(h)
    # 24 bits convert exactly; the scale is a power of two
    return (h & 0x00FFFFFF).to(torch.float32) * (1.0 / 16777216.0)


# Acklam inverse-normal-CDF coefficients (float32), as the JAX package.
_A = (-39.696830, 220.94609, -275.92851, 138.35775, -30.664799, 2.5066283)
_B = (-54.476099, 161.58584, -155.69898, 66.801312, -13.280681, 1.0)
_C = (-0.007784894, -0.32239646, -2.4007583, -2.5497325, 4.3746641, 2.9381640)
_D = (0.007784696, 0.32246713, 2.4451342, 3.7544087, 1.0)


def _horner(coefs, x: torch.Tensor) -> torch.Tensor:
    """``((c0 x + c1) x + c2) ...`` with each step one FMA, as XLA on the
    CPU contracts it (``torch.addcmul`` rounds once)."""
    acc = torch.full_like(x, coefs[0])
    for c in coefs[1:]:
        acc = torch.addcmul(torch.full_like(x, c), acc, x)
    return acc


def _log(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x.double()).float()


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(x.double()).float()


def light_rng_normal01(seed, row, col) -> torch.Tensor:
    """Stateless standard-normal variate per ``(seed, row, col)`` edge
    (Acklam's inverse CDF of the 24-bit uniform), float32.

    The central branch is bitwise the JAX package's. The tails take
    ``log`` and ``sqrt`` in float64 and round to float32, which gives the
    float32 results the CUDA kernels compute (PyTorch's float32 ``log``
    on the CPU differs between its vector and scalar paths in the last
    bit, and its float32 ``sqrt`` is not correctly rounded). XLA's float32
    ``log`` differs from it in the last bit, so fewer than 2 in 1,000
    variates (all in the tails) differ from the JAX package's, by at most
    7 ulp of the variate (``tests/test_torch_jitc_rng.py``)."""
    u = light_rng_uniform01(seed, row, col)
    u = torch.clamp(u, 1e-10, 1.0 - 1e-10)
    lo_v = _sqrt(-2.0 * _log(torch.clamp(u, min=1e-30)))
    hi_v = _sqrt(-2.0 * _log(torch.clamp(1.0 - u, min=1e-30)))
    v = u - 0.5
    r = v * v
    central = _horner(_A, r) * v / _horner(_B, r)
    return torch.where(
        u < 0.02425, -(_horner(_C, lo_v) / _horner(_D, lo_v)),
        torch.where(u > 0.97575, _horner(_C, hi_v) / _horner(_D, hi_v),
                    central))


def light_rng_initial_q(state, cl) -> Tuple[torch.Tensor, torch.Tensor]:
    """Draw the stationary initial residual ``q`` of every stream.

    Rejection sampling, two draws per round for each pending stream
    (accept ``cand = bounded(s1, cl - 1)`` when ``bounded(s2, cl - 1) <
    cl - 1 - cand``); a stream's state advances to ``s2`` each round it
    was pending. Each round works on the pending streams only, which
    gives the JAX package's lockstep result stream for stream.

    Returns ``(q, state)``, int64 tensors shaped like *state*; *cl* is an
    int or a tensor broadcastable to it.
    """
    state = _u32(state)
    shape = state.shape
    state = state.reshape(-1).clone()
    n = torch.broadcast_to((_u32(cl, state.device) - 1) & M32,
                        shape).reshape(-1)
    q = torch.zeros_like(state)
    idx = torch.arange(state.numel(), device=state.device)
    st, nn = state, n
    while idx.numel():
        st1 = light_rng_next(st)
        cand = _mulhi32(st1, nn)
        st2 = light_rng_next(st1)
        accept = _mulhi32(st2, nn) < ((nn - cand) & M32)
        state[idx] = st2
        q[idx[accept]] = cand[accept]
        keep = ~accept
        idx, st, nn = idx[keep], st2[keep], nn[keep]
    return q.reshape(shape), state.reshape(shape)
