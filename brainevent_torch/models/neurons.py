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

"""Leaky integrate-and-fire neurons, as plain functions on tensors.

Counterpart of ``brainevent_tpu.models.neurons``. Units: voltages in mV,
times in ms.

Exactness against the JAX package: ``jax.jit`` on the CPU contracts the
membrane update ``v + X * (dt/tau)`` into one FMA, ``fma(X, dt/tau, v)``.
:func:`lifref_step` writes that FMA out as ``torch.addcmul`` (one rounding),
so that the two packages agree bit for bit. The time ``t`` should be a
float32 value (``float32(i) * float32(dt)``): the refractory test
``(t - t_last) < tau_ref`` flips on its last bit.
"""

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

__all__ = ['LIFRefParams', 'LIFRefState', 'lifref_init', 'lifref_step',
           'surrogate_spike']


@dataclasses.dataclass(frozen=True)
class LIFRefParams:
    """Leaky integrate-and-fire with an absolute refractory period:
    ``tau dV/dt = (V_rest - V) + R*I``, spike at ``V >= V_th``, reset to
    ``V_reset``, hold for ``tau_ref``."""
    v_rest: float = -60.0      # mV
    v_th: float = -50.0        # mV
    v_reset: float = -60.0     # mV
    tau: float = 20.0          # ms
    tau_ref: float = 5.0       # ms
    r: float = 1.0             # membrane resistance


class LIFRefState(NamedTuple):
    """Neuron state: membrane potential and time of the last spike."""
    v: torch.Tensor            # (n,) mV
    t_last: torch.Tensor       # (n,) ms; -1e7 before any spike


def f32(x: float) -> float:
    """*x* rounded to float32, as a Python float."""
    return float(np.float32(x))


def lifref_init(generator: Optional[torch.Generator], n: int,
                params: LIFRefParams, v_mean: float = -55.0,
                v_std: float = 2.0, dtype=torch.float32,
                device=None) -> LIFRefState:
    """Membrane potentials ~ N(v_mean, v_std); no neuron has spiked yet.

    The draw is made on the CPU with *generator* (a ``torch.Generator``),
    then moved to *device*. It is not JAX's draw: to share a state with
    the JAX package, use :func:`brainevent_torch.interop.einet_from_arrays`.
    """
    v = v_mean + v_std * torch.randn(n, generator=generator, dtype=dtype)
    t_last = torch.full((n,), -1e7, dtype=dtype)
    return LIFRefState(v=v.to(device), t_last=t_last.to(device))


def lifref_step(state: LIFRefState, current: torch.Tensor, t, dt: float,
                params: LIFRefParams):
    """One Euler step; returns ``(new_state, spikes)``.

    Neurons in their refractory window hold their potential; spikes are the
    boolean threshold crossings of this step.
    """
    p = params
    v = state.v
    t = torch.as_tensor(t, dtype=v.dtype, device=v.device)
    refractory = (t - state.t_last) < p.tau_ref
    x = (p.v_rest - v) + p.r * current
    dt_tau = torch.tensor(f32(dt / p.tau), dtype=v.dtype, device=v.device)
    v = torch.where(refractory, v, torch.addcmul(v, x, dt_tau))
    spike = v >= p.v_th
    v = torch.where(spike, p.v_reset, v)
    t_last = torch.where(spike, t, state.t_last)
    return LIFRefState(v=v, t_last=t_last), spike


class _SurrogateSpike(torch.autograd.Function):
    alpha = 4.0

    @staticmethod
    def forward(ctx, v_minus_th):
        ctx.save_for_backward(v_minus_th)
        return (v_minus_th >= 0).to(v_minus_th.dtype)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        a = _SurrogateSpike.alpha
        sg = torch.sigmoid(a * x)
        return a * sg * (1 - sg) * grad


def surrogate_spike(v_minus_th: torch.Tensor) -> torch.Tensor:
    """Heaviside spike with a sigmoid surrogate gradient.

    Forward: ``1.0`` where the membrane crosses threshold. Backward: the
    derivative of ``sigmoid(4 x)``, as the JAX package's custom JVP.
    """
    return _SurrogateSpike.apply(v_minus_th)
