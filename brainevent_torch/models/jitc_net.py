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

"""EI LIF network over implicit (JITC) connectivity
(``brainevent_tpu.models.jitc_net``).

The "80k-neuron net on JITCNormalR/JITCUniformR" acceptance workload: the
EI dynamics of :class:`~.networks.EINet`, but both projections are JITC
matrices whose structure and weights regenerate from the seed in every
product. Each projection holds a :class:`~brainevent_torch.jitc.JITCWalkPlan`
built once at construction (K11), and a step propagates its spikes with
one K12 launch per projection in event scatter mode: only the streams of
the rows that spiked walk. The decays, the currents and the LIF update
are plain PyTorch ops.

A step is bitwise ``jax.jit(JITCNet.step)`` of the JAX package on the CPU
(scalar law; the other laws up to the weight draws, see
:mod:`brainevent_torch.rng.light`), with the multiply-adds XLA contracts
written as FMAs (``torch.addcmul``)::

    COBA current = fma(g_e*d_e, e_e - v, (g_i*d_i) * (e_i - v)) + inp
    CUBA current = fma(g_e, d_e, -(g_i * d_i)) + inp
    g'           = fma(g, d, inc)
"""

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..events.binary import BinaryArray
from ..jitc import JITCNormalR, JITCScalarR, JITCUniformR
from ..ops.core import check_device
from .neurons import LIFRefParams, LIFRefState, f32, lifref_init, lifref_step

__all__ = ['JITCNet', 'JITCNetState']


class JITCNetState(NamedTuple):
    neurons: LIFRefState
    g_e: torch.Tensor          # excitatory synaptic drive, (n,)
    g_i: torch.Tensor          # inhibitory synaptic drive, (n,)
    spike_count: torch.Tensor  # per-neuron cumulative spikes, int32


_WEIGHT_CLASSES = {
    'normal': JITCNormalR,
    'uniform': JITCUniformR,
    'scalar': JITCScalarR,
}


@dataclasses.dataclass
class JITCNet:
    """EI network with just-in-time regenerated connectivity.

    Parameters
    ----------
    scale : float
        ``n = 4000 * scale`` neurons (80% excitatory, 20% inhibitory);
        ~``n_conn`` incoming synapses per neuron from each population's
        fixed-probability implicit matrix.
    weight_law : {'normal', 'uniform', 'scalar'}
        Per-edge ``Normal(w, 0.1 w)``, per-edge ``Uniform(0.8 w, 1.2 w)``,
        or the homogeneous ``w``.
    coba : bool
        Conductance-based (COBA) vs current-based (CUBA) synapses.
    cap_divisor : int
        Accepted and ignored: the JAX package's event capacity; the port's
        event route has none.
    initial_state : optional :class:`JITCNetState`
        What :meth:`init_state` returns; drawn from ``seed + 1`` if absent.
    device : torch device, default the card (``'cuda'``)
        Where the plans and states live; ``'cpu'`` runs the twins.
    """
    scale: float = 1.0
    weight_law: str = 'normal'
    coba: bool = True
    dt: float = 0.1          # ms
    n_conn: int = 80         # expected in-degree per projection pair
    w_e: float = 0.6
    w_i: float = 6.7
    tau_e: float = 5.0       # ms
    tau_i: float = 10.0      # ms
    e_e: float = 0.0         # mV
    e_i: float = -80.0       # mV
    seed: int = 42
    cap_divisor: int = 128
    initial_state: Optional[JITCNetState] = dataclasses.field(
        default=None, repr=False)
    device: Optional[torch.device] = None

    def __post_init__(self):
        self.n_exc = int(3200 * self.scale)
        self.n_inh = int(800 * self.scale)
        self.num = self.n_exc + self.n_inh
        self.params = LIFRefParams()
        if self.weight_law not in _WEIGHT_CLASSES:
            raise ValueError(
                f"weight_law must be one of {sorted(_WEIGHT_CLASSES)}, "
                f"got {self.weight_law!r}")
        self.device = check_device(self.device or 'cuda')
        cls = _WEIGHT_CLASSES[self.weight_law]
        prob = min(1.0, self.n_conn / self.num)

        def make(n_pre, w, seed):
            if self.weight_law == 'normal':
                data = (w, 0.1 * w, prob, seed)
            elif self.weight_law == 'uniform':
                data = (0.8 * w, 1.2 * w, prob, seed)
            else:
                data = (w, prob, seed)
            # corder=True: spk @ M walks the presynaptic axis, the
            # direction of the event scatter
            return cls(data, shape=(n_pre, self.num), corder=True,
                       device=self.device)

        self.conn_e = make(self.n_exc, self.w_e, self.seed)
        self.conn_i = make(self.n_inh, self.w_i, self.seed + 1)
        # the stream setup is computed once, here (K11)
        self.plan_e = self.conn_e.build_walk_plan()
        self.plan_i = self.conn_i.build_walk_plan()
        if self.initial_state is not None:
            self.initial_state = _to(self.initial_state, self.device)
        self._decays = tuple(
            torch.full((), f32(math.exp(-self.dt / tau)), device=self.device)
            for tau in (self.tau_e, self.tau_i))

    # -- state -------------------------------------------------------------------

    def init_state(self, generator: Optional[torch.Generator] = None
                   ) -> JITCNetState:
        """The initial state given to the constructor, or one drawn from
        *generator* (default: a generator seeded with ``seed + 1``; not
        JAX's draw, see :func:`brainevent_torch.interop.jitc_net_from_arrays`)."""
        if generator is None and self.initial_state is not None:
            return self.initial_state
        if generator is None:
            generator = torch.Generator().manual_seed(self.seed + 1)
        neurons = lifref_init(generator, self.num, self.params,
                              device=self.device)
        zeros = torch.zeros(self.num, dtype=torch.float32, device=self.device)
        return JITCNetState(neurons=neurons, g_e=zeros, g_i=zeros.clone(),
                            spike_count=torch.zeros(self.num,
                                                    dtype=torch.int32,
                                                    device=self.device))

    # -- dynamics ----------------------------------------------------------------

    def _propagate(self, spike: torch.Tensor):
        """This step's spikes -> synaptic increments, through the walk
        plans (one K12 event scatter per projection)."""
        inc_e = BinaryArray(spike[:self.n_exc]) @ self.plan_e
        inc_i = BinaryArray(spike[self.n_exc:]) @ self.plan_i
        return inc_e, inc_i

    def step(self, state: JITCNetState, t, inp: float = 20.0) -> JITCNetState:
        """One dt step at time *t* (a float32 value): decay the synapses,
        update the membranes, then add this step's spikes' increments."""
        d_e, d_i = self._decays
        v = state.neurons.v
        if self.coba:
            current = torch.addcmul((state.g_i * d_i) * (f32(self.e_i) - v),
                                    state.g_e * d_e, f32(self.e_e) - v) + inp
        else:
            current = torch.addcmul(-(state.g_i * d_i), state.g_e,
                                    d_e) + inp
        neurons, spike = lifref_step(state.neurons, current, t, self.dt,
                                     self.params)
        inc_e, inc_i = self._propagate(spike)
        return JITCNetState(
            neurons=neurons,
            g_e=torch.addcmul(inc_e, state.g_e, d_e),
            g_i=torch.addcmul(inc_i, state.g_i, d_i),
            spike_count=state.spike_count + spike.to(torch.int32))

    def times(self, n_steps: int, start: int = 0) -> list:
        """Step times ``float32(i) * float32(dt)`` for ``start <= i <
        start + n_steps``."""
        return (np.arange(start, start + n_steps, dtype=np.float32)
                * np.float32(self.dt)).tolist()

    def run(self, n_steps: int, inp: float = 20.0,
            state: Optional[JITCNetState] = None) -> JITCNetState:
        """Run ``n_steps`` from *state* (default :meth:`init_state`)."""
        if state is None:
            state = self.init_state()
        for t in self.times(n_steps):
            state = self.step(state, t, inp)
        return state

    def firing_rate_hz(self, state: JITCNetState, n_steps: int
                       ) -> torch.Tensor:
        """Mean firing rate in Hz over the simulated window."""
        t_sec = n_steps * self.dt * 1e-3
        return state.spike_count.to(torch.float32).mean() / t_sec


def _to(state: JITCNetState, device) -> JITCNetState:
    return JITCNetState(
        neurons=LIFRefState(v=state.neurons.v.to(device),
                            t_last=state.neurons.t_last.to(device)),
        g_e=state.g_e.to(device), g_i=state.g_i.to(device),
        spike_count=state.spike_count.to(device))
