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

"""EI (excitatory/inhibitory) LIF networks: the CUBA and COBA benchmarks.

Counterpart of ``brainevent_tpu.models.networks``: 80% excitatory and 20%
inhibitory LIF neurons, ``n_conn`` random targets per neuron, exponential
synapses, current-based (CUBA, Vogels & Abbott 2005) or conductance-based
(COBA, Brette et al. 2007) coupling, stepped at dt = 0.1 ms.

Two formulations of one step, bitwise equal to each other and to
``brainevent_tpu``'s ``EINet.step`` under ``jax.jit`` on the CPU:

- :meth:`EINet.step` on CPU tensors is the JAX package's structure:
  :func:`lifref_step`, then :meth:`EINet._propagate` (compact the spikes,
  scatter 0/1 hits on two channels, scale by the weights).
- :meth:`EINet.run` (and :meth:`EINet.step` on a CUDA tensor) runs two ops
  per step: :data:`einet_step` (kernel K1, ``csrc/einet_step.cu``) and
  :data:`brainevent_torch.ops.scatter.event_count_scatter` (kernel K2). On
  the CPU each runs its plain PyTorch twin; on a CUDA device each launches
  its kernel, on the current stream, with no host sync inside the loop.

Where XLA contracts multiply-adds into FMAs, both formulations write the
FMA out (``torch.addcmul`` here, ``__fmaf_rn`` in K1)::

    g'   = fma(g, decay, w * count)
    COBA current = fma(g_e*d_e, e_e - v, (g_i*d_i) * (e_i - v)) + inp
    CUBA current = fma(g_e, d_e, -(g_i * d_i)) + inp
    v'   = fma((v_rest - v) + r*current, dt/tau, v)       (lifref_step)

Constants are float32 values computed in Python (``decay = float32(exp(-dt
/ tau))``), and the step time is ``float32(i) * float32(dt)``.
"""

import ctypes
import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops import cuda_build
from ..ops.core import KernelOp, check_cuda_tensors, check_device, cuda_stream
from ..ops.scatter import event_count_scatter, event_scatter_add_multi
from .neurons import LIFRefParams, LIFRefState, f32, lifref_init, lifref_step

__all__ = ['EINet', 'EINetState', 'EINetParams', 'einet_step',
           'einet_step_twin']


class EINetState(NamedTuple):
    neurons: LIFRefState
    g_e: torch.Tensor          # excitatory conductance/current, (n,)
    g_i: torch.Tensor          # inhibitory conductance/current, (n,)
    spike_count: torch.Tensor  # per-neuron cumulative spikes, int32


class EINetParams(ctypes.Structure):
    """The scalars of one network and drive, rounded to float32; the same
    layout as ``struct EINetParams`` in ``csrc/common.cuh``."""
    _fields_ = [(name, ctypes.c_float) for name in (
        'decay_e', 'decay_i', 'w_e', 'w_i', 'e_e', 'e_i', 'inp', 'v_rest',
        'v_th', 'v_reset', 'tau_ref', 'dt_tau', 'r')] + [
        ('num', ctypes.c_int), ('coba', ctypes.c_int)]


# -- K1: one neuron step ---------------------------------------------------------

def einet_step_twin(v, t_last, g_e, g_i, counts, spike_count, ids, n_ids,
                    p: EINetParams, t: float, parity: int, fold: bool,
                    step: bool) -> None:
    """Plain PyTorch twin of kernel K1, in place.

    ``fold``: ``g = fma(g, decay, w * counts)`` and zero ``counts`` (the
    previous step's hits). ``step``: clear the spike list of the other
    parity, decay, compute the current, run the LIF update at time ``t``,
    and append the ids of this step's spikes to ``ids`` behind
    ``n_ids[parity]``.
    """
    def c(x):
        return torch.tensor(x, dtype=torch.float32, device=v.device)

    if fold:
        g_e.copy_(torch.addcmul(p.w_e * counts[0].float(), g_e, c(p.decay_e)))
        g_i.copy_(torch.addcmul(p.w_i * counts[1].float(), g_i, c(p.decay_i)))
        counts.zero_()
    if not step:
        return
    n_ids[parity ^ 1] = 0
    if p.coba:
        current = torch.addcmul((g_i * p.decay_i) * (p.e_i - v),
                                g_e * p.decay_e, p.e_e - v) + p.inp
    else:
        current = torch.addcmul(-(g_i * p.decay_i), g_e, c(p.decay_e)) + p.inp
    t = c(t)
    refractory = (t - t_last) < p.tau_ref
    x = (p.v_rest - v) + p.r * current
    vn = torch.where(refractory, v, torch.addcmul(v, x, c(p.dt_tau)))
    spike = vn >= p.v_th
    v.copy_(torch.where(spike, p.v_reset, vn))
    t_last.copy_(torch.where(spike, t, t_last))
    spike_count.add_(spike.to(torch.int32))
    new = torch.nonzero(spike).flatten().to(torch.int32)
    base = int(n_ids[parity])
    ids[base:base + new.numel()] = new
    n_ids[parity] += new.numel()


def _einet_step_cuda(op, v, t_last, g_e, g_i, counts, spike_count, ids,
                     n_ids, p, t, parity, fold, step):
    f, i = torch.float32, torch.int32
    device = check_cuda_tensors(op.name, (v, f), (t_last, f), (g_e, f),
                                (g_i, f), (counts, i), (spike_count, i),
                                (ids, i), (n_ids, i))
    num = p.num
    if (v.shape != (num,) or counts.shape != (2, num) or ids.shape != (num,)
            or n_ids.shape != (2,)):
        raise ValueError(f'{op.name}: state shapes do not match num={num}')
    fn = cuda_build.function('einet_step_launch', [ctypes.c_void_p] * 8 + [
        ctypes.POINTER(EINetParams), ctypes.c_float, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    op.launch(fn, v.data_ptr(), t_last.data_ptr(), g_e.data_ptr(),
              g_i.data_ptr(), counts.data_ptr(), spike_count.data_ptr(),
              ids.data_ptr(), n_ids.data_ptr(), ctypes.byref(p), t,
              parity, int(fold), int(step), device.index or 0,
              cuda_stream(device))


einet_step = KernelOp(
    'einet_step', twin=einet_step_twin, cuda=_einet_step_cuda,
    source='brainevent_torch/csrc/einet_step.cu',
    replaces='brainevent_tpu/models/pallas_sim.py:639')


# -- the network -------------------------------------------------------------------

@dataclasses.dataclass
class EINet:
    """EI network with fixed-number random connectivity.

    Parameters
    ----------
    scale : float
        ``n = 4000 * scale`` neurons (3200*scale excitatory, 800*scale
        inhibitory), ``n_conn`` outgoing synapses each.
    coba : bool
        Conductance-based (COBA) vs current-based (CUBA) synapses.
    conn_all : optional ``(num, n_conn)`` int array
        Target table, excitatory rows first. Drawn from
        ``torch.Generator().manual_seed(seed)`` when not given (not JAX's
        draw; use :mod:`brainevent_torch.interop` to share one).
    initial_state : optional :class:`EINetState`
        What :meth:`init_state` returns; drawn from ``seed + 1`` if absent.
    device : torch device, default CPU
        Where the table and states live. CPU tensors run the twins, CUDA
        tensors the kernels.
    """
    scale: float = 1.0
    coba: bool = True
    dt: float = 0.1          # ms
    n_conn: int = 80
    w_e: float = 0.6         # mS (COBA) / mV-equivalent (CUBA)
    w_i: float = 6.7
    tau_e: float = 5.0       # ms
    tau_i: float = 10.0      # ms
    e_e: float = 0.0         # mV (COBA reversal)
    e_i: float = -80.0       # mV
    seed: int = 42
    conn_all: Optional[torch.Tensor] = dataclasses.field(default=None,
                                                         repr=False)
    initial_state: Optional[EINetState] = dataclasses.field(default=None,
                                                            repr=False)
    device: Optional[torch.device] = None

    def __post_init__(self):
        self.n_exc = int(3200 * self.scale)
        self.n_inh = int(800 * self.scale)
        self.num = self.n_exc + self.n_inh
        self.params = LIFRefParams()
        self.device = check_device(self.device or 'cpu')
        if self.conn_all is None:
            gen = torch.Generator().manual_seed(self.seed)
            n_conn = min(self.n_conn, self.num)
            conn = torch.randint(0, self.num, (self.num, n_conn),
                                 generator=gen, dtype=torch.int32)
        else:
            conn = torch.as_tensor(self.conn_all)
            if conn.dim() != 2 or conn.shape[0] != self.num:
                raise ValueError(f'conn_all must be (num={self.num}, n_conn), '
                                 f'got {tuple(conn.shape)}')
        self.conn_all = conn.to(device=self.device,
                                dtype=torch.int32).contiguous()
        if self.initial_state is not None:
            self.initial_state = _to(self.initial_state, self.device)

    # -- state -------------------------------------------------------------------

    def init_state(self, generator: Optional[torch.Generator] = None
                   ) -> EINetState:
        """The initial state given to the constructor, or one drawn from
        *generator* (default: a generator seeded with ``seed + 1``)."""
        if generator is None and self.initial_state is not None:
            return self.initial_state
        if generator is None:
            generator = torch.Generator().manual_seed(self.seed + 1)
        neurons = lifref_init(generator, self.num, self.params,
                              device=self.device)
        zeros = torch.zeros(self.num, dtype=torch.float32, device=self.device)
        return EINetState(neurons=neurons, g_e=zeros, g_i=zeros.clone(),
                          spike_count=torch.zeros(self.num, dtype=torch.int32,
                                                  device=self.device))

    def step_params(self, inp: float = 20.0) -> EINetParams:
        """The float32 scalars K1 and its twin read."""
        p = self.params
        return EINetParams(
            decay_e=f32(math.exp(-self.dt / self.tau_e)),
            decay_i=f32(math.exp(-self.dt / self.tau_i)),
            w_e=f32(self.w_e), w_i=f32(self.w_i), e_e=f32(self.e_e),
            e_i=f32(self.e_i), inp=f32(inp), v_rest=f32(p.v_rest),
            v_th=f32(p.v_th), v_reset=f32(p.v_reset), tau_ref=f32(p.tau_ref),
            dt_tau=f32(self.dt / p.tau), r=f32(p.r), num=self.num,
            coba=int(self.coba))

    # -- dynamics ----------------------------------------------------------------

    def _propagate(self, spk: torch.Tensor):
        """This step's spikes -> (w_e * E hits, w_i * I hits) per target:
        compact the spiking ids, scatter 0/1 values on two channels, scale
        after the sum. The JAX package needs an event capacity and an
        overflow branch here; the scatter of the port has neither."""
        ids = torch.nonzero(spk).flatten()
        tgt = self.conn_all[ids]                          # (n_act, n_conn)
        is_exc = ids < self.n_exc
        n_conn = tgt.shape[1]
        vals = torch.stack([is_exc, ~is_exc]).to(torch.float32)
        vals = vals[:, :, None].expand(2, ids.numel(), n_conn).reshape(2, -1)
        counts = event_scatter_add_multi(tgt.reshape(-1), vals, self.num)
        return f32(self.w_e) * counts[0], f32(self.w_i) * counts[1]

    def step(self, state: EINetState, t, inp: float = 20.0) -> EINetState:
        """One dt step at time *t* (a float32 value): decay the synapses,
        update the membranes, then scatter THIS step's spikes into the
        conductances the next step reads."""
        if state.neurons.v.device.type != 'cpu':
            return self._simulate(state, [float(t)], inp)
        p = self.step_params(inp)
        d_e = torch.tensor(p.decay_e)
        d_i = torch.tensor(p.decay_i)
        v = state.neurons.v
        if self.coba:
            current = torch.addcmul((state.g_i * p.decay_i) * (p.e_i - v),
                                    state.g_e * p.decay_e, p.e_e - v) + p.inp
        else:
            current = torch.addcmul(-(state.g_i * p.decay_i), state.g_e,
                                    d_e) + p.inp
        neurons, spike = lifref_step(state.neurons, current, t, self.dt,
                                     self.params)
        inc_e, inc_i = self._propagate(spike)
        return EINetState(
            neurons=neurons,
            g_e=torch.addcmul(inc_e, state.g_e, d_e),
            g_i=torch.addcmul(inc_i, state.g_i, d_i),
            spike_count=state.spike_count + spike.to(torch.int32))

    def times(self, n_steps: int) -> list:
        """Step times ``float32(i) * float32(dt)`` for ``i < n_steps``."""
        return (np.arange(n_steps, dtype=np.float32)
                * np.float32(self.dt)).tolist()

    def run(self, n_steps: int, inp: float = 20.0,
            state: Optional[EINetState] = None) -> EINetState:
        """Run ``n_steps`` from *state* (default :meth:`init_state`)
        through K1 and K2, or their twins on the CPU. *state* is not
        modified."""
        if state is None:
            state = self.init_state()
        return self._simulate(state, self.times(n_steps), inp)

    def _simulate(self, state: EINetState, times, inp: float, *,
                  step_op=einet_step, scatter_op=event_count_scatter
                  ) -> EINetState:
        """The step loop: K1 then K2 for each time in *times*, then a
        last K1 that only folds the final counts. ``chip_smoke.py`` passes
        the twins as *step_op* and *scatter_op* to run the twin loop on a
        CUDA device."""
        device = state.neurons.v.device
        v = state.neurons.v.to(torch.float32, copy=True)
        t_last = state.neurons.t_last.to(torch.float32, copy=True)
        g_e = state.g_e.to(torch.float32, copy=True)
        g_i = state.g_i.to(torch.float32, copy=True)
        spike_count = state.spike_count.to(torch.int32, copy=True)
        counts = torch.zeros(2, self.num, dtype=torch.int32, device=device)
        ids = torch.empty(self.num, dtype=torch.int32, device=device)
        n_ids = torch.zeros(2, dtype=torch.int32, device=device)
        p = self.step_params(inp)
        buffers = (v, t_last, g_e, g_i, counts, spike_count, ids, n_ids)
        for k, t in enumerate(times):
            parity = k & 1
            step_op(*buffers, p, t, parity, k > 0, True)
            scatter_op(ids, n_ids[parity:parity + 1], self.conn_all,
                       self.n_exc, counts)
        if len(times):
            step_op(*buffers, p, 0.0, 0, True, False)
        return EINetState(neurons=LIFRefState(v=v, t_last=t_last), g_e=g_e,
                          g_i=g_i, spike_count=spike_count)

    def firing_rate_hz(self, state: EINetState, n_steps: int) -> torch.Tensor:
        """Mean firing rate in Hz over the simulated window."""
        t_sec = n_steps * self.dt * 1e-3
        return state.spike_count.to(torch.float32).mean() / t_sec


def _to(state: EINetState, device) -> EINetState:
    return EINetState(
        neurons=LIFRefState(v=state.neurons.v.to(device),
                            t_last=state.neurons.t_last.to(device)),
        g_e=state.g_e.to(device), g_i=state.g_i.to(device),
        spike_count=state.spike_count.to(device))
