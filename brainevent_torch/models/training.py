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

"""Surrogate-gradient training of a recurrent spiking network.

Counterpart of ``brainevent_tpu.models.training``, with the same functional
API (:class:`SurrogateSNN`, :class:`SNNParams`, :func:`snn_loss`,
:func:`train_step`). A recurrent LIF network is trained end to end by
autograd: spikes come from :func:`~brainevent_torch.models.neurons.surrogate_spike`
(Heaviside forward, steep-sigmoid backward), and the recurrent projection
follows the surrogate-linear contract: binary forward, float cotangents.

The recurrent product is a ``torch.autograd.Function`` over two gather
plans of the ``(n_hidden, n_conn)`` ELL table
(:mod:`brainevent_torch.ops.mxu_gather`):

- **forward** ``rec = W^T spk``: kernel K3 over the *incoming* plan
  (targets as plan rows), one warp per target summing in a fixed order;
  with ``forward='event'``, kernel K5 (``binary_fcnmv``'s event scatter)
  over the ELL table, which reads only the rows of neurons that spiked;
- **backward**: one K4 launch per simulated step over the *outgoing* plan
  gives both ``dspk[i] = sum_k w[i,k] ct[idx[i,k]]`` (over the outgoing
  plan's row-order weights, one gather per train step, like the
  forward's) and ``dw[i,k] = spk[i] ct[idx[i,k]]``, in plan order.
  Autograd sums ``dw`` over the steps, and the plan-order view's backward
  (:class:`_SortedView`, a gather by the inverse permutation, never a
  scatter) brings the sum back to the ELL layout once per train step.

K3 and K4 use no float atomics, so a train step with ``forward='plan'``
repeats bit for bit. K5's heterogeneous sums use float atomics: the event
forward is right to rounding, not bitwise repeatable.

The weights the forward reads get no gradient (``detach``), as in the JAX
package: the whole weight gradient is the backward's ``dw``. The dense
products ``x_t @ w_in`` and the readout stay ``torch.matmul``. The random
draws are the port's own (``torch.Generator``), not JAX's; to run the
network the JAX package drew, use
:func:`brainevent_torch.interop.surrogate_snn_from_arrays`.
"""

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..fcn.binary import fcn_event_scatter
from ..ops.core import check_device
from ..ops.mxu_gather import (GatherPlan, build_gather_plan, plan_from_ell,
                              plan_gather_mv, plan_inverse_perm,
                              plan_matvec_dw_op)
from .neurons import surrogate_spike

__all__ = ['SurrogateSNN', 'SNNParams', 'snn_loss', 'train_step']


class SNNParams(NamedTuple):
    w_in: torch.Tensor    # (n_in, n_hidden) dense input projection
    w_rec: torch.Tensor   # (n_hidden, n_conn) recurrent ELL weights
    w_out: torch.Tensor   # (n_hidden, n_out) dense readout


class _RecOps(NamedTuple):
    """The three ops of the recurrent product. The model holds the kernel
    ops; a check on the card can swap in their twins."""
    mv: object            # K3 plan_gather_mv
    mvdw: object          # K4 plan_matvec_dw
    scatter: object       # K5 fcn_event_scatter


_KERNEL_OPS = _RecOps(plan_gather_mv, plan_matvec_dw_op, fcn_event_scatter)


class _SortedView(torch.autograd.Function):
    """Plan-order view of the ELL weights: a gather by ``perm`` (0 where
    ``perm < 0``); its backward is the gather by ``inv``."""

    @staticmethod
    def forward(ctx, w_rec, perm, inv):
        ctx.save_for_backward(inv)
        ctx.shape = w_rec.shape
        flat = w_rec.reshape(-1).to(torch.float32)
        zero = torch.zeros((), dtype=torch.float32, device=flat.device)
        return torch.where(perm >= 0, flat[perm.clamp(min=0).long()], zero)

    @staticmethod
    def backward(ctx, ct):
        (inv,) = ctx.saved_tensors
        return ct.reshape(-1)[inv.long()].reshape(ctx.shape), None, None


def _sorted_view(w_rec, perm, inv):
    return _SortedView.apply(w_rec, perm, inv)


class _Rec(torch.autograd.Function):
    """``rec = W^T spk``; differentiable with respect to ``w_sorted`` and
    ``spk`` through one K4 launch over the outgoing plan, which reads
    ``bwd_w``, the outgoing plan's row-order view of the same weights."""

    @staticmethod
    def forward(ctx, w_sorted, spk, fwd_w, bwd_w, model):
        ops = model._ops
        if model.forward == 'event':
            out = ops.scatter(fwd_w, model._idx, spk, model.n_hidden)
        else:
            out = ops.mv(model._plan_T, fwd_w, spk)
        ctx.model = model
        ctx.save_for_backward(w_sorted, spk, bwd_w)
        return out

    @staticmethod
    def backward(ctx, ct):
        w_sorted, spk, bwd_w = ctx.saved_tensors
        model = ctx.model
        dspk, dw_sorted = model._ops.mvdw(model._plan, w_sorted, spk,
                                          ct.contiguous(), bwd_w)
        return dw_sorted, dspk, None, None, None


@dataclasses.dataclass
class SurrogateSNN:
    """Recurrent LIF network with fixed-number recurrent connectivity.

    ``forward='plan'`` (default) runs the forward through K3, whatever the
    firing rate; ``'event'`` through K5, which reads only the rows of
    neurons that spiked. ``rec_indices`` and ``initial_params`` take the
    connectivity and weights from outside (see
    :func:`~brainevent_torch.interop.surrogate_snn_from_arrays`); by
    default they are drawn from a ``torch.Generator`` seeded with
    ``seed``. ``bwd_passes`` and ``fwd_passes`` (the JAX package's bf16
    split depths) are accepted and ignored. ``device`` defaults to the
    card (``'cuda'``); ``device='cpu'`` runs the twins.
    """
    n_in: int = 100
    n_hidden: int = 1000
    n_out: int = 10
    n_conn: int = 64
    tau: float = 10.0     # ms
    dt: float = 1.0       # ms
    v_th: float = 1.0
    seed: int = 0
    forward: str = 'plan'
    bwd_passes: int = 3
    fwd_passes: int = 3
    device: Optional[torch.device] = None
    rec_indices: Optional[torch.Tensor] = dataclasses.field(
        default=None, repr=False)
    initial_params: Optional[SNNParams] = dataclasses.field(
        default=None, repr=False)

    def __post_init__(self):
        if self.forward not in ('plan', 'event'):
            raise ValueError(f"forward must be 'plan' or 'event', got "
                             f"{self.forward!r}")
        self.device = check_device(self.device if self.device is not None
                                   else 'cuda')
        gen = torch.Generator().manual_seed(self.seed)
        n = self.n_hidden
        if self.rec_indices is None:
            self.rec_indices = torch.randint(
                0, n, (n, self.n_conn), generator=gen, dtype=torch.int32)
        idx_np = np.asarray(torch.as_tensor(self.rec_indices).cpu(),
                            dtype=np.int32)
        if idx_np.shape != (n, self.n_conn):
            raise ValueError(f'rec_indices {idx_np.shape} for n_hidden={n}, '
                             f'n_conn={self.n_conn}')
        self.rec_indices = torch.from_numpy(idx_np).to(self.device)
        # outgoing plan (rows = pre): the fused backward
        self._plan = plan_from_ell(idx_np, (n, n)).to(self.device)
        self._inv = plan_inverse_perm(self._plan)
        # incoming plan (rows = targets): the forward; flat order matches
        # w_rec.reshape(-1)
        self._plan_T = build_gather_plan(
            idx_np.reshape(-1), np.repeat(np.arange(n), self.n_conn),
            (n, n)).to(self.device)
        self._idx = self.rec_indices.contiguous()
        self._ops = _KERNEL_OPS

        if self.initial_params is None:
            def draw(shape, std):
                return (torch.randn(shape, generator=gen) * std).to(
                    self.device)
            self.initial_params = SNNParams(
                w_in=draw((self.n_in, n), 0.1),
                w_rec=draw((n, self.n_conn), 0.5 / self.n_conn ** 0.5),
                w_out=draw((n, self.n_out), 0.1))

    # -- public API -----------------------------------------------------------

    def init_params(self) -> SNNParams:
        return self.initial_params

    def consts(self) -> dict:
        """The non-trainable tensors (plans, permutations, index table),
        under the JAX package's keys. ``run(..., consts=)`` accepts them
        for API parity; the model reads its own copies."""
        return {
            'meta': self._plan.meta, 'b0': self._plan.b0,
            'rb': self._plan.rb, 'perm': self._plan.perm,
            'metaT': self._plan_T.meta, 'b0T': self._plan_T.b0,
            'rbT': self._plan_T.rb, 'permT': self._plan_T.perm,
            'inv': self._inv, 'idx': self.rec_indices,
        }

    def run(self, params: SNNParams, inputs: torch.Tensor,
            consts: dict = None) -> torch.Tensor:
        """Simulate ``inputs (n_steps, n_in)``; returns readout logits."""
        return self._spikes(params, inputs).mean(dim=0) @ params.w_out

    def _spikes(self, params: SNNParams, inputs: torch.Tensor):
        """Spike trains ``(n_steps, n_hidden)`` float 0/1."""
        decay = float(np.float32(math.exp(-self.dt / self.tau)))
        # the weight views, made once per train step
        w_sorted = _sorted_view(params.w_rec, self._plan.perm, self._inv)
        fwd_w = self._fwd_weights(params.w_rec)
        bwd_w = self._plan.sort_rows(params.w_rec.detach())
        v = torch.zeros(self.n_hidden, device=inputs.device)
        spk = torch.zeros(self.n_hidden, device=inputs.device)
        spikes = []
        for x_t in inputs:
            rec = _Rec.apply(w_sorted, spk, fwd_w, bwd_w, self)
            current = x_t @ params.w_in + rec
            v = v * decay + current
            spk = surrogate_spike(v - self.v_th)
            v = v - spk * self.v_th  # soft reset
            spikes.append(spk)
        return torch.stack(spikes)

    def _fwd_weights(self, w_rec):
        """The forward's weight view, with no gradient: the full gradient
        is the backward's ``dw``. K3 reads the incoming plan's row order
        (one gather per train step, then read at every simulated step)."""
        w = w_rec.detach().to(torch.float32)
        if self.forward == 'event':
            return w.contiguous()
        return self._plan_T.sort_rows(w)

    def spike_counts(self, params: SNNParams,
                     inputs: torch.Tensor) -> torch.Tensor:
        """A stub kept from the JAX package: runs the network and returns
        0."""
        self.run(params, inputs)
        return torch.zeros((), device=inputs.device)


def snn_loss(model: SurrogateSNN, params: SNNParams, inputs: torch.Tensor,
             label, consts: dict = None) -> torch.Tensor:
    """Cross-entropy of the rate readout."""
    logits = model.run(params, inputs, consts=consts)
    return -torch.log_softmax(logits, dim=0)[label]


def train_step(model: SurrogateSNN, params: SNNParams, inputs: torch.Tensor,
               label, lr: float = 1e-2, consts: dict = None):
    """One SGD step; returns ``(new_params, loss)``."""
    leaves = [p.detach().requires_grad_(True) for p in params]
    loss = snn_loss(model, SNNParams(*leaves), inputs, label, consts=consts)
    grads = torch.autograd.grad(loss, leaves)
    new = SNNParams(*(p.detach() - lr * g for p, g in zip(leaves, grads)))
    return new, loss.detach()
