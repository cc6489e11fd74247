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

"""Dense STDP weight updates (``brainevent_tpu.dense.plasticity``).

``update_dense_on_binary_pre``: ``W[i, :] += post_trace`` for every
spiking presynaptic ``i``; ``update_dense_on_binary_post``:
``W[:, j] += pre_trace`` for every spiking postsynaptic ``j``. A spike is
an event where it is true or ``!= 0`` (NaN and negatives included, unlike
the products' ``> 0``). Both clip the whole matrix to ``[w_min, w_max]``
when a bound is given. One pass of K17 (``dense_stdp_pre``/
``dense_stdp_post``) does the add and the clip, out of place: the result
is a new tensor, as in the JAX package, and bitwise the JAX result.

The AD contract is the JAX package's: the update is the identity with
respect to the weight, then the clip's gradient (1 inside the bounds, 0
where clipped); spikes and traces are not differentiated. ``backend=`` is
accepted and ignored.

Dtypes (``ops/operand.py``): spikes of any dtype reach K17 as their
``!= 0`` gate; float16 and bfloat16 weights (the trace takes the weights'
dtype) are updated in float32 and rounded once to their dtype, within
1 ulp of that dtype of the twin. float64 weights are updated in float64,
as the JAX package does (``dense/plasticity.py:60,100``): by the twin on
the CPU, by K17's ``double`` instance on the card, bitwise the twin. A
float64 ``W`` is never rounded to float32.
"""

from typing import Optional

import torch

from .._error import MathError
from ..ops.operand import event_spikes, widen
from .pallas_kernels import dense_stdp_post, dense_stdp_pre

__all__ = ['update_dense_on_binary_pre', 'update_dense_on_binary_post']


def _bound(b):
    """A clip bound as a Python float (or ``None``)."""
    if b is None:
        return None
    return float(b.item() if isinstance(b, torch.Tensor) else b)


class _DenseStdp(torch.autograd.Function):
    """The update with its clip; the gradient passes to the weight where
    the clip did not bind."""

    @staticmethod
    def forward(ctx, weight, spike, trace, w_min, w_max, post):
        op = dense_stdp_post if post else dense_stdp_pre
        dtype = weight.dtype
        weight, trace = widen(weight), widen(trace)
        spike = event_spikes(spike, nonzero=True)
        out = (op(weight, trace, spike, w_min, w_max) if post
               else op(weight, spike, trace, w_min, w_max)).to(dtype)
        ctx.bounds = (w_min, w_max)
        if ctx.needs_input_grad[0]:
            ctx.save_for_backward(out)
        return out

    @staticmethod
    def backward(ctx, ct):
        (out,) = ctx.saved_tensors
        w_min, w_max = ctx.bounds
        # an entry the clip moved sits on its bound and gets no gradient
        if w_min is not None:
            ct = torch.where(out > w_min, ct, 0.0)
        if w_max is not None:
            ct = torch.where(out < w_max, ct, 0.0)
        return ct, None, None, None, None, None


def _update(weight, spike, trace, w_min, w_max, *, post):
    weight = torch.as_tensor(weight)
    spike = torch.as_tensor(spike, device=weight.device)
    trace = torch.as_tensor(trace, device=weight.device).to(weight.dtype)
    rows, cols = (trace, spike) if post else (spike, trace)
    if weight.ndim != 2 or spike.ndim != 1 or trace.ndim != 1:
        raise MathError(f'weight must be 2D and spike, trace 1D, got '
                        f'{weight.ndim}D, {spike.ndim}D, {trace.ndim}D')
    if (weight.shape[0], weight.shape[1]) != (rows.shape[0], cols.shape[0]):
        raise MathError(f'weight {tuple(weight.shape)} does not fit '
                        f'{rows.shape[0]} rows and {cols.shape[0]} columns')
    return _DenseStdp.apply(weight.contiguous(), spike.contiguous(),
                            trace.contiguous(), _bound(w_min), _bound(w_max),
                            post)


def update_dense_on_binary_pre(weight, pre_spike, post_trace, w_min=None,
                               w_max=None, *, backend: Optional[str] = None):
    """``W[i, :] += post_trace`` for every spiking presynaptic ``i``,
    clipped to ``[w_min, w_max]``."""
    del backend
    return _update(weight, pre_spike, post_trace, w_min, w_max, post=False)


def update_dense_on_binary_post(weight, pre_trace, post_spike, w_min=None,
                                w_max=None, *, backend: Optional[str] = None):
    """``W[:, j] += pre_trace`` for every spiking postsynaptic ``j``,
    clipped to ``[w_min, w_max]``."""
    del backend
    return _update(weight, post_spike, pre_trace, w_min, w_max, post=True)
