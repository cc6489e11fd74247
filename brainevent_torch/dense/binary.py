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

"""Event-driven dense products (``brainevent_tpu.dense.binary``).

``binary_densemv(W, s, transpose)``: ``W[m, k] @ g(s[k])``, or with
``transpose`` ``g(s[k]) @ W[k, m]``, through K15 ``dense_event_mv``.
``binary_densemm(W, S, transpose)``: ``W[m, k] @ g(S[k, n])``, or
``W[k, m].T @ g(S[k, n])``, through K16 ``dense_event_mm``. ``g`` is the
event gate: a bool spike on its truth, a float spike at ``> 0``; an
active spike adds the bare weight.

Gradients (``torch.autograd``) mirror the JAX transpose rules
(``_densemv_transpose_rule``, ``_densemm_transpose_rule``): with respect
to the weights, the outer product of the cotangent with the **gate**;
with respect to a float spike operand, the product linear in ``W`` (the
surrogate convention), ``W @ ct`` or ``W.T @ ct``. These are plain
products, as in the JAX package, and run through ``torch.matmul``/
``torch.outer``. Bool spikes get no gradient. ``backend=`` is accepted
and ignored.

Dtypes (``ops/operand.py``): spikes of any dtype reach the kernels as
their gate (bool, or float32 gated in the kernel); float16 and bfloat16
weights are computed in float32 and the result rounded to the weights'
dtype, within 1 ulp of that dtype of the twin's result, on top of the
float32 bound. float64 weights are computed in float64, as the JAX
package keeps float64 on its XLA kernel (``dense/binary.py:87-89``): by
the twins on the CPU, by the ``double`` instances of K15 and K16 on the
card.
"""

from typing import Optional

import torch

from .._error import MathError
from ..ops.operand import event_spikes, widen
from .pallas_kernels import dense_event_mm, dense_event_mv, product_gate

__all__ = ['binary_densemv', 'binary_densemv_p_call', 'binary_densemm',
           'binary_densemm_p_call']


class _DenseEventProduct(torch.autograd.Function):
    """One dense event product (``mm`` selects K16 over K15),
    differentiable with respect to the weights and a float operand."""

    @staticmethod
    def forward(ctx, weights, spikes, transpose, mm):
        ctx.save_for_backward(weights, spikes)
        ctx.transpose, ctx.mm = transpose, mm
        op = dense_event_mm if mm else dense_event_mv
        return op(widen(weights), event_spikes(spikes), transpose).to(
            weights.dtype)

    @staticmethod
    def backward(ctx, ct):
        weights, spikes = ctx.saved_tensors
        transpose, mm = ctx.transpose, ctx.mm
        w_bar = s_bar = None
        if ctx.needs_input_grad[1]:
            s_bar = (weights @ ct if transpose else weights.T @ ct).to(
                spikes.dtype)
        if ctx.needs_input_grad[0]:
            g = product_gate(spikes, ct.dtype)
            if mm:
                w_bar = g @ ct.T if transpose else ct @ g.T
            else:
                w_bar = torch.outer(g, ct) if transpose else torch.outer(ct, g)
        return w_bar, s_bar, None, None


def _operands(weights, spikes):
    """Both operands as tensors on one device: an array-like beside a
    tensor goes to the tensor's device."""
    dev = next((x.device for x in (spikes, weights)
                if isinstance(x, torch.Tensor)), None)
    return (torch.as_tensor(weights, device=dev),
            torch.as_tensor(spikes, device=dev))


def binary_densemv_p_call(weights, spikes, *, transpose: bool,
                          backend: Optional[str] = None):
    """Low-level call; returns a one-element list. The JAX package's
    shape asserts raise :class:`~brainevent_torch.MathError` here."""
    del backend
    weights, spikes = _operands(weights, spikes)
    if weights.ndim != 2:
        raise MathError(f'weights must be 2D, got {weights.ndim}D')
    if spikes.ndim != 1:
        raise MathError(f'spikes must be 1D, got {spikes.ndim}D')
    axis = 0 if transpose else 1
    if spikes.shape[0] != weights.shape[axis]:
        raise MathError(f'spikes length {spikes.shape[0]} != '
                        f'weights.shape[{axis}] {weights.shape[axis]}')
    return [_DenseEventProduct.apply(weights.contiguous(),
                                     spikes.contiguous(), bool(transpose),
                                     False)]


def binary_densemv(weights, spikes, *, transpose: bool,
                   backend: Optional[str] = None):
    """Event-driven dense matvec ``W @ s`` / ``s @ W`` (``W.T @ s``)."""
    (out,) = binary_densemv_p_call(weights, spikes, transpose=transpose,
                                   backend=backend)
    return out


def binary_densemm_p_call(weights, spikes, *, transpose: bool,
                          backend: Optional[str] = None):
    """Low-level call; returns a one-element list."""
    del backend
    weights, spikes = _operands(weights, spikes)
    if weights.ndim != 2 or spikes.ndim != 2:
        raise MathError(f'weights and spikes must be 2D, got '
                        f'{weights.ndim}D and {spikes.ndim}D')
    axis = 0 if transpose else 1
    if weights.shape[axis] != spikes.shape[0]:
        raise MathError(f'weights.shape[{axis}] {weights.shape[axis]} != '
                        f'spikes.shape[0] {spikes.shape[0]}')
    return [_DenseEventProduct.apply(weights.contiguous(),
                                     spikes.contiguous(), bool(transpose),
                                     True)]


def binary_densemm(weights, spikes, *, transpose: bool,
                   backend: Optional[str] = None):
    """Event-driven dense matmul ``W @ S`` / ``W.T @ S``."""
    (out,) = binary_densemm_p_call(weights, spikes, transpose=transpose,
                                   backend=backend)
    return out
