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

"""Event-driven fixed-number-connectivity (ELL) products.

Counterpart of ``brainevent_tpu.fcn.binary``.
``binary_fcnmv(weights, indices, spikes, shape=(n_pre, n_post), transpose)``:

- ``transpose=False`` (gather, kernel K6 :data:`fcn_event_gather`):
  ``y[i] = sum_k w[i,k] * gate(s[indices[i,k]])``;
- ``transpose=True`` (scatter, kernel K5 :data:`fcn_event_scatter`):
  ``y[indices[i,k]] += w[i,k] * gate(s[i])``.

Weights are homogeneous ``(1,)`` or heterogeneous ``(n_pre, n_conn)``;
spikes are bool, or float with ``gate(s) = s > 0``. Homogeneous weights
count hits in int32 and scale once, so those results are exact at any add
order. The kernels (``csrc/fcn_event.cu``) read only the rows of active
neurons (K5) and only the weights of active targets (K6); targets outside
``[0, n_post)`` are dropped. Each has a plain PyTorch twin that runs for
CPU tensors. The device of the tensors picks the route; ``backend=`` is
accepted and ignored.

Dtypes (``ops/operand.py``): spikes of any dtype reach the kernels as
their ``> 0`` gate; float16 and bfloat16 weights are computed in float32
and the result rounded to the weights' dtype (within 1 ulp of it of the
twin, on top of the float32 bound). float64 weights are computed in
float64: by the twins on the CPU, by the kernels' ``double`` instances on
the card.

Gradients through :func:`binary_fcnmv` need the float ELL products
(``fcn/float.py``), which are not ported yet: a backward through it raises
:class:`~brainevent_torch.UnsupportedOperationError`.
"""

import ctypes
from typing import Optional, Tuple

import torch

from .. import config
from .._error import MathError, UnsupportedOperationError
from ..ops import cuda_build
from ..ops.core import KernelOp, check_cuda_tensors, cuda_stream
from ..ops.operand import event_spikes, is_double, widen

__all__ = ['event_capacity', 'binary_fcnmv', 'binary_fcnmv_p_call',
           'check_fixed_conn_num_shape', 'fcn_event_scatter',
           'fcn_event_gather']

_SOURCE = 'brainevent_torch/csrc/fcn_event.cu'


def event_capacity(n: int) -> int:
    """Static active-spike capacity the JAX package's compact event
    scatter uses for ``n`` presynaptic neurons: ``n // divisor`` rounded
    up to a multiple of 8, at least 64 and at most ``n``. The port's
    scatters are atomics and need no capacity; this is kept for API
    parity."""
    div = config.get_event_capacity_divisor()
    cap = max(64, -(-n // div))
    cap = ((cap + 7) // 8) * 8
    return min(n, cap)


def check_fixed_conn_num_shape(indices_shape, operand_len: int,
                               shape: Tuple[int, int], transpose: bool) -> int:
    """Validate operand shapes of a fixed-number-connectivity product and
    return the result length (``brainevent_tpu._misc``'s check)."""
    n_pre, n_post = shape
    if indices_shape[0] != n_pre:
        raise MathError(f'indices.shape[0] ({indices_shape[0]}) must equal '
                        f'shape[0] ({n_pre}).')
    contraction = n_pre if transpose else n_post
    if operand_len != contraction:
        raise MathError(
            f'operand length ({operand_len}) must equal '
            f'{"shape[0]" if transpose else "shape[1]"} ({contraction}) for '
            f'{"A.T @ v" if transpose else "A @ v"}.')
    return n_post if transpose else n_pre


def _active(spikes: torch.Tensor) -> torch.Tensor:
    return spikes if spikes.dtype == torch.bool else spikes > 0


# -- twins -----------------------------------------------------------------------

def fcn_event_scatter_twin(weights, indices, spikes, n_post: int):
    """Plain PyTorch twin of K5: ``y[indices[i,k]] += w[i,k]`` over active
    ``i``; homogeneous weights count in int32 and scale once."""
    rows = _active(spikes)
    tgt = indices[rows].reshape(-1).long()
    valid = (tgt >= 0) & (tgt < n_post)
    if weights.shape == (1,):
        counts = torch.zeros(n_post, dtype=torch.int32, device=tgt.device)
        counts.index_add_(0, tgt[valid],
                          torch.ones_like(tgt[valid], dtype=torch.int32))
        return counts.to(weights.dtype) * weights[0]
    vals = weights[rows].reshape(-1)[valid]
    out = torch.zeros(n_post, dtype=weights.dtype, device=tgt.device)
    return out.index_add_(0, tgt[valid], vals)


def fcn_event_gather_twin(weights, indices, spikes, n_post: int):
    """Plain PyTorch twin of K6: ``y[i] = sum_k w[i,k] gate(s[idx[i,k]])``;
    homogeneous weights count, then scale once."""
    idx = indices.long()
    valid = (idx >= 0) & (idx < n_post)
    g = _active(spikes).to(weights.dtype)
    taken = torch.where(valid, g[idx.clamp(0, max(n_post - 1, 0))],
                        torch.zeros((), dtype=weights.dtype,
                                    device=idx.device))
    if weights.shape == (1,):
        return weights[0] * taken.sum(1)
    return (weights * taken).sum(1)


# -- kernels ---------------------------------------------------------------------

def _event_args(op, weights, indices, spikes):
    if spikes.dtype not in (torch.bool, torch.float32):
        raise TypeError(f'{op.name}: spikes must be bool or float32 on the '
                        f'card, got {spikes.dtype}')
    dbl = is_double(op.name, weights)
    device = check_cuda_tensors(op.name, (indices, torch.int32),
                                (weights, weights.dtype),
                                (spikes, spikes.dtype))
    return device, int(spikes.dtype == torch.float32), int(
        weights.shape == (1,)), dbl


def _fcn_event_scatter_cuda(op, weights, indices, spikes, n_post):
    device, s_is_float, homo, dbl = _event_args(op, weights, indices, spikes)
    n_pre, n_conn = indices.shape
    y = (torch.empty if homo else torch.zeros)(
        n_post, dtype=weights.dtype, device=device)
    counts = torch.zeros(n_post if homo else 0, dtype=torch.int32,
                         device=device)
    fn = cuda_build.function('fcn_event_scatter_launch', [
        ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    op.launch(fn, indices.data_ptr(), weights.data_ptr(), spikes.data_ptr(),
              s_is_float, homo, dbl, n_pre, n_conn, n_post,
              counts.data_ptr(), y.data_ptr(), device.index or 0,
              cuda_stream(device))
    return y


def _fcn_event_gather_cuda(op, weights, indices, spikes, n_post):
    device, s_is_float, homo, dbl = _event_args(op, weights, indices, spikes)
    n_pre, n_conn = indices.shape
    y = torch.empty(n_pre, dtype=weights.dtype, device=device)
    fn = cuda_build.function('fcn_event_gather_launch', [
        ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    op.launch(fn, indices.data_ptr(), weights.data_ptr(), spikes.data_ptr(),
              s_is_float, homo, dbl, n_pre, n_conn, n_post, y.data_ptr(),
              device.index or 0, cuda_stream(device))
    return y


fcn_event_scatter = KernelOp(
    'fcn_event_scatter', twin=fcn_event_scatter_twin,
    cuda=_fcn_event_scatter_cuda, source=_SOURCE,
    replaces='brainevent_tpu/fcn/pallas_kernels.py:260')

fcn_event_gather = KernelOp(
    'fcn_event_gather', twin=fcn_event_gather_twin,
    cuda=_fcn_event_gather_cuda, source=_SOURCE,
    replaces='brainevent_tpu/fcn/pallas_kernels.py:143')


class _BinaryFcnmv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, weights, indices, spikes, n_post, transpose):
        op = fcn_event_scatter if transpose else fcn_event_gather
        return op(widen(weights), indices, event_spikes(spikes),
                  n_post).to(weights.dtype)

    @staticmethod
    def backward(ctx, ct):
        raise UnsupportedOperationError(
            'binary_fcnmv has no gradient in brainevent_torch yet: it needs '
            'the float ELL products (fcn/float.py), which are not ported. '
            'The surrogate-training path takes its gradient from its own '
            'backward (brainevent_torch.models.training).')


def binary_fcnmv_p_call(weights, indices, spikes, *, shape,
                        transpose: bool = False,
                        backend: Optional[str] = None):
    """Low-level call; returns a one-element list, as the JAX package.

    ``weights``: ``(1,)`` or ``indices.shape``; ``indices``: ``(n_pre,
    n_conn)`` int (converted to int32); ``spikes``: bool or float, of
    length ``n_pre`` (``transpose=True``) or ``n_post``. ``backend`` is
    ignored: the tensors' device picks the twin or the kernel.
    """
    del backend
    indices = torch.as_tensor(indices)
    weights = torch.atleast_1d(torch.as_tensor(weights,
                                               device=indices.device))
    spikes = torch.as_tensor(spikes, device=indices.device)
    n_post = shape[1]
    check_fixed_conn_num_shape(indices.shape, spikes.shape[0], shape,
                               transpose)
    if tuple(weights.shape) not in ((1,), tuple(indices.shape)):
        raise ValueError(f'weights must be (1,) or {tuple(indices.shape)}, '
                         f'got {tuple(weights.shape)}')
    if indices.device.type == 'cuda':
        indices = indices.to(torch.int32).contiguous()
        weights = weights.contiguous()
        spikes = spikes.contiguous()
    return [_BinaryFcnmv.apply(weights, indices, spikes, n_post,
                               bool(transpose))]


def binary_fcnmv(weights, indices, spikes, *, shape,
                 transpose: bool = False, backend: Optional[str] = None):
    """Event-driven ELL matvec; see the module docstring."""
    (out,) = binary_fcnmv_p_call(weights, indices, spikes, shape=shape,
                                 transpose=transpose, backend=backend)
    return out
