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

"""Event scatter-add: ``out[targets[e]] += values[e]``.

Counterpart of ``brainevent_tpu.ops.scatter``. The JAX package builds its
scatters from one-hot matrix products because a TPU has no atomics; on a
GPU the scatter is atomics, in the two forms of kernel K2
(``csrc/event_scatter.cu``):

- :data:`event_scatter_float` (``event_scatter_add`` and
  ``event_scatter_add_multi`` on CUDA tensors): the value form, atomics in
  float32, float64, int32 or int64 (its name is from its first instance).
  float32 is exact for 0/1 values at any add order, and integer sums are
  exact always. It ports the JAX package's XLA ``event_scatter_add``
  (``brainevent_tpu/ops/scatter.py:252``), not a Pallas kernel;
- :data:`event_count_scatter` (the EI network's propagation): int32 hit
  counts per target on two channels, read from the device-side spike list
  that kernel K1 writes.

Each has a plain PyTorch twin (``index_add_``) that runs for CPU tensors.
Targets outside ``[0, n_out)`` are dropped by both.
"""

import ctypes
from typing import Optional

import torch

from .._error import UnsupportedOperationError
from . import cuda_build
from .core import KernelOp, check_cuda_tensors, cuda_stream

__all__ = ['event_scatter_add', 'event_scatter_add_multi',
           'event_scatter_float', 'event_count_scatter',
           'event_scatter_float_twin', 'event_count_scatter_twin']

_SOURCE = 'brainevent_torch/csrc/event_scatter.cu'
# K1 and K2 replace einet_pallas_sim_mxu3 (below 40k neurons, the main
# path at 4k) and einet_pallas_sim_mxu6 (pallas_sim.py:1368, from 40k up).
_REPLACES = 'brainevent_tpu/models/pallas_sim.py:639'


# -- float form ---------------------------------------------------------------

def event_scatter_float_twin(targets: torch.Tensor, values: torch.Tensor,
                             out: torch.Tensor) -> torch.Tensor:
    """``out[c, targets[e]] += values[c, e]``, in place, dropping targets
    outside ``[0, out.shape[1])``. Plain PyTorch twin of the float K2."""
    n_out = out.shape[1]
    valid = (targets >= 0) & (targets < n_out)
    out.index_add_(1, targets[valid], values[:, valid].to(out.dtype))
    return out


# the value types of the float form's instances (``kind`` of its C entry)
_KINDS = {torch.float32: 0, torch.float64: 1, torch.int32: 2, torch.int64: 3}


def _event_scatter_float_cuda(op, targets, values, out):
    if out.dtype not in _KINDS:
        raise UnsupportedOperationError(
            f'{op.name}: no instance for {out.dtype} on a CUDA tensor; it '
            f'sums in {", ".join(map(str, _KINDS))}')
    device = check_cuda_tensors(op.name, (targets, torch.int32),
                                (values, out.dtype), (out, out.dtype))
    n_chan, n_events = values.shape
    if targets.shape != (n_events,) or out.shape[0] != n_chan:
        raise ValueError(f'{op.name}: targets {tuple(targets.shape)}, values '
                         f'{tuple(values.shape)}, out {tuple(out.shape)}')
    fn = cuda_build.function('event_scatter_float_launch', [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p])
    op.launch(fn, targets.data_ptr(), values.data_ptr(), n_events, n_chan,
              out.shape[1], out.data_ptr(), _KINDS[out.dtype],
              device.index or 0, cuda_stream(device))
    return out


event_scatter_float = KernelOp(
    'event_scatter_float', twin=event_scatter_float_twin,
    cuda=_event_scatter_float_cuda, source=_SOURCE,
    replaces='brainevent_tpu/ops/scatter.py:252')


def event_scatter_add(targets: torch.Tensor, values, n_out: int, *,
                      mask: Optional[torch.Tensor] = None,
                      dtype=None) -> torch.Tensor:
    """``out[targets[e]] += values[e]`` over all events ``e``.

    Parameters
    ----------
    targets : int tensor, any shape
        Target indices in ``[0, n_out)``; others are dropped.
    values : tensor or scalar broadcastable to ``targets.shape``
    n_out : int
    mask : bool tensor broadcastable to ``targets.shape``, optional
        Events with a false mask contribute nothing.
    dtype : optional
        Output dtype; defaults to ``values.dtype``.

    Returns a ``(n_out,)`` tensor on the device of *targets*. The sum is
    taken as the JAX package takes it: float32 and float64 in their own
    type; float16 and bfloat16 in float32 (its one-hot route); int32 and
    int64 in their own type, wrapping on overflow; int8, int16 and uint8
    in int32 after the values are cast to the output dtype, then cast
    back, which wraps as a sum in that dtype does. On a CUDA tensor these
    run the instances of K2's value form; other output dtypes (bool,
    complex) sum with ``index_add_`` on the CPU and raise on the card.
    """
    targets = torch.as_tensor(targets)
    values = torch.as_tensor(values, device=targets.device)
    out_dtype = dtype or values.dtype
    values = torch.broadcast_to(values, targets.shape).reshape(-1)
    if mask is not None:
        mask = torch.as_tensor(mask, device=targets.device)
        targets = torch.where(torch.broadcast_to(mask, targets.shape),
                              targets, n_out)
    targets = targets.reshape(-1).to(torch.int32).contiguous()
    if not out_dtype.is_floating_point:
        values = values.to(out_dtype)
    acc = _ACCUMULATE.get(out_dtype, out_dtype)
    out = torch.zeros(1, n_out, dtype=acc, device=targets.device)
    event_scatter_float(targets, values.to(acc).reshape(1, -1).contiguous(),
                        out)
    return out[0].to(out_dtype)


# output dtypes that sum in a wider type
_ACCUMULATE = {torch.float16: torch.float32, torch.bfloat16: torch.float32,
               torch.int8: torch.int32, torch.int16: torch.int32,
               torch.uint8: torch.int32}


def event_scatter_add_multi(targets: torch.Tensor, values: torch.Tensor,
                            n_out: int) -> torch.Tensor:
    """``out[c, p] = sum_e values[c, e] * [targets[e] == p]``.

    Parameters
    ----------
    targets : (E,) int tensor
    values : (C, E) tensor, already masked
    n_out : int

    Returns a ``(C, n_out)`` float32 tensor.
    """
    targets = targets.reshape(-1).to(torch.int32).contiguous()
    values = values.to(torch.float32).contiguous()
    out = torch.zeros(values.shape[0], n_out, dtype=torch.float32,
                      device=targets.device)
    return event_scatter_float(targets, values, out)


# -- int32 hit counts (the EI network's propagation) ---------------------------

def event_count_scatter_twin(ids: torch.Tensor, n_ids: torch.Tensor,
                             conn: torch.Tensor, n_exc: int,
                             counts: torch.Tensor) -> torch.Tensor:
    """``counts[id >= n_exc, conn[id, k]] += 1`` for each of the first
    ``n_ids[0]`` entries of *ids*, in place, dropping ids and targets
    outside ``[0, num)``. Plain PyTorch twin of K2."""
    num = counts.shape[1]
    sel = ids[:int(n_ids[0])].long()
    sel = sel[(sel >= 0) & (sel < num)]
    for ch, rows in enumerate((sel[sel < n_exc], sel[sel >= n_exc])):
        tgt = conn[rows].reshape(-1)
        tgt = tgt[(tgt >= 0) & (tgt < num)]
        counts[ch].index_add_(0, tgt, torch.ones_like(tgt, dtype=torch.int32))
    return counts


def _event_count_scatter_cuda(op, ids, n_ids, conn, n_exc, counts):
    device = check_cuda_tensors(op.name, (ids, torch.int32), (n_ids, torch.int32),
                         (conn, torch.int32), (counts, torch.int32))
    num, n_conn = conn.shape
    if counts.shape != (2, num) or ids.shape != (num,) or n_ids.numel() < 1:
        raise ValueError(f'{op.name}: ids {tuple(ids.shape)}, conn '
                         f'{tuple(conn.shape)}, counts {tuple(counts.shape)}')
    fn = cuda_build.function('event_count_scatter_launch', [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p])
    op.launch(fn, ids.data_ptr(), n_ids.data_ptr(), conn.data_ptr(), num,
              n_conn, int(n_exc), counts.data_ptr(), device.index or 0,
              cuda_stream(device))
    return counts


event_count_scatter = KernelOp(
    'event_count_scatter', twin=event_count_scatter_twin,
    cuda=_event_count_scatter_cuda, source=_SOURCE, replaces=_REPLACES)
