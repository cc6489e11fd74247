# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""The event encoders' kernel: K18 :data:`event_row_count`
(``csrc/event_encode.cu``), replacing ``brainevent_tpu/events/
compact_ops.py``'s ``_csr_row_count_pallas_kernel``.

``event_row_count(x)`` is the int32 count of the entries ``!= 0`` (or
true) in each row of a 2-D spike matrix: NaN and negative spikes count,
as in the JAX encoders. The twin takes any dtype; the kernel takes bool
or float32 and raises a ``TypeError`` on anything else.
"""

import ctypes

import torch

from ..ops import cuda_build
from ..ops.core import KernelOp, check_cuda_tensors, cuda_stream
from ..ops.operand import spike_is_bool

__all__ = ['event_row_count', 'event_row_count_twin', 'event_mask']


def event_mask(x: torch.Tensor) -> torch.Tensor:
    """The encoders' events: a bool tensor as it is, else ``x != 0``."""
    return x if x.dtype == torch.bool else x != 0


def event_row_count_twin(x):
    """Plain PyTorch twin of K18: the events of each row, as int32."""
    return event_mask(x).sum(1, dtype=torch.int32)


def _event_row_count_cuda(op, x):
    x_bool = spike_is_bool(op.name, x)
    device = check_cuda_tensors(op.name, (x, x.dtype))
    n, b = x.shape
    counts = torch.empty(n, dtype=torch.int32, device=device)
    fn = cuda_build.function('event_row_count_launch', [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    op.launch(fn, x.data_ptr(), x_bool, n, b, counts.data_ptr(),
              device.index or 0, cuda_stream(device))
    return counts


event_row_count = KernelOp(
    'event_row_count', twin=event_row_count_twin, cuda=_event_row_count_cuda,
    source='brainevent_torch/csrc/event_encode.cu',
    replaces='brainevent_tpu/events/compact_ops.py:470')
