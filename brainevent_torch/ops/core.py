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

"""A small per-op registry: a PyTorch twin and a CUDA kernel per op.

This is the port's counterpart of ``brainevent_tpu.ops.core.XLACustomKernel``,
cut to what the EI-network path needs. Each :class:`KernelOp` holds

- ``twin``: a plain PyTorch function. It runs for tensors on the CPU, and
  the card tests (``tests/test_torch_cuda.py``) call it directly to check
  the kernel;
- ``cuda``: the wrapper that checks its tensors and launches the kernel
  through :meth:`KernelOp.launch`;
- ``launches``: a plain integer, raised by one in :meth:`KernelOp.launch`
  and nowhere else, so that a run can show which kernels it went through.

The device of the tensor arguments picks the backend (``config.get_backend``).
A CUDA tensor launches the kernel or raises; nothing catches that error and
runs the twin instead.
"""

import ctypes
from typing import Callable

import torch

from .. import config
from .._error import (CUDANotInstalledError, KernelExecutionError,
                      KernelNotAvailableError, KernelRegistrationError)

__all__ = ['KernelOp', 'REGISTRY', 'check_device', 'tensor_device',
           'check_cuda_tensors', 'cuda_stream', 'launch_counts',
           'reset_launch_counts']

REGISTRY = {}


def check_device(device) -> torch.device:
    """Return *device* as a ``torch.device``; raise
    :class:`CUDANotInstalledError` for a CUDA device on a host without one."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise CUDANotInstalledError(
            f'device {device} requested, but torch.cuda.is_available() is '
            f'false on this host.')
    return device


def tensor_device(*args) -> torch.device:
    """The one device of the tensors among *args*; raises if they differ."""
    devices = {a.device for a in args if isinstance(a, torch.Tensor)}
    if len(devices) != 1:
        raise ValueError(f'expected tensors on one device, got {devices or "none"}')
    return devices.pop()


def check_cuda_tensors(name: str, *pairs) -> torch.device:
    """Check ``(tensor, dtype)`` *pairs* for a kernel launch: one device,
    the given dtypes, contiguous. Returns the device."""
    device = pairs[0][0].device
    for t, dtype in pairs:
        if t.device != device:
            raise ValueError(f'{name}: tensors on {t.device} and {device}')
        if t.dtype != dtype:
            raise TypeError(f'{name}: expected {dtype}, got {t.dtype}')
        if not t.is_contiguous():
            raise ValueError(f'{name}: tensors must be contiguous')
    return device


def cuda_stream(device: torch.device) -> ctypes.c_void_p:
    """PyTorch's current stream on *device*, as a C pointer."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


class KernelOp:
    """One op: its plain PyTorch twin and its CUDA kernel wrapper.

    ``cuda(op, *args, **kwargs)`` receives the op itself so that it can
    launch through :meth:`launch`. ``source`` is the kernel's file in the
    repo and ``replaces`` the TPU kernel (``file:line``) it takes the
    place of.
    """

    def __init__(self, name: str, *, twin: Callable, cuda: Callable,
                 source: str, replaces: str):
        if name in REGISTRY:
            raise KernelRegistrationError(f'op {name!r} is already registered')
        self.name = name
        self.twin = twin
        self.cuda = cuda
        self.source = source
        self.replaces = replaces
        self.launches = 0
        REGISTRY[name] = self

    def __repr__(self):
        return f'KernelOp({self.name!r}, launches={self.launches})'

    def __call__(self, *args, **kwargs):
        device = tensor_device(*args)
        backend = config.get_backend(device.type)
        if backend == 'torch':
            return self.twin(*args, **kwargs)
        if backend == 'cuda':
            check_device(device)
            return self.cuda(self, *args, **kwargs)
        raise KernelNotAvailableError(
            f'{self.name}: no backend for {device.type} tensors; backends '
            f'exist for cpu ({config.backends_for("cpu")}) and cuda '
            f'({config.backends_for("cuda")}).')

    def launch(self, fn, *cargs) -> None:
        """Call the C entry point *fn*, raise if it reports a CUDA error,
        and count the launch."""
        err = fn(*cargs)
        if err != 0:
            from .cuda_build import error_string
            raise KernelExecutionError(
                f'{self.name}: launch failed with CUDA error {err} '
                f'({error_string(err)})')
        self.launches += 1


def launch_counts() -> dict:
    """``{op name: launches}`` for every registered op."""
    return {name: op.launches for name, op in REGISTRY.items()}


def reset_launch_counts() -> None:
    """Set every op's launch count to 0."""
    for op in REGISTRY.values():
        op.launches = 0
