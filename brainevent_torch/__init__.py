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

"""brainevent-torch: event-driven spiking-network simulation in PyTorch,
with hand-written CUDA kernels for NVIDIA Hopper.

The port of ``brainevent_tpu`` (JAX/Pallas), module for module and under
the same names. It imports ``torch`` and ``numpy``, never ``jax``. Each op
has a plain PyTorch twin, which runs for CPU tensors, and a CUDA kernel,
which runs for CUDA tensors; the kernels are compiled by ``nvcc`` at first
use (:mod:`brainevent_torch.ops.cuda_build`).
"""

from ._version import __version__, __version_info__
from . import config
from ._error import (
    BrainEventError, MathError, UnsupportedOperationError, KernelError,
    KernelNotAvailableError, KernelCompilationError, CompilationError,
    KernelExecutionError, CUDANotInstalledError, KernelToolchainError,
    NvccNotFoundError, KernelLoadError, KernelRegistrationError,
)
from .fcn import event_capacity
from .ops import (
    KernelOp, launch_counts, reset_launch_counts, event_scatter_add,
    event_scatter_add_multi,
)
from .models import (
    LIFRefParams, LIFRefState, lifref_init, lifref_step, surrogate_spike,
    EINet, EINetState, einet_pallas_sim, mxu6_conn_table,
)
from .interop import einet_from_arrays

__all__ = [
    '__version__', '__version_info__', 'config',
    'BrainEventError', 'MathError', 'UnsupportedOperationError',
    'KernelError', 'KernelNotAvailableError', 'KernelCompilationError',
    'CompilationError', 'KernelExecutionError', 'CUDANotInstalledError',
    'KernelToolchainError', 'NvccNotFoundError', 'KernelLoadError',
    'KernelRegistrationError',
    'event_capacity', 'KernelOp', 'launch_counts', 'reset_launch_counts',
    'event_scatter_add', 'event_scatter_add_multi',
    'LIFRefParams', 'LIFRefState', 'lifref_init', 'lifref_step',
    'surrogate_spike', 'EINet', 'EINetState', 'einet_pallas_sim',
    'mxu6_conn_table', 'einet_from_arrays',
]
