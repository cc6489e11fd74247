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

"""Exception taxonomy for brainevent-torch.

The same classes, under the same names, as ``brainevent_tpu._error``, so
code that catches a failure category works against either package. In
the port, ``NvccNotFoundError`` is raised when a CUDA kernel must be built
and no ``nvcc`` is found, ``CompilationError`` when ``nvcc`` fails,
``CUDANotInstalledError`` when a CUDA device is requested on a host
without one, and ``KernelExecutionError`` when a launch reports a CUDA
error. ``MosaicCompilationError`` is kept only for name parity.

Hierarchy::

    BrainEventError
    ├── MathError
    ├── UnsupportedOperationError
    ├── BenchmarkDataFnNotProvidedError
    └── KernelError
        ├── KernelNotAvailableError
        ├── KernelCompilationError
        │   └── CompilationError
        │       ├── HostCompilerIncompatibleError
        │       └── MosaicCompilationError
        ├── KernelFallbackExhaustedError
        ├── KernelExecutionError
        ├── CUDANotInstalledError
        ├── KernelToolchainError
        │   ├── NvccNotFoundError
        │   ├── HostCompilerNotFoundError
        │   ├── HeaderNotFoundError
        │   ├── GpuArchDetectionError
        │   └── UnsupportedArchError
        ├── KernelLoadError
        └── KernelRegistrationError
"""

__all__ = [
    'BrainEventError',
    'MathError',
    'UnsupportedOperationError',
    'KernelError',
    'KernelNotAvailableError',
    'KernelCompilationError',
    'CompilationError',
    'MosaicCompilationError',
    'HostCompilerIncompatibleError',
    'KernelFallbackExhaustedError',
    'KernelExecutionError',
    'CUDANotInstalledError',
    'KernelToolchainError',
    'NvccNotFoundError',
    'HostCompilerNotFoundError',
    'HeaderNotFoundError',
    'GpuArchDetectionError',
    'UnsupportedArchError',
    'KernelLoadError',
    'KernelRegistrationError',
    'BenchmarkDataFnNotProvidedError',
]


class BrainEventError(Exception):
    """Base class for every error raised by brainevent-torch."""


class MathError(BrainEventError):
    """Mathematically invalid operation (shape/dtype/value contract broken)."""


class UnsupportedOperationError(BrainEventError):
    """Operation not supported for the given operand types or layout."""


class BenchmarkDataFnNotProvidedError(BrainEventError):
    """A benchmark was asked of an op that registered no benchmark data."""


class KernelError(BrainEventError):
    """Base class for kernel selection/compilation/execution failures."""


class KernelNotAvailableError(KernelError):
    """No kernel for the requested device type or backend; the message
    names the backends that exist (see ``config.set_backend``)."""


class KernelCompilationError(KernelError):
    """A kernel failed to compile."""


class CompilationError(KernelCompilationError):
    """Native source compilation (g++/nvcc) returned a non-zero status."""


class MosaicCompilationError(CompilationError):
    """Kept for name parity with ``brainevent_tpu``; the port raises it
    nowhere."""


class HostCompilerIncompatibleError(CompilationError):
    """The detected host C++ compiler cannot build the kernel library."""


class KernelFallbackExhaustedError(KernelError):
    """Every registered backend for a platform failed; lists each failure."""


class KernelExecutionError(KernelError):
    """A kernel compiled but failed at run time."""


class CUDANotInstalledError(KernelError):
    """A CUDA device was requested on a host where
    ``torch.cuda.is_available()`` is false."""


class KernelToolchainError(KernelError):
    """Failure discovering or validating the native toolchain."""


class NvccNotFoundError(KernelToolchainError):
    """``nvcc`` not found where a CUDA kernel has to be built."""


class HostCompilerNotFoundError(KernelToolchainError):
    """No usable host C++ compiler (g++/clang++) found."""


class HeaderNotFoundError(KernelToolchainError):
    """A required header could not be located."""


class GpuArchDetectionError(KernelToolchainError):
    """GPU compute-capability detection failed."""


class UnsupportedArchError(KernelToolchainError):
    """The requested architecture is not supported by the toolchain."""


class KernelLoadError(KernelError):
    """The compiled kernel library could not be loaded or lacks a symbol."""


class KernelRegistrationError(KernelError):
    """Two ops registered under one name, or an invalid registration."""
