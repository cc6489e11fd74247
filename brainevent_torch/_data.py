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

"""Base classes of the sparse data representations.

Counterpart of ``brainevent_tpu._data.DataRepresentation``: named tensor
buffers, a static logical ``shape``, and elementwise algebra lifted onto
the stored values. There are no pytrees in PyTorch, so the buffers are a
plain dict; the subclasses implement ``@``. :class:`JITCMatrix` is the base
of the implicit-connectivity matrices (``brainevent_torch.jitc``).
"""

import operator
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from ._error import UnsupportedOperationError

__all__ = ['DataRepresentation', 'JITCMatrix', 'as_operand']


def as_operand(x, device):
    """A numpy array as a tensor on *device* (``torch.as_tensor``);
    anything else as it is."""
    if isinstance(x, np.ndarray):
        return torch.as_tensor(x, device=device)
    return x


class DataRepresentation:
    """Base class of every sparse data representation.

    Subclass contract: ``shape`` is the logical dense shape; the tensors
    live in ``self._buffers`` (read as attributes); ``__matmul__`` and
    ``__rmatmul__`` implement the products; ``apply`` maps the stored
    values.

    ``__array_ufunc__ = None`` makes numpy defer: ``ndarray @ obj`` calls
    ``obj.__rmatmul__``, which takes the array as a tensor on the
    object's device (the JAX classes get the same from
    ``__array_priority__``).
    """

    __array_ufunc__ = None

    def __init__(self, shape: Tuple[int, ...]):
        self.shape = tuple(int(s) for s in shape)
        self._buffers: Dict[str, object] = {}

    def register_buffer(self, name: str, value=None) -> None:
        """Register a named tensor buffer."""
        self._buffers[name] = value

    def set_buffer(self, name: str, value) -> None:
        """Set a previously registered buffer."""
        if name not in self._buffers:
            raise KeyError(
                f'Buffer {name!r} is not registered on {type(self).__name__}; '
                f'registered: {sorted(self._buffers)}.')
        self._buffers[name] = value

    def buffers(self) -> Dict[str, object]:
        """The named-buffer dict (live reference)."""
        return self._buffers

    def __getattr__(self, name):
        # called only when normal lookup fails: expose buffers as attributes
        buffers = self.__dict__.get('_buffers')
        if buffers is not None and name in buffers:
            return buffers[name]
        raise AttributeError(
            f'{type(self).__name__!r} object has no attribute {name!r}')

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def T(self):
        return self.transpose()

    def transpose(self, axes=None):
        raise UnsupportedOperationError(
            f'{type(self).__name__} does not support transpose.')

    def apply(self, fn: Callable):
        """Apply *fn* elementwise to the stored values, keeping structure."""
        raise UnsupportedOperationError(
            f'{type(self).__name__} does not support apply.')

    def apply2(self, other, fn: Callable, *, reverse: bool = False):
        """Binary elementwise op against a scalar (subclasses widen this)."""
        if isinstance(other, (int, float, complex)) or (
                isinstance(other, torch.Tensor) and other.ndim == 0):
            if reverse:
                return self.apply(lambda d: fn(other, d))
            return self.apply(lambda d: fn(d, other))
        raise UnsupportedOperationError(
            f'{type(self).__name__}.apply2 only supports scalars by default, '
            f'got {type(other).__name__}.')

    def __mul__(self, other):
        return self.apply2(other, operator.mul)

    def __rmul__(self, other):
        return self.apply2(other, operator.mul, reverse=True)

    def __truediv__(self, other):
        return self.apply2(other, operator.truediv)

    def __add__(self, other):
        return self.apply2(other, operator.add)

    def __radd__(self, other):
        return self.apply2(other, operator.add, reverse=True)

    def __sub__(self, other):
        return self.apply2(other, operator.sub)

    def __rsub__(self, other):
        return self.apply2(other, operator.sub, reverse=True)

    def __neg__(self):
        return self.apply(operator.neg)

    def __repr__(self):
        return f'{type(self).__name__}(shape={self.shape})'


class JITCMatrix(DataRepresentation):
    """Base class of the implicit (just-in-time connectivity) matrices.

    The matrix is never stored: connectivity and weights are regenerated
    in the kernels from ``(weight params..., prob, seed)`` by the light-RNG
    sampler. Scalar algebra acts on the weight parameters; structure
    changes are not supported.
    """

    @classmethod
    def fromdense(cls, dense, **kwargs):
        raise UnsupportedOperationError(
            'JITC matrices are generative: they cannot be built from a dense '
            'array. Construct them from (weight params, prob, seed).')

    def update_on_pre(self, *args, **kwargs):
        raise UnsupportedOperationError(
            'JITC matrices have no stored weights to update.')

    def update_on_post(self, *args, **kwargs):
        raise UnsupportedOperationError(
            'JITC matrices have no stored weights to update.')
