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

"""Event representation base class.

Counterpart of ``brainevent_tpu.events.base``: an
:class:`EventRepresentation` wraps a tensor of spike events and overloads
``@`` so that a product against a weight structure routes to that
structure's event-driven kernels. Bool entries are events; float entries
are events where ``> 0``.
"""

import abc
from typing import Tuple

import numpy as np
import torch

__all__ = ['extract_raw_value', 'is_known_type', 'EventRepresentation']


def extract_raw_value(obj):
    """Unwrap an event representation into its raw tensor."""
    if isinstance(obj, EventRepresentation):
        return obj.value
    return obj


def is_known_type(x) -> bool:
    """Whether *x* is a raw array-like operand (not a sparse structure
    object that handles the product itself)."""
    return isinstance(x, (torch.Tensor, np.ndarray, EventRepresentation))


class EventRepresentation(abc.ABC):
    """Tensor wrapper marking its content as spike events.

    ``__array_ufunc__ = None``: ``ndarray @ events`` calls
    ``__rmatmul__``, which takes the array as a tensor.
    """

    __array_ufunc__ = None

    def __init__(self, value):
        self._value = (value if isinstance(value, torch.Tensor)
                       else torch.as_tensor(value))

    @property
    def value(self) -> torch.Tensor:
        """The wrapped raw tensor."""
        return self._value

    @value.setter
    def value(self, val):
        self._value = val

    def with_value(self, value) -> 'EventRepresentation':
        """A new wrapper of the same type around *value*."""
        obj = type(self).__new__(type(self))
        obj._value = value
        return obj

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self._value.shape)

    @property
    def ndim(self) -> int:
        return self._value.ndim

    @property
    def dtype(self):
        return self._value.dtype

    @property
    def size(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    def __len__(self):
        return self.shape[0]

    def __getitem__(self, item):
        return self.with_value(self._value[item])

    @abc.abstractmethod
    def __matmul__(self, other):
        ...

    @abc.abstractmethod
    def __rmatmul__(self, other):
        ...

    def __repr__(self):
        return f'{type(self).__name__}(shape={self.shape}, dtype={self.dtype})'
