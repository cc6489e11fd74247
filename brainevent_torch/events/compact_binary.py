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

"""``CompactBinary``: bit packing and stream compaction of spike events
(``brainevent_tpu.events.compact_binary``).

The static-capacity active-index list (``active_ids``/``n_active``) lets a
consumer iterate over ``active_ids[:n_active]`` without a dynamic shape.
``@`` multiplies through ``BinaryArray(value)``, so a ``CompactBinary`` is
an event operand wherever a ``BinaryArray`` is: :func:`is_event` and
:func:`event_value` are how the matrix classes (``Dense``, ``CSR``,
``CSC``) recognise and unwrap either.
"""

import numpy as np
import torch

from .base import EventRepresentation, extract_raw_value
from .bitpack import bitpack
from .compact_ops import (binary_1d_array_index_p_call,
                          binary_2d_array_index_p_call,
                          binary_2d_compact_only_p_call)

__all__ = ['CompactBinary', 'is_event', 'event_value']


class CompactBinary:
    """Binary events stored as (bit-packed words, compacted active ids).

    For a 1-D input ``(n,)``: packed along axis 0, ``active_ids`` the
    active elements. For a 2-D input ``(n, batch)``: packed along axis 1,
    ``active_ids`` the rows active in any batch column. Build with
    :meth:`from_array` (both), :meth:`from_array_light` (compaction only)
    or :meth:`from_packed` (precomputed pieces). ``__array_ufunc__ =
    None``: ``ndarray @ obj`` calls ``__rmatmul__``.
    """

    __array_ufunc__ = None

    __slots__ = ('_packed', '_active_ids', '_n_active', '_value',
                 '_n_orig', '_batch_size', '_bit_width')

    def __init__(self, packed, active_ids, n_active, value, n_orig,
                 batch_size=None, bit_width=32):
        self._packed = packed
        self._active_ids = active_ids
        self._n_active = n_active
        self._value = value
        self._n_orig = n_orig
        self._batch_size = batch_size
        self._bit_width = bit_width

    # -- constructors -----------------------------------------------------------

    @classmethod
    def from_array(cls, x, bit_width=32) -> 'CompactBinary':
        """Bit-pack and compact a dense 1-D or 2-D spike tensor."""
        x = torch.as_tensor(x)
        if x.ndim == 1:
            active_ids, n_active = binary_1d_array_index_p_call(x)
            return cls(bitpack(x, 0), active_ids, n_active, x, x.shape[0],
                       None, bit_width)
        if x.ndim == 2:
            packed, active_ids, n_active = binary_2d_array_index_p_call(x)
            return cls(packed, active_ids, n_active, x, x.shape[0],
                       x.shape[1], bit_width)
        raise ValueError(f'CompactBinary.from_array needs 1D/2D, got '
                         f'{x.ndim}D.')

    @classmethod
    def from_array_light(cls, x, bit_width=32) -> 'CompactBinary':
        """Compaction only (no bit packing); ``packed`` is ``None``."""
        x = torch.as_tensor(x)
        if x.ndim == 1:
            active_ids, n_active = binary_1d_array_index_p_call(x)
            return cls(None, active_ids, n_active, x, x.shape[0], None,
                       bit_width)
        if x.ndim == 2:
            active_ids, n_active = binary_2d_compact_only_p_call(x)
            return cls(None, active_ids, n_active, x, x.shape[0],
                       x.shape[1], bit_width)
        raise ValueError(f'from_array_light needs 1D/2D, got {x.ndim}D.')

    @classmethod
    def from_packed(cls, packed, active_ids, n_active, value, n_orig=None,
                    batch_size=None, bit_width=32) -> 'CompactBinary':
        """Assemble from precomputed components."""
        if n_orig is None:
            n_orig = value.shape[0]
        return cls(packed, active_ids, n_active, value, n_orig, batch_size,
                   bit_width)

    @classmethod
    def compacy_only_vector(cls, x) -> 'CompactBinary':
        """Compaction-only 1-D constructor (the JAX package's name, kept;
        :meth:`compact_only_vector` is the same)."""
        return cls.from_array_light(torch.as_tensor(x).reshape(-1))

    compact_only_vector = compacy_only_vector

    # -- properties ---------------------------------------------------------------

    @property
    def packed(self):
        """Bit-packed uint32 words (``None`` for a light construction)."""
        return self._packed

    @property
    def active_ids(self):
        """Int32 active ids; the valid ones are ``active_ids[:n_active]``."""
        return self._active_ids

    @property
    def n_active(self):
        """Int32 ``(1,)`` count of the valid ``active_ids``."""
        return self._n_active

    @property
    def value(self):
        """The original dense spike tensor (the products use it)."""
        return self._value

    @property
    def n_orig(self) -> int:
        return self._n_orig

    @property
    def batch_size(self):
        return self._batch_size

    @property
    def bit_width(self) -> int:
        return self._bit_width

    @property
    def shape(self):
        return tuple(self._value.shape)

    @property
    def ndim(self):
        return self._value.ndim

    @property
    def dtype(self):
        return self._value.dtype

    @property
    def size(self):
        return int(np.prod(self.shape)) if self.shape else 1

    def to_dense(self):
        """The original dense spike tensor."""
        return self._value

    # -- products -------------------------------------------------------------------

    def __matmul__(self, oc):
        from .binary import BinaryArray
        return BinaryArray(self._value) @ oc

    def __rmatmul__(self, oc):
        from .binary import BinaryArray
        return BinaryArray(self._value).__rmatmul__(oc)

    def __repr__(self):
        return (f'CompactBinary(shape={self.shape}, dtype={self.dtype}, '
                f'bit_width={self._bit_width})')


def is_event(x) -> bool:
    """Is *x* an event operand (an ``EventRepresentation`` or a
    ``CompactBinary``)?"""
    return isinstance(x, (EventRepresentation, CompactBinary))


def event_value(x):
    """The raw spike tensor of an event operand; anything else as it is."""
    if isinstance(x, CompactBinary):
        return x.value
    return extract_raw_value(x)
