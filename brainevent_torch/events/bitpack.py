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

"""Bit-packed event representation (``brainevent_tpu.events.bitpack``).

``bitpack`` packs 32 binary values per word; bit ``b`` of word ``w`` is
element ``w*32 + b`` along the packed axis. PyTorch on the CPU has no
uint32 shift or add, so the words are summed in int64 (distinct powers of
two, exact) and stored as ``torch.uint32``, the JAX package's dtype: the
packings are read, compared and moved, never computed on.
:class:`BitPackedBinary` is a ``BinaryArray`` that keeps the packing along
every axis beside its value.
"""

import torch

from .binary import BinaryArray
from .pallas_kernels import event_mask

__all__ = ['bitpack', 'BitPackedBinary']


def bitpack(arr, axis: int) -> torch.Tensor:
    """Pack the events of *arr* (true, or ``!= 0``) into uint32 words
    along *axis*; the axis shrinks to ``ceil(n / 32)``."""
    arr = event_mask(torch.as_tensor(arr))
    axis = axis % arr.ndim
    n = arr.shape[axis]
    n_words = -(-n // 32)
    pad = [0, 0] * arr.ndim                 # F.pad order: last axis first
    pad[2 * (arr.ndim - 1 - axis) + 1] = n_words * 32 - n
    padded = torch.nn.functional.pad(arr.to(torch.int64), pad)
    shape = list(padded.shape)
    shape[axis:axis + 1] = [n_words, 32]
    bits = 1 << torch.arange(32, dtype=torch.int64, device=arr.device)
    bits = bits.reshape([32] + [1] * (arr.ndim - 1 - axis))
    words = (padded.reshape(shape) * bits).sum(axis + 1)
    return words.to(torch.uint32)


class BitPackedBinary(BinaryArray):
    """Spike array kept both raw and bit-packed along every axis.

    ``value`` is the original tensor, which the products use (they are
    ``BinaryArray``'s); ``packed[i]`` is the uint32 packing along axis
    ``i``.
    """

    def __init__(self, value):
        super().__init__(value)
        self._packed = tuple(bitpack(self._value, axis)
                             for axis in range(self._value.ndim))

    @property
    def packed(self):
        """Tuple of per-axis packed uint32 tensors."""
        return self._packed

    @property
    def original_shape(self):
        return self.shape

    def dot(self, oc):
        return self.__matmul__(oc)
