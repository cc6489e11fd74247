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

"""``BinaryArray``: the spike-event wrapper (``brainevent_tpu.events.binary``).

``@`` against a dense weight tensor (or a numpy array) routes to the
event-driven ``binary_densemv``/``binary_densemm`` (K15, K16), with the
JAX package's orientation: ``s @ W`` is ``binary_densemv(W, s,
transpose=True)`` and ``S @ W`` is ``binary_densemm(W, S.T,
transpose=True).T``. Against a structure object (``Dense``, ``CSR``,
``CSC``, the JITC matrices) the product is deferred to that object, which
runs its own event kernels.
"""

import torch

from .._error import MathError
from .base import EventRepresentation, extract_raw_value, is_known_type

__all__ = ['BinaryArray']


class BinaryArray(EventRepresentation):
    """0/1 spike vector or matrix.

    >>> import torch, brainevent_torch as bt
    >>> s = bt.BinaryArray(torch.tensor([True, False, True]))
    >>> s @ torch.tensor([[1., 2.], [3., 4.], [5., 6.]])
    tensor([6., 8.])
    """

    def bitpack(self):
        """A :class:`~brainevent_torch.BitPackedBinary` of this array."""
        from .bitpack import BitPackedBinary
        return BitPackedBinary(self.value)

    @property
    def T(self):
        """Transposed raw tensor (not re-wrapped, as in the JAX package)."""
        return self.value.T

    def transpose(self, *axes):
        """The raw tensor with its axes permuted."""
        return self.value.permute(*axes) if axes else self.value.T

    def _dense_operand(self, oc, side: str) -> torch.Tensor:
        oc = torch.as_tensor(extract_raw_value(oc), device=self.value.device)
        if self.ndim not in (1, 2):
            raise MathError(
                f'Matrix multiplication is only supported for 1D and 2D '
                f'event arrays; got {self.ndim}D.')
        if oc.ndim != 2:
            raise MathError(
                f'{side} operand must be a 2D weight matrix, got {oc.ndim}D.')
        return oc

    def __matmul__(self, oc):
        from ..dense.binary import binary_densemm, binary_densemv
        if not is_known_type(oc):
            return oc.__rmatmul__(self)
        oc = self._dense_operand(oc, 'Right')
        if self.shape[-1] != oc.shape[0]:
            raise MathError(f'Incompatible matmul dimensions: '
                            f'{self.shape[-1]} vs {oc.shape[0]}.')
        if self.ndim == 1:
            # y[j] = sum over active i of oc[i, j]
            return binary_densemv(oc, self.value, transpose=True)
        return binary_densemm(oc, self.value.T, transpose=True).T

    def __rmatmul__(self, oc):
        from ..dense.binary import binary_densemm, binary_densemv
        if not is_known_type(oc):
            return oc.__matmul__(self)
        oc = self._dense_operand(oc, 'Left')
        if oc.shape[-1] != self.shape[0]:
            raise MathError(f'Incompatible matmul dimensions: '
                            f'{oc.shape[-1]} vs {self.shape[0]}.')
        if self.ndim == 1:
            # y[i] = sum over active j of oc[i, j]
            return binary_densemv(oc, self.value, transpose=False)
        return binary_densemm(oc, self.value, transpose=False)

    def __imatmul__(self, oc):
        return self.__matmul__(oc)
