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

Against a sparse structure object (``CSR``, ``CSC``) the product is
deferred to that object, which runs its own event kernels. The product
against a dense tensor needs the dense event products
(``dense/binary.py``, TPU kernel B9), which are not ported yet: it raises
:class:`~brainevent_torch.UnsupportedOperationError`.
"""

from .._error import UnsupportedOperationError
from .base import EventRepresentation, is_known_type

__all__ = ['BinaryArray']

_DENSE = ('BinaryArray @ dense tensor needs the dense event products '
          '(brainevent_tpu/dense/binary.py, kernel B9), which brainevent_torch '
          'does not port yet; see ROADMAP.md, Queue A item 9.')


class BinaryArray(EventRepresentation):
    """0/1 spike vector or matrix.

    >>> import torch, brainevent_torch as bt
    >>> A = bt.CSR.fromdense(torch.tensor([[1., 0.], [0., 2.]]))
    >>> bt.BinaryArray(torch.tensor([True, False])) @ A
    tensor([1., 0.])
    """

    @property
    def T(self):
        """Transposed raw tensor (not re-wrapped, as in the JAX package)."""
        return self.value.T

    def transpose(self, *axes):
        """The raw tensor with its axes permuted."""
        return self.value.permute(*axes) if axes else self.value.T

    def __matmul__(self, oc):
        if is_known_type(oc):
            raise UnsupportedOperationError(_DENSE)
        return oc.__rmatmul__(self)

    def __rmatmul__(self, oc):
        if is_known_type(oc):
            raise UnsupportedOperationError(_DENSE)
        return oc.__matmul__(self)
