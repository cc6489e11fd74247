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

"""``Dense``: a dense weight matrix whose ``@`` runs the event products
(``brainevent_tpu.dense.main``).

``Dense @ BinaryArray`` and ``BinaryArray @ Dense`` (or a
:class:`~brainevent_torch.CompactBinary`) route to ``binary_densemv``/
``binary_densemm`` (K15, K16); a plain tensor operand takes
``torch.matmul``. The STDP methods run K17 and return a new ``Dense``.
There are no units: the weights are a plain tensor. ``tocoo`` is not
ported yet (the port's CSR has no ``tocoo``; ``ROADMAP.md``).
"""

import numpy as np
import torch

from .._data import DataRepresentation
from .._error import MathError, UnsupportedOperationError
from ..events.compact_binary import event_value, is_event
from .binary import binary_densemm, binary_densemv
from .plasticity import update_dense_on_binary_post, update_dense_on_binary_pre

__all__ = ['Dense']


class Dense(DataRepresentation):
    """A dense weight matrix that understands event operands.

    >>> import torch, brainevent_torch as bt
    >>> W = bt.Dense(torch.tensor([[1., 2.], [3., 4.]]))
    >>> bt.BinaryArray(torch.tensor([True, False])) @ W
    tensor([1., 2.])
    """

    def __init__(self, data, *, shape=None):
        data = torch.as_tensor(data)
        if data.ndim != 2:
            raise MathError(f'Dense data must be 2D, got {data.ndim}D.')
        super().__init__(shape if shape is not None else data.shape)
        self.register_buffer('data', data)

    # -- structure ------------------------------------------------------------

    @property
    def nse(self) -> int:
        return self.data.numel()

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    # -- conversions ----------------------------------------------------------

    @classmethod
    def fromdense(cls, mat, **kwargs) -> 'Dense':
        return cls(mat)

    def with_data(self, data) -> 'Dense':
        """The same shape, new values."""
        data = torch.as_tensor(data, device=self.device)
        if tuple(data.shape) != self.shape:
            raise MathError(f'data shape {tuple(data.shape)} != {self.shape}')
        return Dense(data)

    def todense(self):
        return self.data

    def tocsr(self, *, nse=None, index_dtype=torch.int32):
        from ..csr.main import CSR
        return CSR.fromdense(self.data, nse=nse, index_dtype=index_dtype)

    def tocsc(self, *, nse=None, index_dtype=torch.int32):
        from ..csr.main import CSC
        return CSC.fromdense(self.data, nse=nse, index_dtype=index_dtype)

    def tocoo(self):
        raise UnsupportedOperationError(
            'Dense.tocoo goes through CSR.tocoo, which brainevent_torch does '
            'not port yet; see ROADMAP.md, Queue A item 3.')

    def transpose(self, axes=None) -> 'Dense':
        if axes is not None:
            raise MathError('transpose with axes is not supported.')
        return Dense(self.data.T)

    def slice_rows(self, index) -> 'Dense':
        return Dense(self.data[index])

    def diag_add(self, other) -> 'Dense':
        """``data`` with *other* added along the main diagonal, out of
        place."""
        data = self.data.clone()
        data.diagonal().add_(torch.as_tensor(other, device=self.device))
        return Dense(data)

    def solve(self, b, tol=1e-6, reorder=1):
        """``x`` with ``data @ x = b`` (``torch.linalg.solve``)."""
        del tol, reorder
        return torch.linalg.solve(self.data,
                                  torch.as_tensor(b, device=self.device))

    # -- elementwise ----------------------------------------------------------

    def apply(self, fn) -> 'Dense':
        return Dense(fn(self.data))

    def apply2(self, other, fn, *, reverse: bool = False):
        if isinstance(other, Dense):
            other = other.data
        elif isinstance(other, np.ndarray):
            other = torch.as_tensor(other, device=self.device)
        if reverse:
            return Dense(fn(other, self.data))
        return Dense(fn(self.data, other))

    # -- plasticity -----------------------------------------------------------

    def update_on_pre(self, pre_spike, post_trace, w_min=None,
                      w_max=None) -> 'Dense':
        """STDP on-pre (K17): a new ``Dense``. *pre_spike* is a
        ``BinaryArray``, a ``CompactBinary`` or a raw tensor."""
        return Dense(update_dense_on_binary_pre(
            self.data, event_value(pre_spike), post_trace, w_min, w_max))

    def update_on_post(self, pre_trace, post_spike, w_min=None,
                       w_max=None) -> 'Dense':
        """STDP on-post (K17): a new ``Dense``."""
        return Dense(update_dense_on_binary_post(
            self.data, pre_trace, event_value(post_spike), w_min, w_max))

    # -- dt2t (per-connection broadcast; every entry of Dense is one) ---------

    def dt2t(self, y, transpose: bool = False):
        y = torch.as_tensor(y, device=self.device)
        if transpose:
            return self.data * y[None, :]
        return self.data * y[:, None]

    def dt2t_transposed(self, y):
        return self.dt2t(y, transpose=True)

    # -- products ---------------------------------------------------------------

    def __matmul__(self, other):
        if is_event(other):
            ev = event_value(other)
            if ev.ndim == 1:
                return binary_densemv(self.data, ev, transpose=False)
            return binary_densemm(self.data, ev, transpose=False)
        return self.data @ torch.as_tensor(other, device=self.device)

    def __rmatmul__(self, other):
        if is_event(other):
            ev = event_value(other)
            if ev.ndim == 1:
                return binary_densemv(self.data, ev, transpose=True)
            return binary_densemm(self.data, ev.T, transpose=True).T
        other = torch.as_tensor(other, device=self.device)
        dtype = torch.promote_types(other.dtype, self.data.dtype)
        return other.to(dtype) @ self.data.to(dtype)

    def __repr__(self):
        return f'Dense(shape={self.shape}, dtype={self.dtype})'
