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

"""CSR/CSC sparse matrices whose ``@`` runs the event-driven or the float
products (``brainevent_tpu.csr.main``).

A matrix holds ``data`` (``(1,)`` or one value per entry), ``indices`` and
``indptr`` (int32, converted once at construction), all on one device.
Its CSC mirror ``(t_indptr, t_indices, perm)`` is built on request
(:meth:`CompressedSparseData.build_weight_indices`, :meth:`CSR.tocsc`),
or on the first transposed mat-mat product, and kept: a float product in
the transposed direction then reads the mirror through ``perm``, with no
float atomics. Dispatch of ``@``:

- a :class:`~brainevent_torch.BinaryArray` or
  :class:`~brainevent_torch.CompactBinary` operand (its ``value``): the
  event products (``binary_csrmv``, K7 or K8; ``binary_csrmm``, K10);
- a float tensor: ``csrmv`` (K7, or K8/the mirror transposed) and
  ``csrmm`` (K10), or, for a 1-D operand after :meth:`build_mxu_plan`,
  the gather plans through K3 (``plan_matvec_vjp``), as in the JAX
  package.

The JAX package's dense-mirror route for mat-mat products runs only on a
TPU, and the port has none. ``solve``, ``slice_rows``/``__getitem__``,
``diag_add``, the ``dt2t`` family and ``tocoo`` are not ported yet
(``ROADMAP.md``).
"""

from typing import Tuple

import numpy as np
import torch

from .._data import DataRepresentation
from .._error import MathError, UnsupportedOperationError
from .._misc import csr_to_coo_index, csr_to_csc_index
from ..events.compact_binary import event_value, is_event
from .float import ProductSpec, csr_product, prepare
from .plasticity import (update_csc_on_binary_post, update_csc_on_binary_pre,
                         update_csr_on_binary_post, update_csr_on_binary_pre)

__all__ = ['CompressedSparseData', 'CSR', 'CSC']

_MIRROR = ('_t_indptr', '_t_indices', '_t_perm')


class CompressedSparseData(DataRepresentation):
    """Shared machinery of :class:`CSR` and :class:`CSC`: ``(data,
    indices, indptr)`` plus the cached transpose mirror."""

    def __init__(self, args, *, shape: Tuple[int, int]):
        data, indices, indptr = args
        super().__init__(shape)
        indices = torch.as_tensor(indices)
        device = (data.device if isinstance(data, torch.Tensor)
                  else indices.device)
        self.register_buffer('data', torch.atleast_1d(
            torch.as_tensor(data, device=device)))
        self.register_buffer('indices', indices.to(device, torch.int32))
        self.register_buffer('indptr', torch.as_tensor(indptr).to(
            device, torch.int32))
        for name in _MIRROR:
            self.register_buffer(name, None)
        self._mxu_plans = None
        self._mxu_wviews = None

    @property
    def nse(self) -> int:
        return self.indices.shape[0]

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    def _csr_shape(self) -> Tuple[int, int]:
        """Logical shape of the row-compressed view stored in (indices,
        indptr): ``shape`` for CSR, reversed for CSC."""
        raise NotImplementedError

    def _new(self, data, indices=None, indptr=None):
        obj = type(self)(
            (data, self.indices if indices is None else indices,
             self.indptr if indptr is None else indptr), shape=self.shape)
        if indices is None and indptr is None:
            # structure-only caches survive a change of values
            for name in _MIRROR:
                obj._buffers[name] = self._buffers[name]
            obj._mxu_plans = self._mxu_plans
        return obj

    def with_data(self, data):
        """Same structure, new values."""
        data = torch.atleast_1d(torch.as_tensor(data, device=self.device))
        if tuple(data.shape) not in ((1,), (self.nse,)):
            raise MathError(f'data shape {tuple(data.shape)} incompatible '
                            f'with nse {self.nse}')
        return self._new(data)

    def apply(self, fn):
        return self._new(fn(self.data))

    def apply2(self, other, fn, *, reverse: bool = False):
        if isinstance(other, CompressedSparseData):
            if other.shape != self.shape or other.nse != self.nse:
                raise MathError('Elementwise ops between sparse matrices '
                                'require identical structure.')
            other = other.data
        if isinstance(other, np.ndarray):
            other = torch.as_tensor(other, device=self.device)
        if isinstance(other, torch.Tensor) and other.ndim > 0 and (
                other.ndim > 1 or tuple(other.shape) not in ((1,),
                                                             (self.nse,))):
            raise UnsupportedOperationError(
                'Elementwise ops on sparse matrices accept scalars, (1,)/(nse,) '
                'tensors, or same-structure matrices.')
        if reverse:
            return self._new(fn(other, self.data))
        return self._new(fn(self.data, other))

    # -- transpose mirror ----------------------------------------------------------

    def build_weight_indices(self):
        """Build and cache the transpose mirror ``(t_indptr, t_indices,
        perm)``, with ``data[perm]`` the mirror's values. Returns self."""
        if self._t_perm is None:
            mirror = csr_to_csc_index(self.indptr, self.indices,
                                      shape=self._csr_shape())
            for name, t in zip(_MIRROR, mirror):
                self._buffers[name] = t
        return self

    @property
    def weight_indices(self):
        """The permutation from mirror slots to data slots (or ``None``)."""
        return self._t_perm

    def _mirror(self):
        if self._t_perm is None:
            return None
        return tuple(self._buffers[name] for name in _MIRROR)

    # -- the gather-plan route ---------------------------------------------------

    def build_mxu_plan(self, **knobs):
        """Build and cache the gather-plan pair of the structure (both
        directions, ``ops/mxu_gather.py``); 1-D float products then run
        through K3 (``plan_matvec_vjp``) while ``data`` does not require a
        gradient. The plans are built in numpy on the host. Returns
        self."""
        if self._mxu_plans is None:
            from ..ops.mxu_gather import build_gather_plan
            indices = self.indices.cpu().numpy()
            indptr = self.indptr.cpu().numpy()
            m, k = self._csr_shape()
            rows = np.repeat(np.arange(m), np.diff(indptr))
            plan = build_gather_plan(rows, indices, (m, k), **knobs)
            plan_t = build_gather_plan(indices, rows, (k, m), **knobs)
            self._mxu_plans = (plan.to(self.device), plan_t.to(self.device))
        return self

    def _mxu_matvec(self, v, *, csr_transpose: bool):
        """1-D float product through the cached plan pair, or ``None``
        (no plans, or weights that need their gradient)."""
        if self._mxu_plans is None or v.ndim != 1 or self.data.requires_grad:
            return None
        from ..ops.mxu_gather import plan_matvec_rows
        plan, plan_t = self._mxu_plans
        if self._mxu_wviews is None:
            self._mxu_wviews = (plan.sort_rows(self.data),
                                plan_t.sort_rows(self.data))
        w_s, w_t = self._mxu_wviews
        if csr_transpose:
            return plan_matvec_rows(plan_t, plan, w_t, w_s, v)
        return plan_matvec_rows(plan, plan_t, w_s, w_t, v)

    # -- products ---------------------------------------------------------------------

    def _product(self, operand, *, transpose: bool, binary: bool):
        """The product of the stored row-compressed view: ``A @ x``, or
        ``A.T @ x`` with ``transpose``."""
        if not binary:
            fast = self._mxu_matvec(operand, csr_transpose=transpose)
            if fast is not None:
                return fast
        if transpose and operand.ndim == 2:
            self.build_weight_indices()
        w, idx, ptr, x = prepare(self.data, self.indices, self.indptr,
                                 operand, shape=self._csr_shape(),
                                 transpose=transpose, binary=binary,
                                 ndim=operand.ndim)
        return csr_product(w, idx, ptr, x, ProductSpec(
            self._csr_shape(), transpose, binary, mirror=self._mirror()))

    def _matmul(self, other, *, transpose: bool, left: bool):
        """``self @ other`` (``left=False``) or ``other @ self``; a 2-D
        left operand is transposed in and the result out."""
        binary = is_event(other)
        x = torch.as_tensor(event_value(other), device=self.device)
        if x.ndim not in (1, 2):
            raise MathError(f'CSR products take a 1-D or 2-D operand, got '
                            f'{x.ndim}-D.')
        if left and x.ndim == 2:
            return self._product(x.T, transpose=transpose, binary=binary).T
        return self._product(x, transpose=transpose, binary=binary)


class CSR(CompressedSparseData):
    """Compressed Sparse Row matrix.

    >>> import torch, brainevent_torch as bt
    >>> A = bt.CSR.fromdense(torch.tensor([[1., 0.], [0., 2.]]))
    >>> A @ torch.ones(2)
    tensor([1., 2.])
    >>> bt.BinaryArray(torch.tensor([True, False])) @ A
    tensor([1., 0.])
    """

    def _csr_shape(self):
        return self.shape

    @classmethod
    def fromdense(cls, mat, *, nse=None, index_dtype=torch.int32) -> 'CSR':
        """Build from a dense matrix (entries in row-major order)."""
        mat = torch.as_tensor(mat)
        if mat.ndim != 2:
            raise MathError(f'fromdense needs a 2D matrix, got {mat.ndim}D.')
        rows, cols = torch.nonzero(mat, as_tuple=True)
        if nse is not None and rows.shape[0] != nse:
            rows, cols = rows[:nse], cols[:nse]
        counts = torch.bincount(rows, minlength=mat.shape[0])
        indptr = torch.zeros(mat.shape[0] + 1, dtype=index_dtype,
                             device=mat.device)
        indptr[1:] = torch.cumsum(counts, 0)
        return cls((mat[rows, cols], cols.to(index_dtype), indptr),
                   shape=tuple(mat.shape))

    def todense(self):
        rows, cols = csr_to_coo_index(self.indptr, self.indices)
        d = self.data.expand(self.nse)
        return torch.zeros(self.shape, dtype=d.dtype,
                           device=self.device).index_put_(
            (rows, cols), d, accumulate=True)

    def tocsr(self) -> 'CSR':
        return self

    def tocsc(self) -> 'CSC':
        """The same logical matrix in column-compressed storage."""
        self.build_weight_indices()
        d = self.data if self.data.shape[0] == 1 else self.data[self._t_perm]
        return CSC((d, self._t_indices, self._t_indptr), shape=self.shape)

    def transpose(self, axes=None) -> 'CSC':
        """Zero-copy transpose: the same buffers viewed as CSC of ``A.T``."""
        if axes is not None:
            raise MathError('transpose with axes is not supported.')
        obj = CSC((self.data, self.indices, self.indptr),
                  shape=(self.shape[1], self.shape[0]))
        for name in _MIRROR:
            obj._buffers[name] = self._buffers[name]
        return obj

    def update_on_pre(self, pre_spike, post_trace, w_min=None,
                      w_max=None) -> 'CSR':
        new_data = update_csr_on_binary_pre(
            self.data, self.indices, self.indptr,
            event_value(pre_spike), post_trace, w_min, w_max,
            shape=self.shape)
        return self._new(new_data)

    def update_on_post(self, pre_trace, post_spike, w_min=None,
                       w_max=None) -> 'CSR':
        new_data = update_csr_on_binary_post(
            self.data, self.indices, self.indptr, self.weight_indices,
            pre_trace, event_value(post_spike), w_min, w_max,
            shape=self.shape)
        return self._new(new_data)

    def __matmul__(self, other):
        return self._matmul(other, transpose=False, left=False)

    def __rmatmul__(self, other):
        return self._matmul(other, transpose=True, left=True)

    def __repr__(self):
        return f'CSR(shape={self.shape}, nse={self.nse}, dtype={self.dtype})'


class CSC(CompressedSparseData):
    """Compressed Sparse Column matrix, stored as the CSR arrays of
    ``A.T``: ``indptr`` runs over the columns of the logical ``(m, k)``
    matrix and ``indices`` holds row ids."""

    def _csr_shape(self):
        return (self.shape[1], self.shape[0])

    @classmethod
    def fromdense(cls, mat, *, nse=None, index_dtype=torch.int32) -> 'CSC':
        mat = torch.as_tensor(mat)
        csr_t = CSR.fromdense(mat.T, nse=nse, index_dtype=index_dtype)
        return cls((csr_t.data, csr_t.indices, csr_t.indptr),
                   shape=tuple(mat.shape))

    def todense(self):
        return CSR((self.data, self.indices, self.indptr),
                   shape=self._csr_shape()).todense().T

    def tocsc(self) -> 'CSC':
        return self

    def tocsr(self) -> 'CSR':
        self.build_weight_indices()
        d = self.data if self.data.shape[0] == 1 else self.data[self._t_perm]
        return CSR((d, self._t_indices, self._t_indptr), shape=self.shape)

    def transpose(self, axes=None) -> 'CSR':
        if axes is not None:
            raise MathError('transpose with axes is not supported.')
        obj = CSR((self.data, self.indices, self.indptr),
                  shape=(self.shape[1], self.shape[0]))
        for name in _MIRROR:
            obj._buffers[name] = self._buffers[name]
        return obj

    def update_on_pre(self, pre_spike, post_trace, w_min=None,
                      w_max=None) -> 'CSC':
        new_data = update_csc_on_binary_pre(
            self.data, self.indices, self.indptr,
            event_value(pre_spike), post_trace, w_min, w_max,
            shape=self.shape)
        return self._new(new_data)

    def update_on_post(self, pre_trace, post_spike, w_min=None,
                       w_max=None) -> 'CSC':
        new_data = update_csc_on_binary_post(
            self.data, self.indices, self.indptr, pre_trace,
            event_value(post_spike), w_min, w_max, shape=self.shape)
        return self._new(new_data)

    # A is (m, k); the stored arrays are the CSR of A.T (k, m)
    def __matmul__(self, other):
        return self._matmul(other, transpose=True, left=False)

    def __rmatmul__(self, other):
        return self._matmul(other, transpose=False, left=True)

    def __repr__(self):
        return f'CSC(shape={self.shape}, nse={self.nse}, dtype={self.dtype})'
