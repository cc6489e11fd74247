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

"""Just-in-time connectivity matrix classes (``brainevent_tpu.jitc.classes``).

:func:`make_classes` builds the ``(Matrix, R, C)`` classes of a family:
``R`` is the row-oriented generative matrix, ``C`` its transpose with the
same parameters. Products keep the same sampled matrix in both directions
by flipping ``(transpose, corder)`` together. The ``.mv`` / ``.mm`` views
materialize the matrix that the mv mode (stride 32) or the mm mode
(stride 4) samples; the two differ.

A matrix holds its weight parameters as given (numbers or one-element
tensors, read as float32 by a product or, once, by a plan), ``prob``,
``seed`` and a
``device`` (``None`` means the card). A 1-D product goes through a
:class:`JITCWalkPlan` built on the first such product and kept (on the
card the plan's streams are read faster than each stream's setup is
drawn again); 2-D products sample the mm-mode matrix per call.
``tocsr``/``tocsc``/``tocoo``, ``dt2t`` and the mode views' conversions
other than ``todense`` are not ported (``ROADMAP.md``).
"""

from typing import Tuple

import torch

from .._data import JITCMatrix, as_operand
from .._error import MathError, UnsupportedOperationError
from ..events.base import EventRepresentation, extract_raw_value
from ..ops.core import check_device
from .family import _prob, _seed

__all__ = ['make_classes', 'JITCModeView', 'JITCWalkPlan']

_NO_CSR = ('JITC -> CSR conversion (count/fill/to_csr) is not ported to '
           'brainevent_torch yet; see ROADMAP.md, Queue A.')


class JITCWalkPlan:
    """The walk streams of one JITC matrix, built once (K11).

    ``plan @ v`` / ``v @ plan`` compute the same product as the bound
    matrix, over the plan's streams: the stride-32 (mv-mode) matrix; a
    2-D operand applies that matrix to every column (``matrix @ B``
    samples the mm-mode matrix instead). The plan has none of the JAX
    package's event-route knobs (``scan_rounds``, ``event_cap``,
    ``row_cap``): on the card every event product is one K12 launch. The
    kernels' law arguments are derived once, here, for every product.
    """

    __array_ufunc__ = None

    def __init__(self, family, matrix, shape, transpose, corder, clen,
                 setup):
        self._family = family
        self.matrix = matrix
        self._shape = tuple(shape)
        self._transpose = bool(transpose)
        self._corder = bool(corder)
        self.clen = clen
        self.setup = tuple(setup)
        self._law_args = family.law_args(matrix.data, matrix.seed)

    @property
    def shape(self):
        """Logical (rows, cols) of the bound matrix."""
        if self._transpose:
            return (self._shape[1], self._shape[0])
        return self._shape

    def _product(self, operand, event: bool, *, flip: bool):
        state2, q2, cl = self.setup
        return self._family.product(
            self.matrix.data, self._law_args, cl, operand, shape=self._shape,
            transpose=self._transpose != flip, corder=self._corder != flip,
            event=event, stride_mm=32, setup=(state2, q2))

    def __matmul__(self, other):
        event = isinstance(other, EventRepresentation)
        raw = as_operand(extract_raw_value(other), self.matrix.device)
        return self._product(raw, event, flip=False)

    def __rmatmul__(self, other):
        event = isinstance(other, EventRepresentation)
        raw = as_operand(extract_raw_value(other), self.matrix.device)
        if raw.ndim == 1:
            return self._product(raw, event, flip=True)
        return self._product(raw.T, event, flip=True).T

    def __repr__(self):
        return (f'JITCWalkPlan({self.matrix!r}, walk_shape={self._shape}, '
                f'transpose={self._transpose}, corder={self._corder})')


class JITCModeView:
    """Mode-locked view (``'mv'``/``'mm'``) of a JITC matrix: ``todense``
    materializes the matrix that the selected product mode samples."""

    def __init__(self, matrix, mode: str):
        self._m = matrix
        self._mode = mode

    def todense(self):
        return self._m._todense(matrix_mode=self._mode)

    def tocsr(self):
        raise UnsupportedOperationError(_NO_CSR)

    tocsc = tocoo = tocsr

    def __repr__(self):
        return f'{type(self._m).__name__}.{self._mode}'


def make_classes(family, class_base_name: str, param_names: Tuple[str, ...],
                 lift_add=None):
    """Create the ``(Matrix, R, C)`` classes of *family* (an output of
    :func:`~brainevent_torch.jitc.family.make_family`). ``lift_add(params,
    s)`` defines scalar addition (default: shift every parameter)."""
    npar = len(param_names)
    if lift_add is None:
        def lift_add(params, s):
            return tuple(p + s for p in params)

    class Base(JITCMatrix):
        """Shared R/C machinery."""

        def __init__(self, data, *, shape, corder: bool = False,
                     device=None):
            # data = (param_0, ..., param_{n-1}, prob, seed)
            if len(data) != npar + 2:
                raise MathError(
                    f'{type(self).__name__} expects data = '
                    f'({", ".join(param_names)}, prob, seed), got '
                    f'{len(data)} entries.')
            super().__init__(shape)
            for name, value in zip(param_names, data[:npar]):
                self.register_buffer(name, value)
            self.prob = _prob(data[npar])
            self.seed = _seed(data[npar + 1])
            self.corder = bool(corder)
            if device is None:
                device = next((p.device for p in data[:npar]
                               if isinstance(p, torch.Tensor)), 'cuda')
            self.device = check_device(device)
            self._plan_cache = None

        @property
        def data(self):
            return tuple(self._buffers[n] for n in param_names)

        @property
        def dtype(self):
            return torch.float32

        def with_data(self, data):
            if not isinstance(data, tuple):
                data = (data,)
            if len(data) != npar:
                raise MathError(f'expected {npar} weight parameters, got '
                                f'{len(data)}')
            return type(self)((*data, self.prob, self.seed),
                              shape=self.shape, corder=self.corder,
                              device=self.device)

        # -- algebra on parameters -----------------------------------------

        def _lift_mul(self, s):
            return self.with_data(tuple(p * s for p in self.data))

        def __mul__(self, other):
            return self._lift_mul(other)

        def __rmul__(self, other):
            return self._lift_mul(other)

        def __truediv__(self, other):
            return self._lift_mul(1.0 / other)

        def __neg__(self):
            return self._lift_mul(-1.0)

        def __add__(self, other):
            return self.with_data(lift_add(self.data, other))

        def __radd__(self, other):
            return self.with_data(lift_add(self.data, other))

        def __sub__(self, other):
            return self.with_data(lift_add(self.data, -other))

        def apply(self, fn):
            return self.with_data(tuple(fn(p) for p in self.data))

        # -- generation orientation ---------------------------------------

        def _gen(self):
            """(gen_shape, gen_transpose): the walk layout of this
            orientation."""
            raise NotImplementedError

        def _todense(self, matrix_mode='mv'):
            gen_shape, gen_transpose = self._gen()
            return family.dense_fn(
                *self.data, self.prob, self.seed, shape=gen_shape,
                transpose=gen_transpose, corder=self.corder,
                matrix_mode=matrix_mode, device=self.device)

        @property
        def mv(self) -> JITCModeView:
            """mv-mode (stride-32) view."""
            return JITCModeView(self, 'mv')

        @property
        def mm(self) -> JITCModeView:
            """mm-mode (stride-4) view."""
            return JITCModeView(self, 'mm')

        def tocsr(self):
            raise UnsupportedOperationError(_NO_CSR)

        tocsc = tocoo = tocsr

        def _apply(self, other, *, flip: bool):
            """``self @ other`` (``flip`` False) or ``other @ self``: 1-D
            products through the cached walk plan (the same sampled
            matrix), 2-D ones sample the mm-mode matrix. A flip swaps
            ``(transpose, corder)`` together."""
            other = as_operand(other, self.device)
            raw = extract_raw_value(other)
            if raw.ndim == 1:
                if self._plan_cache is None:
                    self._plan_cache = self.build_walk_plan()
                plan = self._plan_cache
                return other @ plan if flip else plan @ other
            gen_shape, gen_transpose = self._gen()
            transpose = gen_transpose != flip
            kw = dict(shape=gen_shape, transpose=transpose,
                      corder=self.corder != transpose)
            event = isinstance(other, EventRepresentation)
            fn = family.bmm_fn if event else family.mm_fn
            if flip:
                return fn(*self.data, self.prob, raw.T, self.seed, **kw).T
            return fn(*self.data, self.prob, raw, self.seed, **kw)

        def __matmul__(self, other):
            return self._apply(other, flip=False)

        def __rmatmul__(self, other):
            return self._apply(other, flip=True)

        def build_walk_plan(self) -> JITCWalkPlan:
            """The walk streams of this matrix's mv-mode products, built
            once through K11 on the matrix's device (see
            :class:`JITCWalkPlan`)."""
            gen_shape, gen_transpose = self._gen()
            corder = (not self.corder) if gen_transpose else self.corder
            clen, state2, q2, cl = family.build_plan_setup(
                self.prob, self.seed, gen_shape, transpose=gen_transpose,
                corder=corder, device=self.device)
            return JITCWalkPlan(family, self, gen_shape, gen_transpose,
                                corder, clen, (state2, q2, cl))

        def __repr__(self):
            pairs = ', '.join(f'{n}={self._buffers[n]}' for n in param_names)
            return (f'{type(self).__name__}(shape={self.shape}, {pairs}, '
                    f'prob={self.prob}, corder={self.corder})')

    class R(Base):
        """Row-oriented generative matrix."""

        def _gen(self):
            return self.shape, False

        def todense(self):
            return self._todense('mv')

        def transpose(self, axes=None):
            if axes is not None:
                raise MathError('transpose with axes is not supported.')
            return C((*self.data, self.prob, self.seed),
                     shape=(self.shape[1], self.shape[0]),
                     corder=self.corder, device=self.device)

    class C(Base):
        """Column-oriented view: the transpose of the R matrix with the
        same parameters."""

        def _gen(self):
            return (self.shape[1], self.shape[0]), True

        def todense(self):
            return family.dense_fn(
                *self.data, self.prob, self.seed,
                shape=(self.shape[1], self.shape[0]), transpose=False,
                corder=self.corder, device=self.device).T

        def transpose(self, axes=None):
            if axes is not None:
                raise MathError('transpose with axes is not supported.')
            return R((*self.data, self.prob, self.seed),
                     shape=(self.shape[1], self.shape[0]),
                     corder=self.corder, device=self.device)

    R.__name__ = R.__qualname__ = f'{class_base_name}R'
    C.__name__ = C.__qualname__ = f'{class_base_name}C'
    Base.__name__ = Base.__qualname__ = f'{class_base_name}Matrix'
    return Base, R, C
