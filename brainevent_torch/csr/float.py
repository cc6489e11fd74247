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

"""Float CSR products ``csrmv`` and ``csrmm`` (``brainevent_tpu.csr.float``),
and the one autograd rule of every CSR product.

``csrmv(data, indices, indptr, v, shape=(m, k), transpose)`` is ``A @ v``
(or ``A.T @ v``), ``csrmm`` the same with a matrix ``B``. Weights are
homogeneous ``(1,)`` or one per entry; the products compute in float32.
Routes, by the device of the tensors (the twins on the CPU, the kernels
on a CUDA device):

- ``A @ v``: K7 ``csr_gather_mv``, a warp per row;
- ``A.T @ v``: K8 ``csr_scatter_mv`` over the rows with ``v[r] != 0``;
  a float product takes K7 over the CSC mirror instead when a ``CSR``
  object has the mirror cached;
- ``A @ B``: K10 ``csr_gather_mm`` on the CSR arrays;
- ``A.T @ B``: K10 over the CSC mirror, built for the call (a stable
  ``torch.argsort`` of ``indices``) unless a ``CSR`` object has it
  cached. So no mat-mat product uses float atomics.

Gradients (``torch.autograd``) follow the JAX package's rules: with
respect to the operand, the transposed float product; with respect to the
weights, the per-entry pair product (``ct[rows] * v[indices]``, K9
``pair_gather``; for ``csrmm`` a plain PyTorch sum over the columns,
a chunk of entries at a time). A homogeneous ``(1,)`` weight gets the sum,
of shape ``(1,)``. ``backend=`` is accepted and ignored. The JAX package's
warning about slow weight gradients at large ``nse`` is not ported: it
names XLA's gather path, which the port does not take.

Dtypes (``ops/operand.py``): event operands of any dtype reach the
kernels as their ``> 0`` gate; float16 and bfloat16 weights are computed
in float32 and the result rounded to the weights' dtype, the dtype the
JAX package returns (within 1 ulp of it of the twin, on top of the
float32 bound). float64 weights are computed in float64, as the JAX
package keeps float64 on its XLA kernel: by the twins on the CPU, by the
kernels' ``double`` instances (K7-K10) on the card. A float operand is
taken in the dtype of the computation.
"""

import dataclasses
from typing import Optional, Tuple

import torch

from .._error import MathError, UnsupportedOperationError
from .._misc import csr_to_csc_index
from ..ops.mxu_gather import csr_gather_mm
from ..ops.operand import acc_dtype, event_spikes, op_values, widen
from ..ops.pair_gather import pair_gather, pair_gather_product
from ._common import csr_checks, is_homo, row_ids_from_indptr
from .pallas_kernels import csr_gather_mv, csr_scatter_mv

__all__ = ['csrmv', 'csrmv_p_call', 'csrmm', 'csrmm_p_call']

# plain PyTorch weight gradient of the mat-mat products: entries per chunk
# are this many values over the columns
_CHUNK_ELEMS = 1 << 24


@dataclasses.dataclass(frozen=True)
class ProductSpec:
    """What one CSR product computes, beside its tensors.

    ``perm``: the slot permutation of an indexed product (weights
    ``data[perm]``); ``mirror``: a cached CSC mirror ``(t_indptr,
    t_indices, perm)`` for the transposed direction.
    """
    shape: Tuple[int, int]
    transpose: bool
    binary: bool
    perm: Optional[torch.Tensor] = None
    mirror: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None


def _product(w, indices, indptr, x, spec: ProductSpec) -> torch.Tensor:
    """Launch the kernel (or run the twin) of one product."""
    homo = is_homo(w)
    perm = None if homo else spec.perm
    if x.ndim == 1 and not spec.transpose:
        return csr_gather_mv(indptr, indices, perm, w, x, spec.binary)
    # a transposed event matvec stays event-driven: it reads the rows of
    # the active events only
    if x.ndim == 1 and (spec.mirror is None or spec.binary):
        return csr_scatter_mv(indptr, indices, perm, w, x, spec.binary,
                              spec.shape[1])
    if spec.transpose:
        t_indptr, t_indices, t_perm = spec.mirror or csr_to_csc_index(
            indptr, indices, shape=spec.shape)
        if perm is not None:
            t_perm = perm[t_perm]
        indptr, indices, perm = t_indptr, t_indices, (None if homo
                                                      else t_perm)
    op = csr_gather_mv if x.ndim == 1 else csr_gather_mm
    return op(indptr, indices, perm, w, x, spec.binary)


def _weight_grad(indices, indptr, v, ct, transpose: bool) -> torch.Tensor:
    """``dL/dw[e]``: ``ct[row_e] * v[col_e]`` (``v[row_e] * ct[col_e]``
    when transposed), summed over the columns of a mat-mat product."""
    rows = row_ids_from_indptr(indptr, indices.shape[0])
    s, x = (v, ct) if transpose else (ct, v)
    if v.ndim == 1:
        if acc_dtype(s, x) == torch.float64:
            # K9's double instance: the sides stay float64
            return pair_gather(rows, indices, s.double().contiguous(),
                               x.double().contiguous())
        return pair_gather_product(rows, indices, s, x)
    out = torch.empty(indices.shape[0], dtype=acc_dtype(s, x),
                      device=v.device)
    step = max(1, _CHUNK_ELEMS // max(v.shape[1], 1))
    for a in range(0, indices.shape[0], step):
        b = a + step
        out[a:b] = (s[rows[a:b]] * x[indices[a:b]]).sum(1)
    return out


class _CsrProduct(torch.autograd.Function):
    """A CSR product, differentiable with respect to the weights and to a
    float operand (the surrogate-linear rule for event operands)."""

    @staticmethod
    def forward(ctx, weights, operand, indices, indptr, spec):
        ctx.save_for_backward(weights, operand, indices, indptr)
        ctx.spec = spec
        return _product(weights, indices, indptr, operand, spec)

    @staticmethod
    def backward(ctx, ct):
        weights, operand, indices, indptr = ctx.saved_tensors
        spec = ctx.spec
        if spec.perm is not None:
            raise UnsupportedOperationError(
                'the indexed CSR products have no gradient, as in the JAX '
                'package.')
        ct = ct.to(acc_dtype(weights)).contiguous()
        w_bar = x_bar = None
        if ctx.needs_input_grad[1]:
            back = dataclasses.replace(spec, transpose=not spec.transpose,
                                       binary=False)
            x_bar = _product(weights, indices, indptr, ct, back).to(
                operand.dtype)
        if ctx.needs_input_grad[0]:
            w_bar = _weight_grad(indices, indptr,
                                 op_values(operand, spec.binary,
                                           acc_dtype(weights)), ct,
                                 spec.transpose)
            if is_homo(weights):
                w_bar = w_bar.sum().reshape(1)
        return w_bar, x_bar, None, None, None


def prepare(weights, indices, indptr, operand, *, shape, transpose: bool,
            binary: bool, ndim: int):
    """Check a CSR product's operands and bring them to the kernels'
    dtypes: int32 structure, float weights (any other dtype as float32;
    :func:`csr_product` computes in float32 or float64), a bool or float32
    event operand (any other dtype as its ``> 0`` gate), a float operand
    in the dtype of the computation; all contiguous, on one device."""
    indices = torch.as_tensor(indices)
    device = indices.device
    indptr = torch.as_tensor(indptr, device=device)
    weights = torch.atleast_1d(torch.as_tensor(weights, device=device))
    operand = torch.as_tensor(operand, device=device)
    csr_checks(weights, indices, indptr, shape)
    m, k = shape
    exp_in = m if transpose else k
    if operand.ndim != ndim or operand.shape[0] != exp_in:
        raise MathError(
            f'operand shape {tuple(operand.shape)} does not fit shape {shape} '
            f'with transpose={transpose}: expected a {ndim}-D operand of '
            f'length {exp_in}.')
    if not weights.is_floating_point():
        weights = weights.to(torch.float32)
    operand = (event_spikes(operand) if binary
               else operand.to(acc_dtype(weights)))
    return (weights.contiguous(),
            indices.to(torch.int32).contiguous(),
            indptr.to(torch.int32).contiguous(), operand.contiguous())


def csr_product(weights, indices, indptr, operand, spec: ProductSpec):
    """A prepared product through the autograd rule, computed in float32
    (float16 and bfloat16 weights widened) or float64 and returned in the
    weights' dtype."""
    return _CsrProduct.apply(widen(weights), operand, indices, indptr,
                             spec).to(weights.dtype)


def _call(weights, indices, indptr, operand, *, shape, transpose, binary,
          ndim):
    w, idx, ptr, x = prepare(weights, indices, indptr, operand, shape=shape,
                             transpose=transpose, binary=binary, ndim=ndim)
    return [csr_product(w, idx, ptr, x, ProductSpec(
        tuple(shape), bool(transpose), binary))]


def csrmv_p_call(weights, indices, indptr, vector, *, shape,
                 transpose: bool = False, backend: Optional[str] = None):
    """Low-level call; returns a one-element list."""
    del backend
    return _call(weights, indices, indptr, vector, shape=shape,
                 transpose=transpose, binary=False, ndim=1)


def csrmv(data, indices, indptr, v, *, shape, transpose: bool = False,
          backend: Optional[str] = None):
    """Float CSR matrix-vector product ``A @ v`` / ``A.T @ v``."""
    (out,) = csrmv_p_call(data, indices, indptr, v, shape=shape,
                          transpose=transpose, backend=backend)
    return out


def csrmm_p_call(weights, indices, indptr, B, *, shape,
                 transpose: bool = False, backend: Optional[str] = None):
    """Low-level call; returns a one-element list."""
    del backend
    return _call(weights, indices, indptr, B, shape=shape,
                 transpose=transpose, binary=False, ndim=2)


def csrmm(data, indices, indptr, B, *, shape, transpose: bool = False,
          backend: Optional[str] = None):
    """Float CSR matrix-matrix product ``A @ B`` / ``A.T @ B``."""
    (out,) = csrmm_p_call(data, indices, indptr, B, shape=shape,
                          transpose=transpose, backend=backend)
    return out
