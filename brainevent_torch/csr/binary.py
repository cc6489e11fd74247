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

"""Event-driven CSR products (``brainevent_tpu.csr.binary``).

``binary_csrmv(data, indices, indptr, v, shape=..., transpose=...)`` is
``A @ v`` (K7, a warp per row) or ``A.T @ v`` (K8, the rows of the active
events only) with ``v`` a spike vector: bool entries gate their weight,
float entries gate at ``> 0``. ``binary_csrmm`` is the same with a spike
matrix, through K10 (the transposed direction over the CSC mirror). The
indexed variants take weights ``data[perm]``.

Gradients follow the surrogate-linear contract of the JAX package: with
respect to a float event operand, the float product (``csrmv``/``csrmm``
transposed); with respect to the weights, the pair product of the
cotangent and the gated events. Bool events get no gradient. The indexed
variants have none, as in the JAX package. ``workspace=`` and
``backend=`` are accepted and ignored.
"""

from typing import Optional

import torch

from .float import ProductSpec, _call, csr_product, prepare

__all__ = [
    'binary_csrmv', 'binary_csrmv_p_call', 'binary_csrmm',
    'binary_csrmm_p_call', 'binary_csrmv_indexed',
    'binary_csrmv_indexed_p_call', 'binary_csrmm_indexed',
    'binary_csrmm_indexed_p_call',
]


def binary_csrmv_p_call(weights, indices, indptr, vector, *, shape,
                        transpose: bool = False,
                        backend: Optional[str] = None):
    """Low-level call; returns a one-element list."""
    del backend
    return _call(weights, indices, indptr, vector, shape=shape,
                 transpose=transpose, binary=True, ndim=1)


def binary_csrmv(data, indices, indptr, v, *, shape, workspace=None,
                 transpose: bool = False, backend: Optional[str] = None):
    """Event-driven CSR SpMV ``y = A @ v`` / ``A.T @ v``."""
    del workspace
    (out,) = binary_csrmv_p_call(data, indices, indptr, v, shape=shape,
                                 transpose=transpose, backend=backend)
    return out


def binary_csrmm_p_call(weights, indices, indptr, B, *, shape,
                        transpose: bool = False,
                        backend: Optional[str] = None):
    """Low-level call; returns a one-element list."""
    del backend
    return _call(weights, indices, indptr, B, shape=shape,
                 transpose=transpose, binary=True, ndim=2)


def binary_csrmm(data, indices, indptr, B, *, shape, workspace=None,
                 transpose: bool = False, backend: Optional[str] = None):
    """Event-driven CSR SpMM ``A @ B`` / ``A.T @ B``."""
    del workspace
    (out,) = binary_csrmm_p_call(data, indices, indptr, B, shape=shape,
                                 transpose=transpose, backend=backend)
    return out


def _indexed_call(weights, indices, indptr, perm, operand, *, shape,
                  transpose, ndim):
    w, idx, ptr, x = prepare(weights, indices, indptr, operand, shape=shape,
                             transpose=transpose, binary=True, ndim=ndim)
    perm = torch.as_tensor(perm, device=idx.device).to(idx.dtype).contiguous()
    if perm.shape != idx.shape:
        raise ValueError(f'perm {tuple(perm.shape)} must have one entry per '
                         f'structure entry ({idx.shape[0]})')
    return [csr_product(w, idx, ptr, x, ProductSpec(
        tuple(shape), bool(transpose), True, perm=perm))]


def binary_csrmv_indexed_p_call(weights, indices, indptr, perm, vector, *,
                                shape, transpose: bool = False,
                                backend: Optional[str] = None):
    """Low-level indexed SpMV call: ``weights[perm]`` are the per-entry
    weights of the ``(indices, indptr)`` structure."""
    del backend
    return _indexed_call(weights, indices, indptr, perm, vector, shape=shape,
                         transpose=transpose, ndim=1)


def binary_csrmv_indexed(data, indices, indptr, perm, v, *, shape,
                         workspace=None, transpose: bool = False,
                         backend: Optional[str] = None):
    """Event CSR SpMV over a permuted-weight structure."""
    del workspace
    (out,) = binary_csrmv_indexed_p_call(data, indices, indptr, perm, v,
                                         shape=shape, transpose=transpose,
                                         backend=backend)
    return out


def binary_csrmm_indexed_p_call(weights, indices, indptr, perm, B, *, shape,
                                transpose: bool = False,
                                backend: Optional[str] = None):
    """Low-level indexed SpMM call."""
    del backend
    return _indexed_call(weights, indices, indptr, perm, B, shape=shape,
                         transpose=transpose, ndim=2)


def binary_csrmm_indexed(data, indices, indptr, perm, B, *, shape,
                         workspace=None, transpose: bool = False,
                         backend: Optional[str] = None):
    """Event CSR SpMM over a permuted-weight structure."""
    del workspace
    (out,) = binary_csrmm_indexed_p_call(data, indices, indptr, perm, B,
                                         shape=shape, transpose=transpose,
                                         backend=backend)
    return out
