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

"""Sparse index-structure conversions.

The two CSR conversions of ``brainevent_tpu._misc``, on tensors (on any
device) with the structure's integer dtype kept. The CSC mirror
``(t_indptr, t_indices, perm)`` is bitwise the JAX package's: a stable
sort of the column ids, so entries of one column keep their CSR order.
The kernels that read a matrix through its mirror (``csr_gather_mv`` and
``csr_gather_mm``) rely on that order for their summation order.
"""

from typing import Tuple

import torch

__all__ = ['csr_to_coo_index', 'csr_to_csc_index']


def csr_to_coo_index(indptr: torch.Tensor, indices: torch.Tensor):
    """CSR ``(indptr, indices)`` -> COO ``(row_ids, col_ids)``; the row ids
    have the dtype of ``indices``. Empty and trailing empty rows give no
    ids."""
    n_rows = indptr.shape[0] - 1
    rows = torch.repeat_interleave(
        torch.arange(n_rows, dtype=indices.dtype, device=indices.device),
        torch.diff(indptr), output_size=indices.shape[0])
    return rows, indices


def csr_to_csc_index(csr_indptr: torch.Tensor, csr_indices: torch.Tensor, *,
                     shape: Tuple[int, int]):
    """CSR -> CSC structure: ``(csc_indptr, csc_row_indices, perm)``.

    ``data[perm]`` reorders CSR data into CSC order. All three have the
    dtype of ``csr_indices``.
    """
    rows, cols = csr_to_coo_index(csr_indptr, csr_indices)
    dtype = csr_indices.dtype
    perm = torch.argsort(cols, stable=True)
    counts = torch.bincount(cols, minlength=shape[1])
    indptr = torch.zeros(shape[1] + 1, dtype=dtype, device=cols.device)
    indptr[1:] = torch.cumsum(counts, 0)
    return indptr, rows[perm], perm.to(dtype)
