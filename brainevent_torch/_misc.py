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

"""Sparse index-structure conversions and the JITC layout constants.

The two CSR conversions of ``brainevent_tpu._misc``, on tensors (on any
device) with the structure's integer dtype kept. The CSC mirror
``(t_indptr, t_indices, perm)`` is bitwise the JAX package's: a stable
sort of the column ids, so entries of one column keep their CSR order.
The kernels that read a matrix through its mirror (``csr_gather_mv`` and
``csr_gather_mm``) rely on that order for their summation order.

The stream layout of the implicit-connectivity walk (``_MV_STRIDE``,
``_MM_STRIDE``, :func:`_normalize_chunk_size`) and the connection length
(:func:`_initialize_conn_length`) are part of the sampled matrix: they are
the JAX package's values, computed the same way.
"""

import math
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ['csr_to_coo_index', 'csr_to_csc_index']

# Lane layout of the implicit-connectivity sampler. mv and mm modes use
# different strides, so they draw DIFFERENT matrices.
_MV_STRIDE = 32
_MM_STRIDE = 4


def _normalize_chunk_size(n_cols: int, chunk_size: Optional[int],
                          target_chunks: int = 4) -> int:
    """Chunk width of the light-RNG walk: ``ceil(n_cols / 4)`` unless
    given. The chunk id keys the streams, so every op of a family must
    chunk alike."""
    if chunk_size is None:
        target_chunks = int(target_chunks)
        if target_chunks <= 0:
            raise ValueError('target_chunks must be positive')
        chunk_size = max(1, (int(n_cols) + target_chunks - 1) // target_chunks)
    chunk_size = int(chunk_size)
    if chunk_size <= 0:
        raise ValueError('chunk_size must be positive')
    return chunk_size


def _normalize_matrix_mode(mode: str) -> str:
    mode = str(mode).lower()
    if mode not in ('mv', 'mm'):
        raise ValueError(f"matrix_mode must be 'mv' or 'mm', got {mode!r}")
    return mode


def _initialize_conn_length(conn_prob: float) -> int:
    """Connection probability -> the sampler's connection length
    ``clen = max(ceil(2 / prob), 2)``. The quotient is rounded to float32
    before the ceiling, as the JAX package computes it (in float32 unless
    x64 is enabled)."""
    return max(int(math.ceil(np.float32(2.0 / float(conn_prob)))), 2)


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
