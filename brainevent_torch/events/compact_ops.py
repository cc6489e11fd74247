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

"""Event encoders (``brainevent_tpu.events.compact_ops``).

Eight encoders turn a dense spike tensor into index-compacted structures.
Every output has a static size (the capacity is the input's size), valid
entries first and a zero tail, with a separate count, so that a run of
them never waits on the device. An entry is an event where it is true or
``!= 0`` (NaN and negative spikes count, unlike the products' ``> 0``).

The row count (``binary_2d_csr_row_count_p_call``, and the CSR encoder
built on it) runs K18 ``event_row_count`` on a CUDA tensor. The other
seven are plain PyTorch on any device, as the JAX package leaves them to
XLA (its Pallas backend aliases them): compaction by the sort of
``_compact_indices``, the scatters by ``scatter_``. Outputs are int32
(the packed words uint32) and bitwise the JAX package's.
"""

from typing import Optional

import torch

from .bitpack import bitpack
from ..ops.operand import event_spikes
from .pallas_kernels import event_mask, event_row_count

__all__ = [
    'binary_1d_array_index_p_call', 'binary_2d_compact_only_p_call',
    'binary_2d_array_index_p_call', 'binary_2d_pair_stream_encode_p_call',
    'binary_2d_row_sparse_encode_p_call', 'binary_2d_csr_row_count_p_call',
    'binary_2d_csr_fill_p_call', 'binary_2d_csc_encode_p_call',
    'binary_2d_csr_encode_p_call', 'binary_2d_csc_from_array',
]

_I32 = torch.int32


def _compact_indices(mask_flat):
    """The ids of the true lanes of *mask_flat* moved to the front of a
    capacity buffer, ascending, zero tail; and their count ``(1,)``.
    One sort (the inactive lanes key to ``n``) and no scatter, as in the
    JAX package; nothing is read back to the host."""
    n = mask_flat.shape[0]
    ids = torch.arange(n, dtype=_I32, device=mask_flat.device)
    count = mask_flat.sum(dtype=_I32).reshape(1)
    key = torch.where(mask_flat, ids, n)
    out = torch.where(ids < count, torch.sort(key).values, 0)
    return out, count


def _scatter_flat(cap, pos, mask, vals):
    """A ``(cap,)`` int32 buffer of zeros with ``vals`` set at ``pos``
    where *mask* holds; positions outside ``[0, cap)`` are dropped."""
    keep = mask & (pos >= 0) & (pos < cap)
    slot = torch.where(keep, pos, cap).reshape(-1).to(torch.int64)
    out = torch.zeros(cap + 1, dtype=_I32, device=pos.device)
    out.scatter_(0, slot, vals.reshape(-1).to(_I32))
    return out[:cap]


def _check_2d(spikes):
    spikes = torch.as_tensor(spikes)
    if spikes.ndim != 2:
        raise ValueError(f'`spikes` must be 2D, got {spikes.ndim}D.')
    return spikes


def binary_1d_array_index_p_call(spikes, *, backend: Optional[str] = None):
    """Compact a 1-D spike vector into ``(active_ids (n,), n_active
    (1,))``."""
    del backend
    spikes = torch.as_tensor(spikes)
    if spikes.ndim != 1:
        raise ValueError(f'`spikes` must be 1D, got {spikes.ndim}D.')
    return _compact_indices(event_mask(spikes))


def binary_2d_compact_only_p_call(spikes, *, backend: Optional[str] = None):
    """The rows of ``(n_pre, n_batch)`` spikes with any event, as
    ``(active_ids (n_pre,), n_active (1,))``."""
    del backend
    return _compact_indices(event_mask(_check_2d(spikes)).any(1))


def binary_2d_array_index_p_call(spikes, *, backend: Optional[str] = None):
    """``(packed (n, ceil(b/32)) uint32, active_ids (n,), n_active (1,))``:
    the bit packing along the batch axis and the active rows."""
    del backend
    mask = event_mask(_check_2d(spikes))
    return (bitpack(mask, 1), *_compact_indices(mask.any(1)))


def binary_2d_pair_stream_encode_p_call(spikes,
                                        *, backend: Optional[str] = None):
    """``(pair_stream (n*b, 2) int32, n_pairs (1,))``: the ``(row, col)``
    of every event in row-major order, then zero pairs."""
    del backend
    spikes = _check_2d(spikes)
    b = spikes.shape[1]
    ids, cnt = _compact_indices(event_mask(spikes).reshape(-1))
    return torch.stack([ids // b, ids % b], 1), cnt


def binary_2d_row_sparse_encode_p_call(spikes, *,
                                       row_size: Optional[int] = None,
                                       backend: Optional[str] = None):
    """Dense 2-D spikes -> fixed-width per-row layout: ``(spike_indices
    (n_src, row_size) int32,)``, the 1-based active columns of each row,
    front-compacted and zero-padded. ``row_size`` defaults to the batch
    width.

    As in the JAX package, a row with more events than ``row_size``
    raises a ``ValueError``. That check counts the events and reads the
    largest count back to the host, so on a CUDA tensor it waits for the
    device; the rest of the encoder does not."""
    del backend
    spikes = _check_2d(spikes)
    n_src, n_batch = spikes.shape
    if row_size is None:
        row_size = n_batch
    if row_size <= 0:
        raise ValueError(f'`row_size` must be positive, got {row_size}.')
    if row_size > n_batch:
        raise ValueError(
            f'`row_size` must be <= n_batch={n_batch}, got {row_size}.')
    mask = event_mask(spikes)
    if n_src:
        max_row_nnz = int(mask.sum(1, dtype=_I32).max())
        if max_row_nnz > row_size:
            raise ValueError(
                f'`row_size={row_size}` is too small for the input spikes; '
                f'max row NNZ is {max_row_nnz}.')
    sentinel = n_batch + 1
    cols1 = torch.arange(1, n_batch + 1, dtype=_I32, device=spikes.device)
    vals = torch.sort(torch.where(mask, cols1, sentinel), dim=1).values
    vals = vals[:, :row_size]
    return (torch.where(vals == sentinel, 0, vals),)


def binary_2d_csr_row_count_p_call(spikes, *, backend: Optional[str] = None):
    """``(row_counts (n,) int32,)``, through K18 on a CUDA tensor. Spikes
    of any dtype reach K18 as their ``!= 0`` gate (bool and float32 as
    they are), which is exact."""
    del backend
    spikes = event_spikes(_check_2d(spikes), nonzero=True)
    return (event_row_count(spikes.contiguous()),)


def binary_2d_csr_fill_p_call(spikes, indptr, *,
                              backend: Optional[str] = None):
    """``(indices (n*b,) int32,)``: the column of each event at its row's
    offset ``indptr[r]``; valid in ``indices[:indptr[-1]]``."""
    del backend
    spikes = _check_2d(spikes)
    indptr = torch.as_tensor(indptr, device=spikes.device)
    if indptr.shape[0] != spikes.shape[0] + 1:
        raise ValueError(
            f'indptr length must be spikes.shape[0]+1 '
            f'({spikes.shape[0] + 1}), got {indptr.shape[0]}.')
    n, b = spikes.shape
    mask = event_mask(spikes)
    within = torch.cumsum(mask, 1, dtype=_I32) - 1
    pos = indptr[:-1].to(_I32)[:, None] + within
    cols = torch.arange(b, dtype=_I32, device=spikes.device).expand(n, b)
    return (_scatter_flat(n * b, pos, mask, cols),)


def binary_2d_csr_encode_p_call(spikes, *, backend: Optional[str] = None):
    """Dense 2-D spikes -> static-capacity CSR ``(indices, indptr)``."""
    spikes = _check_2d(spikes)
    (row_counts,) = binary_2d_csr_row_count_p_call(spikes, backend=backend)
    indptr = torch.cat([torch.zeros(1, dtype=_I32, device=spikes.device),
                        torch.cumsum(row_counts, 0, dtype=_I32)])
    (indices,) = binary_2d_csr_fill_p_call(spikes, indptr, backend=backend)
    return indices, indptr


def binary_2d_csc_encode_p_call(spikes, *, backend: Optional[str] = None):
    """``(indices (n*b,) int32, indptr (b+1,) int32)``: the static-capacity
    CSC of the events (row ids per column)."""
    del backend
    spikes = _check_2d(spikes)
    n, b = spikes.shape
    mask = event_mask(spikes)
    indptr = torch.cat([torch.zeros(1, dtype=_I32, device=spikes.device),
                        torch.cumsum(mask.sum(0, dtype=_I32), 0, dtype=_I32)])
    within = torch.cumsum(mask, 0, dtype=_I32) - 1
    pos = indptr[:-1][None, :] + within
    rows = torch.arange(n, dtype=_I32, device=spikes.device)[:, None].expand(
        n, b)
    return _scatter_flat(n * b, pos, mask, rows), indptr


def binary_2d_csc_from_array(spikes, *, backend: Optional[str] = None):
    """Function-style wrapper: dense 2-D spikes -> CSC ``(indices,
    indptr)``."""
    return binary_2d_csc_encode_p_call(spikes, backend=backend)
