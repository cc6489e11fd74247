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

"""The CSR matvec kernels: K7 :data:`csr_gather_mv` and K8
:data:`csr_scatter_mv` (``csrc/csr_event.cu``).

Both read a CSR structure ``(indptr, indices)`` of ``n_rows`` rows, its
weights ``w`` (``(1,)`` homogeneous, or one per entry) and an operand
``x``. ``slot(j)`` is ``j``, or ``perm[j]`` when a permutation is given
(the indexed products, and a product over a cached CSC mirror whose
weights stay in CSR order). ``op`` is the event gate for a binary product
(bool ``x``, or float ``x`` gated at ``> 0``) and the identity for a float
one.

- K7 (gather), replacing ``brainevent_tpu/csr/pallas_kernels.py``'s
  ``csr_event_gather_kernel``:
  ``y[r] = sum_{j in [indptr[r], indptr[r+1])} w[slot(j)] * op(x[indices[j]])``;
- K8 (scatter), replacing the XLA transpose branch of
  ``brainevent_tpu/csr/binary.py``'s ``_binary_csrmv_jax_kernel``:
  ``y[indices[j]] += w[slot(j)] * op(x[r])`` over the rows ``r`` with
  ``op(x[r]) != 0`` only.

Homogeneous binary products count in int32 and scale once by ``w[0]``, so
they are exact at any summation order. Ids outside the operand (K7) or
the output (K8) are dropped. Each op has a plain PyTorch twin that runs
for CPU tensors; it sums in float32, or in float64 for float64 weights,
which on a CUDA device launch the kernels' ``double`` instances.
"""

import ctypes
import torch

from ..ops import cuda_build
from ..ops.core import KernelOp, check_cuda_tensors, cuda_stream
from ..ops.operand import (acc_dtype, fits, is_double, op_code, op_values,
                           take)
from ._common import is_homo, row_ids_from_indptr

__all__ = ['csr_gather_mv', 'csr_scatter_mv', 'csr_gather_mv_twin',
           'csr_scatter_mv_twin']

_SOURCE = 'brainevent_torch/csrc/csr_event.cu'


def _slot_weights(w, perm):
    return w if perm is None else w[perm]


def _in_range(ids, n):
    return (ids >= 0) & (ids < n)


# -- twins -----------------------------------------------------------------------

def csr_gather_mv_twin(indptr, indices, perm, w, x, binary: bool):
    """Plain PyTorch twin of K7: gathers and one ``index_add_``;
    homogeneous binary products sum 0/1 gates (exact) and scale once."""
    n_rows = indptr.shape[0] - 1
    rows = row_ids_from_indptr(indptr, indices.shape[0])
    acc = acc_dtype(w, x)
    v = take(op_values(x, binary, acc), indices)
    y = torch.zeros(n_rows, dtype=acc, device=x.device)
    if is_homo(w):
        if binary:
            return y.index_add_(0, rows, v) * w[0]
        return y.index_add_(0, rows, w[0] * v)
    return y.index_add_(0, rows, _slot_weights(w, perm) * v)


def csr_scatter_mv_twin(indptr, indices, perm, w, x, binary: bool,
                        n_out: int):
    """Plain PyTorch twin of K8: the entries of the rows with
    ``op(x[r]) != 0``, added with ``index_add_``; homogeneous binary
    products count in int32 and scale once."""
    rows = row_ids_from_indptr(indptr, indices.shape[0])
    acc = acc_dtype(w, x)
    xv = op_values(x, binary, acc)
    act = (xv != 0)[rows] & _in_range(indices, n_out)
    tgt = indices[act]
    if is_homo(w) and binary:
        counts = torch.zeros(n_out, dtype=torch.int32, device=x.device)
        counts.index_add_(0, tgt, torch.ones_like(tgt, dtype=torch.int32))
        return counts.to(acc) * w[0]
    vals = xv[rows[act]]
    contrib = w[0] * vals if is_homo(w) else _slot_weights(w, perm)[act] * vals
    y = torch.zeros(n_out, dtype=acc, device=x.device)
    return y.index_add_(0, tgt, contrib)


# -- kernels ---------------------------------------------------------------------

def _launch_args(op, indptr, indices, perm, w, x, binary):
    dbl = is_double(op.name, w)
    code = op_code(x, binary, w.dtype)
    pairs = [(indptr, torch.int32), (indices, torch.int32),
             (w, w.dtype), (x, x.dtype)]
    if perm is not None:
        pairs.append((perm, torch.int32))
    device = check_cuda_tensors(op.name, *pairs)
    if not fits(w, indices, perm):
        raise ValueError(f'{op.name}: weights {tuple(w.shape)} or perm do '
                         f'not fit {indices.shape[0]} entries')
    return device, [indptr.data_ptr(), indices.data_ptr(),
                    None if perm is None else perm.data_ptr(), w.data_ptr(),
                    x.data_ptr(), code, int(is_homo(w)), dbl,
                    indptr.shape[0] - 1]


_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4


def _csr_gather_mv_cuda(op, indptr, indices, perm, w, x, binary):
    device, args = _launch_args(op, indptr, indices, perm, w, x, binary)
    y = torch.empty(indptr.shape[0] - 1, dtype=w.dtype, device=device)
    fn = cuda_build.function('csr_gather_mv_launch', _ARGTYPES + [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    op.launch(fn, *args, x.shape[0], y.data_ptr(), device.index or 0,
              cuda_stream(device))
    return y


def _csr_scatter_mv_cuda(op, indptr, indices, perm, w, x, binary, n_out):
    device, args = _launch_args(op, indptr, indices, perm, w, x, binary)
    counting = is_homo(w) and binary
    y = (torch.empty if counting else torch.zeros)(
        n_out, dtype=w.dtype, device=device)
    counts = torch.zeros(n_out if counting else 0, dtype=torch.int32,
                         device=device)
    fn = cuda_build.function('csr_scatter_mv_launch', _ARGTYPES + [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p])
    op.launch(fn, *args, n_out, counts.data_ptr(), y.data_ptr(),
              device.index or 0, cuda_stream(device))
    return y


csr_gather_mv = KernelOp(
    'csr_gather_mv', twin=csr_gather_mv_twin, cuda=_csr_gather_mv_cuda,
    source=_SOURCE, replaces='brainevent_tpu/csr/pallas_kernels.py:55')

csr_scatter_mv = KernelOp(
    'csr_scatter_mv', twin=csr_scatter_mv_twin, cuda=_csr_scatter_mv_cuda,
    source=_SOURCE, replaces='brainevent_tpu/csr/binary.py:57')

