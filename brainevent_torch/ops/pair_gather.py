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

"""The per-entry pair product ``out[e] = s[rows[e]] * x[cols[e]]``.

Counterpart of ``brainevent_tpu.ops.pair_gather``. It serves the CSR STDP
updates (``csr/plasticity.py``) and the weight gradients of the CSR
matvecs (``csr/float.py``, ``csr/binary.py``), whose outputs are needed in
nnz order. Kernel K9 :data:`pair_gather` (``csrc/pair_gather.cu``) gives
one thread to each entry; its one multiply is the twin's, so the two are
bitwise equal. The TPU kernel's one-hot MXU gathers, bf16 splits
(``s_passes``, ``x_passes``) and size envelope have no role on a GPU: the
keywords are accepted and ignored, and the function never returns
``None``.
"""

import ctypes
from typing import Optional

import torch

from . import cuda_build
from .core import KernelOp, check_cuda_tensors, cuda_stream
from .operand import is_double, take

__all__ = ['pair_gather_product', 'pair_gather', 'pair_gather_twin']

_SOURCE = 'brainevent_torch/csrc/pair_gather.cu'


def pair_gather_twin(rows, cols, s, x) -> torch.Tensor:
    """Plain PyTorch twin of K9: the gathered side, or the product of the
    two gathered sides (one rounding)."""
    sides = [take(v, i) for i, v in ((rows, s), (cols, x)) if v is not None]
    return sides[0] if len(sides) == 1 else sides[0] * sides[1]


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _pair_gather_cuda(op, rows, cols, s, x):
    sides = [v for v in (s, x) if v is not None]
    dbl = is_double(op.name, *sides)
    pairs = [(t, dtype) for t, dtype in ((rows, torch.int32),
                                         (cols, torch.int32),
                                         (s, sides[0].dtype),
                                         (x, sides[0].dtype)) if t is not None]
    device = check_cuda_tensors(op.name, *pairs)
    nse = (rows if rows is not None else cols).shape[0]
    out = torch.empty(nse, dtype=sides[0].dtype, device=device)
    fn = cuda_build.function('pair_gather_launch', [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    op.launch(fn, _ptr(rows), _ptr(cols), _ptr(s), _ptr(x),
              0 if s is None else s.shape[0], 0 if x is None else x.shape[0],
              nse, dbl, out.data_ptr(), device.index or 0,
              cuda_stream(device))
    return out


pair_gather = KernelOp(
    'pair_gather', twin=pair_gather_twin, cuda=_pair_gather_cuda,
    source=_SOURCE, replaces='brainevent_tpu/ops/pair_gather.py:72')


def pair_gather_product(rows, cols, s, x, *, s_passes: int = 3,
                        x_passes: int = 3, platform: Optional[str] = None):
    """``out[e] = s[rows[e]] * x[cols[e]]`` in float32, through K9 (the
    twin for CPU tensors).

    Either side may be ``None`` (``rows=None, s=None`` gathers ``x`` alone,
    and vice versa). Ids outside the operand, ``-1`` among them, give an
    exact 0. ``s_passes``, ``x_passes`` and ``platform`` are accepted and
    ignored.
    """
    del s_passes, x_passes, platform
    sides = [(i, v) for i, v in ((rows, s), (cols, x)) if v is not None]
    if not sides:
        raise ValueError('pair_gather_product needs at least one side')
    if len(sides) == 2 and rows.shape[0] != cols.shape[0]:
        raise ValueError('rows/cols length mismatch')
    args = []
    for ids, v in ((rows, s), (cols, x)):
        if v is None:
            args += [None, None]
        else:
            args += [ids.to(torch.int32).contiguous(),
                     v.to(torch.float32).contiguous()]
    rows, s, cols, x = args
    return pair_gather(rows, cols, s, x)
