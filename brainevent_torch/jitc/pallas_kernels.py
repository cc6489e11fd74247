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

"""The JITC walk kernels K11-K14 (``csrc/jitc_walk.cu``) and their twins.

Each op walks the streams of the implicit matrix (:mod:`.engine`) and
evaluates a weight law at each visit: ``law`` 0 scalar (``a``), 1 normal
(``fma(z, b, a)``, ``a`` the location, ``b`` the scale), 2 uniform
(``fma(u, b, a)``, ``a`` the low bound, ``b = high - low``), ``a`` and
``b`` float32 values. ``state2``/``q2`` are a plan's streams
(:func:`walk_plan_setup`, int32 bit patterns of uint32) or ``None``, in
which case each stream draws its own setup. The chunk width is
``ceil(logical_cols / 4)``. K11 and K12 take ``row0``, the global id of
their first walk row (:mod:`.engine`; the sharded products of
:mod:`brainevent_torch.parallel` walk their own rows so).

- K11 :data:`jitc_walk_setup` builds a plan's streams; it stands in for
  the XLA setup of ``walk_plan_setup`` (``pallas_kernels.py:117``).
- K12 :data:`jitc_walk_mv` (``_make_kernel``, ``:142``): the mat-vec,
  gather (``corder=True``) or scatter; in the scatter form only the rows
  with a non-zero operand walk.
- K13 :data:`jitc_walk_mm` (``_make_mm_kernel``, ``:194``, stride 32) and
  :data:`jitc_walk_mm4` (``_make_mm_layout_kernel``, ``:699``, stride 4):
  the mat-mat.
- K14 :data:`jitc_walk_todense` (``_make_todense_kernel``, ``:378``,
  stride 32) and :data:`jitc_walk_todense4` (``_make_todense_mm_kernel``,
  ``:925``, stride 4): the dense matrix.

Each op runs its twin for CPU tensors and launches its kernel for CUDA
tensors. The TPU kernels' envelope checks (x64, VMEM) and their XLA
fallbacks have no counterpart: the CUDA kernels take any shape.
"""

import ctypes
from typing import Tuple

import numpy as np
import torch

from .._misc import _MM_STRIDE, _MV_STRIDE, _normalize_chunk_size
from ..ops import cuda_build
from ..ops.core import KernelOp, check_cuda_tensors, cuda_stream
from ..ops.operand import op_code
from ..rng.light import M32, light_rng_normal01, light_rng_uniform01
from . import engine

__all__ = ['jitc_walk_setup', 'jitc_walk_mv', 'jitc_walk_mm',
           'jitc_walk_mm4', 'jitc_walk_todense', 'jitc_walk_todense4',
           'walk_plan_setup', 'walk_plan_setup_mm', 'law_weight_fn']

_SOURCE = 'brainevent_torch/csrc/jitc_walk.cu'
_TPU = 'brainevent_tpu/jitc/pallas_kernels.py'
_I32, _F32 = torch.int32, torch.float32


def law_weight_fn(law: int, a: float, b: float):
    """``weight_fn(seed, rows, cols)`` of a law code and its two float32
    parameters: the twins' form of ``lr_weight`` in ``light_rng.cuh``."""
    def weight_fn(seed, rows, cols):
        base = torch.full(rows.shape, a, dtype=_F32, device=rows.device)
        if law == 0:
            return base
        draw = (light_rng_normal01 if law == 1 else light_rng_uniform01)(
            seed, rows, cols)
        return torch.addcmul(base, draw, torch.tensor(b, dtype=_F32,
                                                      device=rows.device))
    return weight_fn


def _setup(state2, q2):
    return None if state2 is None else (state2, q2)


def _op(x: torch.Tensor, event: bool) -> int:
    """The kernel's operand op: a bool operand is always an event."""
    return op_code(x, event or x.dtype == torch.bool)


def _chunk(logical_cols: int) -> int:
    return _normalize_chunk_size(logical_cols, None)


def _walk_args(op, state2, q2, x, n_rows, n_cols, stride, chunk_size):
    """Check a launch's tensors; the plan pointers (or nulls)."""
    pairs = [(x, x.dtype)]
    if x.dtype not in (torch.bool, _F32):
        raise TypeError(f'{op.name}: operand must be bool or float32, got '
                        f'{x.dtype}')
    if state2 is not None:
        L = engine.cdiv(n_cols, chunk_size) * stride
        pairs += [(state2, _I32), (q2, _I32)]
        if tuple(state2.shape) != (n_rows, L) or q2.shape != state2.shape:
            raise ValueError(f'{op.name}: plan {tuple(state2.shape)} does '
                             f'not fit the walk ({n_rows}, {L})')
    device = check_cuda_tensors(op.name, *pairs)
    ptrs = ([None, None] if state2 is None
            else [state2.data_ptr(), q2.data_ptr()])
    return device, ptrs


# law, a, b, seed, cl, then n_rows, n_cols, chunk_size, stride, corder
_WALK = [ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_uint32,
         ctypes.c_uint32] + [ctypes.c_int] * 5


# -- K11: plan setup ---------------------------------------------------------------

def jitc_walk_setup_twin(state2, q2, *, seed: int, cl: int, n_rows: int,
                         n_cols: int, chunk_size: int, stride: int,
                         row0: int = 0):
    """Plain PyTorch twin of K11: fills ``state2``/``q2`` in place."""
    s, q = engine.walk_setup2(seed, cl, n_rows, n_cols, stride, chunk_size,
                              device=state2.device, row0=row0)
    state2.copy_(s)
    q2.copy_(q)
    return state2, q2


def _jitc_walk_setup_cuda(op, state2, q2, *, seed, cl, n_rows, n_cols,
                          chunk_size, stride, row0=0):
    device = check_cuda_tensors(op.name, (state2, _I32), (q2, _I32))
    L = engine.cdiv(n_cols, chunk_size) * stride
    if tuple(state2.shape) != (n_rows, L) or q2.shape != state2.shape:
        raise ValueError(f'{op.name}: outputs {tuple(state2.shape)} do not '
                         f'fit the walk ({n_rows}, {L})')
    fn = cuda_build.function('jitc_walk_setup_launch', [
        ctypes.c_uint32, ctypes.c_uint32] + [ctypes.c_int] * 4 + [
        ctypes.c_uint32, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p])
    op.launch(fn, seed & M32, cl, n_rows, n_cols, chunk_size, stride,
              row0 & M32, state2.data_ptr(), q2.data_ptr(),
              device.index or 0, cuda_stream(device))
    return state2, q2


jitc_walk_setup = KernelOp(
    'jitc_walk_setup', twin=jitc_walk_setup_twin, cuda=_jitc_walk_setup_cuda,
    source=_SOURCE, replaces=f'{_TPU}:117')


def _plan_setup(seed, clen, n_rows, n_cols, chunk_size, stride, device,
                row0=0):
    L = engine.cdiv(n_cols, chunk_size) * stride
    state2 = torch.empty(n_rows, L, dtype=_I32, device=device)
    q2 = torch.empty(n_rows, L, dtype=_I32, device=device)
    cl = max(int(clen) & M32, 2)
    jitc_walk_setup(state2, q2, seed=int(seed) & M32, cl=cl, n_rows=n_rows,
                    n_cols=n_cols, chunk_size=chunk_size, stride=stride,
                    row0=row0)
    return state2, q2, cl


def walk_plan_setup(seed, clen, n_rows: int, n_cols: int, chunk_size: int,
                    device=None, row0: int = 0
                    ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """The streams of the stride-32 (mv-mode) walk: ``(state2, q2, cl)``,
    ``(n_rows, n_chunks * 32)`` int32 bit patterns of uint32 and the
    connection length, through K11 on *device*; the rows are the global
    rows ``[row0, row0 + n_rows)``."""
    return _plan_setup(seed, clen, n_rows, n_cols, chunk_size, _MV_STRIDE,
                       device, row0)


def walk_plan_setup_mm(seed, clen, n_rows: int, n_cols: int,
                       chunk_size: int, device=None):
    """The streams of the stride-4 (mm-mode) walk, as
    :func:`walk_plan_setup`."""
    return _plan_setup(seed, clen, n_rows, n_cols, chunk_size, _MM_STRIDE,
                       device)


# -- K12: mat-vec ------------------------------------------------------------------

def jitc_walk_mv_twin(state2, q2, x, *, law: int, a: float, b: float,
                      seed: int, cl: int, n_rows: int, n_cols: int,
                      logical_cols: int, corder: bool, event: bool,
                      stride: int = _MV_STRIDE, row0: int = 0):
    """Plain PyTorch twin of K12: ``(n_rows,)`` (gather) or ``(n_cols,)``
    (scatter); the walk rows are the global rows from *row0*."""
    return engine.walk_matvec(
        law_weight_fn(law, a, b), seed, cl, x, n_rows if corder else n_cols,
        corder=corder, logical_cols=logical_cols, stride=stride,
        event=event, setup=_setup(state2, q2), row0=row0)


def _jitc_walk_mv_cuda(op, state2, q2, x, *, law, a, b, seed, cl, n_rows,
                       n_cols, logical_cols, corder, event,
                       stride=_MV_STRIDE, row0=0):
    chunk = _chunk(logical_cols)
    device, plan = _walk_args(op, state2, q2, x, n_rows, n_cols, stride,
                              chunk)
    if x.shape != ((n_cols,) if corder else (n_rows,)):
        raise ValueError(f'{op.name}: operand {tuple(x.shape)} does not fit '
                         f'the walk ({n_rows}, {n_cols}), corder={corder}')
    out = (torch.empty if corder else torch.zeros)(
        n_rows if corder else n_cols, dtype=_F32, device=device)
    fn = cuda_build.function('jitc_walk_mv_launch', [
        ctypes.c_void_p] * 3 + [ctypes.c_int] + _WALK + [
        ctypes.c_uint32, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    op.launch(fn, *plan, x.data_ptr(), _op(x, event), law, a, b,
              seed & M32, cl, n_rows, n_cols, chunk, stride, int(corder),
              row0 & M32, out.data_ptr(), device.index or 0,
              cuda_stream(device))
    return out


jitc_walk_mv = KernelOp(
    'jitc_walk_mv', twin=jitc_walk_mv_twin, cuda=_jitc_walk_mv_cuda,
    source=_SOURCE, replaces=f'{_TPU}:142')


# -- K13: mat-mat ------------------------------------------------------------------

def _mm_op(name: str, stride: int, line: int) -> KernelOp:
    def twin(state2, q2, B, *, law, a, b, seed, cl, n_rows, n_cols,
             logical_cols, corder, event):
        return engine.walk_matmat(
            law_weight_fn(law, a, b), seed, cl, B,
            n_rows if corder else n_cols, corder=corder,
            logical_cols=logical_cols, stride=stride, event=event,
            setup=_setup(state2, q2))

    def cuda(op, state2, q2, B, *, law, a, b, seed, cl, n_rows, n_cols,
             logical_cols, corder, event):
        chunk = _chunk(logical_cols)
        device, plan = _walk_args(op, state2, q2, B, n_rows, n_cols, stride,
                                  chunk)
        n_batch = B.shape[1]
        if B.shape[0] != (n_cols if corder else n_rows):
            raise ValueError(f'{op.name}: operand {tuple(B.shape)} does not '
                             f'fit the walk ({n_rows}, {n_cols}), '
                             f'corder={corder}')
        out = (torch.empty if corder else torch.zeros)(
            n_rows if corder else n_cols, n_batch, dtype=_F32,
            device=device)
        fn = cuda_build.function('jitc_walk_mm_launch', [
            ctypes.c_void_p] * 3 + [ctypes.c_int] + _WALK + [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
        op.launch(fn, *plan, B.data_ptr(), _op(B, event), law, a, b,
                  seed & M32, cl, n_rows, n_cols, chunk, stride, int(corder),
                  n_batch, out.data_ptr(), device.index or 0,
                  cuda_stream(device))
        return out

    twin.__name__ = f'{name}_twin'
    twin.__doc__ = (f'Plain PyTorch twin of K13 at stride {stride}: '
                    f'``(n_rows, n_batch)`` (gather) or ``(n_cols, '
                    f'n_batch)``.')
    return KernelOp(name, twin=twin, cuda=cuda, source=_SOURCE,
                    replaces=f'{_TPU}:{line}')


jitc_walk_mm = _mm_op('jitc_walk_mm', _MV_STRIDE, 194)
jitc_walk_mm4 = _mm_op('jitc_walk_mm4', _MM_STRIDE, 699)


# -- K14: the dense matrix ---------------------------------------------------------

def _todense_op(name: str, stride: int, line: int) -> KernelOp:
    def twin(out, state2, q2, *, law, a, b, seed, cl, corder):
        return engine.walk_todense(
            law_weight_fn(law, a, b), seed, cl, tuple(out.shape),
            corder=corder, stride=stride, setup=_setup(state2, q2), out=out)

    def cuda(op, out, state2, q2, *, law, a, b, seed, cl, corder):
        m, k = out.shape
        n_rows, n_cols = (m, k) if corder else (k, m)
        chunk = _chunk(k)
        device, plan = _walk_args(op, state2, q2, out, n_rows, n_cols,
                                  stride, chunk)
        fn = cuda_build.function('jitc_walk_todense_launch', [
            ctypes.c_void_p] * 2 + _WALK + [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
        op.launch(fn, *plan, law, a, b, seed & M32, cl, n_rows, n_cols,
                  chunk, stride, int(corder), k, out.data_ptr(),
                  device.index or 0, cuda_stream(device))
        return out

    twin.__name__ = f'{name}_twin'
    twin.__doc__ = (f'Plain PyTorch twin of K14 at stride {stride}: writes '
                    f'the weights into the zeros of ``out`` ``(m, k)``.')
    return KernelOp(name, twin=twin, cuda=cuda, source=_SOURCE,
                    replaces=f'{_TPU}:{line}')


jitc_walk_todense = _todense_op('jitc_walk_todense', _MV_STRIDE, 378)
jitc_walk_todense4 = _todense_op('jitc_walk_todense4', _MM_STRIDE, 925)


def f32(x) -> float:
    """*x* (a number or a one-element tensor) rounded to float32."""
    if isinstance(x, torch.Tensor):
        x = x.detach().reshape(-1)[0].item()
    return float(np.float32(x))


def law_params(law: int, params) -> Tuple[float, float]:
    """The kernels' ``(a, b)`` of a family's weight parameters: scalar
    ``(w, 0)``, normal ``(loc, scale)``, uniform ``(low, high - low)``
    (the difference in float32, as the JAX weight law takes it)."""
    if law == 0:
        return f32(params[0]), 0.0
    a, b = f32(params[0]), f32(params[1])
    if law == 2:
        b = float(np.float32(b) - np.float32(a))
    return a, b
