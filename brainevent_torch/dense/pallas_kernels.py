# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""The dense event kernels: K15 :data:`dense_event_mv`, K16
:data:`dense_event_mm` (``csrc/dense_event.cu``) and K17
:data:`dense_stdp_pre` / :data:`dense_stdp_post` (``csrc/dense_stdp.cu``).

- K15 ``dense_event_mv(w, s, transpose)``: ``g(s) @ w`` (``transpose``,
  ``w`` ``(k, m)``) or ``w @ g(s)`` (``w`` ``(m, k)``); replaces
  ``brainevent_tpu/dense/binary.py``'s ``_densemv_pallas_kernel``;
- K16 ``dense_event_mm(w, S, transpose)``: ``w.T @ g(S)`` or ``w @ g(S)``,
  ``S`` ``(k, n)``; replaces ``_densemm_pallas_kernel``;
- K17 ``dense_stdp_pre(w, s, t, w_min, w_max)``: ``w + outer(g'(s), t)``,
  and ``dense_stdp_post(w, t, s, w_min, w_max)``: ``w + outer(t, g'(s))``,
  each clipped to ``[w_min, w_max]`` when a bound is given; they replace
  ``brainevent_tpu/dense/plasticity.py``'s ``_on_pre_pallas_kernel`` and
  ``_on_post_pallas_kernel``.

Two gates, kept apart as in the JAX package: the products gate a float
spike at ``> 0`` (``g``, :func:`~brainevent_torch.ops.operand.op_values`),
the STDP updates at ``!= 0`` (``g'``, the encoders' ``event_mask``; NaN
and negative spikes count). A bool spike gates on its truth either way.

The twins compute in the weight's dtype and take what the JAX package's
``jax_raw`` kernels take; the kernels take float32 or float64 weights
(and traces of the weights' dtype; float64 launches each kernel's
``double`` instance) and bool or float32 spikes, and raise a
``TypeError`` on anything else.
"""

import ctypes

import torch

from ..events.pallas_kernels import event_mask
from ..ops import cuda_build
from ..ops.core import KernelOp, check_cuda_tensors, cuda_stream
from ..ops.operand import is_double, op_code, spike_is_bool

__all__ = ['dense_event_mv', 'dense_event_mm', 'dense_stdp_pre',
           'dense_stdp_post', 'dense_event_mv_twin', 'dense_event_mm_twin',
           'dense_stdp_pre_twin', 'dense_stdp_post_twin', 'product_gate']

_EVENT_SOURCE = 'brainevent_torch/csrc/dense_event.cu'
_STDP_SOURCE = 'brainevent_torch/csrc/dense_stdp.cu'
# K16's k tile (one 64-bit gate mask per column), and its scratch words
# per tile: a mask per column, a needed-row mask per 32 columns, a
# 128-byte event record per 8 columns
_MM_TILE_K = 64


def _mm_scratch_words(k: int, n: int) -> int:
    per_tile = n + -(-n // 32) + 16 * -(-n // 8)
    return -(-k // _MM_TILE_K) * per_tile + 1


def product_gate(s: torch.Tensor, dtype) -> torch.Tensor:
    """The products' 0/1 gate in *dtype*: a bool on its truth, a number
    at ``> 0``."""
    return (s if s.dtype == torch.bool else s > 0).to(dtype)


def _clip(out, w_min, w_max):
    if w_min is None and w_max is None:
        return out
    return torch.clamp(out, w_min, w_max)


# -- twins -----------------------------------------------------------------------

def dense_event_mv_twin(w, s, transpose: bool):
    """Plain PyTorch twin of K15: the gate times ``w``, in ``w``'s dtype."""
    g = product_gate(s, w.dtype)
    return g @ w if transpose else w @ g


def dense_event_mm_twin(w, s, transpose: bool):
    """Plain PyTorch twin of K16: ``w.T @ g(S)`` or ``w @ g(S)``."""
    g = product_gate(s, w.dtype)
    return w.T @ g if transpose else w @ g


def dense_stdp_pre_twin(w, s, t, w_min=None, w_max=None):
    """Plain PyTorch twin of K17 on-pre: ``w + outer(g'(s), t)``, clipped."""
    return _clip(w + torch.outer(event_mask(s).to(w.dtype), t), w_min, w_max)


def dense_stdp_post_twin(w, t, s, w_min=None, w_max=None):
    """Plain PyTorch twin of K17 on-post: ``w + outer(t, g'(s))``, clipped."""
    return _clip(w + torch.outer(t, event_mask(s).to(w.dtype)), w_min, w_max)


# -- kernels ---------------------------------------------------------------------

def _dense_event_mv_cuda(op, w, s, transpose):
    code = op_code(s, True)
    dbl = is_double(op.name, w)
    device = check_cuda_tensors(op.name, (w, w.dtype), (s, s.dtype))
    rows, cols = w.shape
    k = rows if transpose else cols
    y = torch.empty(cols if transpose else rows, dtype=w.dtype,
                    device=device)
    # the gates as 32-bit ballot words, written by the launch's gate pass
    bits = torch.empty(-(-k // 32), dtype=torch.int32, device=device)
    fn = cuda_build.function('dense_event_mv_launch', [
        ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 5 + [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    op.launch(fn, w.data_ptr(), s.data_ptr(), code, int(transpose), dbl,
              rows, cols, bits.data_ptr(), y.data_ptr(), device.index or 0,
              cuda_stream(device))
    return y


def _dense_event_mm_cuda(op, w, s, transpose):
    code = op_code(s, True)
    dbl = is_double(op.name, w)
    device = check_cuda_tensors(op.name, (w, w.dtype), (s, s.dtype))
    k, n = s.shape
    m = w.shape[1] if transpose else w.shape[0]
    y = torch.empty(m, n, dtype=w.dtype, device=device)
    # written by the launch's mask pass
    scratch = torch.empty(_mm_scratch_words(k, n), dtype=torch.int64,
                          device=device)
    fn = cuda_build.function('dense_event_mm_launch', [
        ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 6 + [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    op.launch(fn, w.data_ptr(), s.data_ptr(), code, int(transpose), dbl, m,
              k, n, scratch.data_ptr(), y.data_ptr(), device.index or 0,
              cuda_stream(device))
    return y


def _dense_stdp_cuda(op, w, s, t, w_min, w_max, *, post):
    spike_bool = spike_is_bool(op.name, s)
    dbl = is_double(op.name, w, t)
    device = check_cuda_tensors(op.name, (w, w.dtype), (s, s.dtype),
                                (t, w.dtype))
    m, n = w.shape
    out = torch.empty_like(w)
    ptrs = (w, out) if post else (w, out, t)
    vec = int(not dbl and n % 4 == 0
              and all(p.data_ptr() % 16 == 0 for p in ptrs))
    fn = cuda_build.function('dense_stdp_launch', [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p] + [
        ctypes.c_int] * 6 + [ctypes.c_double, ctypes.c_int, ctypes.c_double,
                             ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                             ctypes.c_void_p])
    op.launch(fn, w.data_ptr(), s.data_ptr(), t.data_ptr(), spike_bool,
              int(post), dbl, m, n, int(w_min is not None),
              0.0 if w_min is None else float(w_min),
              int(w_max is not None), 0.0 if w_max is None else float(w_max),
              vec, out.data_ptr(), device.index or 0, cuda_stream(device))
    return out


def _dense_stdp_pre_cuda(op, w, s, t, w_min=None, w_max=None):
    return _dense_stdp_cuda(op, w, s, t, w_min, w_max, post=False)


def _dense_stdp_post_cuda(op, w, t, s, w_min=None, w_max=None):
    return _dense_stdp_cuda(op, w, s, t, w_min, w_max, post=True)


dense_event_mv = KernelOp(
    'dense_event_mv', twin=dense_event_mv_twin, cuda=_dense_event_mv_cuda,
    source=_EVENT_SOURCE, replaces='brainevent_tpu/dense/binary.py:81')

dense_event_mm = KernelOp(
    'dense_event_mm', twin=dense_event_mm_twin, cuda=_dense_event_mm_cuda,
    source=_EVENT_SOURCE, replaces='brainevent_tpu/dense/binary.py:267')

dense_stdp_pre = KernelOp(
    'dense_stdp_pre', twin=dense_stdp_pre_twin, cuda=_dense_stdp_pre_cuda,
    source=_STDP_SOURCE, replaces='brainevent_tpu/dense/plasticity.py:55')

dense_stdp_post = KernelOp(
    'dense_stdp_post', twin=dense_stdp_post_twin, cuda=_dense_stdp_post_cuda,
    source=_STDP_SOURCE, replaces='brainevent_tpu/dense/plasticity.py:95')
