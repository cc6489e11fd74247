# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""Operand helpers shared by the event kernels' wrappers and twins.

The CSR and dense product kernels (``csrc/csr_event.cu``,
``csrc/csr_gather_mm.cu``, ``csrc/dense_event.cu``) apply an op to each
operand value they read: the event gate of a binary product (a bool
operand, or a float one gated at ``> 0``) or the identity of a float
product. :func:`op_code` picks it from the operand's dtype and
:func:`op_values` is its plain PyTorch form. The kernels that gate at
``!= 0`` (dense STDP, the row count) take their spikes' dtype from
:func:`spike_is_bool`. :func:`take` is the gather every twin uses: ids
outside the operand give an exact 0, as the kernels drop them.

The kernels take bool or float32 spikes and float32 or float64 weights,
traces and float operands (a float operand in the weights' dtype; each
float kernel has a ``double`` instance, :func:`is_double` picks it), and
raise on anything else. The public entries bring the dtypes the JAX
package computes to them, before any launch:

- :func:`event_spikes`: spikes of any other dtype become their bool gate
  (``> 0`` for the products, ``!= 0`` for STDP and the encoders). The
  kernel then sees the bool that a bool operand gives it, so this is
  exact;
- :func:`widen`: float16 and bfloat16 become float32, which is exact; the
  entry casts the float32 result to the dtype the JAX package returns, as
  its Pallas routes do ("Mosaic computes f32"). Against the twin in that
  dtype the result is within 1 ulp of the dtype, on top of the family's
  float32 bound;
- float64 weights and traces stay float64: on the card they launch the
  kernels' ``double`` instances, on the CPU the twins compute in float64
  (:func:`acc_dtype`), as the JAX package keeps float64 on its XLA
  kernel; the result is float64.
"""

import torch

__all__ = ['OP_BOOL', 'OP_GATE', 'OP_IDENTITY', 'op_code', 'spike_is_bool',
           'op_values', 'take', 'fits', 'event_spikes', 'widen',
           'is_double', 'acc_dtype']

OP_BOOL, OP_GATE, OP_IDENTITY = 0, 1, 2
_HALF = (torch.float16, torch.bfloat16)


def op_code(x: torch.Tensor, binary: bool,
            value: torch.dtype = torch.float32) -> int:
    """The kernels' op for operand *x* of a kernel computing in *value*
    (the weights' dtype); raises on a dtype they do not take."""
    if binary and x.dtype in (torch.bool, torch.float32):
        return OP_BOOL if x.dtype == torch.bool else OP_GATE
    if not binary and x.dtype == value:
        return OP_IDENTITY
    raise TypeError(f'the event kernels take a bool or float32 operand for '
                    f"an event product and one in the weights' dtype "
                    f'({value}) for a float one, got {x.dtype}')


def is_double(name: str, *xs) -> int:
    """1 where the float tensors *xs* (weights, traces) are float64, 0
    where they are float32: the value type of the kernel instance to
    launch. Raises a ``TypeError`` on any other dtype or a mix."""
    dtypes = {x.dtype for x in xs}
    if dtypes == {torch.float64}:
        return 1
    if dtypes == {torch.float32}:
        return 0
    raise TypeError(f'{name}: the kernels compute float32 or float64 '
                    f'weights and traces of one dtype, got {dtypes}')


def spike_is_bool(name: str, x: torch.Tensor) -> int:
    """1 for a bool spike tensor, 0 for float32: the spikes the non-zero
    gated kernels (K17, K18) take; raises a ``TypeError`` otherwise."""
    if x.dtype not in (torch.bool, torch.float32):
        raise TypeError(f'{name}: the kernel takes bool or float32 spikes, '
                        f'got {x.dtype}')
    return int(x.dtype == torch.bool)


def event_spikes(x: torch.Tensor, nonzero: bool = False) -> torch.Tensor:
    """Spikes as the event kernels take them: bool and float32 as they
    are (the kernels gate them), any other dtype reduced to its gate,
    ``x != 0`` with *nonzero*, else ``x > 0``."""
    if x.dtype in (torch.bool, torch.float32):
        return x
    return x != 0 if nonzero else x > 0


def widen(x: torch.Tensor) -> torch.Tensor:
    """float16 and bfloat16 as float32 (exact); any other dtype as it
    is."""
    return x.to(torch.float32) if x.dtype in _HALF else x


def _float64(xs) -> bool:
    return any(isinstance(x, torch.Tensor) and x.dtype == torch.float64
               for x in xs)


def acc_dtype(*xs) -> torch.dtype:
    """The dtype a twin sums in: float64 where a float64 tensor is among
    *xs*, else float32."""
    return torch.float64 if _float64(xs) else torch.float32


def op_values(x: torch.Tensor, binary: bool,
              dtype=torch.float32) -> torch.Tensor:
    """``op(x)`` in *dtype*: the event gate (bool, or ``x > 0``), or ``x``
    itself."""
    if not binary:
        return x.to(dtype)
    return (x if x.dtype == torch.bool else x > 0).to(dtype)


def take(v: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``v[ids]`` (along the first axis) as float32 (float64 stays
    float64), with an exact 0 where an id is outside ``[0, len(v))``."""
    n = v.shape[0]
    shape = ids.shape + v.shape[1:]
    dtype = acc_dtype(v)
    zero = torch.zeros((), dtype=dtype, device=v.device)
    if n == 0:
        return zero.expand(shape)
    valid = (ids >= 0) & (ids < n)
    got = v.to(dtype)[ids.clamp(0, n - 1)]
    return torch.where(valid.reshape(ids.shape + (1,) * (v.ndim - 1)), got,
                       zero)


def fits(w, indices, perm) -> bool:
    """Do weights *w* fit the structure: ``(1,)``, one per entry, or,
    with a permutation (one slot per entry), any length it indexes?"""
    if w.ndim != 1 or w.shape[0] == 0:
        return False
    if perm is not None:
        return perm.shape == indices.shape
    return w.shape[0] in (1, indices.shape[0])
