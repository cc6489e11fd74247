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
"""

import torch

__all__ = ['OP_BOOL', 'OP_GATE', 'OP_IDENTITY', 'op_code', 'spike_is_bool',
           'op_values', 'take', 'fits']

OP_BOOL, OP_GATE, OP_IDENTITY = 0, 1, 2


def op_code(x: torch.Tensor, binary: bool) -> int:
    """The kernels' op for operand *x*; raises on a dtype they do not
    take."""
    if binary and x.dtype == torch.bool:
        return OP_BOOL
    if x.dtype != torch.float32:
        raise TypeError(f'the event kernels take a bool or float32 operand '
                        f'for an event product and float32 for a float one, '
                        f'got {x.dtype}')
    return OP_GATE if binary else OP_IDENTITY


def spike_is_bool(name: str, x: torch.Tensor) -> int:
    """1 for a bool spike tensor, 0 for float32: the spikes the non-zero
    gated kernels (K17, K18) take; raises a ``TypeError`` otherwise."""
    if x.dtype not in (torch.bool, torch.float32):
        raise TypeError(f'{name}: the kernel takes bool or float32 spikes, '
                        f'got {x.dtype}')
    return int(x.dtype == torch.bool)


def op_values(x: torch.Tensor, binary: bool) -> torch.Tensor:
    """``op(x)`` as float32: the event gate (bool, or ``x > 0``), or ``x``
    itself."""
    if not binary:
        return x.to(torch.float32)
    return (x if x.dtype == torch.bool else x > 0).to(torch.float32)


def take(v: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``v[ids]`` (along the first axis) as float32, with an exact 0 where
    an id is outside ``[0, len(v))``."""
    n = v.shape[0]
    shape = ids.shape + v.shape[1:]
    zero = torch.zeros((), dtype=torch.float32, device=v.device)
    if n == 0:
        return zero.expand(shape)
    valid = (ids >= 0) & (ids < n)
    got = v.to(torch.float32)[ids.clamp(0, n - 1)]
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
