# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""Shared helpers of the CSR package (``brainevent_tpu.csr._common``)."""

import torch

from .._error import MathError

__all__ = ['row_ids_from_indptr', 'event_gate', 'is_homo', 'csr_checks']


def row_ids_from_indptr(indptr: torch.Tensor, nse: int) -> torch.Tensor:
    """Expand CSR ``indptr`` into the per-entry row ids (COO rows), in the
    dtype of ``indptr``. Empty rows, trailing ones included, give no ids.
    ``output_size`` spares the device a synchronisation."""
    n_rows = indptr.shape[0] - 1
    return torch.repeat_interleave(
        torch.arange(n_rows, dtype=indptr.dtype, device=indptr.device),
        torch.diff(indptr), output_size=nse)


def event_gate(v: torch.Tensor, out_dtype=torch.float32) -> torch.Tensor:
    """Event gating of a spike tensor: bool casts, floats gate at ``> 0``."""
    if v.dtype == torch.bool:
        return v.to(out_dtype)
    return (v > 0).to(out_dtype)


def is_homo(weights) -> bool:
    """Homogeneous (one shared) weight? Read from the shape, so that the
    answer is the same for a tensor, its gradient and its metadata."""
    return tuple(weights.shape) == (1,)


def csr_checks(weights, indices, indptr, shape) -> None:
    """Validate a CSR operand triple against its logical ``shape``."""
    if len(shape) != 2:
        raise MathError(f'shape must be (m, k), got {shape}.')
    if indices.dtype != indptr.dtype:
        raise MathError(
            f'indices dtype ({indices.dtype}) must match indptr dtype '
            f'({indptr.dtype}).')
    if indptr.shape[0] != shape[0] + 1:
        raise MathError(
            f'indptr length {indptr.shape[0]} != shape[0]+1 = {shape[0] + 1}.')
    if weights.ndim != 1 or weights.shape[0] not in (1, indices.shape[0]):
        raise MathError(
            f'weights must be (1,) or ({indices.shape[0]},), got '
            f'{tuple(weights.shape)}.')
