# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""CSR/CSC matrices and their products (``brainevent_tpu.csr``): the
event products (K7 ``csr_gather_mv``, K8 ``csr_scatter_mv``), the float
products, the mat-mat products (K10 ``csr_gather_mm``) and STDP (K9
``pair_gather``)."""

from .binary import (
    binary_csrmv, binary_csrmv_p_call, binary_csrmm, binary_csrmm_p_call,
    binary_csrmv_indexed, binary_csrmv_indexed_p_call, binary_csrmm_indexed,
    binary_csrmm_indexed_p_call,
)
from .float import csrmv, csrmv_p_call, csrmm, csrmm_p_call
from .main import CompressedSparseData, CSR, CSC
from .pallas_kernels import csr_gather_mv, csr_scatter_mv
from .plasticity import (
    update_csr_on_binary_pre, update_csr_on_binary_post,
    update_csc_on_binary_pre, update_csc_on_binary_post,
)

__all__ = [
    'CompressedSparseData', 'CSR', 'CSC',
    'binary_csrmv', 'binary_csrmv_p_call', 'binary_csrmm',
    'binary_csrmm_p_call', 'binary_csrmv_indexed',
    'binary_csrmv_indexed_p_call', 'binary_csrmm_indexed',
    'binary_csrmm_indexed_p_call',
    'csrmv', 'csrmv_p_call', 'csrmm', 'csrmm_p_call',
    'csr_gather_mv', 'csr_scatter_mv',
    'update_csr_on_binary_pre', 'update_csr_on_binary_post',
    'update_csc_on_binary_pre', 'update_csc_on_binary_post',
]
