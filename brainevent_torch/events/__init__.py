# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""Event representations and encoders (``brainevent_tpu.events``): the
spike wrappers ``BinaryArray``, ``BitPackedBinary`` and ``CompactBinary``,
``bitpack``, and the eight encoders (the row count through K18
``event_row_count``)."""

from .base import EventRepresentation, extract_raw_value, is_known_type
from .binary import BinaryArray
from .bitpack import BitPackedBinary, bitpack
from .compact_binary import CompactBinary, event_value, is_event
from .compact_ops import (
    binary_1d_array_index_p_call, binary_2d_compact_only_p_call,
    binary_2d_array_index_p_call, binary_2d_pair_stream_encode_p_call,
    binary_2d_row_sparse_encode_p_call, binary_2d_csr_row_count_p_call,
    binary_2d_csr_fill_p_call, binary_2d_csc_encode_p_call,
    binary_2d_csr_encode_p_call, binary_2d_csc_from_array,
)
from .pallas_kernels import event_row_count

__all__ = [
    'EventRepresentation', 'extract_raw_value', 'is_known_type',
    'BinaryArray', 'BitPackedBinary', 'bitpack', 'CompactBinary',
    'is_event', 'event_value', 'event_row_count',
    'binary_1d_array_index_p_call', 'binary_2d_compact_only_p_call',
    'binary_2d_array_index_p_call', 'binary_2d_pair_stream_encode_p_call',
    'binary_2d_row_sparse_encode_p_call', 'binary_2d_csr_row_count_p_call',
    'binary_2d_csr_fill_p_call', 'binary_2d_csc_encode_p_call',
    'binary_2d_csr_encode_p_call', 'binary_2d_csc_from_array',
]
