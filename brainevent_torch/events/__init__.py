# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""Event representations: the spike wrapper ``BinaryArray``."""

from .base import EventRepresentation, extract_raw_value, is_known_type
from .binary import BinaryArray

__all__ = ['EventRepresentation', 'extract_raw_value', 'is_known_type',
           'BinaryArray']
