# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""Fixed-number (ELL) connectivity: the event-driven ``binary_fcnmv``."""

from .binary import binary_fcnmv, binary_fcnmv_p_call, event_capacity

__all__ = ['binary_fcnmv', 'binary_fcnmv_p_call', 'event_capacity']
