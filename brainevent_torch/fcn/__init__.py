# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""Fixed-number (ELL) connectivity. So far only ``event_capacity``."""

from .binary import event_capacity

__all__ = ['event_capacity']
