# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""Op registry, the CUDA build, and the event scatter ops."""

from .core import KernelOp, launch_counts, reset_launch_counts
from .scatter import event_scatter_add, event_scatter_add_multi

__all__ = ['KernelOp', 'launch_counts', 'reset_launch_counts',
           'event_scatter_add', 'event_scatter_add_multi']
