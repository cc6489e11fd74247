# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""SNN model components: LIF neurons and the CUBA/COBA EI networks."""

from .neurons import (
    LIFRefParams, LIFRefState, lifref_init, lifref_step, surrogate_spike,
)
from .networks import EINet, EINetState
from .sim import einet_pallas_sim, mxu6_conn_table

__all__ = [
    'LIFRefParams', 'LIFRefState', 'lifref_init', 'lifref_step',
    'surrogate_spike', 'EINet', 'EINetState', 'einet_pallas_sim',
    'mxu6_conn_table',
]
