# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""SNN model components: LIF neurons, the CUBA/COBA EI networks (stored
and implicit connectivity) and surrogate-gradient training."""

from .neurons import (
    LIFRefParams, LIFRefState, lifref_init, lifref_step, surrogate_spike,
)
from .jitc_net import JITCNet, JITCNetState
from .networks import EINet, EINetState
from .sim import (
    dense_count_table, einet_pallas_sim, einet_pallas_sim_chain,
    einet_pallas_sim_dense, einet_pallas_sim_mxu, einet_pallas_sim_mxu2,
    einet_pallas_sim_mxu3, einet_pallas_sim_mxu4, einet_pallas_sim_mxu5,
    einet_pallas_sim_mxu6, mxu6_conn_table,
)
from .training import SNNParams, SurrogateSNN, snn_loss, train_step

__all__ = [
    'LIFRefParams', 'LIFRefState', 'lifref_init', 'lifref_step',
    'surrogate_spike', 'EINet', 'EINetState', 'JITCNet', 'JITCNetState',
    'einet_pallas_sim', 'einet_pallas_sim_mxu', 'einet_pallas_sim_mxu2',
    'einet_pallas_sim_mxu3', 'einet_pallas_sim_mxu4', 'einet_pallas_sim_mxu5',
    'einet_pallas_sim_mxu6', 'einet_pallas_sim_chain',
    'einet_pallas_sim_dense', 'dense_count_table', 'mxu6_conn_table', 'SNNParams', 'SurrogateSNN', 'snn_loss', 'train_step',
]
