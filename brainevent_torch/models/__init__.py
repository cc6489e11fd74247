# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""SNN model components: LIF neurons, the CUBA/COBA EI networks (stored
and implicit connectivity), the Potjans-Diesmann cortical microcircuit,
NEST's HPC benchmark network with STDP, Brette's Hodgkin-Huxley network
(COBAHH), Vogels et al. 2011's network with inhibitory plasticity and
surrogate-gradient training."""

from .neurons import (
    LIFRefParams, LIFRefState, lifref_init, lifref_step, surrogate_spike,
)
from .hh_net import HHNet, HHNetState, HHParams
from .hpc_stdp import (HpcStdpNet, HpcStdpParams, HpcStdpState,
                       build_hpc_network)
from .istdp_net import (IstdpNet, IstdpParams, IstdpState,
                        build_istdp_network)
from .jitc_net import JITCNet, JITCNetState
from .microcircuit import (MicrocircuitNet, MicrocircuitParams,
                           MicrocircuitState, build_microcircuit)
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
    'MicrocircuitNet', 'MicrocircuitParams', 'MicrocircuitState',
    'build_microcircuit', 'HpcStdpNet', 'HpcStdpParams', 'HpcStdpState',
    'build_hpc_network', 'HHNet', 'HHNetState', 'HHParams',
    'IstdpNet', 'IstdpParams', 'IstdpState', 'build_istdp_network',
    'einet_pallas_sim', 'einet_pallas_sim_mxu', 'einet_pallas_sim_mxu2',
    'einet_pallas_sim_mxu3', 'einet_pallas_sim_mxu4', 'einet_pallas_sim_mxu5',
    'einet_pallas_sim_mxu6', 'einet_pallas_sim_chain',
    'einet_pallas_sim_dense', 'dense_count_table', 'mxu6_conn_table', 'SNNParams', 'SurrogateSNN', 'snn_loss', 'train_step',
]
