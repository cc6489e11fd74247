# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""Multi-device parallelism over ``torch.distributed`` device meshes
(``brainevent_tpu.parallel``): the sharded EI network, its per-device
count kernel K20, and the sharded event products.

The caller starts one process per device and initialises the process
group (``torch.distributed.init_process_group``, NCCL for CUDA meshes,
gloo for CPU ones); every rank then runs the same program. The FCN float
and mat-mat wrappers of the JAX package (``sharded_fcnmv``,
``sharded_binary_fcnmm``, ``sharded_fcnmm``) wait for their
single-device ops.
"""

from .sharding import (ShardedEINet, ShardedEINetState, neuron_mesh,
                       host_chip_mesh)
from .mega import MegaScatterLayout, mega_local_counts
from .ops import (
    sharded_binary_fcnmv,
    sharded_binary_csrmv, sharded_csrmv,
    sharded_binary_csrmm, sharded_csrmm,
    CsrShardPlan, balance_csr_shards,
    sharded_jitmv,
)

__all__ = [
    'ShardedEINet', 'ShardedEINetState', 'neuron_mesh', 'host_chip_mesh',
    'MegaScatterLayout', 'mega_local_counts',
    'sharded_jitmv',
    'sharded_binary_fcnmv',
    'sharded_binary_csrmv', 'sharded_csrmv',
    'sharded_binary_csrmm', 'sharded_csrmm',
    'CsrShardPlan', 'balance_csr_shards',
]
