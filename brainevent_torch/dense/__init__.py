# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""The dense weight matrix and its event products (``brainevent_tpu.dense``):
``Dense``, ``binary_densemv``/``binary_densemm`` (K15 ``dense_event_mv``,
K16 ``dense_event_mm``) and the dense STDP updates (K17
``dense_stdp_pre``/``dense_stdp_post``)."""

from .binary import (binary_densemm, binary_densemm_p_call, binary_densemv,
                     binary_densemv_p_call)
from .main import Dense
from .pallas_kernels import (dense_event_mm, dense_event_mv, dense_stdp_post,
                             dense_stdp_pre)
from .plasticity import update_dense_on_binary_post, update_dense_on_binary_pre

__all__ = [
    'Dense',
    'binary_densemv', 'binary_densemv_p_call', 'binary_densemm',
    'binary_densemm_p_call',
    'update_dense_on_binary_pre', 'update_dense_on_binary_post',
    'dense_event_mv', 'dense_event_mm', 'dense_stdp_pre', 'dense_stdp_post',
]
