# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""Just-in-time connectivity (``brainevent_tpu.jitc``): implicit matrices
whose structure and weights regenerate from a seed in every product, in
three weight laws (scalar, normal, uniform), through the walk kernels
K11-K14 (``csrc/jitc_walk.cu``)."""

from .classes import JITCModeView, JITCWalkPlan
from .normal import (
    JITCNormalMatrix, JITCNormalR, JITCNormalC, jitn, jitnmv, jitnmm,
    binary_jitnmv, binary_jitnmm, jitnmv_plan, jitnmm_plan,
)
from .pallas_kernels import (
    jitc_walk_setup, jitc_walk_mv, jitc_walk_mm, jitc_walk_mm4,
    jitc_walk_todense, jitc_walk_todense4, walk_plan_setup,
    walk_plan_setup_mm,
)
from .scalar import (
    JITCScalarMatrix, JITCScalarR, JITCScalarC, jits, jitsmv, jitsmm,
    binary_jitsmv, binary_jitsmm, jitsmv_plan, jitsmm_plan,
)
from .uniform import (
    JITCUniformMatrix, JITCUniformR, JITCUniformC, jitu, jitumv, jitumm,
    binary_jitumv, binary_jitumm, jitumv_plan, jitumm_plan,
)

__all__ = [
    'JITCModeView', 'JITCWalkPlan',
    'JITCScalarMatrix', 'JITCScalarR', 'JITCScalarC', 'jits', 'jitsmv',
    'jitsmm', 'binary_jitsmv', 'binary_jitsmm', 'jitsmv_plan', 'jitsmm_plan',
    'JITCNormalMatrix', 'JITCNormalR', 'JITCNormalC', 'jitn', 'jitnmv',
    'jitnmm', 'binary_jitnmv', 'binary_jitnmm', 'jitnmv_plan', 'jitnmm_plan',
    'JITCUniformMatrix', 'JITCUniformR', 'JITCUniformC', 'jitu', 'jitumv',
    'jitumm', 'binary_jitumv', 'binary_jitumm', 'jitumv_plan', 'jitumm_plan',
    'jitc_walk_setup', 'jitc_walk_mv', 'jitc_walk_mm', 'jitc_walk_mm4',
    'jitc_walk_todense', 'jitc_walk_todense4', 'walk_plan_setup',
    'walk_plan_setup_mm',
]
