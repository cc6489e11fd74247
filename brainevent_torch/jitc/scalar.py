# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""The scalar JITC family (``brainevent_tpu.jitc.scalar``): one weight ``w``
on every edge."""

from .classes import make_classes
from .family import JITCFamilySpec, make_family

__all__ = [
    'JITCScalarMatrix', 'JITCScalarR', 'JITCScalarC', 'jits', 'jitsmv',
    'jitsmm', 'binary_jitsmv', 'binary_jitsmm', 'jitsmv_plan',
    'jitsmm_plan',
]

_family = make_family(JITCFamilySpec(
    tag='s', name='jit_scalar', n_params=1, law=0))

jits = _family.dense_fn
jitsmv = _family.mv_fn
jitsmm = _family.mm_fn
binary_jitsmv = _family.bmv_fn
binary_jitsmm = _family.bmm_fn
jitsmv_plan = _family.plan_mv_fn
jitsmm_plan = _family.plan_mm_fn

JITCScalarMatrix, JITCScalarR, JITCScalarC = make_classes(
    _family, 'JITCScalar', ('weight',),
)
