# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""The uniform JITC family (``brainevent_tpu.jitc.uniform``): per-edge ``w_low
+ u * (w_high - w_low)``, ``u`` the light-RNG uniform."""

from .classes import make_classes
from .family import JITCFamilySpec, make_family

__all__ = [
    'JITCUniformMatrix', 'JITCUniformR', 'JITCUniformC', 'jitu', 'jitumv',
    'jitumm', 'binary_jitumv', 'binary_jitumm', 'jitumv_plan',
    'jitumm_plan',
]

_family = make_family(JITCFamilySpec(
    tag='u', name='jit_uniform', n_params=2, law=2))

jitu = _family.dense_fn
jitumv = _family.mv_fn
jitumm = _family.mm_fn
binary_jitumv = _family.bmv_fn
binary_jitumm = _family.bmm_fn
jitumv_plan = _family.plan_mv_fn
jitumm_plan = _family.plan_mm_fn

JITCUniformMatrix, JITCUniformR, JITCUniformC = make_classes(
    _family, 'JITCUniform', ('wlow', 'whigh'),
)
