# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""The normal JITC family (``brainevent_tpu.jitc.normal``): per-edge ``w_loc +
z * w_scale``, ``z`` the light-RNG normal variate."""

from .classes import make_classes
from .family import JITCFamilySpec, make_family

__all__ = [
    'JITCNormalMatrix', 'JITCNormalR', 'JITCNormalC', 'jitn', 'jitnmv',
    'jitnmm', 'binary_jitnmv', 'binary_jitnmm', 'jitnmv_plan',
    'jitnmm_plan',
]

_family = make_family(JITCFamilySpec(
    tag='n', name='jit_normal', n_params=2, law=1))

jitn = _family.dense_fn
jitnmv = _family.mv_fn
jitnmm = _family.mm_fn
binary_jitnmv = _family.bmv_fn
binary_jitnmm = _family.bmm_fn
jitnmv_plan = _family.plan_mv_fn
jitnmm_plan = _family.plan_mm_fn

JITCNormalMatrix, JITCNormalR, JITCNormalC = make_classes(
    _family, 'JITCNormal', ('wloc', 'wscale'),
    # adding a scalar shifts the location only
    lift_add=lambda params, s: (params[0] + s, params[1]),
)
