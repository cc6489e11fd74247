# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""Op registry, the CUDA build, the event scatter ops, the gather plans,
the pair product and the entries' spans (:mod:`.tracing`)."""

from .core import KernelOp, launch_counts, reset_launch_counts
from .scatter import event_scatter_add, event_scatter_add_multi
from .mxu_gather import (
    GatherPlan, build_gather_plan, plan_from_csr, plan_from_ell,
    gather_matvec, gather_matvec_xla, plan_matvec_dw, matvec_dw_xla,
    plan_inverse_perm, plan_aux, plan_matvec_vjp, build_mm_plan,
    gather_matmat, gather_matmat_xla, plan_matmat_vjp,
)
from .pair_gather import pair_gather_product
from . import tracing

__all__ = ['KernelOp', 'launch_counts', 'reset_launch_counts',
           'event_scatter_add', 'event_scatter_add_multi', 'GatherPlan',
           'build_gather_plan', 'plan_from_csr', 'plan_from_ell',
           'gather_matvec', 'gather_matvec_xla', 'plan_matvec_dw',
           'matvec_dw_xla', 'plan_inverse_perm', 'plan_aux',
           'plan_matvec_vjp', 'build_mm_plan', 'gather_matmat',
           'gather_matmat_xla', 'plan_matmat_vjp', 'pair_gather_product',
           'tracing']
