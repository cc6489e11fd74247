# Copyright 2026 The brainevent-tpu Authors.
#
# Licensed under the Apache License, Version 2.0 (the "License");
# you may not use this file except in compliance with the License.
# You may obtain a copy of the License at
#
#     http://www.apache.org/licenses/LICENSE-2.0
#
# Unless required by applicable law or agreed to in writing, software
# distributed under the License is distributed on an "AS IS" BASIS,
# WITHOUT WARRANTIES OR CONDITIONS OF ANY KIND, either express or implied.
# See the License for the specific language governing permissions and
# limitations under the License.
# ==============================================================================

"""One JIT-connectivity operator family per weight law
(``brainevent_tpu.jitc.family``).

:func:`make_family` returns the functional surface of a family:
``dense_fn`` (``jit*``), ``mv_fn``/``mm_fn`` (``jit*mv``/``jit*mm``),
``bmv_fn``/``bmm_fn`` (``binary_jit*``), the walk-plan products
``plan_mv_fn``/``plan_mm_fn`` (``jit*_plan``) and ``build_plan_setup``.
Signatures are the JAX package's: ``(*weight_params, prob, [operand,]
seed)``; the plan products take ``(*weight_params, clen, operand, seed,
state2, q2, cl)``.

Routes (the tensors' device picks the twin or the kernel):

- ``dense_fn``: K14 (``matrix_mode='mv'``, stride 32) or K14 at stride 4
  (``'mm'``);
- ``mv_fn``/``bmv_fn`` and the plan mat-vec: K12, gather for
  ``corder=True`` and scatter otherwise (the plan's event scatter through
  :func:`.event_route.jitc_event_matvec_plan`);
- ``mm_fn``/``bmm_fn``: K13 at stride 4 (``matrix_mode='mm'``, the
  default) or 32 (``'mv'``); the plan mat-mat: K13 at stride 32 over the
  plan.

``dense_fn`` has no tensor argument, so it takes ``device``: ``None``
means the card (``'cuda'``), unless a weight parameter is a tensor, whose
device is then used. A product runs on its operand's device. Results are
float32, or the dtype of the first weight parameter where that is a
float16 or bfloat16 tensor (the dtype the JAX package returns).

Operand dtypes (``ops/operand.py``): an event operand of any dtype
reaches the kernels as its ``> 0`` gate; a float operand of any other
dtype than float32 as float32, the dtype of the law's weights, in which
the JAX package computes too (its result takes the dtype of the first
weight parameter), so a float64 operand is rounded to float32 there as
here. A backward through a product raises
:class:`~brainevent_torch.UnsupportedOperationError`: the JVP and
transpose rules are not ported. ``count``/``fill``/``to_csr`` and
``dt2t`` are not ported either (``ROADMAP.md``).
"""

import dataclasses
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from .._error import UnsupportedOperationError
from .._misc import (_initialize_conn_length, _normalize_chunk_size,
                     _normalize_matrix_mode)
from ..ops.core import check_device
from ..ops.operand import event_spikes
from ..rng.light import M32
from .event_route import jitc_event_matvec_plan
from .pallas_kernels import (jitc_walk_mm, jitc_walk_mm4, jitc_walk_mv,
                             jitc_walk_todense, jitc_walk_todense4,
                             law_params, walk_plan_setup)

__all__ = ['JITCFamilySpec', 'make_family']


@dataclasses.dataclass(frozen=True)
class JITCFamilySpec:
    """Weight law of one family: ``law`` is the kernels' code (0 scalar,
    1 normal, 2 uniform)."""
    tag: str                       # 's' / 'n' / 'u'
    name: str                      # e.g. 'jit_normal'
    n_params: int
    law: int


def _seed(seed) -> int:
    if seed is None:
        seed = int(np.random.randint(0, 2 ** 31 - 1))
    if isinstance(seed, torch.Tensor):
        seed = seed.reshape(-1)[0].item()
    return int(np.asarray(seed).reshape(-1)[0]) & M32


def _prob(prob) -> float:
    if isinstance(prob, torch.Tensor):
        prob = prob.reshape(-1)[0].item()
    return float(prob)


def _is_static_zero(prob) -> bool:
    return _prob(prob) == 0.0


def walk_dims(shape, transpose: bool):
    """``(out_len, in_len)`` of a product over the logical *shape*."""
    if transpose:
        return shape[1], shape[0]
    return shape[0], shape[1]


def _operand(x, event: bool) -> torch.Tensor:
    """An operand as the walk kernels take it: an event operand as its
    gate, a float one as float32 (the weights' dtype)."""
    x = torch.as_tensor(x)
    if event:
        x = event_spikes(x)
    elif x.dtype not in (torch.bool, torch.float32):
        x = x.to(torch.float32)
    return x.contiguous()


def _out_dtype(params, out: torch.Tensor) -> torch.dtype:
    """The result's dtype: the first weight parameter's where that is a
    float16 or bfloat16 tensor, else the computation's."""
    p = params[0] if params else None
    if isinstance(p, torch.Tensor) and p.dtype in (torch.float16,
                                                   torch.bfloat16):
        return p.dtype
    return out.dtype


class _NoBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fn, *tensors):
        return fn()

    @staticmethod
    def backward(ctx, ct):
        raise UnsupportedOperationError(
            'JITC products have no gradient in brainevent_torch yet: their '
            'JVP and transpose rules (brainevent_tpu/jitc/family.py) are '
            'not ported; see ROADMAP.md, Queue A.')


def _guard(fn, *tensors):
    """``fn()``, with a backward that raises if a tensor needs a grad."""
    needs = [t for t in tensors
             if isinstance(t, torch.Tensor) and t.requires_grad]
    if needs and torch.is_grad_enabled():
        return _NoBackward.apply(fn, *needs)
    return fn()


def make_family(spec: JITCFamilySpec) -> SimpleNamespace:
    """The functional surface of one family; see the module docstring."""
    law, npar = spec.law, spec.n_params

    def _device(device, params):
        if device is not None:
            return check_device(device)
        for p in params:
            if isinstance(p, torch.Tensor):
                return p.device
        return check_device('cuda')

    def dense_fn(*args, shape, transpose=False, corder=True,
                 matrix_mode='mv', backend: Optional[str] = None,
                 device=None):
        """The dense matrix (``jit{t}``): ``(*weight_params, prob, seed)``;
        ``(shape[1], shape[0])`` when ``transpose``."""
        del backend
        params, prob, seed = args[:npar], args[npar], args[npar + 1]
        out_len, in_len = walk_dims(shape, transpose)
        out = torch.zeros(out_len, in_len, dtype=torch.float32,
                          device=_device(device, params))
        if _is_static_zero(prob):
            return out
        a, b = law_params(law, params)
        op = (jitc_walk_todense if _normalize_matrix_mode(matrix_mode) == 'mv'
              else jitc_walk_todense4)
        return _guard(lambda: op(out, None, None, law=law, a=a, b=b,
                                 seed=_seed(seed),
                                 cl=_initialize_conn_length(_prob(prob)),
                                 corder=bool(corder)), *params)

    def law_args(params, seed):
        """The kernels' ``(a, b, seed)`` of weight *params* and *seed*."""
        return (*law_params(law, params), _seed(seed))

    def product(params, args, clen: int, operand, *, shape, transpose,
                corder, event, stride_mm=4, setup=None):
        """The mat-vec (1-D operand) or mat-mat (2-D) over the walk of
        *shape*, with the kernels' law arguments *args* (:func:`law_args`);
        *setup* ``(state2, q2)`` is a plan of that walk."""
        x = _operand(operand, event)
        out_len, in_len = walk_dims(shape, transpose)
        if x.shape[0] != in_len:
            raise ValueError(f'operand length {x.shape[0]} != {in_len} '
                             f'(shape={tuple(shape)}, transpose={transpose})')
        n_rows, n_cols = (out_len, in_len) if corder else (in_len, out_len)
        a, b, seed = args
        state2, q2 = (None, None) if setup is None else setup
        kw = dict(law=law, a=a, b=b, seed=seed, cl=max(clen, 2),
                  n_rows=n_rows, n_cols=n_cols, logical_cols=shape[1],
                  corder=bool(corder), event=bool(event))
        if x.ndim == 1:
            if event and not corder and setup is not None:
                out = _guard(lambda: jitc_event_matvec_plan(
                    law, a, b, seed, x, out_len, n_rows=in_len,
                    logical_cols=shape[1], setup=(state2, q2, kw['cl'])),
                    operand, *params)
                return out.to(_out_dtype(params, out))
            op = jitc_walk_mv
        else:
            op = jitc_walk_mm if stride_mm == 32 else jitc_walk_mm4
        out = _guard(lambda: op(state2, q2, x, **kw), operand, *params)
        return out.to(_out_dtype(params, out))

    def _zeros(operand, shape, transpose):
        out_len, _ = walk_dims(shape, transpose)
        operand = torch.as_tensor(operand)
        o_shape = ((out_len,) if operand.ndim == 1
                   else (out_len, operand.shape[1]))
        return torch.zeros(o_shape, dtype=torch.float32,
                           device=operand.device)

    def _wrap(event: bool, is_mm: bool):
        def fn(*args, shape, transpose=False, corder=True,
               matrix_mode='mm', backend: Optional[str] = None):
            del backend
            params = args[:npar]
            prob, operand, seed = args[npar], args[npar + 1], args[npar + 2]
            if _is_static_zero(prob):
                return _zeros(operand, shape, transpose)
            stride = (32 if _normalize_matrix_mode(matrix_mode) == 'mv'
                      else 4)
            return product(params, law_args(params, seed),
                           _initialize_conn_length(_prob(prob)), operand,
                           shape=shape, transpose=transpose, corder=corder,
                           event=event, stride_mm=stride)
        kind = 'binary_' if event else ''
        fn.__name__ = f'{kind}jit{spec.tag}{"mm" if is_mm else "mv"}'
        fn.__doc__ = (
            f'{"Event" if event else "Float"} implicit {spec.name} '
            f'{"mat-mat" if is_mm else "mat-vec"}: connectivity and weights '
            f'regenerate from ``seed`` per call (K{13 if is_mm else 12}).'
            + (" ``matrix_mode`` ('mm' stride 4, 'mv' stride 32) picks the "
               'sampled matrix.' if is_mm else ''))
        return fn

    mv_fn, mm_fn = _wrap(False, False), _wrap(False, True)
    bmv_fn, bmm_fn = _wrap(True, False), _wrap(True, True)

    def _wrap_plan(is_mm: bool):
        def fn(*args, shape, transpose=False, corder=True, event=False,
               scan_rounds: Optional[int] = None,
               event_cap: Optional[int] = None,
               row_cap: Optional[int] = None,
               backend: Optional[str] = None):
            del backend, scan_rounds, event_cap, row_cap
            params = args[:npar]
            operand, seed = args[npar + 1], args[npar + 2]
            state2, q2, cl = args[npar + 3:npar + 6]
            return product(params, law_args(params, seed), int(cl), operand,
                           shape=shape, transpose=transpose, corder=corder,
                           event=event, stride_mm=32, setup=(state2, q2))
        fn.__name__ = f'jit{spec.tag}{"mm" if is_mm else "mv"}_plan'
        fn.__doc__ = (
            f'Implicit {spec.name} {"mat-mat" if is_mm else "mat-vec"} over '
            f'a walk plan (:func:`build_plan_setup`): the stride-32 mv-mode '
            f'matrix{", applied to every operand column" if is_mm else ""}.'
            f' ``scan_rounds``, ``event_cap`` and ``row_cap`` are accepted '
            f'and ignored.')
        return fn

    plan_mv_fn, plan_mm_fn = _wrap_plan(False), _wrap_plan(True)

    def build_plan_setup(prob, seed, shape, transpose=False, corder=True,
                         device=None):
        """``(clen, state2, q2, cl)`` of the walk of the plan products
        (K11 on *device*, default the card)."""
        out_len, in_len = walk_dims(shape, transpose)
        n_rows, n_cols = ((out_len, in_len) if corder
                          else (in_len, out_len))
        clen = _initialize_conn_length(_prob(prob))
        state2, q2, cl = walk_plan_setup(
            _seed(seed), clen, n_rows, n_cols,
            _normalize_chunk_size(shape[1], None),
            device=check_device(device or 'cuda'))
        return clen, state2, q2, cl

    return SimpleNamespace(
        spec=spec, dense_fn=dense_fn, mv_fn=mv_fn, mm_fn=mm_fn,
        bmv_fn=bmv_fn, bmm_fn=bmm_fn, plan_mv_fn=plan_mv_fn,
        plan_mm_fn=plan_mm_fn, build_plan_setup=build_plan_setup,
        law_args=law_args, product=product)
