# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""Sharded event-driven operators over a device mesh
(``brainevent_tpu.parallel.ops``), over ``torch.distributed``.

Every rank runs the same call on the same global arguments, cuts its own
rows of the synapse table (aligned with the spike vector in the scatter
direction), computes its partial with the port's single-device entry (so
the card runs K5-K10 and K12, and autograd applies per shard), and reduces
with one collective:

- gather direction (``transpose=False``): the output rows are the shards;
  the ELL and JITC ops need no communication and return a ``DTensor``
  sharded over the rows. The CSR ops balance rows by nonzeros, so their
  row blocks are not the even blocks a ``DTensor`` shards into: they
  all-gather the blocks and return the rows replicated, as the JAX
  package's ``plan.unpad_rows`` of a sharded array gathers them;
- scatter direction (``transpose=True``): full-length partials, reduced
  with ``reduce='psum'`` (``all_reduce``, a replicated ``DTensor``) or
  ``reduce='psum_scatter'`` (``reduce_scatter_tensor``, a ``DTensor``
  sharded along the mesh axis; the output length must divide by the mesh
  size).

Sizes need not divide: ELL rows pad with inert rows, and CSR structures
are split into row-aligned shards of equal padded size by
:func:`balance_csr_shards` (host numpy; its dummy entries sit in padded
empty rows, inert in both directions). ``axis`` names a mesh dimension,
or a tuple of them to shard over several (``('hosts', 'chips')``).
Gradients flow through the collectives (:mod:`._comm`): a global input's
gradient is summed over the ranks. ``backend=`` is accepted, as the
single-device ops accept it.

The FCN float and mat-mat wrappers (``sharded_fcnmv``,
``sharded_binary_fcnmm``, ``sharded_fcnmm``) wait for their single-device
ops (``fcn/float.py``, ``binary_fcnmm``), which are not ported yet.
"""

import dataclasses
from typing import Optional

import numpy as np
import torch

from .._misc import _initialize_conn_length
from ..jitc.engine import cdiv
from . import _comm

__all__ = [
    'sharded_binary_fcnmv',
    'sharded_binary_csrmv', 'sharded_csrmv',
    'sharded_binary_csrmm', 'sharded_csrmm',
    'CsrShardPlan', 'balance_csr_shards',
    'sharded_jitmv',
]


def _reduce(partial_out, axis: _comm.Axis, reduce: str):
    if reduce == 'psum':
        return _comm.replicate(_comm.psum(partial_out, axis), axis)
    if reduce == 'psum_scatter':
        return _comm.sharded(_comm.psum_scatter(partial_out, axis), axis,
                             partial_out.shape[0])
    raise ValueError(f"reduce must be 'psum' or 'psum_scatter', got "
                     f"{reduce!r}")


def _concrete(x, what):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    try:
        return np.asarray(x)
    except Exception:
        raise ValueError(
            f'{what} must be concrete to build the shard plan; build the '
            f'plan once (balance_csr_shards) and pass it as plan=.') from None


def _check_reduce(reduce, out_len, n_dev, transpose):
    if not transpose:
        return 'none'
    if reduce == 'psum_scatter' and out_len % n_dev:
        raise ValueError(
            f'psum_scatter needs the output length ({out_len}) divisible by '
            f'the mesh size ({n_dev}); use reduce="psum" or pad the '
            f'postsynaptic axis.')
    return reduce


def _pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """*x* with zero (false) rows appended up to *rows*
    (differentiable)."""
    pad = rows - x.shape[0]
    if pad <= 0:
        return x
    return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])


# =============================================================================
# FCN (ELL) family
# =============================================================================

def _sharded_fcn(p_call, weights, indices, operand, *, mesh, shape,
                 transpose, axis, reduce, backend):
    ax = _comm.mesh_axis(mesh, axis)
    n_pre, n_post = shape
    indices = _comm.global_tensor(indices)
    device = indices.device
    weights = torch.atleast_1d(_comm.global_tensor(weights, device))
    operand = _comm.global_tensor(operand, device)
    homo = weights.dim() == 1 and weights.shape[0] == 1
    rows_loc = cdiv(n_pre, ax.size)
    lo = min(ax.index * rows_loc, n_pre)
    hi = min(lo + rows_loc, n_pre)
    reduce = _check_reduce(reduce, n_post, ax.size, transpose)

    weights = _comm.replicated(weights, ax)
    operand = _comm.replicated(operand, ax)
    idx_loc = _pad_rows(indices[lo:hi], rows_loc)
    w_loc = weights if homo else _pad_rows(weights[lo:hi], rows_loc)
    op_loc = _pad_rows(operand[lo:hi], rows_loc) if transpose else operand
    (out,) = p_call(w_loc, idx_loc, op_loc, shape=(rows_loc, n_post),
                    transpose=transpose, backend=backend)
    if reduce == 'none':
        return _comm.sharded(out[:hi - lo], ax, n_pre)
    return _reduce(out, ax, reduce)


def sharded_binary_fcnmv(weights, indices, spikes, *, mesh, shape,
                         transpose: bool = True, axis=None,
                         reduce: str = 'psum', backend: Optional[str] = None):
    """Multi-device event ELL product through ``binary_fcnmv``.

    ``transpose=True`` (default, the scatter direction ``y = W.T @ s``)
    shards the rows and the spikes and reduces with one collective;
    ``transpose=False`` (gather, ``y = W @ gate(s)``) takes the spike
    vector whole and needs no communication. Row counts that do not divide
    by the mesh pad with inert rows. A backward raises, as through the
    single-device ``binary_fcnmv`` (its float ELL products are not ported
    yet).
    """
    from ..fcn.binary import binary_fcnmv_p_call
    return _sharded_fcn(binary_fcnmv_p_call, weights, indices, spikes,
                        mesh=mesh, shape=shape, transpose=transpose,
                        axis=axis, reduce=reduce, backend=backend)


# =============================================================================
# CSR family
# =============================================================================

@dataclasses.dataclass(frozen=True)
class CsrShardPlan:
    """A row-aligned, equal-``nse`` split of a CSR structure, in host
    numpy (:func:`balance_csr_shards`).

    - ``indices_pad`` ``(n_dev * nse_loc,)`` and ``counts_pad``
      ``(n_dev * rows_loc,)``: the padded structure, shard-major. Dummy
      entries point at column 0 and sit in padded empty rows, so they add
      exactly zero in both product directions.
    - ``row_pos`` maps an original row to its padded position (operand
      scatter, output gather); ``nse_pos`` an original nonzero to its
      padded position (heterogeneous weights).
    """
    n_dev: int
    shape: tuple
    rows_loc: int
    nse_loc: int
    indices_pad: np.ndarray
    counts_pad: np.ndarray
    row_pos: np.ndarray
    nse_pos: np.ndarray

    def pad_weights(self, weights):
        """Weights in padded order (differentiable); a ``(1,)`` weight as
        it is."""
        weights = torch.atleast_1d(torch.as_tensor(weights))
        if weights.shape[0] == 1:
            return weights
        pos = torch.from_numpy(self.nse_pos).to(weights.device)
        out = weights.new_zeros(self.n_dev * self.nse_loc)
        return out.index_copy(0, pos, weights)

    def pad_rows(self, x, fill=0):
        """A row-aligned operand (1-D or 2-D) in padded order
        (differentiable)."""
        x = torch.as_tensor(x)
        pos = torch.from_numpy(self.row_pos).to(x.device)
        shp = (self.n_dev * self.rows_loc,) + tuple(x.shape[1:])
        out = torch.full(shp, fill, dtype=x.dtype, device=x.device)
        return out.index_copy(0, pos, x)

    def unpad_rows(self, y):
        """The original rows of a padded output."""
        return y[torch.from_numpy(self.row_pos).to(y.device)]


def balance_csr_shards(indices, indptr, n_dev: int,
                       shape=None) -> CsrShardPlan:
    """Split a CSR structure into ``n_dev`` row-aligned shards of equal
    padded size, balancing the nonzeros across shards.

    Row boundaries are chosen so each shard carries about ``nse / n_dev``
    nonzeros; the shards then pad to the common ``rows_loc``/``nse_loc``
    with empty rows that take the dummy entries. Host numpy, as in the JAX
    package.
    """
    indices = _concrete(indices, 'indices')
    indptr = _concrete(indptr, 'indptr')
    counts = np.diff(indptr).astype(np.int64)
    m = counts.shape[0]
    nse = int(indices.shape[0])
    if shape is None:
        shape = (m, int(indices.max()) + 1 if nse else 1)
    if n_dev <= 0:
        raise ValueError(f'n_dev must be positive, got {n_dev}')
    # contiguous row ranges with ~equal nnz: boundary b_s = first row whose
    # cumulative nnz reaches s * nse / n_dev
    cum = np.concatenate([[0], np.cumsum(counts)])
    targets = (np.arange(1, n_dev) * nse) / n_dev
    bounds = np.concatenate([[0], np.searchsorted(cum[1:], targets,
                                                  side='left') + 1, [m]])
    bounds = np.clip(bounds, 0, m)
    row_cnt = np.diff(bounds)
    nse_cnt = cum[bounds[1:]] - cum[bounds[:-1]]
    rows_loc = int(row_cnt.max()) + 1          # +1 padding row per shard
    nse_loc = int(nse_cnt.max())
    indices_pad = np.zeros((n_dev, nse_loc), dtype=indices.dtype)
    counts_pad = np.zeros((n_dev, rows_loc), dtype=np.int32)
    row_pos = np.empty(m, dtype=np.int64)
    nse_pos = np.empty(nse, dtype=np.int64)
    for s in range(n_dev):
        r0, r1 = int(bounds[s]), int(bounds[s + 1])
        e0, e1 = int(cum[r0]), int(cum[r1])
        k = e1 - e0
        indices_pad[s, :k] = indices[e0:e1]
        counts_pad[s, :r1 - r0] = counts[r0:r1]
        counts_pad[s, r1 - r0] = nse_loc - k      # dummy entries -> pad row
        row_pos[r0:r1] = s * rows_loc + np.arange(r1 - r0)
        nse_pos[e0:e1] = s * nse_loc + np.arange(k)
    return CsrShardPlan(
        n_dev=n_dev, shape=tuple(shape), rows_loc=rows_loc, nse_loc=nse_loc,
        indices_pad=indices_pad.reshape(-1),
        counts_pad=counts_pad.reshape(-1), row_pos=row_pos, nse_pos=nse_pos)


def _sharded_csr(p_call, weights, indices, indptr, operand, *, mesh, shape,
                 transpose, axis, reduce, backend, plan):
    ax = _comm.mesh_axis(mesh, axis)
    m, k = shape
    if plan is None:
        plan = balance_csr_shards(indices, indptr, ax.size, shape=shape)
    if plan.n_dev != ax.size or plan.shape != tuple(shape):
        raise ValueError(
            f'plan was built for n_dev={plan.n_dev}, shape={plan.shape}; '
            f'this call uses n_dev={ax.size}, shape={tuple(shape)}.')
    device = torch.as_tensor(indices).device
    weights = torch.atleast_1d(_comm.global_tensor(weights, device))
    operand = _comm.global_tensor(operand, device)
    homo = weights.shape[0] == 1
    rows_loc, nse_loc = plan.rows_loc, plan.nse_loc
    reduce = _check_reduce(reduce, k, ax.size, transpose)

    weights = _comm.replicated(weights, ax)
    operand = _comm.replicated(operand, ax)
    e0, r0 = ax.index * nse_loc, ax.index * rows_loc
    w_loc = weights if homo else plan.pad_weights(weights)[e0:e0 + nse_loc]
    idx_loc = torch.from_numpy(plan.indices_pad[e0:e0 + nse_loc]).to(device)
    cnt = torch.from_numpy(plan.counts_pad[r0:r0 + rows_loc]).to(device)
    indptr_loc = torch.cat([cnt.new_zeros(1), torch.cumsum(cnt, 0)]).to(
        idx_loc.dtype)
    op_loc = (plan.pad_rows(operand)[r0:r0 + rows_loc] if transpose
              else operand)
    (out,) = p_call(w_loc, idx_loc, indptr_loc, op_loc, shape=(rows_loc, k),
                    transpose=transpose, backend=backend)
    if reduce == 'none':
        return _comm.replicate(plan.unpad_rows(_comm.all_gather(out, ax)),
                               ax)
    return _reduce(out, ax, reduce)


def sharded_binary_csrmv(weights, indices, indptr, spikes, *, mesh, shape,
                         transpose: bool = True, axis=None,
                         reduce: str = 'psum', backend: Optional[str] = None,
                         plan: Optional[CsrShardPlan] = None):
    """Multi-device event CSR product through ``binary_csrmv``.

    Rows (and the spike vector in the scatter direction) are split over
    *mesh* after :func:`balance_csr_shards` equalises the nonzeros per
    shard; any structure works. Pass a prebuilt ``plan`` to skip the
    host-side split on every call.
    """
    from ..csr.binary import binary_csrmv_p_call
    return _sharded_csr(binary_csrmv_p_call, weights, indices, indptr,
                        spikes, mesh=mesh, shape=shape, transpose=transpose,
                        axis=axis, reduce=reduce, backend=backend, plan=plan)


def sharded_csrmv(weights, indices, indptr, v, *, mesh, shape,
                  transpose: bool = True, axis=None, reduce: str = 'psum',
                  backend: Optional[str] = None,
                  plan: Optional[CsrShardPlan] = None):
    """Multi-device float CSR product through ``csrmv``."""
    from ..csr.float import csrmv_p_call
    return _sharded_csr(csrmv_p_call, weights, indices, indptr, v,
                        mesh=mesh, shape=shape, transpose=transpose,
                        axis=axis, reduce=reduce, backend=backend, plan=plan)


def sharded_binary_csrmm(weights, indices, indptr, S, *, mesh, shape,
                         transpose: bool = True, axis=None,
                         reduce: str = 'psum', backend: Optional[str] = None,
                         plan: Optional[CsrShardPlan] = None):
    """Multi-device event CSR mat-mat through ``binary_csrmm``."""
    from ..csr.binary import binary_csrmm_p_call
    return _sharded_csr(binary_csrmm_p_call, weights, indices, indptr, S,
                        mesh=mesh, shape=shape, transpose=transpose,
                        axis=axis, reduce=reduce, backend=backend, plan=plan)


def sharded_csrmm(weights, indices, indptr, B, *, mesh, shape,
                  transpose: bool = True, axis=None, reduce: str = 'psum',
                  backend: Optional[str] = None,
                  plan: Optional[CsrShardPlan] = None):
    """Multi-device float CSR mat-mat through ``csrmm``."""
    from ..csr.float import csrmm_p_call
    return _sharded_csr(csrmm_p_call, weights, indices, indptr, B,
                        mesh=mesh, shape=shape, transpose=transpose,
                        axis=axis, reduce=reduce, backend=backend, plan=plan)


# =============================================================================
# JITC (implicit connectivity): the walk rows split over the mesh; each
# shard walks its GLOBAL row range (K11/K12's row0), so the sampled matrix
# does not depend on the split.
# =============================================================================

_JITC_LAWS = {'s': (0, 1), 'n': (1, 2), 'u': (2, 2)}


def sharded_jitmv(law: str, params, prob, v, seed, *, mesh, shape,
                  corder: bool = True, axis=None, event: bool = False,
                  transpose: bool = False):
    """Multi-device implicit mat-vec (families ``'s'``/``'n'``/``'u'``),
    through K12 with ``row0``.

    ``corder=True``: the output rows shard and ``v`` is taken whole; no
    collective, a ``DTensor`` sharded over the rows. ``corder=False``
    (scatter direction): the input rows shard; each shard scatters into a
    full-length output and one ``psum`` combines them. The streams are
    keyed on global row ids, so the sampled matrix is the single-device
    ``jitnmv``'s (etc.): the gather is bitwise, the scatter's float sums
    associate otherwise across shards.

    ``transpose=True`` computes ``M.T @ v`` of the same sampled ``M`` of
    ``shape`` (the weight hash keys on the original orientation,
    ``logical_cols = shape[1]``), as the single-device ``transpose`` flag.
    """
    from ..jitc.family import _operand, _prob, _seed
    from ..jitc.pallas_kernels import jitc_walk_mv, law_params

    ax = _comm.mesh_axis(mesh, axis)
    code, npar = _JITC_LAWS[law]
    if len(params) != npar:
        raise ValueError(f"law {law!r} takes {npar} weight parameters, got "
                         f"{len(params)}")
    a, b = law_params(code, params)
    x = _operand(v, event)
    out_len, in_len = ((shape[1], shape[0]) if transpose
                       else (shape[0], shape[1]))
    walk_rows = out_len if corder else in_len
    local = cdiv(walk_rows, ax.size)
    row0 = ax.index * local
    kw = dict(law=code, a=a, b=b, seed=_seed(seed),
              cl=max(_initialize_conn_length(_prob(prob)), 2),
              logical_cols=shape[1], corder=corder, event=event, row0=row0)
    if corder:
        out = jitc_walk_mv(None, None, x, n_rows=local, n_cols=in_len, **kw)
        valid = max(0, min(local, out_len - row0))
        return _comm.sharded(out[:valid], ax, out_len)
    x_loc = _pad_rows(x[row0:row0 + local], local)
    out = jitc_walk_mv(None, None, x_loc.contiguous(), n_rows=local,
                       n_cols=out_len, **kw)
    return _comm.replicate(_comm.psum(out, ax), ax)
