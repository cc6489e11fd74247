# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""Mesh axes and the collectives of the sharded layer, over
``torch.distributed``.

The JAX package shards with ``shard_map`` over named mesh axes and reduces
with ``psum`` and ``psum_scatter``. Here every rank runs the same Python
on the same global arguments (SPMD) and computes its own shard:

- :func:`mesh_axis` turns a mesh and an axis name (or a tuple of names,
  taken together in the mesh's order) into a 1-D :class:`Axis`: its mesh,
  its process group, its size and this rank's index along it;
- :func:`psum` (``all_reduce``), :func:`psum_scatter`
  (``reduce_scatter_tensor``) and :func:`all_gather`
  (``all_gather_into_tensor``) are differentiable: a replicated output's
  cotangent is the same on every rank, so ``psum``'s backward is the
  identity, ``psum_scatter``'s an all-gather and ``all_gather``'s this
  rank's slice; :func:`replicated` marks a global input that every rank
  holds (its gradient is the sum of the ranks' gradients, an
  ``all_reduce`` in the backward), as ``shard_map`` transposes a ``P()``
  input;
- :func:`sharded` and :func:`replicate` wrap a rank's result as a
  ``DTensor`` (``Shard(0)`` or ``Replicate()``), at the API boundary only.

The collectives are looked up on ``torch.distributed`` at each call, under
names that PyTorch 2.11 and 2.13 both have, so that a caller can count
them by wrapping those names.
"""

from typing import NamedTuple, Optional, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

__all__ = ['Axis', 'mesh_axis', 'psum', 'psum_scatter', 'all_gather',
           'replicated', 'sharded', 'replicate', 'global_tensor']

# 1-D meshes over several axes of a mesh, made once: (mesh, names) -> mesh
_FLAT = {}


class Axis(NamedTuple):
    """One (possibly flattened) mesh axis: a 1-D mesh over it, its process
    group, its size, and this rank's index along it."""
    mesh: DeviceMesh
    group: object
    size: int
    index: int


def _names(mesh: DeviceMesh, axis) -> Tuple[str, ...]:
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError('the mesh needs named dimensions (mesh_dim_names)')
    if axis is None:
        return (names[0],)
    axis = tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)
    for a in axis:
        if a not in names:
            raise ValueError(f'axis {a!r} is not a dimension of the mesh '
                             f'{names}')
    return axis


def mesh_axis(mesh: DeviceMesh, axis: Union[str, Tuple[str, ...], None] = None
              ) -> Axis:
    """The 1-D :class:`Axis` of *axis* (default the mesh's first
    dimension). A tuple of names shards over those dimensions together,
    the first outermost, as ``P(('hosts', 'chips'))`` does; it must name
    all of the mesh's dimensions in their order."""
    names = _names(mesh, axis)
    if len(names) == 1:
        sub = mesh if mesh.ndim == 1 else mesh[names[0]]
    else:
        if names != tuple(mesh.mesh_dim_names):
            raise ValueError(
                f'several axes shard together only as all of the mesh\'s '
                f'dimensions in order {tuple(mesh.mesh_dim_names)}, got '
                f'{names}')
        key = (id(mesh), names)
        if key not in _FLAT:
            flat = DeviceMesh(mesh.device_type, mesh.mesh.flatten(),
                              mesh_dim_names=('_'.join(names),))
            _FLAT[key] = (mesh, flat)
        sub = _FLAT[key][1]
    return Axis(mesh=sub, group=sub.get_group(), size=sub.size(),
                index=sub.get_local_rank())


# -- collectives, differentiable ---------------------------------------------------

class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, ct):
        return ct, None


class _PSumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size):
        ctx.group, ctx.size = group, size
        out = x.new_empty((x.shape[0] // size,) + tuple(x.shape[1:]))
        dist.reduce_scatter_tensor(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, ct):
        full = ct.new_empty((ct.shape[0] * ctx.size,) + tuple(ct.shape[1:]))
        dist.all_gather_into_tensor(full, ct.contiguous(), group=ctx.group)
        return full, None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, index):
        ctx.n, ctx.index = x.shape[0], index
        full = x.new_empty((x.shape[0] * size,) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(full, x.contiguous(), group=group)
        return full

    @staticmethod
    def backward(ctx, ct):
        lo = ctx.index * ctx.n
        return ct[lo:lo + ctx.n], None, None, None


class _Replicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        ct = ct.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(ct, group=ctx.group)
        return ct, None


def psum(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The sum of every rank's *x*, on every rank (``all_reduce``)."""
    return _PSum.apply(x, axis.group)


def psum_scatter(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The sum of every rank's *x*, this rank's block of ``len(x) /
    axis.size`` rows (``reduce_scatter_tensor``)."""
    return _PSumScatter.apply(x, axis.group, axis.size)


def all_gather(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Every rank's *x*, stacked along the rows in rank order."""
    return _AllGather.apply(x, axis.group, axis.size, axis.index)


def replicated(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """*x*, a global input that every rank holds; in the backward its
    gradient is summed over the ranks. A tensor that needs no gradient is
    returned as it is."""
    if isinstance(x, torch.Tensor) and x.requires_grad:
        return _Replicated.apply(x, axis.group)
    return x


# -- DTensor at the boundary ---------------------------------------------------------

def sharded(local: torch.Tensor, axis: Axis, length: int) -> DTensor:
    """This rank's rows of a ``(length, ...)`` tensor sharded over *axis*
    (``Shard(0)``; the blocks of ``ceil(length / axis.size)`` rows that
    ``torch.chunk`` cuts, the last ones shorter or empty)."""
    shape = torch.Size((int(length),) + tuple(local.shape[1:]))
    return DTensor.from_local(local, axis.mesh, [Shard(0)], run_check=False,
                              shape=shape,
                              stride=torch.empty(shape, device='meta').stride())


def replicate(local: torch.Tensor, axis: Axis) -> DTensor:
    """A tensor that every rank holds whole (``Replicate()``)."""
    return DTensor.from_local(local, axis.mesh, [Replicate()],
                              run_check=False)


def global_tensor(x, device: Optional[torch.device] = None) -> torch.Tensor:
    """*x* as a plain global tensor: a ``DTensor`` gathered whole, anything
    else through ``torch.as_tensor``."""
    if isinstance(x, DTensor):
        x = x.full_tensor()
    return torch.as_tensor(x, device=device)
