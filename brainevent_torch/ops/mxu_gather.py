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

"""Gather plans: float sparse products over a fixed sparsity structure.

Counterpart of ``brainevent_tpu.ops.mxu_gather``. There
is no MXU here; the module keeps the JAX name so that each function is easy
to find beside its original.

A :class:`GatherPlan` is the JAX package's layout, bit for bit: the
structure's ``nse`` entries sorted by (row block, column window), cut into
chunks of ``chunk`` slots, with each slot's (window-local column block,
lane, block-local row) packed into one int32 of ``meta``; ``perm`` maps a
slot back to its flat entry (``-1`` at padding). That order is the
interface the two packages share: weights go in through
:meth:`GatherPlan.sort_data` and weight gradients come out in plan order.

On a GPU each output is read in the order it wants. At build time, in
numpy, each plan also gets a row index: ``row_ptr (M+1,)`` and
``row_slots (nse,)``, the plan slots of row ``r`` in increasing slot order
at ``row_slots[row_ptr[r]:row_ptr[r+1]]``, ``row_cols (nse,)``, their
columns, and ``row_src (nse,)``, their flat-nse entries; and ``n_valid
(n_chunks,)``, each chunk's valid slots, which are a prefix of the chunk
(the build fills a chunk's slots in turn; padding chunks are whole). The
two matvec kernels (``csrc/plan_gather.cu``) give each row one warp, which
walks the row's entries and sums in a fixed order (lane-strided partial
sums, then a fixed shuffle tree). No float atomics: the same inputs give
bitwise-equal outputs on every run.

- K3 :data:`plan_gather_mv` (:func:`gather_matvec`):
  ``y[r] = sum_{slots e of row r} w_sorted[e] * x[col_e]``, over the row
  index alone (``row_ptr``, ``row_cols``) with the weights in row order
  (:meth:`GatherPlan.sort_rows`, :meth:`GatherPlan.rows_of`): K7's float
  row gather, 8 coalesced bytes a slot;
- K4 :data:`plan_matvec_dw_op` (:func:`plan_matvec_dw`): K3's ``y`` plus
  ``dw[e] = s[row_e] * x[col_e]`` for every valid slot (0 at padding), in
  one call: the surrogate-training backward. ``y`` is K3's row gather over
  the weights in row order (a view the caller may pass, else one gather);
  ``dw`` is one pass over the plan in plan order, which decodes each
  slot's row and column from ``meta``, ``rb`` and ``b0``;
- K10 :data:`csr_gather_mm` (``csrc/csr_gather_mm.cu``, :func:`gather_matmat`):
  ``Y[r, :] = sum_j w[slot(j)] * op(X[col_j, :])`` over any CSR-like row
  index with an optional slot permutation: a plan's (``row_ptr``,
  ``row_cols``, ``row_slots``), or a CSR matrix's own arrays
  (``csr/float.py:csrmm``, ``csr/binary.py:binary_csrmm``). A row takes
  4 lanes up to ``B = 16`` and a whole warp above, each lane 4 columns of
  ``Y`` (two such pieces in a warp) read as 16-byte pieces where they are
  aligned, so each read of an ``X`` row is coalesced; the row's entries
  are added in stored order.

Each has a plain PyTorch twin (:func:`gather_matvec_rows`,
:func:`matvec_dw_xla`, :func:`csr_gather_mm_twin`) that gathers and sums
with ``index_add_``; it runs for CPU tensors. K10 is also held bitwise
against :func:`csr_gather_mm_ordered`, its sum in stored order. :func:`gather_matvec_xla`,
the JAX package's oracle over the plan order, stays beside them. The JAX
functions' TPU keywords ``passes`` (the bf16 split depth) and
``force_xla`` (a VMEM guard) are accepted and ignored: float32 on the card
needs no split, and nothing on the card routes a CUDA tensor to the twin.
"""

import ctypes
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .. import _misc
from . import cuda_build
from .core import KernelOp, check_cuda_tensors, cuda_stream
from .operand import acc_dtype, fits, is_double, op_code, op_values, take

__all__ = [
    'GatherPlan', 'build_gather_plan', 'plan_from_csr', 'plan_from_ell',
    'gather_matvec', 'gather_matvec_xla', 'gather_matvec_rows',
    'plan_matvec_dw', 'matvec_dw_xla',
    'plan_inverse_perm', 'plan_aux', 'plan_matvec_vjp', 'plan_matvec_rows',
    'plan_gather_mv',
    'plan_matvec_dw_op', 'build_mm_plan', 'gather_matmat_xla',
    'gather_matmat', 'plan_matmat_vjp', 'csr_gather_mm',
    'csr_gather_mm_twin', 'csr_gather_mm_ordered',
]

_LANES = 128

# packed metadata bit layout (brainevent_tpu/ops/mxu_gather.py:77-80)
_COL_BITS = 7      # lane within the 128-column block
_ROW_BITS = 10     # block-local row  -> row_block <= 1024
_BLK_BITS = 8      # window-local column block -> win_blocks <= 256

# the JAX plan pads every row block's chunk run to a multiple of this
_CPB = 8

_SOURCE = 'brainevent_torch/csrc/plan_gather.cu'


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass
class GatherPlan:
    """Static blocked layout of one sparsity structure.

    Tensors: ``meta (n_chunks, C) int32`` packed per-slot metadata, ``b0
    (n_chunks,)`` window starts (in 128-column blocks), ``rb (n_chunks,)``
    row-block ids (non-decreasing), ``perm (n_chunks, C) int32`` flat-nse
    source index (-1 = padding), and the row index the kernels walk:
    ``row_ptr (M+1,)``, ``row_slots (nse,)``, and for each listed slot its
    column, ``row_cols (nse,)``, and its flat-nse entry, ``row_src
    (nse,)``; ``n_valid (n_chunks,)``: the valid slots of each chunk, its
    first ``n_valid`` slots. The other fields are static.
    """
    meta: torch.Tensor
    b0: torch.Tensor
    rb: torch.Tensor
    perm: torch.Tensor
    row_ptr: torch.Tensor
    row_slots: torch.Tensor
    row_cols: torch.Tensor
    row_src: torch.Tensor
    n_valid: torch.Tensor
    shape: Tuple[int, int]
    nse: int
    chunk: int
    row_block: int
    win_blocks: int
    n_rb: int
    nbp: int              # padded number of 128-column blocks

    _TENSORS = ('meta', 'b0', 'rb', 'perm', 'row_ptr', 'row_slots',
                'row_cols', 'row_src', 'n_valid')

    @property
    def n_chunks(self) -> int:
        return self.meta.shape[0]

    def to(self, device) -> 'GatherPlan':
        """The same plan with its tensors on *device*."""
        return dataclasses.replace(
            self, **{k: getattr(self, k).to(device) for k in self._TENSORS})

    def sort_data(self, data: torch.Tensor) -> torch.Tensor:
        """Permute flat nse ``data`` into plan order: ``(n_chunks, C)``
        float32, zero at padding slots. Homogeneous ``data`` of shape
        ``(1,)`` broadcasts without a gather."""
        valid = self.perm >= 0
        zero = torch.zeros((), dtype=torch.float32, device=self.perm.device)
        if tuple(data.shape) == (1,):
            return torch.where(valid, data[0].to(torch.float32), zero)
        flat = data.reshape(-1).to(torch.float32)
        if flat.shape[0] == 0:
            return torch.zeros(self.perm.shape, dtype=torch.float32,
                               device=self.perm.device)
        return torch.where(valid, flat[self.perm.clamp(min=0).long()], zero)

    def sort_rows(self, data: torch.Tensor) -> torch.Tensor:
        """Flat nse ``data`` in row order, ``(nse,)`` float32, in one
        gather: what K3 reads, and ``rows_of(sort_data(data))``.
        Homogeneous ``data`` of shape ``(1,)`` broadcasts."""
        flat = data.reshape(-1).to(torch.float32)
        if tuple(data.shape) == (1,):
            return flat.expand(self.nse).contiguous()
        return torch.index_select(flat, 0, self.row_src)

    def rows_of(self, w_sorted: torch.Tensor) -> torch.Tensor:
        """Plan-order ``w_sorted`` (``(n_chunks, C)``) in row order,
        ``(nse,)``: one gather by ``row_slots``."""
        return torch.index_select(w_sorted.reshape(-1), 0, self.row_slots)


def _row_index(meta, b0, rb, perm, row_block: int, n_rows: int):
    """``row_ptr``, ``row_slots``, ``row_cols``, ``row_src``: the valid
    slots of each row, in increasing slot order, their columns and their
    flat-nse entries (numpy, at build time)."""
    flat_perm = perm.reshape(-1)
    slots = np.flatnonzero(flat_perm >= 0)
    chunk = meta.shape[1]
    m = meta.reshape(-1)[slots]
    local = (m >> _COL_BITS) & ((1 << _ROW_BITS) - 1)
    rows = rb[slots // chunk].astype(np.int64) * row_block + local
    blk = (m >> (_COL_BITS + _ROW_BITS)) & ((1 << _BLK_BITS) - 1)
    cols = ((b0[slots // chunk].astype(np.int64) + blk) * _LANES
            + (m & ((1 << _COL_BITS) - 1)))
    order = np.argsort(rows, kind='stable')
    row_ptr = np.zeros(n_rows + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=n_rows), out=row_ptr[1:])
    row_slots = slots[order]
    return (row_ptr.astype(np.int32), row_slots.astype(np.int32),
            cols[order].astype(np.int32),
            flat_perm[row_slots].astype(np.int32))


def _plan(meta, b0, rb, perm, shape, nse, chunk, row_block, win_blocks,
          n_rb, nbp) -> GatherPlan:
    index = _row_index(meta, b0, rb, perm, row_block, shape[0])
    n_valid = (perm >= 0).sum(axis=1).astype(np.int32)
    t = torch.from_numpy
    return GatherPlan(t(meta), t(b0), t(rb), t(perm), *map(t, index),
                      t(n_valid), tuple(shape), nse, chunk, row_block,
                      win_blocks, n_rb, nbp)


def build_gather_plan(rows, cols, shape: Tuple[int, int], *,
                      chunk: int = 1024, row_block: int = 1024,
                      win_blocks: int = 32) -> GatherPlan:
    """Build the blocked layout for flat COO-style ``(rows, cols)``.

    The numpy steps of ``brainevent_tpu.ops.mxu_gather.build_gather_plan``,
    unchanged, so that ``meta``, ``b0``, ``rb``, ``perm`` and the static
    fields are bitwise equal to the JAX plan's; plus the row index. The
    tensors are on the CPU (:meth:`GatherPlan.to` moves them).
    """
    if row_block > (1 << _ROW_BITS) or row_block % _LANES:
        raise ValueError(f'row_block must be a multiple of {_LANES} up to '
                         f'{1 << _ROW_BITS}, got {row_block}')
    if win_blocks > (1 << _BLK_BITS):
        raise ValueError(f'win_blocks must be at most {1 << _BLK_BITS}, '
                         f'got {win_blocks}')
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    M, N = shape
    E = rows.shape[0]
    nb = -(-N // _LANES)
    nbp = _ceil_to(max(nb, win_blocks), win_blocks)
    n_rb = max(1, -(-M // row_block))

    if E == 0:
        z2 = np.zeros((_CPB, chunk), np.int32)
        z1 = np.zeros((_CPB,), np.int32)
        return _plan(z2, z1, z1.copy(), np.full((_CPB, chunk), -1, np.int32),
                     (M, N), 0, chunk, row_block, win_blocks, n_rb, nbp)

    blk = cols // _LANES
    rbid = rows // row_block
    win = blk // win_blocks
    order = np.lexsort((cols, win, rbid))
    rbid_s = rbid[order]
    win_s = win[order]
    group = rbid_s * (nbp // win_blocks) + win_s
    # index within the (rb, window) group
    grp_change = np.empty(E, bool)
    grp_change[0] = True
    grp_change[1:] = group[1:] != group[:-1]
    grp_start = np.maximum.accumulate(np.where(grp_change, np.arange(E), 0))
    within = np.arange(E) - grp_start
    chunk_key = group * (E // chunk + 2) + within // chunk
    # chunk ids, densely renumbered in order
    ck_change = np.empty(E, bool)
    ck_change[0] = True
    ck_change[1:] = chunk_key[1:] != chunk_key[:-1]
    chunk_id = np.cumsum(ck_change) - 1
    n_chunks = int(chunk_id[-1]) + 1
    slot = within % chunk

    col_local = (cols[order] % _LANES).astype(np.int64)
    row_local = (rows[order] % row_block).astype(np.int64)
    blk_rel = (blk[order] - win_s * win_blocks).astype(np.int64)
    packed = (col_local | (row_local << _COL_BITS)
              | (blk_rel << (_COL_BITS + _ROW_BITS))).astype(np.int32)

    meta = np.zeros((n_chunks, chunk), np.int32)
    perm = np.full((n_chunks, chunk), -1, np.int32)
    meta[chunk_id, slot] = packed
    perm[chunk_id, slot] = order.astype(np.int32)
    first_of_chunk = np.full(n_chunks, E, np.int64)
    np.minimum.at(first_of_chunk, chunk_id, np.arange(E))
    b0 = (win_s[first_of_chunk] * win_blocks).astype(np.int32)
    rb_arr = rbid_s[first_of_chunk].astype(np.int32)

    # pad every row-block's chunk run to a multiple of _CPB, as the JAX
    # plan does (its kernel covers _CPB consecutive chunks per program)
    rb_present, rb_counts = np.unique(rb_arr, return_counts=True)
    padded_counts = -(-rb_counts // _CPB) * _CPB
    total = int(padded_counts.sum())
    new_off = np.concatenate([[0], np.cumsum(padded_counts)])[:-1]
    old_off = np.concatenate([[0], np.cumsum(rb_counts)])[:-1]
    pos = (np.arange(n_chunks)
           - np.repeat(old_off, rb_counts)
           + np.repeat(new_off, rb_counts))
    meta_p = np.zeros((total, chunk), np.int32)
    perm_p = np.full((total, chunk), -1, np.int32)
    b0_p = np.zeros(total, np.int32)
    rb_p = np.repeat(rb_present, padded_counts).astype(np.int32)
    meta_p[pos] = meta
    perm_p[pos] = perm
    b0_p[pos] = b0
    return _plan(meta_p, b0_p, rb_p, perm_p, (M, N), E, chunk, row_block,
                 win_blocks, n_rb, nbp)


def plan_from_csr(indices, indptr, shape, **kw) -> GatherPlan:
    """Plan for a CSR structure (host arrays)."""
    indptr = np.asarray(indptr)
    indices = np.asarray(indices)
    rows = np.repeat(np.arange(shape[0]), np.diff(indptr))
    return build_gather_plan(rows, indices, shape, **kw)


def plan_from_ell(ell_indices, shape, **kw) -> GatherPlan:
    """Plan for an ELL table ``(n_rows, K)`` of column ids; flat order is
    row-major, matching ``data.reshape(-1)`` of an ``(n_rows, K)`` table."""
    ell_indices = np.asarray(ell_indices)
    n_rows, K = ell_indices.shape
    rows = np.repeat(np.arange(n_rows), K)
    return build_gather_plan(rows, ell_indices.reshape(-1), shape, **kw)


def plan_aux(plan: GatherPlan) -> Tuple:
    """Static (hashable) view of a plan's layout."""
    return (plan.shape, plan.nse, plan.chunk, plan.row_block,
            plan.win_blocks, plan.n_rb, plan.nbp)


def plan_inverse_perm(plan: GatherPlan) -> torch.Tensor:
    """``inv (nse,) int32``: the plan slot (flat ``n_chunks*C`` index) of
    every flat-nse element. ``data_sorted.reshape(-1)[inv]`` is the
    inverse of :meth:`GatherPlan.sort_data`: a gather, so cotangents in
    plan order come back to nse order without a scatter."""
    flat_perm = plan.perm.reshape(-1)
    valid = flat_perm >= 0
    slots = torch.arange(flat_perm.shape[0], dtype=torch.int32,
                         device=flat_perm.device)
    inv = torch.zeros(plan.nse, dtype=torch.int32, device=flat_perm.device)
    inv[flat_perm[valid].long()] = slots[valid]
    return inv


# -- the twins ------------------------------------------------------------------

def _decode(plan: GatherPlan):
    """Global ``(row, col)`` of every slot."""
    m = plan.meta
    col = m & ((1 << _COL_BITS) - 1)
    row = (m >> _COL_BITS) & ((1 << _ROW_BITS) - 1)
    blk = (m >> (_COL_BITS + _ROW_BITS)) & ((1 << _BLK_BITS) - 1)
    gcol = (plan.b0[:, None] + blk).long() * _LANES + col
    grow = plan.rb[:, None].long() * plan.row_block + row
    return grow, gcol


def gather_matvec_xla(plan: GatherPlan, w_sorted: torch.Tensor,
                      x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of K3: decode the plan with gathers and sum with
    ``index_add_``."""
    grow, gcol = _decode(plan)
    x = x.to(torch.float32)
    xv = torch.where(plan.perm >= 0, x[gcol.clamp(0, plan.shape[1] - 1)],
                     torch.zeros((), dtype=torch.float32, device=x.device))
    out = torch.zeros(plan.n_rb * plan.row_block, dtype=torch.float32,
                      device=x.device)
    out.index_add_(0, grow.reshape(-1), (w_sorted * xv).reshape(-1))
    return out[:plan.shape[0]]


def gather_matvec_rows(plan: GatherPlan, w_row: torch.Tensor,
                       x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of K3 over the row index: ``w_row * x[row_cols]``
    summed into each row with ``index_add_``. A row's entries are its plan
    slots in increasing slot order, so on the CPU this adds what
    :func:`gather_matvec_xla` adds, in the same order."""
    M = plan.shape[0]
    rows = torch.repeat_interleave(
        torch.arange(M, device=x.device), plan.row_ptr.diff().long())
    xv = torch.index_select(x.to(torch.float32), 0, plan.row_cols)
    y = torch.zeros(M, dtype=torch.float32, device=x.device)
    return y.index_add_(0, rows, w_row * xv)


def matvec_dw_xla(plan: GatherPlan, w_sorted: torch.Tensor,
                  s_vec: torch.Tensor, x: torch.Tensor,
                  w_row: Optional[torch.Tensor] = None):
    """Plain PyTorch twin of K4: ``(y, dw)``, ``dw`` 0 at padding slots.
    Given the row view ``w_row`` (what K4 reads), ``y`` is
    :func:`gather_matvec_rows` over it, which adds what the plan-order sum
    adds in the same order."""
    grow, gcol = _decode(plan)
    valid = plan.perm >= 0
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    xv = torch.where(valid, x.to(torch.float32)[
        gcol.clamp(0, plan.shape[1] - 1)], zero)
    sv = torch.where(valid, s_vec.to(torch.float32)[
        grow.clamp(0, plan.shape[0] - 1)], zero)
    if w_row is not None:
        return gather_matvec_rows(plan, w_row, x), sv * xv
    y = torch.zeros(plan.n_rb * plan.row_block, dtype=torch.float32,
                    device=x.device)
    y.index_add_(0, grow.reshape(-1), (w_sorted * xv).reshape(-1))
    return y[:plan.shape[0]], sv * xv


# -- the kernels -----------------------------------------------------------------

def _plan_gather_mv_cuda(op, plan, w_row, x):
    i32, f32 = torch.int32, torch.float32
    device = check_cuda_tensors(op.name, (plan.row_ptr, i32),
                                (plan.row_cols, i32), (w_row, f32), (x, f32))
    M, N = plan.shape
    if (w_row.shape != (plan.nse,) or x.shape != (N,)
            or plan.row_ptr.shape != (M + 1,)
            or plan.row_cols.shape != (plan.nse,)):
        raise ValueError(f'{op.name}: w_row {tuple(w_row.shape)}, x '
                         f'{tuple(x.shape)} or the row index does not fit '
                         f'the plan ({plan.nse} slots, shape {plan.shape})')
    y = torch.empty(M, dtype=f32, device=device)
    fn = cuda_build.function('plan_gather_mv_launch', [ctypes.c_void_p] * 3 + [
        ctypes.c_int] * 2 + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                             ctypes.c_void_p])
    op.launch(fn, plan.row_ptr.data_ptr(), plan.row_cols.data_ptr(),
              w_row.data_ptr(), M, N, x.data_ptr(), y.data_ptr(),
              device.index or 0, cuda_stream(device))
    return y


def _plan_matvec_dw_cuda(op, plan, w_sorted, s_vec, x, w_row=None):
    i32, f32 = torch.int32, torch.float32
    M, N = plan.shape
    if (tuple(w_sorted.shape) != tuple(plan.meta.shape) or x.shape != (N,)
            or s_vec.shape != (M,)):
        raise ValueError(f'{op.name}: w_sorted {tuple(w_sorted.shape)}, s '
                         f'{tuple(s_vec.shape)} or x {tuple(x.shape)} does '
                         f'not fit the plan (meta {tuple(plan.meta.shape)}, '
                         f'shape {plan.shape})')
    if w_row is None:
        w_row = plan.rows_of(w_sorted)
    device = check_cuda_tensors(
        op.name, (plan.meta, i32), (plan.b0, i32), (plan.rb, i32),
        (plan.n_valid, i32), (plan.row_ptr, i32), (plan.row_cols, i32),
        (w_sorted, f32), (w_row, f32), (s_vec, f32), (x, f32))
    if (w_row.shape != (plan.nse,) or plan.row_ptr.shape != (M + 1,)
            or plan.row_cols.shape != (plan.nse,)
            or plan.n_valid.shape != (plan.n_chunks,)):
        raise ValueError(f'{op.name}: w_row {tuple(w_row.shape)} or the row '
                         f'index does not fit the plan ({plan.nse} slots)')
    y = torch.empty(M, dtype=f32, device=device)
    # written in full, padding slots too
    dw = torch.empty(plan.meta.shape, dtype=f32, device=device)
    fn = cuda_build.function('plan_matvec_dw_launch', [ctypes.c_void_p] * 7 + [
        ctypes.c_int] * 5 + [ctypes.c_void_p] * 4 + [ctypes.c_int,
                                                     ctypes.c_void_p])
    op.launch(fn, plan.meta.data_ptr(), plan.b0.data_ptr(),
              plan.rb.data_ptr(), plan.n_valid.data_ptr(),
              plan.row_ptr.data_ptr(), plan.row_cols.data_ptr(),
              w_row.data_ptr(), M, N, plan.n_chunks, plan.chunk,
              plan.row_block, s_vec.data_ptr(), x.data_ptr(), y.data_ptr(),
              dw.data_ptr(), device.index or 0, cuda_stream(device))
    return y, dw


plan_gather_mv = KernelOp(
    'plan_gather_mv', twin=gather_matvec_rows, cuda=_plan_gather_mv_cuda,
    source=_SOURCE, replaces='brainevent_tpu/ops/mxu_gather.py:288')

plan_matvec_dw_op = KernelOp(
    'plan_matvec_dw', twin=matvec_dw_xla, cuda=_plan_matvec_dw_cuda,
    source=_SOURCE, replaces='brainevent_tpu/ops/mxu_gather.py:633')


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).contiguous()


def gather_matvec(plan: GatherPlan, w_sorted, x, *,
                  force_xla: Optional[bool] = None, passes: int = 3):
    """``out[r] = sum_{e in row r} w[e] * x[col[e]]`` over the plan's
    structure, through K3 (the twin for CPU tensors).

    ``w_sorted`` is :meth:`GatherPlan.sort_data`'s output; it is brought
    to row order (:meth:`GatherPlan.rows_of`, one gather) for K3. A caller
    that reuses its weights keeps them in row order
    (:meth:`GatherPlan.sort_rows`) and calls :data:`plan_gather_mv`.
    ``force_xla`` and ``passes`` are accepted and ignored.
    """
    del force_xla, passes
    return plan_gather_mv(plan, plan.rows_of(_f32(w_sorted)), _f32(x))


def plan_matvec_dw(plan: GatherPlan, w_sorted, s_vec, x, *,
                   w_row: Optional[torch.Tensor] = None,
                   force_xla: Optional[bool] = None, passes: int = 3):
    """The fused backward products of one sparsity structure, through K4:

    - ``y[r]  = sum_{e in row r} w_sorted[e] * x[col_e]``  (row matvec)
    - ``dw[e] = s_vec[row_e] * x[col_e]``  (per-slot pair product, in plan
      order; 0 at padding slots; :func:`plan_inverse_perm` brings it back
      to nse order)

    This is the surrogate-training backward: ``x`` = the recurrent
    cotangent, ``s_vec`` = the step's spikes, ``y`` = dspk, ``dw`` = the
    weight gradient. ``w_row`` is ``w_sorted`` in row order
    (:meth:`GatherPlan.sort_rows` of the flat weights, or
    :meth:`GatherPlan.rows_of`), what K4 reads for ``y``: a caller that
    launches K4 many times on one weight update makes it once; without it
    each call makes it (one gather). ``force_xla`` and ``passes`` are
    accepted and ignored.
    """
    del force_xla, passes
    return plan_matvec_dw_op(plan, _f32(w_sorted), _f32(s_vec), _f32(x),
                             None if w_row is None else _f32(w_row))


class _PlanMatvecVjp(torch.autograd.Function):
    """Matvec over a plan pair with row-order weights, differentiable with
    respect to ``v``: both directions are K3 launches (``plan_b`` carries
    the transposed structure)."""

    @staticmethod
    def forward(ctx, v, plan_f, plan_b, wr_f, wr_b):
        ctx.plan_b = plan_b
        ctx.save_for_backward(wr_b)
        ctx.v_dtype = v.dtype
        return plan_gather_mv(plan_f, wr_f, _f32(v))

    @staticmethod
    def backward(ctx, ct):
        (wr_b,) = ctx.saved_tensors
        v_bar = plan_gather_mv(ctx.plan_b, wr_b, _f32(ct)).to(ctx.v_dtype)
        return v_bar, None, None, None, None


def plan_matvec_rows(plan_f: GatherPlan, plan_b: GatherPlan, wr_f, wr_b, v):
    """:func:`plan_matvec_vjp` with the weights already in row order
    (:meth:`GatherPlan.sort_rows` of each plan): what a caller that keeps
    its weight views across calls launches."""
    return _PlanMatvecVjp.apply(v, plan_f, plan_b, wr_f, wr_b)


def plan_matvec_vjp(plan_f: GatherPlan, plan_b: GatherPlan, w_f, w_b, v, *,
                    passes: int = 3):
    """Matvec over a cached plan pair, differentiable with respect to ``v``.

    ``plan_b``/``w_b`` must describe the transposed structure of
    ``plan_f``/``w_f`` (the same nse set with rows and columns swapped), so
    that the vector cotangent is exact. The weights get no gradient, as in
    the JAX package. ``passes`` is accepted and ignored.
    """
    del passes
    return plan_matvec_rows(plan_f, plan_b, plan_f.rows_of(_f32(w_f)),
                            plan_b.rows_of(_f32(w_b)), v)


# -- the mat-mat half: K10 -------------------------------------------------------

_MM_CHUNK = 256
_MM_RB = 128
_MM_WB = 1

_MM_SOURCE = 'brainevent_torch/csrc/csr_gather_mm.cu'

# twin work per chunk of entries: about this many gathered values
_TWIN_ELEMS = 1 << 24


def build_mm_plan(rows, cols, shape, *, chunk: int = _MM_CHUNK,
                  row_block: int = _MM_RB,
                  win_blocks: int = _MM_WB) -> GatherPlan:
    """Gather plan with the JAX package's mat-mat knobs (``chunk=256,
    row_block=128, win_blocks=1``), bitwise its plan."""
    return build_gather_plan(rows, cols, shape, chunk=chunk,
                             row_block=row_block, win_blocks=win_blocks)


def gather_matmat_xla(plan: GatherPlan, w_sorted: torch.Tensor,
                      X: torch.Tensor) -> torch.Tensor:
    """The JAX package's mat-mat oracle: decode the plan with gathers and
    sum with ``index_add_``."""
    grow, gcol = _decode(plan)
    xv = take(X, torch.where(plan.perm >= 0, gcol, -1))
    out = torch.zeros(plan.n_rb * plan.row_block, X.shape[1],
                      dtype=torch.float32, device=X.device)
    out.index_add_(0, grow.reshape(-1),
                   (w_sorted[..., None] * xv).reshape(-1, X.shape[1]))
    return out[:plan.shape[0]]


def csr_gather_mm_twin(indptr, indices, perm, w, X, binary: bool):
    """Plain PyTorch twin of K10: ``Y[r, :] = sum_j w[slot(j)] *
    op(X[indices[j], :])`` with gathers and ``index_add_``, a chunk of
    entries at a time; homogeneous binary products sum 0/1 gates (exact)
    and scale once."""
    n_rows, B = indptr.shape[0] - 1, X.shape[1]
    nse = indices.shape[0]
    rows = _misc.csr_to_coo_index(indptr, indices)[0]
    homo = tuple(w.shape) == (1,)
    ws = None if homo else (w if perm is None else w[perm])
    acc = acc_dtype(w, X)
    Xv = op_values(X, binary, acc)
    Y = torch.zeros(n_rows, B, dtype=acc, device=X.device)
    step = max(1, _TWIN_ELEMS // max(B, 1))
    for a in range(0, nse, step):
        v = take(Xv, indices[a:a + step])
        if not (homo and binary):
            v = (w[0] if homo else ws[a:a + step, None]) * v
        Y.index_add_(0, rows[a:a + step], v)
    return Y * w[0] if homo and binary else Y


def csr_gather_mm_ordered(indptr, indices, perm, w, X, binary: bool):
    """K10's function summed as K10 sums it: position by position over the
    rows, each row's next entry multiplied (or, for an event product,
    gated: ``w if op(x) != 0 else 0``) and then added to its row, one
    rounding each, in stored order; out-of-range columns add nothing, and
    homogeneous binary products sum 0/1 gates and scale once. K10's output
    is bitwise this one's; nothing on the main path calls it."""
    n_rows, B = indptr.shape[0] - 1, X.shape[1]
    ptr = indptr.long()
    lens = ptr[1:] - ptr[:-1]
    homo = tuple(w.shape) == (1,)
    acc = acc_dtype(w, X)
    Xv = op_values(X, binary, acc)
    wv = w.to(acc)
    Y = torch.zeros(n_rows, B, dtype=acc, device=X.device)
    zero = torch.zeros((), dtype=acc, device=X.device)
    for p in range(int(lens.max()) if n_rows else 0):
        rows = torch.nonzero(lens > p).squeeze(1)
        j = ptr[rows] + p
        c = indices[j].long()
        keep = (c >= 0) & (c < X.shape[0])
        rows, j, x = rows[keep], j[keep], Xv[c[keep]]
        if homo and binary:
            v = x
        else:
            wt = (wv[:1].expand(j.shape[0]) if homo
                  else wv[j if perm is None else perm[j].long()])[:, None]
            v = torch.where(x != 0, wt, zero) if binary else wt * x
        Y[rows] = Y[rows] + v
    return Y * wv[0] if homo and binary else Y


def _csr_gather_mm_cuda(op, indptr, indices, perm, w, X, binary):
    dbl = is_double(op.name, w)
    code = op_code(X, binary, w.dtype)
    pairs = [(indptr, torch.int32), (indices, torch.int32),
             (w, w.dtype), (X, X.dtype)]
    if perm is not None:
        pairs.append((perm, torch.int32))
    device = check_cuda_tensors(op.name, *pairs)
    n_rows = indptr.shape[0] - 1
    if X.ndim != 2 or not fits(w, indices, perm):
        raise ValueError(f'{op.name}: X {tuple(X.shape)}, weights '
                         f'{tuple(w.shape)} or perm do not fit '
                         f'{indices.shape[0]} entries')
    Y = torch.empty(n_rows, X.shape[1], dtype=w.dtype, device=device)
    fn = cuda_build.function('csr_gather_mm_launch', [ctypes.c_void_p] * 5 + [
        ctypes.c_int] * 6 + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    op.launch(fn, indptr.data_ptr(), indices.data_ptr(),
              None if perm is None else perm.data_ptr(), w.data_ptr(),
              X.data_ptr(), code, int(tuple(w.shape) == (1,)), dbl, n_rows,
              X.shape[0], X.shape[1], Y.data_ptr(), device.index or 0,
              cuda_stream(device))
    return Y


csr_gather_mm = KernelOp(
    'csr_gather_mm', twin=csr_gather_mm_twin, cuda=_csr_gather_mm_cuda,
    source=_MM_SOURCE, replaces='brainevent_tpu/ops/mxu_gather.py:854')


def gather_matmat(plan: GatherPlan, w_sorted, X, *,
                  force_xla: Optional[bool] = None, passes=3):
    """``out[r, :] = sum_{e in row r} w[e] * X[col[e], :]`` over the plan,
    through K10 on the plan's row index (``row_ptr``, ``row_cols``, and
    ``row_slots`` into ``w_sorted``); the twin for CPU tensors.
    ``force_xla`` and ``passes`` are accepted and ignored: K10 takes any
    width of ``X``."""
    del force_xla, passes
    if X.ndim != 2 or X.shape[0] != plan.shape[1]:
        raise ValueError(f'X {tuple(X.shape)} for a plan of shape {plan.shape}')
    return csr_gather_mm(plan.row_ptr, plan.row_cols, plan.row_slots,
                         _f32(w_sorted).reshape(-1), _f32(X), False)


class _PlanMatmatVjp(torch.autograd.Function):
    """Mat-mat over a plan pair, differentiable with respect to ``X``: the
    backward is K10 over the transposed plan."""

    @staticmethod
    def forward(ctx, X, plan_f, plan_b, w_f, w_b):
        ctx.plan_b = plan_b
        ctx.save_for_backward(w_b)
        ctx.x_dtype = X.dtype
        return gather_matmat(plan_f, w_f, X)

    @staticmethod
    def backward(ctx, ct):
        (w_b,) = ctx.saved_tensors
        X_bar = gather_matmat(ctx.plan_b, w_b, ct).to(ctx.x_dtype)
        return X_bar, None, None, None, None


def plan_matmat_vjp(plan_f: GatherPlan, plan_b: GatherPlan, w_f, w_b, X, *,
                    passes=3):
    """Mat-mat over a cached plan pair, differentiable with respect to
    ``X`` (``plan_b``/``w_b``: the transposed structure). The weights get
    no gradient, as in the JAX package. Any width of ``X`` works: there is
    no fallback to fail. ``passes`` is accepted and ignored."""
    del passes
    return _PlanMatmatVjp.apply(X, plan_f, plan_b, w_f, w_b)
