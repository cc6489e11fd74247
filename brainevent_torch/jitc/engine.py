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

"""The implicit-connectivity walk (``brainevent_tpu.jitc.engine``), in plain
PyTorch: the twins of the JITC kernels K11-K14.

A walk of ``n_rows`` x ``n_cols`` runs one light-RNG stream per ``(row,
chunk, lane)``, ``lane < stride`` (32 in mv mode, 4 in mm mode),
``chunk_size = ceil(logical_cols / 4)``. A stream starts at its
stationary residual ``q`` (rejection-sampled, :func:`walk_setup`) and
visits the columns ``chunk * chunk_size + lane + stride * q`` while
``lane + stride * q`` is inside its chunk, drawing one geometric skip
``q += 1 + bounded(next(state), cl - 1)`` per visit. The layout is the
sampled matrix, so it is the JAX package's, draw for draw.

For ``corder=True`` the walk rows are output indices and the walk columns
input indices; for ``corder=False`` the reverse (the scatter form). The
JAX engine advances every stream in lockstep under a mask; this twin
keeps only the streams still inside their chunk, round by round (and, in
the scatter form, only the rows whose operand is not zero), which gives
the same visits. A plan's streams (``setup = (state2, q2)``, ``(n_rows,
n_chunks * stride)`` int32 bit patterns of uint32, :func:`walk_setup2`)
replace the stream setup when given.

``weight_fn(seed, rows, cols) -> float32`` is a family's weight law,
evaluated at walk coordinates.

``row0`` offsets the walk rows, the sharding hook of the JAX engine
(``brainevent_tpu/jitc/engine.py:63-77``): a walk of ``n_rows`` rows is
the walk of the global rows ``[row0, row0 + n_rows)``, its streams and
weights keyed on the global ids, while the operand (scatter form), the
output (gather form) and a plan's streams stay in local rows. Each shard
of :mod:`brainevent_torch.parallel` walks its own rows so, and the
sampled matrix does not depend on the split.
"""

from typing import Callable, Iterator, Optional, Tuple

import torch

from .._misc import _MM_STRIDE, _MV_STRIDE, _normalize_chunk_size
from ..ops.operand import op_values
from ..rng.light import (M32, _mulhi32, _u32, light_rng_init,
                         light_rng_initial_q, light_rng_next)

__all__ = ['walk_setup', 'walk_setup2', 'walk_fold', 'walk_matvec',
           'walk_matmat', 'walk_todense', 'to_int32', 'cdiv']


def cdiv(m: int, n: int) -> int:
    return -(-m // n)


def to_int32(x: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 -> their int32 bit patterns."""
    return (x - ((x >> 31) << 32)).to(torch.int32)


def _stream_ids(rows: torch.Tensor, L: int, stride: int):
    """Walk row, chunk and lane of every stream of *rows*, row-major."""
    sub = torch.arange(L, device=rows.device).repeat(rows.numel())
    return rows.repeat_interleave(L), sub // stride, sub % stride


def walk_setup(seed, clen, n_rows: int, n_cols: int, stride: int,
               chunk_size: int, rows: Optional[torch.Tensor] = None,
               device=None, row0: int = 0):
    """Initialize the streams of *rows* (default: every walk row), local
    rows of a walk starting at global row *row0*.

    Returns ``(rows, chunks, lanes, state, q, cl)``: flat int64 tensors
    over the streams, row-major as ``(row, chunk, lane)`` (local rows),
    and the connection length ``cl = max(clen, 2)``.
    """
    n_chunks = cdiv(n_cols, chunk_size)
    cl = max(int(clen) & M32, 2)
    if rows is None:
        rows = torch.arange(n_rows, device=device)
    r, c, l = _stream_ids(rows, n_chunks * stride, stride)
    state = light_rng_init(int(seed) & M32, r + row0, c, l)
    q, state = light_rng_initial_q(state, cl)
    return r, c, l, state, q, cl


def walk_setup2(seed, clen, n_rows: int, n_cols: int, stride: int,
                chunk_size: int, device=None, row0: int = 0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A plan's streams: ``(state2, q2)``, ``(n_rows, n_chunks *
    stride)`` int32 bit patterns of the uint32 state and residual, of the
    global rows ``[row0, row0 + n_rows)``."""
    _, _, _, state, q, _ = walk_setup(seed, clen, n_rows, n_cols, stride,
                                      chunk_size, device=device, row0=row0)
    L = cdiv(n_cols, chunk_size) * stride
    return (to_int32(state).reshape(n_rows, L),
            to_int32(q).reshape(n_rows, L))


def walk_rounds(seed, clen, n_rows: int, n_cols: int, *, stride: int,
                chunk_size: int, rows: Optional[torch.Tensor] = None,
                setup=None, device=None, row0: int = 0
                ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """Yield ``(rows, cols)`` of the visits of each round, over the
    streams still inside their chunk; *rows* are local (the walk starts
    at global row *row0*)."""
    n_chunks = cdiv(n_cols, chunk_size)
    L = n_chunks * stride
    if setup is None:
        r, c, l, state, q, cl = walk_setup(seed, clen, n_rows, n_cols,
                                           stride, chunk_size, rows, device,
                                           row0)
    else:
        state2, q2 = setup
        if tuple(state2.shape) != (n_rows, L):
            raise ValueError(
                f'walk plan setup shape {tuple(state2.shape)} does not match '
                f"this product's walk layout {(n_rows, L)}: build the plan "
                f'from the same matrix orientation.')
        if rows is None:
            rows = torch.arange(n_rows, device=state2.device)
        r, c, l = _stream_ids(rows, L, stride)
        state = _u32(state2[rows].reshape(-1))
        q = _u32(q2[rows].reshape(-1))
        cl = max(int(clen) & M32, 2)
    start = c * chunk_size
    width = torch.clamp(n_cols - start, max=chunk_size)
    while True:
        local_j = (l + stride * q) & M32
        live = local_j < width
        r, l, start, width = r[live], l[live], start[live], width[live]
        state, q = state[live], q[live]
        if not r.numel():
            return
        yield r, start + local_j[live]
        state = light_rng_next(state)
        q = (q + 1 + _mulhi32(state, cl - 1)) & M32


def walk_fold(seed, clen, n_rows: int, n_cols: int, *, stride: int,
              body: Callable, carry, chunk_size: Optional[int] = None,
              logical_cols: Optional[int] = None,
              rows: Optional[torch.Tensor] = None, setup=None, device=None,
              row0: int = 0):
    """Fold ``carry = body(carry, rows, cols)`` over the rounds of the
    walk (local *rows*; the walk starts at global row *row0*).
    ``chunk_size`` defaults to ``ceil(logical_cols / 4)`` (the logical
    column count, not the walk width); *rows* restricts the walk to those
    walk rows."""
    if chunk_size is None:
        chunk_size = _normalize_chunk_size(
            n_cols if logical_cols is None else logical_cols, None)
    for r, c in walk_rounds(seed, clen, n_rows, n_cols, stride=stride,
                            chunk_size=chunk_size, rows=rows, setup=setup,
                            device=device, row0=row0):
        carry = body(carry, r, c)
    return carry


def walk_matvec(weight_fn, seed, clen, v, out_len: int, *, corder: bool,
                logical_cols: int, stride: int = _MV_STRIDE,
                event: bool = False, setup=None,
                row0: int = 0) -> torch.Tensor:
    """Implicit mat-vec: ``out[row] += w * v[col]`` (``corder=True``) or
    ``out[col] += w * v[row]`` (``corder=False``, over the rows with
    ``v != 0`` only), the walk rows starting at global row *row0*."""
    in_len = v.shape[0]
    gate = op_values(v, event)
    out = torch.zeros(out_len, dtype=torch.float32, device=v.device)
    if corder:
        def body(acc, r, c):
            return acc.index_add_(0, r, gate[c] * weight_fn(seed, r + row0,
                                                              c))
        return walk_fold(seed, clen, out_len, in_len, stride=stride,
                         logical_cols=logical_cols, body=body, carry=out,
                         setup=setup, device=v.device, row0=row0)

    def body(acc, r, c):
        return acc.index_add_(0, c, gate[r] * weight_fn(seed, r + row0, c))
    rows = torch.nonzero(v != 0).flatten()
    return walk_fold(seed, clen, in_len, out_len, stride=stride,
                     logical_cols=logical_cols, body=body, carry=out,
                     rows=rows, setup=setup, device=v.device, row0=row0)


def walk_matmat(weight_fn, seed, clen, B, out_len: int, *, corder: bool,
                logical_cols: int, stride: int = _MM_STRIDE,
                event: bool = False, setup=None) -> torch.Tensor:
    """Implicit mat-mat: rows of ``B`` are gathered (``corder=True``) or
    scattered whole."""
    in_len, n_batch = B.shape
    gate = op_values(B, event)
    out = torch.zeros(out_len, n_batch, dtype=torch.float32, device=B.device)
    if corder:
        def body(acc, r, c):
            return acc.index_add_(0, r, weight_fn(seed, r, c)[:, None]
                                  * gate[c])
        return walk_fold(seed, clen, out_len, in_len, stride=stride,
                         logical_cols=logical_cols, body=body, carry=out,
                         setup=setup, device=B.device)

    def body(acc, r, c):
        return acc.index_add_(0, c, weight_fn(seed, r, c)[:, None] * gate[r])
    rows = torch.nonzero((B != 0).any(dim=1)).flatten()
    return walk_fold(seed, clen, in_len, out_len, stride=stride,
                     logical_cols=logical_cols, body=body, carry=out,
                     rows=rows, setup=setup, device=B.device)


def walk_todense(weight_fn, seed, clen, shape: Tuple[int, int], *,
                 corder: bool, stride: int = _MV_STRIDE, setup=None,
                 out: Optional[torch.Tensor] = None,
                 device=None) -> torch.Tensor:
    """Materialize the ``(m, k)`` implicit matrix (``corder=False`` walks
    the transposed layout). Each ``(row, col)`` has one stream and one
    visit, so the visits are plain stores into the zeros of *out*."""
    m, k = shape
    n_rows, n_cols = (m, k) if corder else (k, m)
    if out is None:
        out = torch.zeros(m, k, dtype=torch.float32, device=device)
    flat = out.view(-1)

    def body(acc, r, c):
        acc[r * k + c if corder else c * k + r] = weight_fn(seed, r, c)
        return acc
    walk_fold(seed, clen, n_rows, n_cols, stride=stride, logical_cols=k,
              body=body, carry=flat, setup=setup, device=out.device)
    return out
