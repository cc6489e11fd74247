# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""The sharded EI network's per-device hit counts: kernel K20
(``csrc/mega_counts.cu``), the port of ``brainevent_tpu.parallel.mega``,
and kernel K22 (``csrc/einet_shard.cu``), which runs a rank's neuron step
and its counts in one launch (:class:`~.sharding.ShardedEINet`'s step).

Each device of a sharded EI network holds the rows of its own neurons in
the ``(num, n_conn)`` connection table. A step counts, for every spiking
local neuron and each of its targets, one E or I hit (by the neuron's
global id against ``n_exc``) into full-length partials; one reduce-scatter
then sums them and hands every device the counts of its own neurons, which
are scaled by the weights after the sum. Integer counts keep that sum
exact, so the sharded run is bitwise the single-device one.

The JAX package does the counting with the mxu6 mega-kernel's encoded,
target-partitioned table and a one-hot MXU contraction
(``_make_counts_kernel``), because a TPU has no atomics. That layout
(``_partition_table_cg``, ``_encode_slots``, the c-group ``conn_flat``) is
not ported, nor are its refusals of an in-degree above 255 and of a shard
width that is not a multiple of 128: K20 adds int32 counts with atomics,
exact at any in-degree and any shard width. :class:`MegaScatterLayout`
keeps the JAX signature and holds the plain table; the TPU knobs (``rpb``,
``group``, ``pmap``, ``cap``) are accepted and ignored.
"""

import ctypes
from typing import Tuple

import torch

from ..models.networks import EINetParams, einet_step_twin
from ..ops import cuda_build
from ..ops.core import KernelOp, check_cuda_tensors, cuda_stream

__all__ = ['MegaScatterLayout', 'mega_local_counts', 'mega_counts',
           'mega_counts_twin', 'einet_shard_step', 'einet_shard_step_twin']


class MegaScatterLayout:
    """The connection table of a sharded EI network, sliceable by neuron
    shard: ``conn_flat`` is the plain ``(num, n_conn)`` int32 table (row
    ``i``: the targets of neuron ``i``, excitatory rows first), so a
    device's rows are its shard. ``rpb`` and ``group`` are the TPU
    layout's knobs, accepted and ignored."""

    def __init__(self, conn_all, n_exc: int, num: int, *, rpb: int = 384,
                 group: int = 4):
        del rpb, group
        conn = torch.as_tensor(conn_all)
        if conn.dim() != 2 or conn.shape[0] != num:
            raise ValueError(f'conn_all must be (num={num}, n_conn), got '
                             f'{tuple(conn.shape)}')
        self.conn_flat = conn.to(torch.int32).contiguous()
        self.num = int(num)
        self.n_exc = int(n_exc)


# -- K20 ----------------------------------------------------------------------------

def mega_counts_twin(ids, n_ids, conn, row0: int, n_exc: int,
                     counts: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of K20, in place: for the first ``n_ids[0]``
    local ids of *ids* and each target ``t`` of their rows of *conn*, add
    1 at class ``row0 + id >= n_exc`` and target ``t`` of *counts*
    ``(num / seg, 2, seg)``; ids outside ``[0, n_loc)`` and targets
    outside ``[0, num)`` are dropped."""
    n_loc = conn.shape[0]
    n_blocks, _, seg = counts.shape
    num = n_blocks * seg
    sel = ids[:int(n_ids[0])].long()
    sel = sel[(sel >= 0) & (sel < n_loc)]
    flat = counts.view(-1)
    for ch, rows in enumerate((sel[row0 + sel < n_exc],
                               sel[row0 + sel >= n_exc])):
        tgt = conn[rows].reshape(-1).long()
        tgt = tgt[(tgt >= 0) & (tgt < num)]
        at = (tgt // seg) * (2 * seg) + ch * seg + tgt % seg
        flat.index_add_(0, at, torch.ones_like(at, dtype=torch.int32))
    return counts


def _mega_counts_cuda(op, ids, n_ids, conn, row0, n_exc, counts):
    device = check_cuda_tensors(op.name, (ids, torch.int32),
                                (n_ids, torch.int32), (conn, torch.int32),
                                (counts, torch.int32))
    n_loc, n_conn = conn.shape
    n_blocks, two, seg = counts.shape
    if two != 2 or ids.shape != (n_loc,) or n_ids.numel() < 1:
        raise ValueError(f'{op.name}: ids {tuple(ids.shape)}, conn '
                         f'{tuple(conn.shape)}, counts {tuple(counts.shape)}')
    fn = cuda_build.function('mega_counts_launch', [
        ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    op.launch(fn, ids.data_ptr(), n_ids.data_ptr(), conn.data_ptr(), n_loc,
              n_conn, n_blocks * seg, int(row0), int(n_exc), seg,
              counts.data_ptr(), device.index or 0, cuda_stream(device))
    return counts


mega_counts = KernelOp(
    'mega_counts', twin=mega_counts_twin, cuda=_mega_counts_cuda,
    source='brainevent_torch/csrc/mega_counts.cu',
    replaces='brainevent_tpu/parallel/mega.py:122')


# -- K22: the rank's step and partials in one launch -----------------------------------

def einet_shard_step_twin(v, t_last, g_e, g_i, counts, spike_count, partials,
                          conn, row0: int, n_exc: int, p: EINetParams,
                          t: float, parity: int, fold: bool,
                          step: bool) -> None:
    """Plain PyTorch twin of K22, in place: K1's twin on the rank's
    ``p.num`` neurons (fold the summed ``(2, n_loc)`` *counts*, which stay
    as they are, then step at time *t*), then, on a step, K20's twin of
    the step's spikes into ``partials[parity]`` ``(n_dev, 2, n_loc)``
    after zeroing ``partials[parity ^ 1]``."""
    ids = torch.empty(p.num, dtype=torch.int32, device=v.device)
    n_ids = torch.zeros(2, dtype=torch.int32, device=v.device)
    einet_step_twin(v, t_last, g_e, g_i, counts.clone(), spike_count, ids,
                    n_ids, p, t, 0, fold, step)
    if step:
        partials[parity ^ 1].zero_()
        mega_counts_twin(ids, n_ids[:1], conn, row0, n_exc, partials[parity])


def _einet_shard_step_cuda(op, v, t_last, g_e, g_i, counts, spike_count,
                           partials, conn, row0, n_exc, p, t, parity, fold,
                           step):
    f, i = torch.float32, torch.int32
    device = check_cuda_tensors(op.name, (v, f), (t_last, f), (g_e, f),
                                (g_i, f), (counts, i), (spike_count, i),
                                (partials, i), (conn, i))
    n_loc = p.num
    if (partials.dim() != 4 or partials.shape[0] != 2
            or partials.shape[2:] != (2, n_loc) or conn.dim() != 2
            or conn.shape[0] != n_loc or counts.shape != (2, n_loc)
            or any(x.shape != (n_loc,) for x in (v, t_last, g_e, g_i,
                                                  spike_count))):
        raise ValueError(f'{op.name}: state, counts {tuple(counts.shape)}, '
                         f'partials {tuple(partials.shape)} and conn '
                         f'{tuple(conn.shape)} do not match n_loc={n_loc}')
    fn = cuda_build.function('einet_shard_step_launch', [
        ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
        ctypes.POINTER(EINetParams), ctypes.c_float] + [ctypes.c_int] * 4 + [
        ctypes.c_void_p])
    op.launch(fn, v.data_ptr(), t_last.data_ptr(), g_e.data_ptr(),
              g_i.data_ptr(), counts.data_ptr(), spike_count.data_ptr(),
              partials.data_ptr(), conn.data_ptr(), conn.shape[1],
              partials.shape[1] * n_loc, int(row0), int(n_exc),
              ctypes.byref(p), t, parity, int(fold), int(step),
              device.index or 0, cuda_stream(device))


einet_shard_step = KernelOp(
    'einet_shard_step', twin=einet_shard_step_twin,
    cuda=_einet_shard_step_cuda,
    source='brainevent_torch/csrc/einet_shard.cu',
    replaces='brainevent_tpu/parallel/mega.py:122')


def mega_local_counts(spike_loc, conn_loc, pmap=None, *,
                      layout: MegaScatterLayout, cap: int = 512,
                      platform=None, row0: int = 0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One device's step of the sharded propagation: LOCAL spikes x its
    rows of the table -> full-length ``(count_e, count_i)`` partials,
    exact integers in float32 (sum them over the devices, then scale).

    ``spike_loc``: ``(n_loc,)`` spikes (bool, or a number that spikes where
    ``> 0``); ``conn_loc``: the device's rows of ``layout.conn_flat``;
    ``row0``: the global id of its first row, which picks each spike's
    class (the JAX layout bakes the class into its encoded rows; the plain
    table does not). ``pmap``, ``cap`` and ``platform`` are the TPU
    kernel's, accepted and ignored. Runs K20 on CUDA tensors, its twin on
    the CPU.
    """
    del pmap, cap, platform
    spike_loc = torch.as_tensor(spike_loc)
    conn_loc = torch.as_tensor(conn_loc, device=spike_loc.device).to(
        torch.int32).contiguous()
    n_loc = conn_loc.shape[0]
    if spike_loc.shape != (n_loc,):
        raise ValueError(f'spike_loc {tuple(spike_loc.shape)} does not fit '
                         f'{n_loc} local rows')
    gate = spike_loc if spike_loc.dtype == torch.bool else spike_loc > 0
    ids = torch.nonzero(gate).flatten().to(torch.int32)
    ids = torch.cat([ids, ids.new_zeros(n_loc - ids.numel())])
    n_ids = torch.count_nonzero(gate).reshape(1).to(torch.int32)
    counts = torch.zeros(1, 2, layout.num, dtype=torch.int32,
                         device=spike_loc.device)
    mega_counts(ids, n_ids, conn_loc, row0, layout.n_exc, counts)
    out = counts[0].to(torch.float32)
    return out[0], out[1]
