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

"""EI (excitatory/inhibitory) LIF networks: the CUBA and COBA benchmarks.

Counterpart of ``brainevent_tpu.models.networks``: 80% excitatory and 20%
inhibitory LIF neurons, ``n_conn`` random targets per neuron, exponential
synapses, current-based (CUBA, Vogels & Abbott 2005) or conductance-based
(COBA, Brette et al. 2007) coupling, stepped at dt = 0.1 ms.

Two formulations of one step, bitwise equal to each other and to
``brainevent_tpu``'s ``EINet.step`` under ``jax.jit`` on the CPU:

- :meth:`EINet.step` on CPU tensors is the JAX package's structure:
  :func:`lifref_step`, then :meth:`EINet._propagate` (compact the spikes,
  scatter 0/1 hits on two channels, scale by the weights).
- :meth:`EINet.run` (and :meth:`EINet.step` on a CUDA tensor) runs the
  whole simulation as one op, :data:`einet_sim` (kernel K21,
  ``csrc/einet_sim.cu``): one launch per run, the neurons' state in
  registers across the steps, a grid-wide barrier between steps (where
  one thread-block cluster holds the network, :func:`einet_sim_cluster`,
  its cluster instance: the hit counts and conn's rows in shared memory,
  the cluster's barrier). Its
  plain PyTorch twin, which the CPU runs, is :func:`einet_loop` over the
  twins of two ops per step: :data:`einet_step` (kernel K1,
  ``csrc/einet_step.cu``) and
  :data:`brainevent_torch.ops.scatter.event_count_scatter` (kernel K2).
  Given the dense strategy's ``(num, num)`` count table, K21's table
  instance walks the table's rows in place of conn's, and its twin runs
  :data:`einet_dense_hits` (kernel K19, ``csrc/einet_dense.cu``) in K2's
  place. The same loop over the kernels (2n + 1 launches) is the route of
  a network larger than K21 holds and of a caller that passes
  ``step_op``/``scatter_op``.

Where XLA contracts multiply-adds into FMAs, both formulations write the
FMA out (``torch.addcmul`` here, ``__fmaf_rn`` in K1 and K21)::

    g'   = fma(g, decay, w * count)
    COBA current = fma(g_e*d_e, e_e - v, (g_i*d_i) * (e_i - v)) + inp
    CUBA current = fma(g_e, d_e, -(g_i * d_i)) + inp
    v'   = fma((v_rest - v) + r*current, dt/tau, v)       (lifref_step)

Constants are float32 values computed in Python (``decay = float32(exp(-dt
/ tau))``), and the step time is ``float32(i) * float32(dt)``.
"""

import ctypes
import dataclasses
import functools
import math
import numbers
from typing import NamedTuple, Optional

import numpy as np
import torch

from .._error import KernelExecutionError
from ..ops import cuda_build, tracing
from ..ops.core import KernelOp, check_cuda_tensors, check_device, cuda_stream
from ..ops.scatter import (event_count_scatter, event_count_scatter_twin,
                           event_scatter_add_multi)
from .neurons import LIFRefParams, LIFRefState, f32, lifref_init, lifref_step

__all__ = ['EINet', 'EINetState', 'EINetParams', 'einet_step',
           'einet_step_twin', 'einet_sim', 'einet_sim_twin', 'einet_loop',
           'einet_sim_capacity', 'einet_sim_holds', 'einet_dense_hits',
           'einet_dense_hits_twin']


class EINetState(NamedTuple):
    neurons: LIFRefState
    g_e: torch.Tensor          # excitatory conductance/current, (n,)
    g_i: torch.Tensor          # inhibitory conductance/current, (n,)
    spike_count: torch.Tensor  # per-neuron cumulative spikes, int32


class EINetParams(ctypes.Structure):
    """The scalars of one network and drive, rounded to float32; the same
    layout as ``struct EINetParams`` in ``csrc/common.cuh``."""
    _fields_ = [(name, ctypes.c_float) for name in (
        'decay_e', 'decay_i', 'w_e', 'w_i', 'e_e', 'e_i', 'inp', 'v_rest',
        'v_th', 'v_reset', 'tau_ref', 'dt_tau', 'r')] + [
        ('num', ctypes.c_int), ('coba', ctypes.c_int)]


# -- K1: one neuron step ---------------------------------------------------------

def einet_step_twin(v, t_last, g_e, g_i, counts, spike_count, ids, n_ids,
                    p: EINetParams, t: float, parity: int, fold: bool,
                    step: bool) -> None:
    """Plain PyTorch twin of kernel K1, in place.

    ``fold``: ``g = fma(g, decay, w * counts)`` and zero ``counts`` (the
    previous step's hits). ``step``: clear the spike list of the other
    parity, decay, compute the current, run the LIF update at time ``t``,
    and append the ids of this step's spikes to ``ids`` behind
    ``n_ids[parity]``.
    """
    def c(x):
        return torch.tensor(x, dtype=torch.float32, device=v.device)

    if fold:
        g_e.copy_(torch.addcmul(p.w_e * counts[0].float(), g_e, c(p.decay_e)))
        g_i.copy_(torch.addcmul(p.w_i * counts[1].float(), g_i, c(p.decay_i)))
        counts.zero_()
    if not step:
        return
    n_ids[parity ^ 1] = 0
    if p.coba:
        current = torch.addcmul((g_i * p.decay_i) * (p.e_i - v),
                                g_e * p.decay_e, p.e_e - v) + p.inp
    else:
        current = torch.addcmul(-(g_i * p.decay_i), g_e, c(p.decay_e)) + p.inp
    t = c(t)
    refractory = (t - t_last) < p.tau_ref
    x = (p.v_rest - v) + p.r * current
    vn = torch.where(refractory, v, torch.addcmul(v, x, c(p.dt_tau)))
    spike = vn >= p.v_th
    v.copy_(torch.where(spike, p.v_reset, vn))
    t_last.copy_(torch.where(spike, t, t_last))
    spike_count.add_(spike.to(torch.int32))
    new = torch.nonzero(spike).flatten().to(torch.int32)
    base = int(n_ids[parity])
    ids[base:base + new.numel()] = new
    n_ids[parity] += new.numel()


def _einet_step_cuda(op, v, t_last, g_e, g_i, counts, spike_count, ids,
                     n_ids, p, t, parity, fold, step):
    f, i = torch.float32, torch.int32
    device = check_cuda_tensors(op.name, (v, f), (t_last, f), (g_e, f),
                                (g_i, f), (counts, i), (spike_count, i),
                                (ids, i), (n_ids, i))
    num = p.num
    if (v.shape != (num,) or counts.shape != (2, num) or ids.shape != (num,)
            or n_ids.shape != (2,)):
        raise ValueError(f'{op.name}: state shapes do not match num={num}')
    fn = cuda_build.function('einet_step_launch', [ctypes.c_void_p] * 8 + [
        ctypes.POINTER(EINetParams), ctypes.c_float, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    op.launch(fn, v.data_ptr(), t_last.data_ptr(), g_e.data_ptr(),
              g_i.data_ptr(), counts.data_ptr(), spike_count.data_ptr(),
              ids.data_ptr(), n_ids.data_ptr(), ctypes.byref(p), t,
              parity, int(fold), int(step), device.index or 0,
              cuda_stream(device))


einet_step = KernelOp(
    'einet_step', twin=einet_step_twin, cuda=_einet_step_cuda,
    source='brainevent_torch/csrc/einet_step.cu',
    replaces='brainevent_tpu/models/pallas_sim.py:639')


# -- K19: the dense strategy's hits above K21's capacity ----------------------------

def einet_dense_hits_twin(ids: torch.Tensor, n_ids: torch.Tensor,
                          table: torch.Tensor, n_exc: int,
                          counts: torch.Tensor) -> torch.Tensor:
    """``counts[0] += sum of table[i]`` over the first ``n_ids[0]`` ids
    ``i < n_exc``, ``counts[1]`` over the others, in place, dropping ids
    outside ``[0, num)``. Plain PyTorch twin of K19."""
    num = counts.shape[1]
    sel = ids[:max(0, min(int(n_ids[0]), num))].long()
    sel = sel[(sel >= 0) & (sel < num)]
    for ch, rows in enumerate((sel[sel < n_exc], sel[sel >= n_exc])):
        counts[ch] += table[rows].sum(0, dtype=torch.int32)
    return counts


def _check_table(name, table):
    if table.dtype not in (torch.uint8, torch.int32):
        raise TypeError(f'{name}: the table must be uint8 or int32, got '
                        f'{table.dtype}')


def _einet_dense_hits_cuda(op, ids, n_ids, table, n_exc, counts):
    _check_table(op.name, table)
    i32 = torch.int32
    device = check_cuda_tensors(op.name, (ids, i32), (n_ids, i32),
                                (table, table.dtype), (counts, i32))
    num = table.shape[0]
    if (table.shape != (num, num) or counts.shape != (2, num)
            or ids.shape != (num,) or n_ids.numel() < 1):
        raise ValueError(f'{op.name}: ids {tuple(ids.shape)}, table '
                         f'{tuple(table.shape)}, counts {tuple(counts.shape)}')
    fn = cuda_build.function('einet_dense_hits_launch', [
        ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    op.launch(fn, ids.data_ptr(), n_ids.data_ptr(), table.data_ptr(),
              int(table.dtype == torch.int32), num, int(n_exc),
              counts.data_ptr(), device.index or 0, cuda_stream(device))
    return counts


einet_dense_hits = KernelOp(
    'einet_dense_hits', twin=einet_dense_hits_twin,
    cuda=_einet_dense_hits_cuda,
    source='brainevent_torch/csrc/einet_dense.cu',
    replaces='brainevent_tpu/models/pallas_sim.py:532')


# -- K21: the whole run in one launch -----------------------------------------------

SIM_BLOCK = 256          # threads a block of K21 (BE_SIM_BLOCK in einet_sim.cu)
SIM_NPT = (1, 2, 4, 8)   # K21's instances: neurons a thread keeps in registers
# K21's target sources (SRC in einet_sim.cu), by the count table's dtype:
# None the rows of conn, else the rows of the (num, num) table
SIM_SOURCES = {None: 0, torch.uint8: 1, torch.int32: 2}
# the NPT instances built for each source (be_sim_max_npt in einet_sim.cu):
# a table that fits an 80 GB card (~290k neurons uint8, ~145k int32)
# needs no more than NPT 4 or NPT 2 at three blocks an SM
SIM_SOURCE_NPT = {None: SIM_NPT, torch.uint8: SIM_NPT[:3],
                  torch.int32: SIM_NPT[:2]}


def einet_sim_twin(v, t_last, g_e, g_i, spike_count, conn, times,
                   p: EINetParams, n_exc: int, table=None) -> None:
    """Plain PyTorch twin of kernel K21, in place: :func:`einet_loop` at
    the float32 step *times* over the twins of K1 and K2 (the hit counts
    of the whole ``(num, n_conn)`` table *conn*), or of K1 and K19 (the
    rows of the ``(num, num)`` count *table*, when one is given)."""
    def propagate(ids, n_ids, counts):
        if table is None:
            event_count_scatter_twin(ids, n_ids, conn, n_exc, counts)
        else:
            einet_dense_hits_twin(ids, n_ids, table, n_exc, counts)
    out = einet_loop(v, t_last, g_e, g_i, spike_count, times.tolist(), p,
                     propagate, step_op=einet_step_twin)
    for dst, src in zip((v, t_last, g_e, g_i, spike_count), out):
        dst.copy_(src)


@functools.lru_cache(maxsize=None)
def _max_blocks(device_index: int, npt: int, src: int) -> int:
    fn = cuda_build.function('einet_sim_max_blocks', [
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int)])
    out = ctypes.c_int(0)
    err = fn(npt, src, device_index, ctypes.byref(out))
    if err:
        raise KernelExecutionError(
            f'einet_sim: occupancy of npt={npt}, src={src} failed with CUDA '
            f'error {err} ({cuda_build.error_string(err)})')
    return out.value


def einet_sim_max_blocks(device: torch.device, npt: int,
                         table_dtype=None) -> int:
    """Blocks of :data:`SIM_BLOCK` threads of K21's instance *npt* that
    can be co-resident on *device*: the largest grid its cooperative
    launch takes (asked of the CUDA occupancy calculator once per device
    and instance). *table_dtype*: the count table's dtype for a table
    instance, ``None`` for the rows of conn."""
    return _max_blocks(device.index or 0, npt, SIM_SOURCES[table_dtype])


def einet_sim_capacity(device: torch.device, table_dtype=None) -> int:
    """The most neurons K21 runs on *device*: the largest NPT instance of
    the source *table_dtype* (:data:`SIM_SOURCE_NPT`; see
    :func:`einet_sim_max_blocks`) at its own occupancy, every co-resident
    thread holding NPT neurons (811,008 on an H100 over conn: NPT 8 at
    three blocks of 256 an SM)."""
    npt = SIM_SOURCE_NPT[table_dtype][-1]
    return einet_sim_max_blocks(device, npt, table_dtype) * SIM_BLOCK * npt


def einet_sim_holds(num: int, device: torch.device, table_dtype=None) -> bool:
    """Whether a run of *num* neurons on *device* takes K21 (one launch):
    always on the CPU (its twin), on a card up to
    :func:`einet_sim_capacity` of the source *table_dtype*. The route is
    chosen by size, never on failure."""
    return (device.type != 'cuda'
            or num <= einet_sim_capacity(device, table_dtype))


def einet_sim_grid(num: int, device: torch.device, table_dtype=None):
    """``(npt, blocks)`` of K21 for *num* neurons: the fewest neurons a
    thread that a co-resident grid covers, and as many blocks as that
    takes (16 of 256 threads at 4,000 neurons). Raises ``ValueError``
    above :func:`einet_sim_capacity`."""
    for npt in SIM_SOURCE_NPT[table_dtype]:
        blocks = -(-num // (npt * SIM_BLOCK))
        if blocks <= einet_sim_max_blocks(device, npt, table_dtype):
            return npt, blocks
    raise ValueError(f'einet_sim: {num} neurons exceed what K21 holds on '
                     f'{device} ({einet_sim_capacity(device, table_dtype)})')


# K21's cluster instances (be_cluster_kernel in einet_sim.cu): neurons a
# thread keeps in registers, and the most threads of a block
SIM_CLUSTER_NPT = (1, 2, 4)
SIM_CLUSTER_THREADS = 1024


@functools.lru_cache(maxsize=None)
def _cluster_limits(device_index: int) -> tuple:
    """``(most, smem)``: the largest cluster (a power of two up to 16, 0
    for none) in which K21's cluster instances run on the device, and the
    bytes of shared memory a block may take (232,448 on an H100)."""
    fn = cuda_build.function('einet_sim_cluster_limits', [
        ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int)])
    most, smem = ctypes.c_int(0), ctypes.c_int(0)
    err = fn(device_index, ctypes.byref(most), ctypes.byref(smem))
    if err:
        raise KernelExecutionError(
            f'einet_sim: the cluster query failed with CUDA error {err} '
            f'({cuda_build.error_string(err)})')
    return most.value, smem.value


def einet_sim_cluster(num: int, n_conn: int, device: torch.device,
                      table_dtype=None):
    """``(blocks, share, npt)`` of K21's cluster instance for *num* neurons
    of *n_conn* targets, or ``None`` where the grid instance runs them.

    The cluster instance runs the whole network on one thread-block
    cluster: block b owns neurons ``[b * share, (b + 1) * share)``, their
    hit counts and their rows of conn in its shared memory, and the step's
    barrier is the cluster's. It takes a run over conn (never a table) on
    a card where some cluster of C blocks (a power of two, up to the
    largest the device grants) gives ``share = ceil(num / C)`` whose rows
    and counts, ``share * (n_conn + 4) * 4`` bytes, fit a block's shared
    memory, and ``share <= 1024 * npt`` for an instance *npt*; the fewest
    such blocks, so that the barrier spans the fewest SMs (8 blocks of 500
    at 4,000 neurons of 80 targets on an H100; ~11k neurons at most
    there). The route is chosen by size, never on failure."""
    if table_dtype is not None or device.type != 'cuda':
        return None
    most, smem = _cluster_limits(device.index or 0)
    blocks = 1
    while blocks <= most:
        share = -(-num // blocks)
        if share * (n_conn + 4) * 4 <= smem:
            for npt in SIM_CLUSTER_NPT:
                if share <= SIM_CLUSTER_THREADS * npt:
                    return blocks, share, npt
        blocks *= 2
    return None


def table_piece_bytes(table: torch.Tensor) -> int:
    """The bytes of the pieces K21's table instance reads a row in: 16
    where the row length ``num * itemsize`` and the table's address are
    multiples of 16, else 4 (uint8) or one entry."""
    row = table.shape[1] * table.element_size()
    for vec in (16, 4, table.element_size()):
        if row % vec == 0 and table.data_ptr() % vec == 0:
            return vec
    raise ValueError(f'einet_sim: the table at {table.data_ptr():#x} is not '
                     f'aligned to its {table.element_size()}-byte entries')


# The longest table row K21's table instance walks by block; longer rows
# are walked by the whole grid. At NPT 1 (about half a spike a block a
# step at 20 Hz) the block walk's step grows by ~0.34 us a KB of row and
# the grid walk's by ~0.13 over its second barrier's ~0.7 us: on an H100
# the block walk is faster up to 8 KB (8k uint8 neurons), the grid walk
# from 10 KB, whether the table fits the L2 cache or not (PERF.md, 6).
TABLE_BLOCK_WALK_ROW_BYTES = 8192


def table_grid_walk(table: torch.Tensor) -> bool:
    """Whether K21's table instance walks the table rows of a step's
    spikes with the whole grid (a second grid barrier a step) rather
    than with each block alone: where a row's bytes exceed
    :data:`TABLE_BLOCK_WALK_ROW_BYTES`, so that a block's few spiking
    rows take more than one round of its loads in flight."""
    return (table.shape[1] * table.element_size()
            > TABLE_BLOCK_WALK_ROW_BYTES)


def _einet_sim_cuda(op, v, t_last, g_e, g_i, spike_count, conn, times, p,
                    n_exc, table=None, *, npt=0, blocks=0, grid_walk=None):
    """Launch K21 once for ``times.numel()`` steps, over the rows of
    *conn*, or of the ``(num, num)`` count *table* where one is given.
    By default the cluster instance where :func:`einet_sim_cluster` finds
    one, else the grid instance that :func:`einet_sim_grid` picks. *npt*
    and *blocks* pick a grid instance and its grid (so tests can run it
    where the cluster would), *grid_walk* a table's walk (default:
    :func:`table_grid_walk`); no public entry sets them. A grid that
    cannot be co-resident is refused by the cooperative launch and raises
    :class:`KernelExecutionError`."""
    f, i = torch.float32, torch.int32
    pairs = [(v, f), (t_last, f), (g_e, f), (g_i, f), (spike_count, i),
             (conn, i), (times, f)]
    num = p.num
    if table is not None:
        _check_table(op.name, table)
        pairs.append((table, table.dtype))
        if table.shape != (num, num):
            raise ValueError(f'{op.name}: table {tuple(table.shape)} does '
                             f'not match num={num}')
    device = check_cuda_tensors(op.name, *pairs)
    if (conn.dim() != 2 or conn.shape[0] != num or times.dim() != 1
            or any(x.shape != (num,) for x in (v, t_last, g_e, g_i,
                                                spike_count))):
        raise ValueError(f'{op.name}: state, conn {tuple(conn.shape)} and '
                         f'times {tuple(times.shape)} do not match num={num}')
    dtype = None if table is None else table.dtype
    cluster = (None if npt or blocks
               else einet_sim_cluster(num, conn.shape[1], device, dtype))
    if cluster is not None:
        blocks, share, npt = cluster
        fn = cuda_build.function('einet_sim_cluster_launch', [
            ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [
            ctypes.POINTER(EINetParams)] + [ctypes.c_int] * 4 + [
            ctypes.c_void_p])
        op.launch(fn, v.data_ptr(), t_last.data_ptr(), g_e.data_ptr(),
                  g_i.data_ptr(), spike_count.data_ptr(), conn.data_ptr(),
                  times.data_ptr(), times.numel(), conn.shape[1],
                  int(n_exc), ctypes.byref(p), npt, blocks, share,
                  device.index or 0, cuda_stream(device))
        return
    if not npt:
        npt, fewest = einet_sim_grid(num, device, dtype)
    elif npt in SIM_SOURCE_NPT[dtype]:
        fewest = -(-num // (npt * SIM_BLOCK))
    else:
        raise ValueError(f'{op.name}: npt must be one of '
                         f'{SIM_SOURCE_NPT[dtype]}, got {npt}')
    blocks = blocks or fewest
    if blocks * SIM_BLOCK * npt < num:
        raise ValueError(f'{op.name}: {blocks} blocks of {SIM_BLOCK} threads '
                         f'x {npt} neurons do not cover {num} neurons')
    counts = torch.zeros(2, 2, num, dtype=i, device=device)
    targets, vec, lists = conn, 0, None
    if table is not None:
        targets, vec = table, table_piece_bytes(table)
        if table_grid_walk(table) if grid_walk is None else grid_walk:
            # the grid's spike lists by parity and their two counters
            lists = torch.zeros(2 * num + 2, dtype=i, device=device)
    fn = cuda_build.function('einet_sim_launch', [ctypes.c_void_p] * 7 + [
        ctypes.c_int] * 3 + [ctypes.c_void_p, ctypes.POINTER(EINetParams)] + [
        ctypes.c_int] * 4 + [ctypes.c_void_p] + [ctypes.c_int] * 2 + [
        ctypes.c_void_p])
    op.launch(fn, v.data_ptr(), t_last.data_ptr(), g_e.data_ptr(),
              g_i.data_ptr(), spike_count.data_ptr(), targets.data_ptr(),
              times.data_ptr(), times.numel(), conn.shape[1], int(n_exc),
              counts.data_ptr(), ctypes.byref(p), npt, blocks,
              SIM_SOURCES[dtype], vec,
              None if lists is None else lists.data_ptr(),
              int(lists is not None), device.index or 0, cuda_stream(device))


einet_sim = KernelOp(
    'einet_sim', twin=einet_sim_twin, cuda=_einet_sim_cuda,
    source='brainevent_torch/csrc/einet_sim.cu',
    replaces='brainevent_tpu/models/pallas_sim.py:639')


# -- the network -------------------------------------------------------------------

@dataclasses.dataclass
class EINet:
    """EI network with fixed-number random connectivity.

    Parameters
    ----------
    scale : float
        ``n = 4000 * scale`` neurons (3200*scale excitatory, 800*scale
        inhibitory), ``n_conn`` outgoing synapses each.
    coba : bool
        Conductance-based (COBA) vs current-based (CUBA) synapses.
    conn_all : optional ``(num, n_conn)`` int array
        Target table, excitatory rows first. Drawn from
        ``torch.Generator().manual_seed(seed)`` when not given (not JAX's
        draw; use :mod:`brainevent_torch.interop` to share one).
    initial_state : optional :class:`EINetState`
        What :meth:`init_state` returns; drawn from ``seed + 1`` if absent.
    device : torch device, default the card (``'cuda'``)
        Where the table and states live. CUDA tensors run the kernels;
        ``device='cpu'`` runs the twins. Without a card the default
        raises :class:`~brainevent_torch.CUDANotInstalledError`.
    """
    scale: float = 1.0
    coba: bool = True
    dt: float = 0.1          # ms
    n_conn: int = 80
    w_e: float = 0.6         # mS (COBA) / mV-equivalent (CUBA)
    w_i: float = 6.7
    tau_e: float = 5.0       # ms
    tau_i: float = 10.0      # ms
    e_e: float = 0.0         # mV (COBA reversal)
    e_i: float = -80.0       # mV
    seed: int = 42
    conn_all: Optional[torch.Tensor] = dataclasses.field(default=None,
                                                         repr=False)
    initial_state: Optional[EINetState] = dataclasses.field(default=None,
                                                            repr=False)
    device: Optional[torch.device] = None

    def __post_init__(self):
        self.n_exc = int(3200 * self.scale)
        self.n_inh = int(800 * self.scale)
        self.num = self.n_exc + self.n_inh
        self.params = LIFRefParams()
        self.device = check_device(self.device or 'cuda')
        if self.conn_all is None:
            gen = torch.Generator().manual_seed(self.seed)
            n_conn = min(self.n_conn, self.num)
            conn = torch.randint(0, self.num, (self.num, n_conn),
                                 generator=gen, dtype=torch.int32)
        else:
            conn = torch.as_tensor(self.conn_all)
            if conn.dim() != 2 or conn.shape[0] != self.num:
                raise ValueError(f'conn_all must be (num={self.num}, n_conn), '
                                 f'got {tuple(conn.shape)}')
        self.conn_all = conn.to(device=self.device,
                                dtype=torch.int32).contiguous()
        if self.initial_state is not None:
            self.initial_state = _to(self.initial_state, self.device)

    # -- state -------------------------------------------------------------------

    def init_state(self, generator: Optional[torch.Generator] = None
                   ) -> EINetState:
        """The initial state given to the constructor, or one drawn from
        *generator* (default: a generator seeded with ``seed + 1``)."""
        if generator is None and self.initial_state is not None:
            return self.initial_state
        if generator is None:
            generator = torch.Generator().manual_seed(self.seed + 1)
        neurons = lifref_init(generator, self.num, self.params,
                              device=self.device)
        zeros = torch.zeros(self.num, dtype=torch.float32, device=self.device)
        return EINetState(neurons=neurons, g_e=zeros, g_i=zeros.clone(),
                          spike_count=torch.zeros(self.num, dtype=torch.int32,
                                                  device=self.device))

    def step_params(self, inp: float = 20.0) -> EINetParams:
        """The float32 scalars K1 and its twin read."""
        p = self.params
        return EINetParams(
            decay_e=f32(math.exp(-self.dt / self.tau_e)),
            decay_i=f32(math.exp(-self.dt / self.tau_i)),
            w_e=f32(self.w_e), w_i=f32(self.w_i), e_e=f32(self.e_e),
            e_i=f32(self.e_i), inp=f32(inp), v_rest=f32(p.v_rest),
            v_th=f32(p.v_th), v_reset=f32(p.v_reset), tau_ref=f32(p.tau_ref),
            dt_tau=f32(self.dt / p.tau), r=f32(p.r), num=self.num,
            coba=int(self.coba))

    # -- dynamics ----------------------------------------------------------------

    def _propagate(self, spk: torch.Tensor):
        """This step's spikes -> (w_e * E hits, w_i * I hits) per target:
        compact the spiking ids, scatter 0/1 values on two channels, scale
        after the sum. The JAX package needs an event capacity and an
        overflow branch here; the scatter of the port has neither."""
        ids = torch.nonzero(spk).flatten()
        tgt = self.conn_all[ids]                          # (n_act, n_conn)
        is_exc = ids < self.n_exc
        n_conn = tgt.shape[1]
        vals = torch.stack([is_exc, ~is_exc]).to(torch.float32)
        vals = vals[:, :, None].expand(2, ids.numel(), n_conn).reshape(2, -1)
        counts = event_scatter_add_multi(tgt.reshape(-1), vals, self.num)
        return f32(self.w_e) * counts[0], f32(self.w_i) * counts[1]

    def step(self, state: EINetState, t, inp: float = 20.0) -> EINetState:
        """One dt step at time *t* (a float32 value): decay the synapses,
        update the membranes, then scatter THIS step's spikes into the
        conductances the next step reads."""
        if state.neurons.v.device.type != 'cpu':
            return self._simulate(state, [float(t)], inp)
        p = self.step_params(inp)
        d_e = torch.tensor(p.decay_e)
        d_i = torch.tensor(p.decay_i)
        v = state.neurons.v
        if self.coba:
            current = torch.addcmul((state.g_i * p.decay_i) * (p.e_i - v),
                                    state.g_e * p.decay_e, p.e_e - v) + p.inp
        else:
            current = torch.addcmul(-(state.g_i * p.decay_i), state.g_e,
                                    d_e) + p.inp
        neurons, spike = lifref_step(state.neurons, current, t, self.dt,
                                     self.params)
        inc_e, inc_i = self._propagate(spike)
        return EINetState(
            neurons=neurons,
            g_e=torch.addcmul(inc_e, state.g_e, d_e),
            g_i=torch.addcmul(inc_i, state.g_i, d_i),
            spike_count=state.spike_count + spike.to(torch.int32))

    def times(self, n_steps: int) -> list:
        """Step times ``float32(i) * float32(dt)`` for ``i < n_steps``."""
        return (np.arange(n_steps, dtype=np.float32)
                * np.float32(self.dt)).tolist()

    def run(self, n_steps: int, inp: float = 20.0,
            state: Optional[EINetState] = None) -> EINetState:
        """Run ``n_steps`` from *state* (default :meth:`init_state`)
        through K21 in one launch, or its twin on the CPU. *state* is not
        modified."""
        if state is None:
            state = self.init_state()
        return self._simulate(state, n_steps, inp)

    def _simulate(self, state: EINetState, times, inp: float, *,
                  step_op=None, scatter_op=None, table=None) -> EINetState:
        """The run at the float32 step *times*, or, given a number of
        steps, at the first that many of :meth:`times`.

        By default one :data:`einet_sim` call: K21 on a CUDA device, its
        twin (:func:`einet_loop` over the K1 and K2 twins) on the CPU;
        with a ``(num, num)`` count *table* (the dense strategy's) K21's
        table instance, whose twin runs K19's twin in K2's place. The
        route is chosen by size, not on failure (:func:`einet_sim_holds`):
        a network above :func:`einet_sim_capacity` of the source (the
        neurons its largest instance holds in the registers of a
        co-resident grid, 811,008 on an H100 over conn) runs
        :func:`einet_loop` over K1 and K2 (K19 with a table) instead, 2n +
        1 launches. Passing *step_op* or *scatter_op* runs
        :func:`einet_loop` with them (K1, or K2 or K19, for the one not
        passed): the card tests (``tests/test_torch_cuda.py``) pass the
        twins or the kernels to compare routes on a card.

        With tracing on (:mod:`~brainevent_torch.ops.tracing`), a call
        records the span ``brainevent_torch.EINet.run`` (attributes
        ``num``, ``n_steps`` and ``route``: ``sim_cluster`` where K21's
        cluster instance runs it (:func:`einet_sim_cluster`), ``sim``,
        ``sim_table`` or ``loop``) around its pieces: ``.times`` (given a
        number of steps), then ``.copies``, ``.upload`` and ``.launch`` on
        K21's route, or ``.loop``; at most five spans, whatever the number
        of steps."""
        p = self.step_params(inp)
        device = state.neurons.v.device
        if step_op is None and scatter_op is None and einet_sim_holds(
                p.num, device, None if table is None else table.dtype):
            if table is not None:
                route = 'sim_table'
            elif einet_sim_cluster(p.num, self.conn_all.shape[1], device):
                route = 'sim_cluster'
            else:
                route = 'sim'
        else:
            route = 'loop'
        counted = isinstance(times, numbers.Integral)
        with tracing.span('brainevent_torch.EINet.run', num=p.num,
                          n_steps=int(times) if counted else len(times),
                          route=route):
            if counted:
                with tracing.span('brainevent_torch.EINet.times'):
                    times = self.times(times)
            if route != 'loop':
                with tracing.span('brainevent_torch.EINet.copies'):
                    out = [x.to(dtype, copy=True) for x, dtype in (
                        (state.neurons.v, torch.float32),
                        (state.neurons.t_last, torch.float32),
                        (state.g_e, torch.float32),
                        (state.g_i, torch.float32),
                        (state.spike_count, torch.int32))]
                with tracing.span('brainevent_torch.EINet.upload'):
                    t = torch.from_numpy(np.asarray(times, dtype=np.float32))
                    t = t.to(device)
                with tracing.span('brainevent_torch.EINet.launch'):
                    einet_sim(*out, self.conn_all, t, p, self.n_exc,
                              table=table)
                v, t_last, g_e, g_i, spike_count = out
            else:
                def propagate(ids, n_ids, counts):
                    if scatter_op is not None:
                        scatter_op(ids, n_ids, self.conn_all, self.n_exc,
                                   counts)
                    elif table is None:
                        event_count_scatter(ids, n_ids, self.conn_all,
                                            self.n_exc, counts)
                    else:
                        einet_dense_hits(ids, n_ids, table, self.n_exc,
                                         counts)
                with tracing.span('brainevent_torch.EINet.loop'):
                    v, t_last, g_e, g_i, spike_count = einet_loop(
                        state.neurons.v, state.neurons.t_last, state.g_e,
                        state.g_i, state.spike_count, times, p, propagate,
                        step_op=step_op or einet_step)
        return EINetState(neurons=LIFRefState(v=v, t_last=t_last), g_e=g_e,
                          g_i=g_i, spike_count=spike_count)

    def firing_rate_hz(self, state: EINetState, n_steps: int) -> torch.Tensor:
        """Mean firing rate in Hz over the simulated window."""
        t_sec = n_steps * self.dt * 1e-3
        return state.spike_count.to(torch.float32).mean() / t_sec


def einet_loop(v, t_last, g_e, g_i, spike_count, times, p: EINetParams,
               propagate, *, step_op=einet_step):
    """The EI step loop on ``p.num`` neurons, shared by :class:`EINet`'s
    routes over two ops a step and K21's twins: for each time in *times*,
    K1 then ``propagate(ids, n_ids, counts)``, which leaves in the int32 ``(2,
    p.num)`` *counts* this step's hits of the spike list *ids* (its
    length at ``n_ids[0]``); then a last K1 that only folds the final
    counts. The five state arrays are copied, not modified; the copies
    are returned."""
    device = v.device
    v = v.to(torch.float32, copy=True)
    t_last = t_last.to(torch.float32, copy=True)
    g_e = g_e.to(torch.float32, copy=True)
    g_i = g_i.to(torch.float32, copy=True)
    spike_count = spike_count.to(torch.int32, copy=True)
    counts = torch.zeros(2, p.num, dtype=torch.int32, device=device)
    ids = torch.empty(p.num, dtype=torch.int32, device=device)
    n_ids = torch.zeros(2, dtype=torch.int32, device=device)
    buffers = (v, t_last, g_e, g_i, counts, spike_count, ids, n_ids)
    for k, t in enumerate(times):
        parity = k & 1
        step_op(*buffers, p, t, parity, k > 0, True)
        propagate(ids, n_ids[parity:parity + 1], counts)
    if len(times):
        step_op(*buffers, p, 0.0, 0, True, False)
    return v, t_last, g_e, g_i, spike_count


def _to(state: EINetState, device) -> EINetState:
    return EINetState(
        neurons=LIFRefState(v=state.neurons.v.to(device),
                            t_last=state.neurons.t_last.to(device)),
        g_e=state.g_e.to(device), g_i=state.g_i.to(device),
        spike_count=state.spike_count.to(device))
