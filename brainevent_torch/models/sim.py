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

"""Whole-simulation entry points for EI networks.

Counterpart of ``brainevent_tpu.models.pallas_sim``: the same names, the
same signatures and defaults, the same return tuple ``(v, t_last, g_e,
g_i, spike_count)``. The JAX package runs each strategy as one Pallas
kernel whose layout (one-hot contractions, mantissa packing, a
partitioned table, DMA banks) exists because a TPU has no atomics and no
gather. On a GPU the whole simulation is one launch too, kernel K21
``einet_sim`` (``csrc/einet_sim.cu``): a persistent cooperative grid keeps
each neuron's state in registers across the steps, counts its spikes'
targets into int32 E/I hits with integer atomics, and crosses a grid-wide
barrier between steps; a network that one thread-block cluster holds
(up to ~11k neurons of 80 targets on an H100, Brette's 4k among them)
runs K21's cluster instance, its counts and rows of conn in the blocks'
shared memory and the cluster's barrier in place of the grid's
(:func:`~brainevent_torch.models.networks.einet_sim_cluster`). The dense strategy runs K21's table instance: the
same grid, barrier and registers, each block (for rows over 8 KB the
whole grid) walking the rows of its spiking neurons in the ``(num, num)``
count table in place of their rows of conn. Every route gives the same counts, so all eight strategies
return bitwise the same five outputs.

======== ======================================== ======== ==================
strategy JAX function (``pallas_sim.py``)          route    why
======== ======================================== ======== ==================
mxu3     ``einet_pallas_sim_mxu3`` (``:639``)       K21      two-stage compaction
                                                           and packed one-hot
                                                           factors are K21's
                                                           integer atomics
mxu6     ``einet_pallas_sim_mxu6`` (``:1368``)      K21      K21 reads the plain
                                                           row-major table
                                                           from HBM at any size
dense    ``einet_pallas_sim_dense`` (``:532``)      K21      the count product
                                                  (table)  ``masks @ table``:
                                                           K21 sums the table
                                                           rows of the spikes
mxu      ``einet_pallas_sim_mxu`` (``:143``)        K21      branchy scan and
                                                           event buffers are
                                                           K21's warp ballots
chain    ``einet_pallas_sim_chain`` (``:350``)      K21      per-synapse RMW
                                                           chains are K21's
                                                           atomics
mxu2     ``einet_pallas_sim_mxu2`` (``:2763``)      K21      vectorized
                                                           compaction is K21's
                                                           warp ballots
mxu4     ``einet_pallas_sim_mxu4`` (``:2973``)      K21      chunked state phases
                                                           are K21's grid
mxu5     ``einet_pallas_sim_mxu5`` (``:2430``)      K21      split E/I compaction
                                                           is K21's channel by
                                                           id
======== ======================================== ======== ==================

The seven K21 strategies run :meth:`EINet.run`, so a network larger than
K21 holds (:func:`~brainevent_torch.models.networks.einet_sim_capacity`,
811,008 neurons on an H100) runs its route of two kernels a step, K1 and
K2 (``csrc/event_scatter.cu``), there; the dense strategy above its table
instance's capacity runs K1 and K19 (``csrc/einet_dense.cu``, which sums
the table rows of K1's spike list), a size whose table no card holds.

K21, K2 and K19 count in int32 with no capacity, so no strategy needs an
overflow round, and none copies the TPU's in-degree limit of 255 (the
mxu4 refusal, the mxu3 to mxu2 fallback at ``pallas_sim.py:716-717``):
their 8-bit packed fields have no counterpart here. Each function accepts
its JAX knobs (``rpb``, ``group``, ``radix``, ...) and ignores them, and
rejects any other keyword with ``TypeError``, as Python does in the JAX
package. ``platform`` is accepted for parity; the device of *state*
decides where a strategy runs.
"""

import torch

from .networks import (EINet, EINetState, einet_dense_hits,
                       einet_dense_hits_twin)

__all__ = ['einet_pallas_sim', 'einet_pallas_sim_mxu',
           'einet_pallas_sim_mxu2', 'einet_pallas_sim_mxu3',
           'einet_pallas_sim_mxu4', 'einet_pallas_sim_mxu5',
           'einet_pallas_sim_mxu6', 'mxu6_conn_table',
           'einet_pallas_sim_chain', 'einet_pallas_sim_dense',
           'dense_count_table', 'einet_dense_hits', 'einet_dense_hits_twin',
           'STRATEGIES', 'CPU_TABLE_BUDGET']

STRATEGIES = ('chain', 'mxu', 'mxu2', 'mxu3', 'mxu4', 'mxu5', 'mxu6', 'dense')

# Largest dense count table built in host memory (bytes).
CPU_TABLE_BUDGET = 2 * 1024 ** 3


def einet_pallas_sim(net: EINet, state: EINetState, n_steps: int,
                     inp: float = 20.0, platform=None, strategy: str = 'auto',
                     **knobs):
    """Run ``n_steps`` of *net* from *state*; returns
    ``(v, t_last, g_e, g_i, spike_count)`` with ``g`` after the step's
    scatter and ``spike_count`` int32, as the JAX package returns them.

    ``strategy`` is one of :data:`STRATEGIES` or ``'auto'`` (mxu3 below
    40k neurons, mxu6 from 40k up). The knobs go to the strategy's
    function, so a knob it does not take raises ``TypeError``; see the
    module docstring for what each strategy runs.
    """
    if strategy == 'auto':
        strategy = _auto_strategy(net.num)
    if strategy not in _FUNCTIONS:
        raise ValueError(f'unknown strategy {strategy!r}; expected one of '
                         f"{STRATEGIES} or 'auto'")
    return _FUNCTIONS[strategy](net, state, n_steps, inp, platform, **knobs)


def _auto_strategy(num: int) -> str:
    """The JAX package's choice: ``'mxu3'`` below 40k neurons, ``'mxu6'``
    from 40k up. Both run K21 here; the name is kept so that callers and
    tests see the same strategy as in ``brainevent_tpu``."""
    return 'mxu6' if num >= 40_000 else 'mxu3'


def _run(net: EINet, state: EINetState, n_steps: int, inp: float):
    """The K21 route: :meth:`EINet.run`, one launch."""
    out = net.run(n_steps, inp, state)
    return (out.neurons.v, out.neurons.t_last, out.g_e, out.g_i,
            out.spike_count)


# -- the K21 strategies ---------------------------------------------------------------

def einet_pallas_sim_mxu3(net, state, n_steps: int, inp: float = 20.0,
                          platform=None, *, mask_dtype=None,
                          operands: str = 'concat', pack: bool = True,
                          two_stage: bool = True, table_space: str = 'auto',
                          cap_divisor: int = 448, factors: str = 'auto'):
    """The main path below 40k neurons, through K21 in one launch: the
    two-stage compaction is a warp ballot over the spikes; the
    mantissa-packed one-hot contraction is int32 atomics, exact at any
    order and with no capacity, so neither the overflow rounds nor the
    in-degree fallback to mxu2 is needed. The knobs lay out the TPU kernel and are ignored."""
    del platform, mask_dtype, operands, pack, two_stage, table_space
    del cap_divisor, factors
    return _run(net, state, n_steps, inp)


def einet_pallas_sim_mxu6(net, state, n_steps: int, inp: float = 20.0,
                          platform=None, *, mask_dtype=None,
                          table_space: str = 'auto', cap_divisor: int = 448,
                          rpb: int = 384, group: int = 4,
                          factor_unroll: int = 4, gather: str = 'block',
                          prefetch: bool = True,
                          fused_load: 'bool | int' = 2,
                          ei_split: bool = True, block_pack: int = 1,
                          m1_fuse: bool = False,
                          compact_j: 'int | None' = None,
                          compact_dot: 'bool | None' = None,
                          dead_skip: 'bool | None' = None,
                          tier_w: int = 0, radix: 'int | str' = 'auto',
                          conn_table=None, _ablate: tuple = ()):
    """The main path from 40k neurons up, through K21: K21 reads the
    plain row-major table wherever it lies in HBM, so the target-partitioned
    table, its two-level one-hot and its radix channels have no
    counterpart. ``conn_table`` (see :func:`mxu6_conn_table`) and the
    layout knobs are ignored."""
    del platform, mask_dtype, table_space, cap_divisor, rpb, group
    del factor_unroll, gather, prefetch, fused_load, ei_split, block_pack
    del m1_fuse, compact_j, compact_dot, dead_skip, tier_w, radix
    del conn_table, _ablate
    return _run(net, state, n_steps, inp)


def einet_pallas_sim_mxu(net, state, n_steps: int, inp: float = 20.0,
                         platform=None):
    """Superseded on the TPU by mxu2; here K21. Its branchy firing scan and
    per-channel event buffers are a warp ballot over the spikes, its
    chunked one-hot contraction is int32 atomics, and its per-event
    overflow fallback is not needed: K21 has no capacity."""
    del platform
    return _run(net, state, n_steps, inp)


def einet_pallas_sim_chain(net, state, n_steps: int, inp: float = 20.0,
                           platform=None):
    """Per-synapse read-modify-write chains on the TPU's scalar unit; here
    K21. The chains are its int32 atomic adds: integer sums do not depend
    on the order the adds land in, so the counts are exact, and the fold
    of the chain columns is its fold of the counts."""
    del platform
    return _run(net, state, n_steps, inp)


def einet_pallas_sim_mxu2(net, state, n_steps: int, inp: float = 20.0,
                          platform=None):
    """Vectorized compaction (prefix-sum slot map, one-hot id gather) and a
    stacked one-hot contraction on the TPU; here K21. The compaction is a
    warp ballot and the contraction int32 atomics; the multi-round
    overflow handling is not needed, since K21 has no capacity."""
    del platform
    return _run(net, state, n_steps, inp)


def einet_pallas_sim_mxu4(net, state, n_steps: int, inp: float = 20.0,
                          platform=None, *, row_chunk: int = 128,
                          table_space: str = 'auto'):
    """mxu3 with its state phases chunked by ``row_chunk`` on the TPU, to
    bound the Mosaic program size; here K21, whose grid already covers
    the neurons in blocks. The JAX function refuses an in-degree above
    255 (its 8-bit packed fields); K21's int32 counts have no such
    limit, so that refusal is not copied."""
    del platform, row_chunk, table_space
    return _run(net, state, n_steps, inp)


def einet_pallas_sim_mxu5(net, state, n_steps: int, inp: float = 20.0,
                          platform=None, *, mask_dtype=None,
                          table_space: str = 'auto', cap_divisor: int = 448,
                          factors: str = 'unrolled'):
    """mxu3 with separate E and I compactions on the TPU; here K21, which
    picks each event's channel from its id (``id >= n_exc``), so
    the split needs no second pass. The knobs are ignored."""
    del platform, mask_dtype, table_space, cap_divisor, factors
    return _run(net, state, n_steps, inp)


def mxu6_conn_table(net: EINet, *, rpb: int = 384, group: int = 4,
                    gather: str = 'block', radix='auto'):
    """The table mxu6 would read. The TPU kernel partitions it by target
    block; K21 reads the plain row-major ``(num, n_conn)`` int32 table, so
    this returns ``net.conn_all`` as it lies on the device."""
    del rpb, group, gather, radix
    return net.conn_all


# -- the dense strategy: the count table --------------------------------------------

def dense_count_table(net: EINet) -> torch.Tensor:
    """The ``(num, num)`` connection-count table on the net's device:
    ``table[i, j]`` is the multiplicity of the edge ``i -> j`` (targets
    outside ``[0, num)`` are dropped). The counterpart of
    ``pallas_sim.py:572-577``, without its 128-lane padding, which never
    reaches the TPU kernel's result.

    The element type is uint8 when every multiplicity is at most 255
    (always so for ``n_conn <= 255``), else int32. The table takes
    ``num**2`` bytes of uint8, checked before anything is allocated:
    against ``torch.cuda.mem_get_info``'s free bytes on the card and
    against :data:`CPU_TABLE_BUDGET` (2 GiB) on the CPU. A table above that
    raises ``ValueError`` with its bytes and the budget: 16 MB at 4k
    neurons, 1.6 GB at 40k, 160 GB at 400k, which no card holds.
    """
    conn = net.conn_all
    device = conn.device
    num, n_conn = conn.shape
    budget = (torch.cuda.mem_get_info(device)[0] if device.type == 'cuda'
              else CPU_TABLE_BUDGET)

    def check(itemsize):
        n_bytes = num * num * itemsize
        if n_bytes > budget:
            raise ValueError(
                f'dense count table of {num} neurons needs {n_bytes} bytes, '
                f'above the budget of {budget} bytes on {device}; use an '
                f'event-driven strategy (mxu3, mxu6) at this size.')

    check(1)
    rows = torch.arange(num, dtype=torch.int64, device=device)[:, None]
    keys = (rows * num + conn.long())[(conn >= 0) & (conn < num)]
    edges, mult = torch.unique(keys, return_counts=True)
    dtype = torch.uint8
    if n_conn > 255 and mult.numel() and int(mult.max()) > 255:
        dtype = torch.int32
        check(4)
    table = torch.zeros(num * num, dtype=dtype, device=device)
    table[edges] = mult.to(dtype)
    return table.view(num, num)


def einet_pallas_sim_dense(net, state, n_steps: int, inp: float = 20.0,
                           platform=None):
    """The dense formulation, through K21's table instance in one launch:
    the JAX kernel multiplies the step's E and I spike masks by the
    ``(num, num)`` count table; K21 walks the table rows of each step's
    spikes into the same int32 counts, so all five outputs are bitwise
    the mxu3 route's.

    Each call builds the table (:func:`dense_count_table`). There is no
    VMEM cap: the table's limit is device memory. Above the table
    instance's capacity (:func:`~.networks.einet_sim_capacity` of the
    table's dtype), which the uint8 table reaches only past device
    memory, :meth:`EINet._simulate` runs K1 and K19 (2n + 1 launches)
    instead; the route is chosen by size, not on failure.
    """
    del platform
    out = net._simulate(state, net.times(n_steps), inp,
                        table=dense_count_table(net))
    return (out.neurons.v, out.neurons.t_last, out.g_e, out.g_i,
            out.spike_count)


_FUNCTIONS = {'chain': einet_pallas_sim_chain, 'mxu': einet_pallas_sim_mxu,
              'mxu2': einet_pallas_sim_mxu2, 'mxu3': einet_pallas_sim_mxu3,
              'mxu4': einet_pallas_sim_mxu4, 'mxu5': einet_pallas_sim_mxu5,
              'mxu6': einet_pallas_sim_mxu6, 'dense': einet_pallas_sim_dense}
