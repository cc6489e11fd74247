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

"""Whole-simulation entry point for EI networks.

Counterpart of ``brainevent_tpu.models.pallas_sim``: the same name, the
same arguments and the same return tuple. The JAX package runs the whole
simulation in one Pallas kernel whose layout (one-hot contractions,
mantissa packing, a partitioned table, DMA banks) exists because a TPU has
no atomics and no gather. On a GPU the same contract is two kernels per
step, K1 (``csrc/einet_step.cu``) and K2 (``csrc/event_scatter.cu``),
through :meth:`EINet.run`. Every strategy name is accepted and runs them;
the TPU layout knobs are accepted and ignored.
"""

from .networks import EINet, EINetState

__all__ = ['einet_pallas_sim', 'mxu6_conn_table', 'STRATEGIES']

STRATEGIES = ('chain', 'mxu', 'mxu2', 'mxu3', 'mxu4', 'mxu5', 'mxu6', 'dense')

# Knobs of the JAX package's strategies: layouts of the TPU kernels, with
# no meaning for K1/K2.
_LAYOUT_KNOBS = frozenset((
    '_ablate', 'block_pack', 'cap_divisor', 'compact_dot', 'compact_j',
    'conn_table', 'dead_skip', 'ei_split', 'factor_unroll', 'factors',
    'fused_load', 'gather', 'group', 'm1_fuse', 'mask_dtype', 'operands',
    'pack', 'prefetch', 'radix', 'row_chunk', 'rpb', 'table_space', 'tier_w',
    'two_stage'))


def einet_pallas_sim(net: EINet, state: EINetState, n_steps: int,
                     inp: float = 20.0, platform=None, strategy: str = 'auto',
                     **knobs):
    """Run ``n_steps`` of *net* from *state*; returns
    ``(v, t_last, g_e, g_i, spike_count)`` with ``g`` after the step's
    scatter and ``spike_count`` int32, as the JAX package returns them.

    ``platform`` is accepted for signature parity (the device of *state*
    decides where this runs). ``strategy`` is one of :data:`STRATEGIES` or
    ``'auto'``; every strategy, and every TPU layout knob (``rpb``,
    ``group``, ``radix``, ``prefetch``, ``dead_skip``, ``cap_divisor``,
    ``conn_table``, ...), runs the same two kernels.
    """
    del platform
    if strategy == 'auto':
        strategy = _auto_strategy(net.num)
    if strategy not in STRATEGIES:
        raise ValueError(f'unknown strategy {strategy!r}; expected one of '
                         f"{STRATEGIES} or 'auto'")
    unknown = set(knobs) - _LAYOUT_KNOBS
    if unknown:
        raise TypeError(f'einet_pallas_sim got unknown knobs {sorted(unknown)}')
    out = net.run(n_steps, inp, state)
    return (out.neurons.v, out.neurons.t_last, out.g_e, out.g_i,
            out.spike_count)


def _auto_strategy(num: int) -> str:
    """The JAX package's choice: ``'mxu3'`` below 40k neurons, ``'mxu6'``
    from 40k up. Both run K1/K2 here; the name is kept so that callers and
    tests see the same strategy as in ``brainevent_tpu``."""
    return 'mxu6' if num >= 40_000 else 'mxu3'


def mxu6_conn_table(net: EINet, *, rpb: int = 384, group: int = 4,
                    gather: str = 'block', radix='auto'):
    """The table mxu6 would read. The TPU kernel partitions it by target
    block; K2 reads the plain row-major ``(num, n_conn)`` int32 table, so
    this returns ``net.conn_all`` as it lies on the device."""
    del rpb, group, gather, radix
    return net.conn_all
