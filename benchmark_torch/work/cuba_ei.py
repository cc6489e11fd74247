"""The least work of a ``cuba_ei`` trial, whatever route runs it.

Operations, an FMA counted as two, the branch of the neuron update that
current-based synapses take:

- 16 a neuron a step. The currents' decays ``g * d`` (2), computed once
  and used by both the current and the fold; the current ``g_e d_e - g_i
  d_i`` (1, the difference of the two decays: the program's FMA
  ``fma(g_e, d_e, -(g_i d_i))`` multiplies by ``d_e`` once, which is the
  decay already counted, and negates an operand, which costs nothing)
  plus the drive (1); the refractory test ``t - t_last < tau_ref`` (2);
  ``(v_rest - v) + r I`` (3); the membrane's FMA (2); the refractory
  select, the threshold test, the reset and ``t_last`` selects (4); the
  spike count (1). COBA's 20 less its two ``e - v`` subtractions and the
  two products of those by the decayed conductances. A neuron that
  received no hit folds nothing more: ``fma(g, d, 0)`` is the decay
  already counted. The fold of a neuron that was hit (``w * hits`` and
  the FMA) is left out, so the count stays a lower bound;
- 1 a hit: each spike adds one to each of its row's 80 targets' counters.

Bytes, as ``coba_ei``'s: the five state arrays of ``num`` 4-byte entries
read once and written once (40 a neuron), and the table row (80 4-byte
targets) of each neuron that spiked at least once in the trial, read
once. The step times, the counters and every re-read are left out.
"""

import torch

from benchmark_torch.work.coba_ei import (
    OPS_PER_HIT, STATE_BYTES_PER_NEURON, reduce)

__all__ = ['OPS_PER_NEURON_STEP', 'OPS_PER_HIT', 'STATE_BYTES_PER_NEURON',
           'reduce', 'count']

OPS_PER_NEURON_STEP = 16


def count(cfg: dict, inputs: dict, total: torch.Tensor, n_trials: int,
          n_steps: int):
    """``(operations, bytes)`` of *n_trials* trials of *n_steps* steps
    whose :func:`reduce` sum to *total*."""
    num, n_conn = inputs['conn'].shape
    spikes, rows = (int(x) for x in total)
    ops = (OPS_PER_NEURON_STEP * num * n_steps * n_trials
           + OPS_PER_HIT * n_conn * spikes)
    nbytes = STATE_BYTES_PER_NEURON * num * n_trials + 4 * n_conn * rows
    return ops, nbytes
