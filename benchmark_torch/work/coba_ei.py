"""The least work of a ``coba_ei`` trial, whatever route runs it.

Operations, an FMA counted as two:

- 20 a neuron a step. The conductances' decays ``g * d`` (2), computed
  once and used by both the current and the fold; the current ``(e_i - v)
  * g_i d_i`` and ``fma(g_e d_e, e_e - v, .)`` plus the drive (6); the
  refractory test ``t - t_last < tau_ref`` (2); ``(v_rest - v) + r I``
  (3); the membrane's FMA (2); the refractory select, the threshold test,
  the reset and ``t_last`` selects (4); the spike count (1). A neuron
  that received no hit folds nothing more: ``fma(g, d, 0)`` is the decay
  already counted. The fold of a neuron that was hit (``w * hits`` and
  the FMA) is left out, so the count stays a lower bound;
- 1 a hit: each spike adds one to each of its row's 80 targets' counters.

Bytes: the five state arrays of ``num`` 4-byte entries read once and
written once (40 a neuron), and the table row (80 4-byte targets) of
each neuron that spiked at least once in the trial, read once. The step
times, the counters and every re-read are left out.
"""

import torch

OPS_PER_NEURON_STEP = 20
OPS_PER_HIT = 1
STATE_BYTES_PER_NEURON = 40


def reduce(cfg: dict, inputs: dict, out: dict) -> torch.Tensor:
    """What a trial's count needs of its final state, on the device:
    ``[spikes, neurons that spiked]``; summed over the trials."""
    sc = out['spike_count']
    return torch.stack([sc.sum(dtype=torch.int64), (sc > 0).sum()])


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
