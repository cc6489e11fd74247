"""The least work of a ``pd_microcircuit`` trial, whatever route runs it.

Operations, an FMA counted as two and an integer operation or compare as
one:

- 28 a neuron a step. The Poisson draw: the step's hash (shared by the
  neurons) xor the neuron's term (fixed, so not counted) (1), and the
  finalizer's three xor-shifts (6) and two multiplies (2); the events it
  reached, a binary search of the 16 thresholds (4); the input ``s +
  events * w_ext`` (2); the refractory test (1), the membrane's ``V * P22``
  and FMA (3) and the refractory select (1); the current's conversion,
  ``q * s`` and FMA (4); the threshold test (1), the reset's two selects
  (2) and the spike count (1). The ring slot's read and clear are memory;
- 5 a synapse event (each spike times its row's synapses): the slot ``(t
  + d) mod D`` (2), the ring's address, a multiply-add (2), and the add
  (1).

Bytes: the four state arrays of ``num`` 4-byte entries read once and
written once (32 a neuron), the ring (``D`` 4-byte slots a neuron, 19.8 MB
at full scale, inside L2) read once and written once, and for each spike
its two 4-byte row bounds and its row: 7 bytes a synapse event (an int32
target, an int16 weight, a uint8 delay). The rows are counted at every
spike, not once a trial: at full scale they are 2.09 GB, 42 times the
H100's 50 MB L2, and a neuron firing at ~3 Hz comes back ~3,300 steps
later, after ~2.3 GB of other rows have passed through L2, so each of its
~30 walks a trial reads its row from HBM again.
"""

import torch

OPS_PER_NEURON_STEP = 28
OPS_PER_EVENT = 5
STATE_BYTES_PER_NEURON = 32
BYTES_PER_EVENT = 7
BYTES_PER_SPIKE = 8


def reduce(cfg: dict, inputs: dict, out: dict) -> torch.Tensor:
    """What a trial's count needs of its final state, on the device:
    ``[synapse events, spikes]``; summed over the trials."""
    sc = out['spike_count'].to(torch.int64)
    degree = inputs['net']['degree'].to(sc.device)
    return torch.stack([(sc * degree).sum(), sc.sum()])


def count(cfg: dict, inputs: dict, total: torch.Tensor, n_trials: int,
          n_steps: int):
    """``(operations, bytes)`` of *n_trials* trials of *n_steps* steps
    whose :func:`reduce` sum to *total*."""
    num, depth = inputs['num'], inputs['depth']
    events, spikes = (int(x) for x in total)
    ops = (OPS_PER_NEURON_STEP * num * n_steps * n_trials
           + OPS_PER_EVENT * events)
    nbytes = ((STATE_BYTES_PER_NEURON + 8 * depth) * num * n_trials
              + BYTES_PER_EVENT * events + BYTES_PER_SPIKE * spikes)
    return ops, nbytes
