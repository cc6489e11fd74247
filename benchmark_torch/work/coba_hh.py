"""The least work of a ``coba_hh`` trial, whatever route runs it.

Operations, an FMA counted as two, an add, multiply, compare or select
as one, and each ``exp``, ``expm1`` and division as 16. A Hopper SM's
special-function unit (MUFU: ``ex2``, ``rcp``) gives 16 results a clock
against 128 FP32 lanes of two operations each (an FMA), so one MUFU
instruction takes the time of 16 of the 67 TFLOP/s peak's operations; an
accurate ``expf``, ``expm1f`` or IEEE division needs at least one of
them, and FP32 work besides, which is left out:

- 404 a neuron a step, as ``reference/coba_hh.py`` writes the update:
  ``d = v - V_T`` (1); the three exprel rates (52 each: the argument's
  difference and product 2, the zero test and select 2, ``expm1``, its
  quotient and the rate's quotient 48); ``alpha_h`` and ``beta_n`` (19
  each: the argument 2, ``exp`` 16, the product 1); ``beta_h`` (35: the
  argument 2, ``exp`` 16, the sum 1, the quotient 16); the three gates
  (37 each: ``alpha + beta`` 1, ``x_inf`` 16, ``s * -dt`` 1, ``exp`` 16,
  the difference, product and sum 3); the membrane (55: ``m^3 h`` 3,
  ``n^4`` 2, the two conductances 2, ``den``'s four sums, ``num``'s four
  products and four sums, ``v_inf`` 16, ``den * -dt/C_m`` 1, ``exp``
  16, the difference, product and sum 3); the conductances' decays (2);
  the spike test and the arming (5) and the spike count (1). A neuron
  that received no hit folds nothing more; the fold of one that was hit
  (``w * hits`` and the sum) is left out, so the count stays a lower
  bound;
- 1 a hit: each spike adds one to each of its row's 80 targets'
  counters.

Bytes: the eight state arrays of ``num`` entries read once and written
once (six float32, the int32 count and the one-byte flag: 58 a neuron),
and the table row (80 4-byte targets) of each neuron that spiked at least
once in the trial, read once. The counters and every re-read are left
out.
"""

import torch

OPS_PER_NEURON_STEP = 404
OPS_PER_HIT = 1
STATE_BYTES_PER_NEURON = 58


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
