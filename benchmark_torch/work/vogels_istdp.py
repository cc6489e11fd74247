"""The least work of a ``vogels_istdp`` trial, whatever route runs it.

Operations, an integer operation or compare counted as one:

- 28 a neuron a step, the Euler update. The fold of the ring's two
  channels: two conversions, two products and two sums (6); the
  refractory count's test, decrement and the live test (3); the membrane:
  ``v - E_L``, its product with g_L, ``I_bg`` less it, ``ga v`` and its
  difference, ``v - E_r``, its product with gg and its difference, the
  product with dt / C and the sum (10), and its select (1); the two
  conductances' decays (2); the threshold test and the live test's and
  (2), the reset's two selects (2) and the spike count (1); the trace's
  decay (1). The ring's reads and clears are memory;
- 1 a spike: its trace's +1;
- 1 a delivery (each synapse of each spike): the add of its units;
- 7 a pre update: ``A_post - alpha`` (1), times eta (1), the sum (1), the
  clip's two compares and selects (2), the units' product (1) and
  rounding (1);
- 4 a post update: ``eta A_pre`` (1), the sum (1), the clip (2).

Bytes: the state arrays read once and written once a trial (v, g_ampa,
g_gaba, ref and the count, 40 B a neuron; the ring's two slots of two
channels, 32 B a neuron; the trace, 8 B a neuron), the trial's copy of
the I -> E weights (read and written, 8 B a plastic synapse), and at every
spike its rows' bounds (8 B, and 8 B more for an I neuron's plastic row)
and its rows: the 4-byte target of each synapse, each plastic synapse's
weight read and written at a pre update (8 B), and at a post update its
column entry (8 B: position and source) and its weight read and written
(8 B). The traces (0.8 MB at scale 20) stay in L2 and are not counted at
their lookups.
"""

import torch

OPS_PER_NEURON_STEP = 28
OPS_PER_SPIKE = 1
OPS_PER_DELIVERY = 1
OPS_PER_PRE = 7
OPS_PER_POST = 4
STATE_BYTES_PER_NEURON = 80
BYTES_PER_DELIVERY = 4
BYTES_PER_PRE = 8
BYTES_PER_POST = 16
BYTES_PER_SPIKE = 8
BYTES_PER_INH_SPIKE = 8


def _degrees(inputs: dict) -> tuple:
    """Each neuron's synapses, each I neuron's plastic ones and each E
    neuron's plastic inputs (int64), from the rows."""
    net = inputs['net']
    pp = net['plastic_ptr'].long()
    sp = net['static_ptr'].long()
    ne = inputs['ne']
    plastic = pp[1:] - pp[:-1]
    total = sp[1:] - sp[:-1]
    total[ne:] += plastic
    inputs_e = torch.bincount(net['targets'][:int(pp[-1])].long(),
                              minlength=ne)
    return total, plastic, inputs_e


def reduce(cfg: dict, inputs: dict, out: dict) -> torch.Tensor:
    """What a trial's count needs of its final state, on the device:
    ``[deliveries, pre updates, post updates, spikes, I spikes]``; summed
    over the trials (each from a count of 0)."""
    if 'degrees' not in inputs:
        inputs['degrees'] = _degrees(inputs)
    total, plastic, inputs_e = inputs['degrees']
    sc = out['spike_count'].to(torch.int64)
    ne = inputs['ne']
    si = sc[ne:]
    return torch.stack([(sc * total).sum(), (si * plastic).sum(),
                        (sc[:ne] * inputs_e).sum(), sc.sum(), si.sum()])


def count(cfg: dict, inputs: dict, total: torch.Tensor, n_trials: int,
          n_steps: int):
    """``(operations, bytes)`` of *n_trials* trials of *n_steps* steps
    whose :func:`reduce` sum to *total*."""
    num = inputs['num']
    n_plastic = inputs['net']['weights'].numel()
    deliveries, pre, post, spikes, i_spikes = (int(x) for x in total)
    ops = (OPS_PER_NEURON_STEP * num * n_steps * n_trials
           + OPS_PER_SPIKE * spikes + OPS_PER_DELIVERY * deliveries
           + OPS_PER_PRE * pre + OPS_PER_POST * post)
    nbytes = ((STATE_BYTES_PER_NEURON * num + 8 * n_plastic) * n_trials
              + BYTES_PER_DELIVERY * deliveries + BYTES_PER_PRE * pre
              + BYTES_PER_POST * post + BYTES_PER_SPIKE * spikes
              + BYTES_PER_INH_SPIKE * i_spikes)
    return ops, nbytes
