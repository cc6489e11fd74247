"""The least work of an ``hpc_stdp`` trial, whatever route runs it.

Operations, an FMA counted as two and an integer operation or compare as
one:

- 35 a neuron a step. The Poisson draw: the step's hash (shared) xor the
  neuron's term (1), the finalizer's three xor-shifts (6) and two
  multiplies (2), a binary search of the 16 thresholds (4); the input ``s
  + events * 4096`` (2); the refractory test (1), the membrane's four
  products and three sums (7) and its select (1); I's two products and
  sum (3); dI's conversion, two products and sum (4); the threshold test
  (1), the reset's two selects (2) and the spike count (1). The ring
  slot's read and clear are memory;
- 2 an E neuron a step, the decays of K+ and K-, and 2 an E spike, their
  +1;
- 3 a delivery (each synapse of each spike): the ring's address, a
  multiply-add (2), and the add (1);
- 6 a depression: ``lambda alpha w`` (1), times K- (1), the difference
  (1), the clamp (1), the units' product (1) and rounding (1);
- 7 a facilitation: K+'s decay (1), ``w^mu`` as ``exp2(mu log2 w)`` (3),
  ``lambda`` times it (1), times K+ (1), the sum (1).

Bytes: the state arrays read once and written once a trial (v, I, dI,
ref and the count, 40 B a neuron; K+ 8 B, K-'s history and the spikes of
D steps 10 D B an E neuron; the ring 8 D B a neuron), the trial's copy of
the E -> E weights (read and written, 8 B a plastic synapse), and at
every spike its rows' bounds (16 B, and 8 B of column bounds for an E
spike) and its rows: the 4-byte target of each synapse, and each plastic
synapse's weight read and written (8 B); at every facilitation its column
entry (8 B: position and source) and its weight read and written (8 B).
The rows and columns are counted at every spike: at scale 10 they are
5.06 GB and 6.48 GB, over 100 times the H100's 50 MB L2, and a neuron
firing at ~7 Hz comes back ~1,400 steps later, after ~1.3 GB of other
rows and columns have passed through L2.
"""

import torch

OPS_PER_NEURON_STEP = 35
OPS_PER_EXC_STEP = 2
OPS_PER_EXC_SPIKE = 2
OPS_PER_DELIVERY = 3
OPS_PER_DEPRESSION = 6
OPS_PER_FACILITATION = 7
STATE_BYTES_PER_NEURON = 40
BYTES_PER_DELIVERY = 4
BYTES_PER_DEPRESSION = 8
BYTES_PER_FACILITATION = 16
BYTES_PER_SPIKE = 16
BYTES_PER_EXC_SPIKE = 8


def _degrees(inputs: dict) -> tuple:
    """Each neuron's synapses, each E neuron's plastic ones and each E
    neuron's plastic inputs (int64), from the rows."""
    net = inputs['net']
    pp = net['plastic_ptr'].long()
    sp = net['static_ptr'].long()
    ne = pp.numel() - 1
    plastic = pp[1:] - pp[:-1]
    total = sp[1:] - sp[:-1]
    total[:ne] += plastic
    inputs_e = torch.bincount(net['targets'][:int(pp[-1])], minlength=ne)
    return total, plastic, inputs_e


def reduce(cfg: dict, inputs: dict, out: dict) -> torch.Tensor:
    """What a trial's count needs of its final state, on the device:
    ``[deliveries, depressions, facilitations, spikes, E spikes]``; summed
    over the trials. A facilitation is made ``d`` steps after its post
    spike, so the E spikes of the trial's last ``d`` steps (``spiked``: all
    its slots but that of step ``step - D``) made none yet."""
    if 'degrees' not in inputs:
        inputs['degrees'] = _degrees(inputs)
    total, plastic, inputs_e = inputs['degrees']
    sc = out['spike_count'].to(torch.int64)
    ne = plastic.numel()
    depth = out['spiked'].shape[0]
    stale = out['step'] % depth
    recent = out['spiked'].to(torch.int64).sum(0) - out['spiked'][stale]
    se = sc[:ne]
    return torch.stack([(sc * total).sum(), (se * plastic).sum(),
                        ((se - recent) * inputs_e).sum(), sc.sum(),
                        se.sum()])


def count(cfg: dict, inputs: dict, total: torch.Tensor, n_trials: int,
          n_steps: int):
    """``(operations, bytes)`` of *n_trials* trials of *n_steps* steps
    whose :func:`reduce` sum to *total*."""
    num, ne, depth = inputs['num'], inputs['ne'], inputs['depth']
    n_plastic = inputs['net']['weights'].numel()
    deliveries, depressions, facilitations, spikes, e_spikes = (
        int(x) for x in total)
    ops = ((OPS_PER_NEURON_STEP * num + OPS_PER_EXC_STEP * ne) * n_steps
           * n_trials + OPS_PER_EXC_SPIKE * e_spikes
           + OPS_PER_DELIVERY * deliveries
           + OPS_PER_DEPRESSION * depressions
           + OPS_PER_FACILITATION * facilitations)
    nbytes = ((STATE_BYTES_PER_NEURON * num + (8 + 10 * depth) * ne
               + 8 * depth * num + 8 * n_plastic) * n_trials
              + BYTES_PER_DELIVERY * deliveries
              + BYTES_PER_DEPRESSION * depressions
              + BYTES_PER_FACILITATION * facilitations
              + BYTES_PER_SPIKE * spikes + BYTES_PER_EXC_SPIKE * e_spikes)
    return ops, nbytes
