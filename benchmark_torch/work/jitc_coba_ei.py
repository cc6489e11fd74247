"""The least work of a ``jitc_coba_ei`` trial, whatever route runs it.

Operations, an FMA counted as two:

- 20 a neuron a step: the step of ``coba_ei`` (see ``work/coba_ei.py``);
- for each spike of row ``r``, its row generated: each of the row's 128
  streams (the configuration's 4 chunks x 32 lanes) tests once more
  whether its next column lies in its chunk (2), and each of the row's
  edges (its out-degree in the sampled matrix) costs 50: the stream's
  xorshift step (6), the bounded skip and the residual's update (3), the
  column and its test (3), the edge's hash (14), Acklam's central
  rational (22 in FMAs and 2 more), the weight's FMA (2) and the add
  into the target's input (1), taking every edge's weight from the
  central branch, the cheaper one.

Bytes: the five state arrays read once and written once (40 a neuron).
The sampled matrix is a function of the seed and needs no bytes; the
walk plan's streams and every re-read are left out.
"""

import torch

from benchmark_torch.harness import spec

OPS_PER_NEURON_STEP = 20
OPS_PER_STREAM = 2
OPS_PER_EDGE = 50
STATE_BYTES_PER_NEURON = 40


def reduce(cfg: dict, inputs: dict, out: dict) -> torch.Tensor:
    """What a trial's count needs of its final state, on the device: the
    spike count of each neuron (summed over the trials)."""
    return out['spike_count'].to(torch.int64)


def count(cfg: dict, inputs: dict, total: torch.Tensor, n_trials: int,
          n_steps: int):
    """``(operations, bytes)`` of *n_trials* trials of *n_steps* steps
    whose spike counts sum to *total*."""
    m = spec.load_module('reference', cfg['name']).matrix(cfg, inputs)
    num = inputs['num']
    degree = torch.cat([m['e']['out_degree'], m['i']['out_degree']])
    streams = cfg['walk']['stride'] * cfg['walk']['chunks']
    total = total.to(degree.device)
    ops = (OPS_PER_NEURON_STEP * num * n_steps * n_trials
           + OPS_PER_STREAM * streams * int(total.sum())
           + OPS_PER_EDGE * int((total * degree).sum()))
    return ops, STATE_BYTES_PER_NEURON * num * n_trials
