"""Plain reference of ``coba_ei``: the Brette COBA network over a stored
table of 80 targets a neuron, in plain PyTorch float32 (TF32 off).

The benchmark draws the table and the trials' initial states from its
seed, on the device, and gives both to the program and to this reference.
Each step spikes as :mod:`lif_ei` sets out; each spike of neuron ``i``
adds one hit to each of its table row's targets, on the excitatory
channel for ``i < n_exc`` and the inhibitory one above; the hits are
counted exactly (integers in float32) and scaled after the sum, ``w *
hits``, before the fold. The comparison is bit for bit.

On a card the steps run as CUDA graphs (see :func:`lif_ei.run`), so the
spiking ids are compacted in static shapes rather than by ``nonzero``,
which would wait for the device every step.
"""

import torch

from benchmark_torch.reference.lif_ei import (
    bit_mismatches, initial_states, params, run, sizes)


def make_inputs(cfg: dict, traffic: dict, seed: int, device) -> dict:
    """The table and the trials' initial states from *seed*, on *device*
    (one generator, two calls)."""
    n_exc, _, num = sizes(cfg, traffic['scale'])
    n_conn = min(cfg['network']['n_conn'], num)
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    conn = torch.randint(0, num, (num, n_conn), generator=gen,
                         device=device, dtype=torch.int32)
    states = initial_states(cfg, num, traffic['initial_states'], gen, device)
    return dict(program={'conn_all': conn}, conn=conn, n_exc=n_exc, num=num,
                states=states)


def propagation(conn: torch.Tensor, n_exc: int, p, cap: int):
    """A step's propagation for at most *cap* spikes, in static shapes:
    the spiking ids compacted by a prefix sum into *cap* slots; an empty
    slot ``j`` adds row ``j`` with weight 0 (distinct rows, so that the
    zeros do not pile onto one row's targets); returns ``(w_e * hits_e,
    w_i * hits_i, n_spikes)``."""
    num, n_conn = conn.shape
    device = conn.device
    neurons = torch.arange(num, device=device)
    slots = torch.arange(cap + 1, device=device)

    def propagate(spike):
        pos = torch.cumsum(spike, 0)
        n_spikes = pos[-1]
        slot = torch.where(spike & (pos <= cap), pos - 1, cap)
        ids = slots.clone().scatter_(0, slot, neurons)[:cap] % num
        used = (slots[:cap] < n_spikes).to(torch.float32)
        targets = conn[ids].long() + ((ids >= n_exc).long() * num)[:, None]
        hits = torch.zeros(2 * num, dtype=torch.float32, device=device)
        hits.index_add_(0, targets.reshape(-1),
                        used[:, None].expand(cap, n_conn).reshape(-1))
        return p.w_e * hits[:num], p.w_i * hits[num:], n_spikes
    return propagate


def simulate(cfg: dict, traffic: dict, inputs: dict, state: dict,
             n_steps: int, dtype=torch.float32) -> dict:
    """One trial of *n_steps* from *state*; returns the final state."""
    p = params(cfg)
    conn, n_exc = inputs['conn'], inputs['n_exc']
    return run(state, p, n_steps,
               lambda cap: propagation(conn, n_exc, p, cap),
               cap=min(inputs['num'], max(256, inputs['num'] // 128)),
               dtype=dtype)


def compare(cfg: dict, inputs: dict, got: dict, want: dict) -> dict:
    """Entries of each state array that differ from the reference's."""
    return bit_mismatches(got, want)
