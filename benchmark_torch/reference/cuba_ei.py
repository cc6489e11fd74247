"""Plain reference of ``cuba_ei``: the current-based (CUBA) EI network
over a stored table of 80 targets a neuron, in plain PyTorch float32
(TF32 off).

The table and the trials' initial states are those of ``coba_ei``
(:func:`coba_ei.make_inputs`, one draw from the seed), and so is the
propagation: each spike adds one hit to each of its row's
targets, counted exactly and scaled after the sum. Only the synaptic
current differs. The excitatory and inhibitory currents decay and enter
the membrane's equation as they are, with no reversal potentials::

    current = fma(g_e, d_e, -(g_i * d_i)) + inp
    v'      = fma((v_rest - v) + r*current, dt/tau, v)
    g'      = fma(g, d, input)

``torch.addcmul`` is the single-rounding FMA. The comparison is bit for
bit, as in ``coba_ei``. On a card the steps run as CUDA graphs of
:data:`lif_ei.CHUNK` steps, as :func:`lif_ei.run` runs COBA's.

Nothing here imports the program.
"""

import math

import torch

from benchmark_torch.reference.coba_ei import make_inputs, propagation
from benchmark_torch.reference.lif_ei import (
    CHUNK, FIELDS, Params, _Consts, bit_mismatches, f32, step_times)

__all__ = ['make_inputs', 'params', 'simulate', 'compare']


def params(cfg: dict) -> Params:
    """The step's float32 constants from a CUBA configuration file; CUBA
    has no reversal potentials, so ``e_e`` and ``e_i`` are NaN."""
    net, neuron = cfg['network'], cfg['neuron']
    if net['coba']:
        raise ValueError('this reference steps current-based (CUBA) '
                         'synapses only')
    dt = net['dt']
    return Params(
        decay_e=f32(math.exp(-dt / net['tau_e'])),
        decay_i=f32(math.exp(-dt / net['tau_i'])),
        w_e=f32(net['w_e']), w_i=f32(net['w_i']), e_e=math.nan,
        e_i=math.nan, inp=f32(cfg['drive']['inp']),
        v_rest=f32(neuron['v_rest']), v_th=f32(neuron['v_th']),
        v_reset=f32(neuron['v_reset']), tau_ref=f32(neuron['tau_ref']),
        dt_tau=f32(dt / neuron['tau']), r=f32(neuron['r']), dt=f32(dt))


def _step(s: dict, t: torch.Tensor, c: _Consts, propagate):
    """One CUBA step at time *t*: the current from the decayed currents,
    the membrane update, spike and reset, then ``propagate(spike) ->
    (input_e, input_i, n_spikes)`` and the fold. Returns the new state
    and ``n_spikes``."""
    p, v = c.p, s['v']
    current = torch.addcmul(-(s['g_i'] * p.decay_i), s['g_e'], c.d_e) + p.inp
    refractory = (t - s['t_last']) < p.tau_ref
    x = (p.v_rest - v) + p.r * current
    vn = torch.where(refractory, v, torch.addcmul(v, x, c.dt_tau))
    spike = vn >= p.v_th
    in_e, in_i, n_spikes = propagate(spike)
    return dict(
        v=torch.where(spike, p.v_reset, vn),
        t_last=torch.where(spike, t.to(c.dtype), s['t_last']),
        g_e=torch.addcmul(in_e.to(c.dtype), s['g_e'], c.d_e),
        g_i=torch.addcmul(in_i.to(c.dtype), s['g_i'], c.d_i),
        spike_count=s['spike_count'] + spike), n_spikes


class _Chunk:
    """*k* steps captured as one CUDA graph over static state buffers;
    ``peak`` holds the largest spike count a step of the replay saw."""

    def __init__(self, s: dict, c: _Consts, propagate, k: int):
        # the graph reads the tensors that c and propagate hold: keep them
        self.c, self.propagate = c, propagate
        self.state = {key: x.clone() for key, x in s.items()}
        self.t = torch.zeros(k, dtype=torch.float32, device=s['v'].device)
        self.peak = torch.zeros((), dtype=torch.int64, device=s['v'].device)

        def body():
            cur = dict(self.state)
            for i in range(k):
                cur, n = _step(cur, self.t[i], c, propagate)
                self.peak.copy_(torch.maximum(self.peak, n))
            for key in FIELDS:
                self.state[key].copy_(cur[key])
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            body()
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            body()

    def replay(self, s: dict, times: torch.Tensor) -> int:
        for key in FIELDS:
            self.state[key].copy_(s[key])
        self.t.copy_(times)
        self.peak.zero_()
        self.graph.replay()
        return int(self.peak)


def _run(state: dict, p: Params, n_steps: int, make_propagate, cap: int,
         dtype) -> dict:
    """One trial of *n_steps* from *state* (not modified); returns the
    final state. On a card the steps run as CUDA graphs of ``CHUNK``
    steps with static shapes for at most *cap* spikes a step; a chunk in
    which a step spiked more than *cap* is run again from its start with
    *cap* doubled."""
    device = state['v'].device
    c = _Consts(p, dtype, device)
    s = {k: state[k].to(torch.int32 if k == 'spike_count' else dtype,
                        copy=True) for k in FIELDS}
    times = step_times(p, n_steps, device)
    if device.type != 'cuda':
        propagate = make_propagate(s['v'].numel())
        for k in range(n_steps):
            s, _ = _step(s, times[k], c, propagate)
        return s
    chunks = {}
    pos = 0
    while pos < n_steps:
        k = min(CHUNK, n_steps - pos)
        if (k, cap) not in chunks:
            chunks[k, cap] = _Chunk(s, c, make_propagate(cap), k)
        chunk = chunks[k, cap]
        if chunk.replay(s, times[pos:pos + k]) > cap:
            cap = min(2 * cap, s['v'].numel())
            continue
        s = {key: x.clone() for key, x in chunk.state.items()}
        pos += k
    return s


def simulate(cfg: dict, traffic: dict, inputs: dict, state: dict,
             n_steps: int, dtype=torch.float32) -> dict:
    """One trial of *n_steps* from *state*; returns the final state."""
    p = params(cfg)
    conn, n_exc = inputs['conn'], inputs['n_exc']
    return _run(state, p, n_steps,
                lambda cap: propagation(conn, n_exc, p, cap),
                cap=min(inputs['num'], max(256, inputs['num'] // 128)),
                dtype=dtype)


def compare(cfg: dict, inputs: dict, got: dict, want: dict) -> dict:
    """Entries of each state array that differ from the reference's."""
    return bit_mismatches(got, want)
