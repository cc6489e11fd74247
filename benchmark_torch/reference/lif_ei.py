"""The EI network's neuron step in plain PyTorch, shared by the references
of the EI configurations (``coba_ei``, ``jitc_coba_ei``).

Brette et al. 2007, Benchmark 1 (COBA): leaky integrate-and-fire neurons
with an absolute refractory period and exponential conductances,

    tau dv/dt = (v_rest - v) + r * (g_e (e_e - v) + g_i (e_i - v) + inp)
    dg/dt = -g / tau_syn, a spike adding w to each target's g

stepped by forward Euler at dt, in the order and roundings the
configuration states: each step decays the conductances (``g * d``, ``d =
float32(exp(-dt / tau_syn))``), computes the current from them, updates
the membrane of each neuron outside its refractory window, spikes at
``v >= v_th``, resets, and then folds this step's synaptic input into the
conductances the next step reads. The multiply-adds are single-rounding
FMAs (``torch.addcmul``)::

    current = fma(g_e*d_e, e_e - v, (g_i*d_i) * (e_i - v)) + inp
    v'      = fma((v_rest - v) + r*current, dt/tau, v)
    g'      = fma(g, d, input)

Nothing here imports the program.
"""

import dataclasses
import math

import numpy as np
import torch

FIELDS = ('v', 't_last', 'g_e', 'g_i', 'spike_count')


def f32(x: float) -> float:
    """*x* rounded to float32, as a Python float."""
    return float(np.float32(x))


@dataclasses.dataclass(frozen=True)
class Params:
    """The float32 constants of one configuration's step."""
    decay_e: float
    decay_i: float
    w_e: float
    w_i: float
    e_e: float
    e_i: float
    inp: float
    v_rest: float
    v_th: float
    v_reset: float
    tau_ref: float
    dt_tau: float
    r: float
    dt: float


def params(cfg: dict) -> Params:
    """The step's constants from a configuration file."""
    net, neuron = cfg['network'], cfg['neuron']
    if not net['coba']:
        raise ValueError('this reference steps conductance-based (COBA) '
                         'synapses only')
    dt = net['dt']
    return Params(
        decay_e=f32(math.exp(-dt / net['tau_e'])),
        decay_i=f32(math.exp(-dt / net['tau_i'])),
        w_e=f32(net['w_e']), w_i=f32(net['w_i']), e_e=f32(net['e_e']),
        e_i=f32(net['e_i']), inp=f32(cfg['drive']['inp']),
        v_rest=f32(neuron['v_rest']), v_th=f32(neuron['v_th']),
        v_reset=f32(neuron['v_reset']), tau_ref=f32(neuron['tau_ref']),
        dt_tau=f32(dt / neuron['tau']), r=f32(neuron['r']), dt=f32(dt))


def sizes(cfg: dict, scale: float):
    """``(n_exc, n_inh, num)`` of the network at *scale*."""
    n_exc = int(cfg['excitatory_per_4000'] * scale)
    n_inh = int(cfg['inhibitory_per_4000'] * scale)
    return n_exc, n_inh, n_exc + n_inh


def initial_states(cfg: dict, num: int, count: int,
                   gen: torch.Generator, device) -> list:
    """*count* initial states of *num* neurons from *gen*: ``v ~ N(v_mean,
    v_std)``, no neuron refractory, conductances and counts 0."""
    init = cfg['initial_state']
    z = torch.randn((count, num), generator=gen, device=device)
    states = []
    for k in range(count):
        zeros = torch.zeros(num, device=device)
        states.append(dict(
            v=init['v_mean'] + init['v_std'] * z[k],
            t_last=torch.full((num,), init['t_last'], device=device),
            g_e=zeros, g_i=zeros.clone(),
            spike_count=torch.zeros(num, dtype=torch.int32, device=device)))
    return states


def step_times(p: Params, n_steps: int, device) -> torch.Tensor:
    """``float32(i) * float32(dt)`` for ``i < n_steps``, from 0."""
    t = np.arange(n_steps, dtype=np.float32) * np.float32(p.dt)
    return torch.from_numpy(t).to(device)


class _Consts:
    """The step's constants as tensors of *dtype* on *device*."""

    def __init__(self, p: Params, dtype, device):
        self.p, self.dtype = p, dtype
        self.dt_tau = torch.full((), p.dt_tau, dtype=dtype, device=device)
        self.d_e = torch.full((), p.decay_e, dtype=dtype, device=device)
        self.d_i = torch.full((), p.decay_i, dtype=dtype, device=device)


def _step(s: dict, t: torch.Tensor, c: _Consts, propagate):
    """One step at time *t*: decay, current, membrane update, spike and
    reset, then ``propagate(spike) -> (input_e, input_i, n_spikes)`` and
    the fold. Returns the new state and ``n_spikes``."""
    p, v = c.p, s['v']
    current = torch.addcmul((s['g_i'] * p.decay_i) * (p.e_i - v),
                            s['g_e'] * p.decay_e, p.e_e - v) + p.inp
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
                if n is not None:
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


CHUNK = 100


def run(state: dict, p: Params, n_steps: int, make_propagate, cap: int,
        dtype=torch.float32) -> dict:
    """One trial of *n_steps* from *state* (not modified); returns the
    final state. ``make_propagate(cap)`` gives a step's propagation with
    static shapes for at most *cap* spikes a step. On a card the steps run
    as CUDA graphs of :data:`CHUNK` steps; a chunk in which a step spiked
    more than *cap* is run again from its start with *cap* doubled."""
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


def bit_mismatches(got: dict, want: dict) -> dict:
    """``{'<field>_mismatch': n}``: how many entries of each state array
    differ from the reference's bit for bit (float arrays compared as
    float32; a missing or misshaped array counts every entry)."""
    out = {}
    for k in FIELDS:
        w = want[k]
        g = got.get(k)
        if g is None or g.shape != w.shape:
            out[f'{k}_mismatch'] = int(w.numel())
            continue
        g, w = g.to(w.device), w
        if w.dtype.is_floating_point:
            g = g.to(torch.float32).view(torch.int32)
            w = w.to(torch.float32).view(torch.int32)
        out[f'{k}_mismatch'] = int((g != w).sum())
    return out
