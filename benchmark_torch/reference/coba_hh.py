"""Plain reference of ``coba_hh``: Brette et al. 2007's Benchmark 3
(COBAHH), a Hodgkin-Huxley EI network with exponential conductances, over
``coba_ei``'s stored table of 80 targets a neuron, in plain PyTorch float32
(TF32 off).

Each neuron (Traub and Miles's channels, as Brian 2's ``examples/COBAHH.py``
writes them; v in mV, rates in 1/ms, conductances in nS, C_m in pF)::

    C_m dv/dt = g_L(E_L - v) - g_e(v - E_e) - g_i(v - E_i)
                - g_Na m^3 h (v - E_Na) - g_Kd n^4 (v - E_K)
    dx/dt = alpha_x (1 - x) - beta_x x,  x in m, h, n
    dg/dt = -g / tau_syn

is advanced by exponential Euler (Brian's ``exponential_euler``): every
variable from the step's old state, each equation linear in its own
variable, ``x' = x_inf + (x - x_inf) exp(-dt / tau_x)``. With ``d = v -
V_T`` and each rate's argument ``a = (o - d) * s`` (the configuration's
``c``, ``o`` and ``s`` of each rate, ``s`` a float32 constant in place of
a division by 4, 5, 18 or 40)::

    alpha_m, beta_m, alpha_n = c / exprel(a)   exprel(0) = 1, else
                                               expm1(a) / a
    alpha_h, beta_n          = c * exp(a)
    beta_h                   = c / (1 + exp(a))
    gate:  s = alpha + beta;  x_inf = alpha / s
           x' = x_inf + (x - x_inf) * exp(s * -dt)
    membrane: g_Na m^3 h = g_Na * (((m*m)*m)*h),
              g_Kd n^4 = g_Kd * ((n*n)*(n*n))
           den = (((g_L + g_e) + g_i) + g_Na m^3 h) + g_Kd n^4
           num = (((g_L E_L + g_e E_e) + g_i E_i) + g_Na m^3 h E_Na)
                 + g_Kd n^4 E_K
           v_inf = num / den;  v' = v_inf + (v - v_inf) * exp(den * -dt/C_m)
    conductances: g' = g * float32(exp(-dt / tau_syn))

each product, sum and quotient rounded once, no FMA. A neuron spikes at
``v' > v_spike`` while it is armed; its spike disarms it, and a step that
ends at ``v' <= v_spike`` arms it again (Brian's ``refractory='v >
-20*mV'``); there is no reset. Each spike of neuron ``i`` adds one hit to
each of its table row's targets (``coba_ei.propagation``: exact counts,
scaled after the sum), and the hits enter the conductances the next step
reads: ``g = g' + w * hits``, every step.

On a card the steps run as CUDA graphs of :data:`CHUNK` steps, as
``lif_ei.run`` runs COBA's. No constant divides or is divided by a Python
number: ``torch`` turns ``x / c`` on a card and ``c / x`` everywhere into
a product with a reciprocal, a second rounding; each such quotient here
divides tensors.

Nothing here imports the program.
"""

import dataclasses
import math

import torch

from benchmark_torch.reference.coba_ei import propagation
from benchmark_torch.reference.lif_ei import f32, sizes

__all__ = ['make_inputs', 'params', 'simulate', 'compare', 'rates']

FIELDS = ('v', 'm', 'h', 'n', 'g_e', 'g_i', 'armed', 'spike_count')
# the rates in their order, each with the form of its function
RATES = ('alpha_m', 'beta_m', 'alpha_h', 'beta_h', 'alpha_n', 'beta_n')
FORMS = ('exprel', 'exprel', 'exp', 'sigmoid', 'exprel', 'exp')
CHUNK = 100


@dataclasses.dataclass(frozen=True)
class Params:
    """The float32 constants of one configuration's step."""
    v_t: float
    g_l: float
    gl_el: float
    e_e: float
    e_i: float
    e_na: float
    e_k: float
    g_na: float
    g_k: float
    neg_dt: float
    neg_dt_c: float
    decay_e: float
    decay_i: float
    w_e: float
    w_i: float
    v_spike: float
    rates: tuple      # (c, o, s) of each rate of RATES


def params(cfg: dict) -> Params:
    """The step's constants from a configuration file."""
    net, neuron = cfg['network'], cfg['neuron']
    dt = net['dt']
    return Params(
        v_t=f32(neuron['v_t']), g_l=f32(neuron['g_l']),
        gl_el=f32(neuron['g_l'] * neuron['e_l']), e_e=f32(net['e_e']),
        e_i=f32(net['e_i']), e_na=f32(neuron['e_na']),
        e_k=f32(neuron['e_k']), g_na=f32(neuron['g_na']),
        g_k=f32(neuron['g_kd']), neg_dt=f32(-dt),
        neg_dt_c=f32(-dt / neuron['c_m']),
        decay_e=f32(math.exp(-dt / net['tau_e'])),
        decay_i=f32(math.exp(-dt / net['tau_i'])),
        w_e=f32(net['w_e']), w_i=f32(net['w_i']),
        v_spike=f32(neuron['v_spike']),
        rates=tuple(tuple(f32(cfg['gates'][r][k]) for k in 'cos')
                    for r in RATES))


def initial_states(cfg: dict, num: int, count: int, gen: torch.Generator,
                   device) -> list:
    """*count* initial states of *num* neurons from *gen*, as Brian's
    example draws them: ``v = E_L + (5 z - 5)``, ``g_e = 10 (1.5 z + 4)``,
    ``g_i = 10 (12 z + 20)`` (z standard normal, float32 arithmetic; a
    negative g_i is kept), the gates 0, armed where ``v <= v_spike``."""
    init, neuron = cfg['initial_state'], cfg['neuron']
    z = torch.randn((count, 3, num), generator=gen, device=device)
    states = []
    for k in range(count):
        v = neuron['e_l'] + (init['v_sd'] * z[k, 0] + init['v_shift'])
        zeros = torch.zeros(num, device=device)
        states.append(dict(
            v=v, m=zeros, h=zeros.clone(), n=zeros.clone(),
            g_e=init['g_e_scale'] * (init['g_e_sd'] * z[k, 1]
                                     + init['g_e_mean']),
            g_i=init['g_i_scale'] * (init['g_i_sd'] * z[k, 2]
                                     + init['g_i_mean']),
            armed=v <= neuron['v_spike'],
            spike_count=torch.zeros(num, dtype=torch.int32, device=device)))
    return states


def make_inputs(cfg: dict, traffic: dict, seed: int, device) -> dict:
    """The table and the trials' initial states from *seed*, on *device*
    (one generator: ``coba_ei``'s table draw, then the states)."""
    n_exc, _, num = sizes(cfg, traffic['scale'])
    n_conn = min(cfg['network']['n_conn'], num)
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    conn = torch.randint(0, num, (num, n_conn), generator=gen,
                         device=device, dtype=torch.int32)
    states = initial_states(cfg, num, traffic['initial_states'], gen, device)
    return dict(program={'conn_all': conn}, conn=conn, n_exc=n_exc, num=num,
                states=states)


class _Consts:
    """The constants that divide, as 0-dim tensors of *dtype* on
    *device*: ``c / x`` with a tensor ``c`` is one rounded quotient."""

    def __init__(self, p: Params, dtype, device):
        self.p, self.dtype = p, dtype
        self.c = [torch.tensor(c, dtype=dtype, device=device)
                  for c, _, _ in p.rates]


def rates(v: torch.Tensor, c: _Consts) -> list:
    """The six rates of RATES at membrane *v* (1/ms)."""
    d = v - c.p.v_t
    out = []
    for (_, o, s), ct, form in zip(c.p.rates, c.c, FORMS):
        a = (o - d) * s
        if form == 'exprel':
            exprel = torch.where(a == 0, 1.0, torch.expm1(a) / a)
            out.append(torch.div(ct, exprel))
        elif form == 'exp':
            out.append(ct * torch.exp(a))
        else:
            out.append(torch.div(ct, 1.0 + torch.exp(a)))
    return out


def _gate(x, alpha, beta, p: Params):
    s = alpha + beta
    x_inf = alpha / s
    return x_inf + (x - x_inf) * torch.exp(s * p.neg_dt)


def _step(s: dict, c: _Consts, propagate):
    """One step: every variable from the old state, the spike test, then
    ``propagate(spike) -> (input_e, input_i, n_spikes)`` and the fold.
    Returns the new state and ``n_spikes``."""
    p = c.p
    v, m, h, n, g_e, g_i = (s[k] for k in ('v', 'm', 'h', 'n', 'g_e',
                                           'g_i'))
    am, bm, ah, bh, an, bn = rates(v, c)
    gna = p.g_na * (m * m * m * h)
    n2 = n * n
    gk = p.g_k * (n2 * n2)
    den = p.g_l + g_e + g_i + gna + gk
    num = p.gl_el + g_e * p.e_e + g_i * p.e_i + gna * p.e_na + gk * p.e_k
    v_inf = num / den
    vn = v_inf + (v - v_inf) * torch.exp(den * p.neg_dt_c)
    spike = s['armed'] & (vn > p.v_spike)
    in_e, in_i, n_spikes = propagate(spike)
    return dict(
        v=vn, m=_gate(m, am, bm, p), h=_gate(h, ah, bh, p),
        n=_gate(n, an, bn, p),
        g_e=g_e * p.decay_e + in_e.to(c.dtype),
        g_i=g_i * p.decay_i + in_i.to(c.dtype),
        armed=(s['armed'] & ~spike) | (vn <= p.v_spike),
        spike_count=s['spike_count'] + spike), n_spikes


class _Chunk:
    """*k* steps captured as one CUDA graph over static state buffers;
    ``peak`` holds the largest spike count a step of the replay saw."""

    def __init__(self, s: dict, c: _Consts, propagate, k: int):
        # the graph reads the tensors that c and propagate hold: keep them
        self.c, self.propagate = c, propagate
        self.state = {key: x.clone() for key, x in s.items()}
        self.peak = torch.zeros((), dtype=torch.int64, device=s['v'].device)

        def body():
            cur = dict(self.state)
            for _ in range(k):
                cur, n = _step(cur, c, propagate)
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

    def replay(self, s: dict) -> int:
        for key in FIELDS:
            self.state[key].copy_(s[key])
        self.peak.zero_()
        self.graph.replay()
        return int(self.peak)


def _spiking_rows(conn: torch.Tensor, n_exc: int, p: Params):
    """A step's propagation off the card: the rows of the spiking ids
    (``nonzero``), the hits counted by ``bincount``; returns ``(w_e *
    hits_e, w_i * hits_i, n_spikes)``, the counts exact as
    ``coba_ei.propagation``'s."""
    num = conn.shape[0]

    def propagate(spike):
        ids = torch.nonzero(spike).flatten()
        targets = conn[ids].long() + ((ids >= n_exc).long() * num)[:, None]
        hits = torch.bincount(targets.flatten(), minlength=2 * num).to(
            torch.float32)
        return p.w_e * hits[:num], p.w_i * hits[num:], ids.numel()
    return propagate


def _state(state: dict, dtype) -> dict:
    kinds = dict(armed=torch.bool, spike_count=torch.int32)
    return {k: state[k].to(kinds.get(k, dtype), copy=True) for k in FIELDS}


def simulate(cfg: dict, traffic: dict, inputs: dict, state: dict,
             n_steps: int, dtype=torch.float32) -> dict:
    """One trial of *n_steps* from *state* (not modified); returns the
    final state. On a card the steps run as CUDA graphs of :data:`CHUNK`
    steps; a chunk in which a step spiked more than its propagation's
    capacity is run again from its start with the capacity doubled."""
    p = params(cfg)
    conn, n_exc, num = inputs['conn'], inputs['n_exc'], inputs['num']
    device = conn.device
    c = _Consts(p, dtype, device)
    s = _state(state, dtype)
    if device.type != 'cuda':
        propagate = _spiking_rows(conn, n_exc, p)
        for _ in range(n_steps):
            s, _ = _step(s, c, propagate)
        return s
    cap = min(num, max(256, num // 128))
    chunks = {}
    pos = 0
    while pos < n_steps:
        k = min(CHUNK, n_steps - pos)
        if (k, cap) not in chunks:
            chunks[k, cap] = _Chunk(s, c, propagation(conn, n_exc, p, cap),
                                    k)
        chunk = chunks[k, cap]
        if chunk.replay(s) > cap:
            cap = min(2 * cap, num)
            continue
        s = {key: x.clone() for key, x in chunk.state.items()}
        pos += k
    return s


def compare(cfg: dict, inputs: dict, got: dict, want: dict) -> dict:
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
        g = g.to(w.device)
        if w.dtype.is_floating_point:
            g = g.to(torch.float32).view(torch.int32)
            w = w.to(torch.float32).view(torch.int32)
        out[f'{k}_mismatch'] = int((g != w).sum())
    return out
