"""Plain reference of ``vogels_istdp``: Vogels, Sprekeler, Zenke, Clopath &
Gerstner 2011's recurrent network with inhibitory plasticity on its I -> E
synapses, as Brian 2's ``examples/frompapers/Vogels_et_al_2011.py`` sets
it up, in plain PyTorch float32 (TF32 off), from the configuration's
parameters alone.

The network is drawn on the device from the configuration's
``network_seed``, so that every seed of a run sees the one network
instance; the seed draws the trials' initial membranes. Every ordered pair
is a synapse with probability ``epsilon / scale``: each source's targets
are the running sums of geometric gaps ``floor(log1p(-u) (1 / log1p(-p)))
+ 1``, u uniform float64 in [0, 1), :data:`ROWS` rows of :func:`budget`
gaps at a time, in turn for the E neurons' rows over all neurons, the I
neurons' over the E neurons (the plastic rows, at positions ``[0, P)`` of
``targets``) and the I neurons' over the I neurons. Every plastic weight
starts at ``w0``.

A step ``t`` of neuron ``j``, every product and sum rounded once (Euler)::

    ga = ga + float(ring[t mod 2][0][j]) / U;  gg = gg + ... [1][j] / U
    ring[t mod 2][.][j] = 0;  if ref > 0: ref -= 1
    if ref == 0: v = v + (dt / C) (((I_bg - g_L (v - E_L)) - ga v)
                                   - gg (v - E_r))
    ga = (1 - dt / tau_ampa) ga;  gg = (1 - dt / tau_gaba) gg
    spike: ref == 0 and v > V_t: v = E_L, ref = t_ref / dt, count += 1
    A_post = exp(-dt / tau_stdp) A_post (E);  A_pre = exp(-dt /
    tau_stdp) A_pre + spike (I)

(``1 / U`` and the other constants float32), then Brian's pre pathway,
then its post pathway, then the E spikes into A_post:

1. each I -> E synapse i -> j of a spiking i: ``w = clip(w + eta (A_post_j
   - alpha), 0, g_max)``, A_post_j before j's spike, and ``rint(w U)``
   into ``ring[(t + 1) mod 2][1][j]``; each E synapse of a spike adds
   ``0.3 U`` into ``[0]``, each I -> I synapse ``3 U`` into ``[1]``;
2. each I -> E synapse i -> j of a spiking j: ``w = clip(w + eta A_pre_i,
   0, g_max)``;
3. ``A_post_j += 1`` at a spike of j.

Step by step in dynamic shapes, on the CPU and on a card alike. Nothing
here imports the program.
"""

import math

import numpy as np
import torch

FIELDS = ('v', 'g_ampa', 'g_gaba', 'ref', 'ring', 'spike_count', 'weights',
          'apre', 'apost')
FLOATS = ('v', 'g_ampa', 'g_gaba', 'weights', 'apre', 'apost')
ROWS = 4096
SDS = 10.0


def f32(x: float) -> float:
    return float(np.float32(x))


def sizes(cfg: dict, scale: float) -> tuple:
    """``(NE, NI)`` at *scale*, rounded."""
    net = cfg['network']
    return int(round(net['ne'] * scale)), int(round(net['ni'] * scale))


def budget(n: int, p: float) -> int:
    """The gaps drawn for a row over *n* targets: the mean degree and SDS
    standard deviations, plus 10."""
    mean = n * p
    return max(int(math.ceil(mean + SDS * math.sqrt(mean * (1 - p)) + 10)), 1)


def _rows(count: int, n: int, p: float, first: int, gen, device) -> tuple:
    """*count* rows over targets ``first + [0, n)``: (lengths, targets)."""
    m = budget(n, p)
    inv = 1.0 / math.log1p(-p) if p < 1.0 else 0.0
    lens, out = [], []
    for r0 in range(0, count, ROWS):
        u = torch.rand((min(ROWS, count - r0), m), generator=gen,
                       device=device, dtype=torch.float64)
        at = torch.cumsum(torch.floor(torch.log1p(-u) * inv).long() + 1,
                          1) - 1
        if bool((at[:, -1] < n).any()):
            raise RuntimeError('a row drew too few gaps')
        inside = at < n
        lens.append(inside.sum(1))
        out.append((at[inside] + first).int())
    return torch.cat(lens), torch.cat(out)


def network(cfg: dict, scale: float, device) -> dict:
    """The network at *scale*, drawn on *device* from ``network_seed``:
    ``targets``, ``plastic_ptr`` (NI + 1), ``static_ptr`` (N + 1, int32)
    and the initial ``weights`` (float32, P)."""
    net = cfg['network']
    gen = torch.Generator(device=device).manual_seed(cfg['network_seed'])
    ne, ni = sizes(cfg, scale)
    n, p = ne + ni, net['epsilon'] / scale
    len_e, t_e = _rows(ne, n, p, 0, gen, device)
    len_ie, t_ie = _rows(ni, ne, p, 0, gen, device)
    len_ii, t_ii = _rows(ni, ni, p, ne, gen, device)
    zero = torch.zeros(1, dtype=torch.int64, device=device)
    n_plastic = t_ie.numel()
    return dict(
        targets=torch.cat([t_ie, t_e, t_ii]),
        plastic_ptr=torch.cat([zero, torch.cumsum(len_ie, 0)]).int(),
        static_ptr=(n_plastic + torch.cat(
            [zero, torch.cumsum(torch.cat([len_e, len_ii]), 0)])).int(),
        weights=torch.full((n_plastic,), f32(net['w0']), device=device))


def columns(net: dict, ne: int) -> dict:
    """The plastic synapses by target: ``col_ptr`` (NE + 1), each entry's
    position ``col_pos`` and I source ``col_src``."""
    ptr = net['plastic_ptr'].long()
    tp = net['targets'][:int(ptr[-1])].long()
    order = torch.argsort(tp, stable=True)
    zero = torch.zeros(1, dtype=torch.int64, device=tp.device)
    src = torch.repeat_interleave(torch.arange(ptr.numel() - 1,
                                               device=tp.device),
                                  ptr[1:] - ptr[:-1])
    return dict(col_ptr=torch.cat([zero, torch.cumsum(torch.bincount(
        tp, minlength=ne), 0)]), col_pos=order, col_src=src[order])


def initial_states(cfg: dict, ne: int, num: int, weights, count: int,
                   gen: torch.Generator, device) -> list:
    """*count* initial states from *gen*: v uniform in ``[v0_low,
    v0_high]`` (float32 ``v0_low + (v0_high - v0_low) u``), the network's
    weights (one tensor for all), the rest 0."""
    init = cfg['initial_state']
    u = torch.rand((count, num), generator=gen, device=device)

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)
    lo, width = f32(init['v0_low']), f32(init['v0_high'] - init['v0_low'])
    return [dict(v=lo + width * u[c], g_ampa=zeros(num), g_gaba=zeros(num),
                 ref=zeros(num, dtype=torch.int32),
                 ring=zeros(2, 2, num, dtype=torch.int32),
                 spike_count=zeros(num, dtype=torch.int32), weights=weights,
                 apre=zeros(num - ne), apost=zeros(ne), step=0)
            for c in range(count)]


# -- the benchmark's interface

def make_inputs(cfg: dict, traffic: dict, seed: int, device) -> dict:
    """The network (from the configuration's ``network_seed``) and the
    trials' initial states (from *seed*), on *device*."""
    net = network(cfg, traffic['scale'], device)
    ne, ni = sizes(cfg, traffic['scale'])
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    states = initial_states(cfg, ne, ne + ni, net['weights'],
                            traffic['initial_states'], gen, device)
    return dict(program=dict(net), net=net, ne=ne, num=ne + ni,
                states=states)


class _Consts:
    """A run's constants, the float ones as *dtype*."""

    def __init__(self, cfg: dict, inputs: dict, dtype, device):
        nrn, net = cfg['neuron'], cfg['network']
        dt, units = nrn['dt'], net['weight_units']

        def s(x):
            return torch.tensor(f32(x), dtype=dtype, device=device)
        self.dt_c = s(dt / nrn['c_m'])
        self.g_l, self.e_l, self.e_r = s(nrn['g_l']), s(nrn['e_l']), s(
            nrn['e_r'])
        self.i_bg, self.v_t = s(nrn['i_bg']), s(nrn['v_t'])
        self.da = s(1.0 - dt / nrn['tau_ampa'])
        self.dg = s(1.0 - dt / nrn['tau_gaba'])
        self.q = s(1.0 / units)
        self.kd = s(math.exp(-dt / net['tau_stdp']))
        self.eta, self.alpha = s(net['eta']), s(net['alpha'])
        self.g_max, self.units = s(net['g_max']), s(units)
        self.ref_steps = int(round(nrn['t_ref'] / dt))
        self.w_e = int(round(net['w_e'] * units))
        self.w_ii = int(round(net['w_ii'] * units))
        self.ne, self.num = inputs['ne'], inputs['num']
        self.static_e_end = int(inputs['net']['static_ptr'][self.ne])


def _positions(ptr: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The positions of the rows *ids* of *ptr* (int64), row after row."""
    beg = ptr[ids]
    lens = ptr[ids + 1] - beg
    return (torch.repeat_interleave(beg - (torch.cumsum(lens, 0) - lens),
                                    lens)
            + torch.arange(int(lens.sum()), device=ptr.device))


def _clip(w, c: _Consts):
    w = torch.where(w > 0, w, 0.0)
    return torch.where(w < c.g_max, w, c.g_max)


def _step(s: dict, t: int, g: dict, c: _Consts) -> None:
    """One step at *t*, in place."""
    ne, num = c.ne, c.num
    ring = s['ring']
    x = ring[t % 2].clone()
    ring[t % 2] = 0
    ga = s['g_ampa'] + x[0].to(c.q.dtype) * c.q
    gg = s['g_gaba'] + x[1].to(c.q.dtype) * c.q
    ref = torch.where(s['ref'] > 0, s['ref'] - 1, s['ref'])
    live = ref == 0
    v = s['v']
    drive = ((c.i_bg - c.g_l * (v - c.e_l)) - ga * v) - gg * (v - c.e_r)
    v = torch.where(live, v + c.dt_c * drive, v)
    s['g_ampa'], s['g_gaba'] = c.da * ga, c.dg * gg
    spike = live & (v > c.v_t)
    s['v'] = torch.where(spike, c.e_l, v)
    s['ref'] = torch.where(spike, c.ref_steps, ref).int()
    s['spike_count'] = s['spike_count'] + spike
    post = c.kd * s['apost']
    s['apre'] = c.kd * s['apre'] + spike[ne:]
    late = ring[(t + 1) % 2]
    w = s['weights']
    ids = torch.nonzero(spike).flatten()
    ep = _positions(g['plastic_ptr'], ids[ids >= ne] - ne)
    if ep.numel():
        tg = g['targets'][ep].long()
        x = _clip(w[ep] + c.eta * (post[tg] - c.alpha), c)
        w[ep] = x
        late[1].index_add_(0, tg, torch.round(x * c.units).int())
    es = _positions(g['static_ptr'], ids)
    if es.numel():
        tg = g['targets'][es].long()
        from_e = es < c.static_e_end
        late[0].index_add_(0, tg[from_e], torch.full_like(
            tg[from_e], c.w_e, dtype=torch.int32))
        late[1].index_add_(0, tg[~from_e], torch.full_like(
            tg[~from_e], c.w_ii, dtype=torch.int32))
    e = _positions(g['col_ptr'], torch.nonzero(spike[:ne]).flatten())
    if e.numel():
        pos = g['col_pos'][e]
        w[pos] = _clip(w[pos] + c.eta * s['apre'][g['col_src'][e]], c)
    s['apost'] = post + spike[:ne]


def simulate(cfg: dict, traffic: dict, inputs: dict, state: dict,
             n_steps: int, dtype=torch.float32) -> dict:
    """One trial of *n_steps* from *state* (not modified); returns the
    final state's arrays (:data:`FIELDS`)."""
    device = state['v'].device
    c = _Consts(cfg, inputs, dtype, device)
    net = inputs['net']
    if 'columns' not in inputs:
        inputs['columns'] = columns(net, inputs['ne'])
    g = dict(net, **inputs['columns'])
    g = {k: (x.long() if k.endswith('ptr') else x) for k, x in g.items()}
    s = {k: state[k].to(dtype if k in FLOATS else state[k].dtype, copy=True)
         for k in FIELDS}
    for k in range(n_steps):
        _step(s, (state['step'] + k) & 0xFFFFFFFF, g, c)
    return {k: s[k] for k in FIELDS}


def compare(cfg: dict, inputs: dict, got: dict, want: dict) -> dict:
    """``{'<field>_mismatch': n}``: entries of each state array that differ
    from the reference's bit for bit (float arrays as float32; a missing
    or misshaped array counts every entry)."""
    out = {}
    for k in FIELDS:
        w = want[k]
        g = got.get(k)
        if g is None or g.shape != w.shape:
            out[f'{k}_mismatch'] = int(w.numel())
            continue
        g = g.to(w.device)
        if w.dtype.is_floating_point or g.dtype.is_floating_point:
            g = g.to(torch.float32).view(torch.int32)
            w = w.to(torch.float32).view(torch.int32)
        out[f'{k}_mismatch'] = int((g != w).sum())
    return out
