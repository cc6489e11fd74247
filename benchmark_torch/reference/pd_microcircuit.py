"""Plain reference of ``pd_microcircuit``: the Potjans-Diesmann cortical
microcircuit (Potjans & Diesmann 2014), in plain PyTorch float32 (TF32
off), from the configuration's parameters alone.

The network is drawn on the device from the configuration's
``network_seed``, so that every seed of a run sees the one published
network instance; the seed draws the trials' initial states and their
Poisson keys. For each source population, then each target population,
its projection's ``K = round(log(1 - C) / log(1 - 1 / (N_pre N_post)))``
synapses: presynaptic and postsynaptic neurons uniform within their
populations, the weight ``N(mean, w_rel_sd |mean|)`` (drawn again on a
sign flip) rounded to int16 units of ``q = PSC_mean / weight_units``, the
delay ``N(mean, d_rel_sd mean)`` in steps (drawn again below one step)
rounded; then the source population's synapses in the order of their
source (a stable sort), as CSR rows.

A step ``t`` of neuron ``j``, ``V`` relative to ``E_L``::

    s = ring[t mod D][j];  ring[t mod D][j] = 0
    u = mix(mix(key ^ t * 0x9E3779B9) ^ j * 0x85EBCA6B)
    s += weight_units * #{m < 16 : u >= thr[pop(j)][m]}
    if ref == 0: V = fma(I, P21, V * P22)  else: ref -= 1
    I = fma(I, P11, q * float(s))
    if V >= V_th: V = V_reset, ref = t_ref / dt, count += 1, and each
        synapse (target, w, d) of row j adds w to ring[(t + d) mod D][target]

``mix`` is the light RNG's finalizer (:func:`jitc_coba_ei._mix`, uint32
in int64), ``thr[p][m] = floor(2^32 P(k <= m))`` of Poisson(``k_ext[p]
bg_rate dt``) in float64, and the ring's depth ``D`` the next power of two
above the largest delay. The multiply-adds are single-rounding FMAs
(``torch.addcmul``) and the ring holds exact int32 sums, so the
comparison is bit for bit.

On a card the steps run as CUDA graphs of :data:`CHUNK` steps whose
scatter has static budgets (:data:`SPIKES` spikes, :data:`SYNAPSES`
synapses a step); a chunk that overflows them is run again step by step
with the dynamic scatter the CPU uses. Nothing here imports the program.
"""

import math

import numpy as np
import torch

from benchmark_torch.reference.jitc_coba_ei import M32, _mix, _mul

FIELDS = ('v', 'i_syn', 'ref', 'ring', 'spike_count')
T_MUL = 0x9E3779B9
I_MUL = 0x85EBCA6B
CHUNK = 100
SPIKES = 256
SYNAPSES = 2 ** 19


def f32(x: float) -> float:
    return float(np.float32(x))


def sizes(cfg: dict, scale: float) -> list:
    """The populations' sizes at *scale*, rounded."""
    return [int(round(n * scale)) for n in cfg['network']['full_sizes']]


def synapse_counts(cfg: dict, n) -> np.ndarray:
    """Synapses of each projection (target x source)."""
    c = np.asarray(cfg['network']['conn_probs'], dtype=np.float64)
    k = np.zeros(c.shape, dtype=np.int64)
    for q, n_post in enumerate(n):
        for p, n_pre in enumerate(n):
            if n_pre and n_post:
                k[q, p] = int(np.round(np.log(1.0 - c[q, p]) / np.log(
                    1.0 - 1.0 / (float(n_pre) * float(n_post)))))
    return k


def psc_mean(cfg: dict) -> float:
    """The current (pA) whose PSP peaks at ``psp_mean``."""
    nrn = cfg['neuron']
    tm, ts = nrn['tau_m'], nrn['tau_syn']
    sub = 1.0 / (ts - tm)
    pre = tm * ts * sub / nrn['c_m']
    frac = (tm / ts) ** sub
    return cfg['network']['psp_mean'] / (pre * (frac ** tm - frac ** ts))


def thresholds(cfg: dict) -> list:
    """Each population's Poisson thresholds, uint32 as ints."""
    net = cfg['network']
    out = []
    for k_ext in net['k_ext']:
        lam = k_ext * net['bg_rate'] * cfg['neuron']['dt'] * 1e-3
        term, cdf, row = math.exp(-lam), 0.0, []
        for m in range(net['poisson_thresholds']):
            cdf += term
            term *= lam / (m + 1)
            row.append(min(math.floor(cdf * 2.0 ** 32), M32))
        out.append(row)
    return out


def network(cfg: dict, scale: float, device) -> dict:
    """The network at *scale*, drawn on *device* from ``network_seed``:
    ``row_ptr``, ``targets``, ``weights`` and ``delays``, and ``degree``
    (each neuron's synapses, int64)."""
    net, dt = cfg['network'], cfg['neuron']['dt']
    gen = torch.Generator(device=device).manual_seed(cfg['network_seed'])
    n = sizes(cfg, scale)
    k = synapse_counts(cfg, n)
    starts = np.concatenate([[0], np.cumsum(n)]).tolist()
    units = net['weight_units']

    def redrawn(mean, sd, bad, count):
        x = mean + sd * torch.randn(count, generator=gen, device=device)
        idx = torch.nonzero(bad(x)).flatten()
        while idx.numel():
            x[idx] = mean + sd * torch.randn(idx.numel(), generator=gen,
                                             device=device)
            idx = idx[bad(x[idx])]
        return x

    degree, cols = [], {'targets': [], 'weights': [], 'delays': []}
    for p, n_pre in enumerate(n):
        exc = net['excitatory'][p]
        d_mean = (net['d_mean_e'] if exc else net['d_mean_i']) / dt
        pre, parts = [], {'targets': [], 'weights': [], 'delays': []}
        for q, n_post in enumerate(n):
            count = int(k[q, p])
            if not count:
                continue
            pre.append(torch.randint(0, n_pre, (count,), generator=gen,
                                     device=device, dtype=torch.int32))
            parts['targets'].append(torch.randint(
                0, n_post, (count,), generator=gen, device=device,
                dtype=torch.int32) + starts[q])
            w_mean = float(units if exc else net['g'] * units)
            if (q, p) == (0, 2):
                w_mean *= net['l4e_to_l23e']
            w = redrawn(w_mean, net['w_rel_sd'] * abs(w_mean),
                        lambda x: x * w_mean <= 0, count)
            parts['weights'].append(torch.round(w).to(torch.int16))
            d = redrawn(d_mean, net['d_rel_sd'] * d_mean, lambda x: x < 1.0,
                        count)
            parts['delays'].append(torch.round(d).to(torch.uint8))
        if not pre:
            degree.append(torch.zeros(n_pre, dtype=torch.int64,
                                      device=device))
            continue
        pre = torch.cat(pre)
        order = torch.sort(pre, stable=True).indices
        degree.append(torch.bincount(pre, minlength=n_pre))
        for name, part in parts.items():
            cols[name].append(torch.cat(part)[order])
    degree = torch.cat(degree)
    row_ptr = torch.cat([torch.zeros(1, dtype=torch.int64, device=device),
                         torch.cumsum(degree, 0)])
    empty = {'targets': torch.int32, 'weights': torch.int16,
             'delays': torch.uint8}
    out = {name: torch.cat(c) if c else torch.zeros(0, dtype=empty[name],
                                                      device=device)
           for name, c in cols.items()}
    return dict(row_ptr=row_ptr.to(torch.int32), degree=degree, **out)


def initial_states(cfg: dict, num: int, depth: int, count: int,
                   gen: torch.Generator, device) -> list:
    """*count* initial states from *gen*: ``V ~ N(v0_mean, v0_sd) - E_L``
    in float32, a uniform uint32 Poisson key each, the rest 0."""
    init, e_l = cfg['initial_state'], cfg['neuron']['e_l']
    z = torch.randn((count, num), generator=gen, device=device)
    keys = torch.randint(0, 2 ** 32, (count,), generator=gen,
                         device=device).tolist()

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=device)
    return [dict(v=f32(init['v0_mean'] - e_l) + f32(init['v0_sd']) * z[c],
                 i_syn=torch.zeros(num, device=device), ref=zeros(num),
                 ring=zeros(depth, num), spike_count=zeros(num),
                 key=keys[c], step=0) for c in range(count)]


# -- the benchmark's interface

def make_inputs(cfg: dict, traffic: dict, seed: int, device) -> dict:
    """The network (from the configuration's ``network_seed``) and the
    trials' initial states (from *seed*), on *device*."""
    net = network(cfg, traffic['scale'], device)
    n = sizes(cfg, traffic['scale'])
    num = sum(n)
    max_delay = int(net['delays'].max()) if net['delays'].numel() else 1
    depth = 1 << max_delay.bit_length()
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    states = initial_states(cfg, num, depth, traffic['initial_states'], gen,
                            device)
    program = {k: net[k] for k in ('row_ptr', 'targets', 'weights', 'delays')}
    return dict(program=program, net=net, sizes=n, num=num, depth=depth,
                states=states)


class _Consts:
    """A run's constants: the step's float32 scalars as *dtype*, and per
    neuron its Poisson thresholds and its term of the hash."""

    def __init__(self, cfg: dict, inputs: dict, dtype, device):
        nrn, net = cfg['neuron'], cfg['network']
        p11 = math.exp(-nrn['dt'] / nrn['tau_syn'])
        p22 = math.exp(-nrn['dt'] / nrn['tau_m'])
        p21 = (nrn['tau_m'] * nrn['tau_syn']
               / (nrn['c_m'] * (nrn['tau_syn'] - nrn['tau_m'])) * (p11 - p22))
        self.dtype = dtype
        self.p11 = torch.tensor(f32(p11), dtype=dtype, device=device)
        self.p21 = torch.tensor(f32(p21), dtype=dtype, device=device)
        self.p22 = f32(p22)
        self.q = f32(psc_mean(cfg) / net['weight_units'])
        self.v_th = f32(nrn['v_th'] - nrn['e_l'])
        self.v_reset = f32(nrn['v_reset'] - nrn['e_l'])
        self.ref_steps = int(round(nrn['t_ref'] / nrn['dt']))
        self.w_ext = net['weight_units']
        num = inputs['num']
        pop = torch.repeat_interleave(
            torch.arange(len(inputs['sizes']), device=device),
            torch.tensor(inputs['sizes'], device=device))
        self.thr = torch.tensor(thresholds(cfg), dtype=torch.int64,
                                device=device)[pop]
        self.neuron_hash = _mul(torch.arange(num, device=device), I_MUL)
        self.depth = inputs['depth']


def _neurons(s: dict, slot: torch.Tensor, h: torch.Tensor, c: _Consts):
    """A step's neuron update, the ring's slot *slot* (a one-element index)
    read and cleared in place, *h* the step's hash; returns the new state
    (the same ring) and the spikes."""
    ring = s['ring']
    x = ring.index_select(0, slot).view(-1)
    ring.index_fill_(0, slot, 0)
    u = _mix(h ^ c.neuron_hash)
    x = x + ((u[:, None] >= c.thr).sum(1) * c.w_ext).to(torch.int32)
    live = s['ref'] == 0
    v = torch.where(live, torch.addcmul(s['v'] * c.p22, s['i_syn'], c.p21),
                    s['v'])
    ref = torch.where(live, s['ref'], s['ref'] - 1)
    i_syn = torch.addcmul(c.q * x.to(c.dtype), s['i_syn'], c.p11)
    spike = v >= c.v_th
    return dict(v=torch.where(spike, c.v_reset, v),
                i_syn=i_syn,
                ref=torch.where(spike, c.ref_steps, ref),
                ring=ring,
                spike_count=s['spike_count'] + spike), spike


def _add(ring: torch.Tensor, e: torch.Tensor, t, net: dict, depth: int):
    """The ring entries and int32 weights of the synapses *e* (indices
    into the rows) of a spike at step *t*."""
    num = ring.shape[1]
    idx = (((t + net['delays'][e].long()) & (depth - 1)) * num
           + net['targets'][e].long())
    return idx, net['weights'][e].to(torch.int32)


def _scatter(ring: torch.Tensor, spike: torch.Tensor, t: int, net: dict,
             depth: int) -> None:
    """The spikes' rows into the ring, in dynamic shapes."""
    ids = torch.nonzero(spike).flatten()
    if not ids.numel():
        return
    lens = net['degree'][ids]
    first = net['row_ptr'][ids].long() - (torch.cumsum(lens, 0) - lens)
    e = (torch.repeat_interleave(first, lens)
         + torch.arange(int(lens.sum()), device=ring.device))
    idx, w = _add(ring, e, t, net, depth)
    ring.view(-1).index_add_(0, idx, w)


class _Static:
    """The scatter of at most :data:`SPIKES` spikes and :data:`SYNAPSES`
    synapses a step, in static shapes: the spiking ids compacted by a
    prefix sum, each budget slot ``p`` of the synapses found in its row by
    a search of the rows' running lengths; a slot past the step's synapses
    adds 0 at its own ring entry. ``over`` becomes 1 where a step
    exceeded a budget."""

    def __init__(self, net: dict, num: int, depth: int, device):
        self.net, self.depth = net, depth
        self.neurons = torch.arange(num, device=device)
        self.slots = torch.arange(SPIKES + 1, device=device)
        self.budget = torch.arange(SYNAPSES, device=device)
        self.spare = self.budget % (depth * num)
        self.over = torch.zeros((), dtype=torch.int64, device=device)

    def __call__(self, ring, spike, t):
        num = ring.shape[1]
        pos = torch.cumsum(spike, 0)
        n = pos[-1]
        at = torch.where(spike & (pos <= SPIKES), pos - 1, SPIKES)
        ids = self.slots.clone().scatter_(0, at, self.neurons)[:SPIKES] % num
        lens = torch.where(self.slots[:SPIKES] < n, self.net['degree'][ids],
                           0)
        ends = torch.cumsum(lens, 0)
        which = torch.searchsorted(ends, self.budget, right=True).clamp_(
            max=SPIKES - 1)
        e = self.net['row_ptr'][ids[which]].long() + (
            self.budget - (ends[which] - lens[which]))
        valid = self.budget < ends[-1]
        e = torch.where(valid, e, 0)
        idx, w = _add(ring, e, t, self.net, self.depth)
        ring.view(-1).index_add_(0, torch.where(valid, idx, self.spare),
                                 torch.where(valid, w, 0))
        self.over.copy_(torch.maximum(self.over, (
            (n > SPIKES) | (ends[-1] > SYNAPSES)).long()))


class _Chunk:
    """*k* steps captured as one CUDA graph over static state buffers."""

    def __init__(self, s: dict, c: _Consts, net: dict, k: int):
        self.c = c
        self.state = {key: x.clone() for key, x in s.items()}
        device = s['v'].device
        self.t = torch.zeros(k, dtype=torch.int64, device=device)
        self.h = torch.zeros(k, dtype=torch.int64, device=device)
        self.scatter = _Static(net, s['v'].numel(), c.depth, device)

        def body():
            cur = dict(self.state)
            for i in range(k):
                cur, spike = _neurons(cur, self.t[i:i + 1] & (c.depth - 1),
                                      self.h[i], c)
                self.scatter(cur['ring'], spike, self.t[i])
            for key in FIELDS:
                if key != 'ring':
                    self.state[key].copy_(cur[key])
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            body()
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            body()

    def replay(self, s: dict, t: torch.Tensor, h: torch.Tensor) -> bool:
        """The chunk from *s* (not modified); whether a step overflowed."""
        for key in FIELDS:
            self.state[key].copy_(s[key])
        self.t.copy_(t)
        self.h.copy_(h)
        self.scatter.over.zero_()
        self.graph.replay()
        return bool(self.scatter.over)


def _eager(s: dict, c: _Consts, net: dict, t: torch.Tensor,
           h: torch.Tensor) -> dict:
    """The steps at *t* from *s* (not modified), one at a time."""
    s = {key: x.clone() for key, x in s.items()}
    for i, step in enumerate(t.tolist()):
        slot = t[i:i + 1] & (c.depth - 1)
        s, spike = _neurons(s, slot, h[i], c)
        _scatter(s['ring'], spike, step, net, c.depth)
    return s


def simulate(cfg: dict, traffic: dict, inputs: dict, state: dict,
             n_steps: int, dtype=torch.float32) -> dict:
    """One trial of *n_steps* from *state* (not modified); returns the
    final state's five arrays."""
    device = state['v'].device
    c = _Consts(cfg, inputs, dtype, device)
    net = inputs['net']
    s = {k: state[k].to(dtype if k in ('v', 'i_syn') else torch.int32,
                        copy=True) for k in FIELDS}
    t = (state['step'] + torch.arange(n_steps, device=device)) & M32
    h = _mix(state['key'] ^ _mul(t, T_MUL))
    if device.type != 'cuda':
        return _eager(s, c, net, t, h)
    chunks = {}
    for pos in range(0, n_steps, CHUNK):
        k = min(CHUNK, n_steps - pos)
        if k not in chunks:
            chunks[k] = _Chunk(s, c, net, k)
        chunk = chunks[k]
        if chunk.replay(s, t[pos:pos + k], h[pos:pos + k]):
            s = _eager(s, c, net, t[pos:pos + k], h[pos:pos + k])
        else:
            s = {key: x.clone() for key, x in chunk.state.items()}
    return s


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
