"""Plain reference of ``hpc_stdp``: NEST's HPC benchmark network with
power-law STDP (Morrison, Aertsen & Diesmann 2007; NEST's
``hpc_benchmark.py``), in plain PyTorch float32 (TF32 off), from the
configuration's parameters alone.

The network is drawn on the device from the configuration's
``network_seed``, so that every seed of a run sees the one network
instance; the seed draws the trials' initial states and their Poisson
keys. In turn: each E neuron's CE sources uniform over the E neurons, each
I neuron's CE E sources, each neuron's CI I sources (with replacement, in
the order of the targets), then the E -> E weights ``JE_pA + sigma_w
N(0, 1)`` in the order of the plastic rows. Each group is put in the order
of its source (a stable sort): the plastic E -> E rows at positions ``[0,
P)`` of ``targets``, then the static rows (E -> I, then I -> E and I -> I)
from ``P`` on.

A step ``t`` of neuron ``j``, every product and sum rounded once::

    s = ring[t mod D][j] + 4096 #{m < 16 : u >= thr[m]};  ring[t mod D][j] = 0
    if r == 0: V = ((P31 dI + P32 I) + expm1(-h/tau_m) V) + V  else r -= 1
    I = P21 dI + P11 I;  dI = P11 dI + (e / tau_syn) (JE_pA / 4096) s
    if V >= V_th: V = V_reset, r = t_ref / h, count += 1

``u = mix(mix(key ^ t * 0x9E3779B9) ^ j * 0x85EBCA6B)`` and ``thr[m] =
floor(2^32 P(k <= m))`` of Poisson(``eta nu_th CE h``). Then, for the E
neurons, K+ and K- decay by ``exp(-h/tau)``, K- (before the step's spike)
is kept at ``khist[t mod D]``, and:

1. each E -> E synapse i -> j whose j spiked at step ``t - d``:
   ``w = w + (lambda w^mu) K+_i`` (K+_i of step t, before i's spike);
2. each E -> E synapse i -> j whose i spikes at t:
   ``w = max(w - (lambda alpha w) khist[(t - d) mod D][j], 0)``; and each
   synapse of a spike at t adds to ``ring[(t + d) mod D][j]`` 4096 (E ->
   I), -20480 (I) or ``rint(w 4096 / JE_pA)`` (E -> E);
3. the spikes of t add 1 to K+ and K-; ``spiked[t mod D]`` holds them.

On a card the steps run as CUDA graphs of :data:`CHUNK` steps with static
budgets (:data:`SPIKES` spikes, :data:`COLUMNS` facilitations,
:data:`PLASTIC` depressions and :data:`STATIC` static synapses a step); a
chunk that overflows one is run again step by step with the dynamic
shapes the CPU uses. Nothing here imports the program.
"""

import math

import numpy as np
import torch

from benchmark_torch.reference.jitc_coba_ei import M32, _mix, _mul

FIELDS = ('v', 'i_syn', 'di', 'ref', 'ring', 'spike_count', 'weights',
          'kplus', 'khist', 'spiked')
FLOATS = ('v', 'i_syn', 'di', 'weights', 'kplus', 'khist')
T_MUL = 0x9E3779B9
I_MUL = 0x85EBCA6B
CHUNK = 100
SPIKES = 1024
COLUMNS = 2 ** 21
PLASTIC = 2 ** 21
STATIC = 2 ** 21


def f32(x: float) -> float:
    return float(np.float32(x))


def sizes(cfg: dict, scale: float) -> tuple:
    """``(NE, NI)`` at *scale*, rounded."""
    net = cfg['network']
    return int(round(net['ne'] * scale)), int(round(net['ni'] * scale))


def _wm1(x: float) -> float:
    """Lambert's W, lower branch, at -1/e < x < 0 (Newton in float64)."""
    w = math.log(-x) - math.log(-math.log(-x))
    for _ in range(100):
        step = (w * math.exp(w) - x) / (math.exp(w) * (w + 1.0))
        w -= step
        if abs(step) < 1e-16 * abs(w):
            break
    return w


def je_pa(cfg: dict) -> float:
    """The current (pA) whose PSP peaks at JE (``convert_synapse_weight``
    of ``hpc_benchmark.py``)."""
    nrn = cfg['neuron']
    tm, ts, c = nrn['tau_m'], nrn['tau_syn'], nrn['c_m']
    a, b = tm / ts, 1.0 / ts - 1.0 / tm
    t_rise = 1.0 / b * (-_wm1(-math.exp(-1.0 / a) / a) - 1.0 / a)
    v_max = (math.e / (ts * c * b)
             * ((math.exp(-t_rise / tm) - math.exp(-t_rise / ts)) / b
                - t_rise * math.exp(-t_rise / ts)))
    return cfg['network']['je'] / v_max


def poisson_lambda(cfg: dict) -> float:
    """The mean Poisson events a step: ``eta nu_th CE`` Hz times h."""
    net, nrn = cfg['network'], cfg['neuron']
    nu_th = nrn['v_th'] / (net['ce'] * nrn['tau_m'] / nrn['c_m'] * je_pa(cfg)
                           * math.e * nrn['tau_syn'])
    return net['eta'] * nu_th * net['ce'] * 1000.0 * nrn['dt'] * 1e-3


def thresholds(cfg: dict) -> list:
    """The uint32 thresholds of the Poisson draw (ints)."""
    lam = poisson_lambda(cfg)
    term, cdf, out = math.exp(-lam), 0.0, []
    for m in range(cfg['network']['poisson_thresholds']):
        cdf += term
        term *= lam / (m + 1)
        out.append(min(math.floor(cdf * 2.0 ** 32), M32))
    return out


def propagators(cfg: dict) -> tuple:
    """NEST's ``propagator_31`` and ``propagator_32`` of
    ``iaf_psc_alpha`` at the step (float64; their regular branches: tau_m
    and tau_syn lie far apart)."""
    nrn = cfg['neuron']
    h, ts, tm, c = nrn['dt'], nrn['tau_syn'], nrn['tau_m'], nrn['c_m']
    p31 = (1.0 / c * (math.exp(-h / ts) * math.expm1(-h / tm + h / ts)
                      / (tm / ts - 1.0) * tm - h * math.exp(-h / ts))
           / (-1.0 / tm - -1.0 / ts))
    p32 = (-tm / (c * (1.0 - tm / ts)) * math.exp(-h / ts)
           * math.expm1(h * (1.0 / ts - 1.0 / tm)))
    return p31, p32


def network(cfg: dict, scale: float, device) -> dict:
    """The network at *scale*, drawn on *device* from ``network_seed``:
    ``targets``, ``plastic_ptr``, ``static_ptr`` (int32) and the initial
    ``weights`` (float32)."""
    net = cfg['network']
    gen = torch.Generator(device=device).manual_seed(cfg['network_seed'])
    ne, ni = sizes(cfg, scale)
    n, ce, ci = ne + ni, net['ce'], net['ci']

    def rows(n_src, per, first, n_targets):
        src = torch.randint(0, n_src, (n_targets * per,), generator=gen,
                            device=device, dtype=torch.int32)
        order = torch.sort(src, stable=True).indices
        degree = torch.bincount(src, minlength=n_src)
        return degree, (first + torch.div(order, per,
                                          rounding_mode='floor')).int()
    deg_ee, t_ee = rows(ne, ce, 0, ne)
    deg_ei, t_ei = rows(ne, ce, ne, ni)
    deg_ii, t_ii = rows(ni, ci, 0, n)
    n_plastic = t_ee.numel()
    weights = (f32(je_pa(cfg)) + f32(net['sigma_w'])
               * torch.randn(n_plastic, generator=gen, device=device))
    zero = torch.zeros(1, dtype=torch.int64, device=device)
    plastic_ptr = torch.cat([zero, torch.cumsum(deg_ee, 0)])
    static_ptr = n_plastic + torch.cat(
        [zero, torch.cumsum(torch.cat([deg_ei, deg_ii]), 0)])
    return dict(targets=torch.cat([t_ee, t_ei, t_ii]),
                plastic_ptr=plastic_ptr.int(), static_ptr=static_ptr.int(),
                weights=weights)


def columns(net: dict) -> dict:
    """The plastic synapses by target: ``col_ptr`` (NE + 1), each entry's
    position ``col_pos`` and source ``col_src`` (int32), a column's
    entries in the order of their position."""
    ptr = net['plastic_ptr'].long()
    ne = ptr.numel() - 1
    tp = net['targets'][:int(ptr[-1])]
    order = torch.sort(tp, stable=True).indices.int()
    zero = torch.zeros(1, dtype=torch.int64, device=tp.device)
    col_ptr = torch.cat([zero, torch.cumsum(torch.bincount(
        tp, minlength=ne), 0)])
    src = torch.repeat_interleave(
        torch.arange(ne, dtype=torch.int32, device=tp.device),
        ptr[1:] - ptr[:-1])
    return dict(col_ptr=col_ptr, col_pos=order,
                col_src=torch.index_select(src, 0, order))


def initial_states(cfg: dict, ne: int, num: int, depth: int, weights,
                   count: int, gen: torch.Generator, device) -> list:
    """*count* initial states from *gen*: ``V ~ N(v0_mean, v0_sd) - E_L``
    in float32 and a uniform uint32 Poisson key each, the network's
    weights (one tensor for all), the rest 0."""
    init, e_l = cfg['initial_state'], cfg['neuron']['e_l']
    z = torch.randn((count, num), generator=gen, device=device)
    keys = torch.randint(0, 2 ** 32, (count,), generator=gen,
                         device=device).tolist()

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)
    return [dict(v=f32(init['v0_mean'] - e_l) + f32(init['v0_sd']) * z[c],
                 i_syn=zeros(num), di=zeros(num),
                 ref=zeros(num, dtype=torch.int32),
                 ring=zeros(depth, num, dtype=torch.int32),
                 spike_count=zeros(num, dtype=torch.int32), weights=weights,
                 kplus=zeros(ne), khist=zeros(depth, ne),
                 spiked=zeros(depth, ne, dtype=torch.uint8), key=keys[c],
                 step=0) for c in range(count)]


# -- the benchmark's interface

def make_inputs(cfg: dict, traffic: dict, seed: int, device) -> dict:
    """The network (from the configuration's ``network_seed``) and the
    trials' initial states (from *seed*), on *device*."""
    net = network(cfg, traffic['scale'], device)
    ne, ni = sizes(cfg, traffic['scale'])
    delay = int(round(cfg['network']['delay'] / cfg['neuron']['dt']))
    depth = 1 << delay.bit_length()
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    states = initial_states(cfg, ne, ne + ni, depth, net['weights'],
                            traffic['initial_states'], gen, device)
    return dict(program=dict(net), net=net, ne=ne, num=ne + ni, depth=depth,
                delay=delay, states=states)


class _Consts:
    """A run's constants: the step's scalars, the Poisson thresholds and
    each neuron's term of the hash; the float scalars as *dtype*."""

    def __init__(self, cfg: dict, inputs: dict, dtype, device):
        nrn, net = cfg['neuron'], cfg['network']
        h, ts, tm = nrn['dt'], nrn['tau_syn'], nrn['tau_m']
        je = je_pa(cfg)
        units = net['weight_units']
        p31, p32 = propagators(cfg)

        def s(x):
            return torch.tensor(f32(x), dtype=dtype, device=device)
        self.dtype = dtype
        self.p11, self.p21 = s(math.exp(-h / ts)), s(h * math.exp(-h / ts))
        self.em1, self.p31, self.p32 = s(math.expm1(-h / tm)), s(p31), s(p32)
        self.pa = s(math.e / ts * je / units)
        self.kp_decay = s(math.exp(-h / net['tau_plus']))
        self.km_decay = s(math.exp(-h / net['tau_minus']))
        self.lam = s(net['lambda'])
        self.lam_alpha = s(net['lambda'] * net['alpha'])
        self.mu = f32(net['mu'])
        self.units = s(units / je)
        self.v_th = f32(nrn['v_th'] - nrn['e_l'])
        self.v_reset = f32(nrn['v_reset'] - nrn['e_l'])
        self.ref_steps = int(round(nrn['t_ref'] / h))
        self.w_e = units
        self.w_i = int(round(net['g'] * units))
        self.ne, self.num = inputs['ne'], inputs['num']
        self.depth, self.delay = inputs['depth'], inputs['delay']
        self.thr = torch.tensor(thresholds(cfg), dtype=torch.int64,
                                device=device)
        self.neuron_hash = _mul(torch.arange(self.num, device=device), I_MUL)
        ptr = inputs['net']['static_ptr']
        self.static_e_end = int(ptr[self.ne])


def _neurons(s: dict, slot: torch.Tensor, h: torch.Tensor, c: _Consts):
    """A step's neuron update and the traces' decay, the ring's slot
    *slot* (a one-element index) read and cleared in place; returns the
    spikes and the decayed traces ``(K+, K-)``."""
    ring = s['ring']
    x = ring.index_select(0, slot).view(-1)
    ring.index_fill_(0, slot, 0)
    u = _mix(h ^ c.neuron_hash)
    x = x + ((u[:, None] >= c.thr).sum(1) * c.w_e).to(torch.int32)
    v, i, di = s['v'], s['i_syn'], s['di']
    live = s['ref'] == 0
    v = torch.where(live, ((c.p31 * di + c.p32 * i) + c.em1 * v) + v, v)
    ref = torch.where(live, s['ref'], s['ref'] - 1)
    s['i_syn'] = c.p21 * di + c.p11 * i
    s['di'] = c.p11 * di + c.pa * x.to(c.dtype)
    spike = v >= c.v_th
    s['v'] = torch.where(spike, c.v_reset, v)
    s['ref'] = torch.where(spike, c.ref_steps, ref)
    s['spike_count'] = s['spike_count'] + spike
    kp = c.kp_decay * s['kplus']
    km = c.km_decay * s['km']
    s['khist'].index_copy_(0, slot, km[None])
    return spike, kp, km


def _traces(s: dict, spike: torch.Tensor, slot, kp, km, c: _Consts) -> None:
    """The spikes of the step into K+, K- and ``spiked``."""
    se = spike[:c.ne]
    s['kplus'] = torch.where(se, kp + 1.0, kp)
    s['km'] = torch.where(se, km + 1.0, km)
    s['spiked'].index_copy_(0, slot, se.to(torch.uint8)[None])


def _positions(ptr: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The positions of the rows *ids* of *ptr*, row after row."""
    beg = ptr[ids]
    lens = ptr[ids + 1] - beg
    return (torch.repeat_interleave(beg - (torch.cumsum(lens, 0) - lens),
                                    lens)
            + torch.arange(int(lens.sum()), device=ptr.device))


def _plastic(w, km, c: _Consts):
    """Depressed weights, and the units they deliver."""
    w = w - (c.lam_alpha * w) * km
    w = torch.where(w > 0, w, 0.0)
    return w, torch.round(w * c.units).to(torch.int32)


def _eager_step(s: dict, t: int, h, g: dict, c: _Consts) -> None:
    """One step at *t* in place, in dynamic shapes."""
    mask = c.depth - 1
    slot = torch.tensor([t & mask], device=s['v'].device)
    spike, kp, km = _neurons(s, slot, h, c)
    w = s['weights']
    posts = torch.nonzero(s['spiked'][(t - c.delay) & mask]).flatten()
    e = _positions(g['col_ptr'], posts)
    if e.numel():
        pos = g['col_pos'][e].long()
        x = w[pos]
        w[pos] = x + (c.lam * x.pow(c.mu)) * kp[g['col_src'][e].long()]
    ids = torch.nonzero(spike).flatten()
    flat = s['ring'].view(-1)
    late = ((t + c.delay) & mask) * c.num
    ep = _positions(g['plastic_ptr'], ids[ids < c.ne])
    if ep.numel():
        tg = g['targets'][ep].long()
        x, units = _plastic(w[ep], s['khist'][(t - c.delay) & mask][tg], c)
        w[ep] = x
        flat.index_add_(0, late + tg, units)
    es = _positions(g['static_ptr'], ids)
    if es.numel():
        flat.index_add_(0, late + g['targets'][es].long(), torch.where(
            es < c.static_e_end, c.w_e, c.w_i).to(torch.int32))
    _traces(s, spike, slot, kp, km, c)


class _Budget:
    """Rows of at most :data:`SPIKES` listed neurons, in static shapes:
    the listed ids compacted by a prefix sum, each of *size* slots found
    in its row by a search of the rows' running lengths. ``e`` the slots'
    positions (0 past the rows' entries), ``valid`` which are entries,
    ``over`` whether the list or the entries exceeded a budget."""

    def __init__(self, n: int, size: int, device):
        self.items = torch.arange(n, device=device)
        self.slots = torch.arange(SPIKES + 1, device=device)
        self.budget = torch.arange(size, device=device)

    def __call__(self, listed: torch.Tensor, ptr: torch.Tensor):
        pos = torch.cumsum(listed.long(), 0)
        n = pos[-1]
        at = torch.where(listed.bool() & (pos <= SPIKES), pos - 1, SPIKES)
        ids = self.slots.clone().scatter_(0, at, self.items)[:SPIKES]
        ids = ids % self.items.numel()
        lens = torch.where(self.slots[:SPIKES] < n, ptr[ids + 1] - ptr[ids],
                           0)
        ends = torch.cumsum(lens, 0)
        which = torch.searchsorted(ends, self.budget, right=True).clamp_(
            max=SPIKES - 1)
        e = ptr[ids[which]] + (self.budget - (ends[which] - lens[which]))
        valid = self.budget < ends[-1]
        over = (n > SPIKES) | (ends[-1] > self.budget.numel())
        return torch.where(valid, e, 0), valid, over


class _Chunk:
    """*k* steps captured as one CUDA graph over static state buffers."""

    def __init__(self, s: dict, c: _Consts, g: dict, k: int):
        self.c = c
        device = s['v'].device
        self.state = {key: x.clone() for key, x in s.items()}
        self.state['weights'] = torch.cat(
            [s['weights'], s['weights'].new_zeros(1)])  # a sink at P
        self.t = torch.zeros(k, dtype=torch.int64, device=device)
        self.h = torch.zeros(k, dtype=torch.int64, device=device)
        self.over = torch.zeros((), dtype=torch.bool, device=device)
        self.posts = _Budget(c.ne, COLUMNS, device)
        self.plastic = _Budget(c.num, PLASTIC, device)
        self.static = _Budget(c.num, STATIC, device)
        n_plastic = s['weights'].numel()
        # the plastic rows over all neurons: the I neurons' are empty
        self.pptr_all = torch.cat([g['plastic_ptr'], g['plastic_ptr'][-1:]
                                   .expand(c.num - c.ne)])
        self.sink = n_plastic
        self.spare = torch.arange(STATIC, device=device) % (c.depth * c.num)

        def body():
            cur = dict(self.state)
            for i in range(k):
                self._step(cur, self.t[i:i + 1], self.h[i], g)
            for key, x in cur.items():
                if x is not self.state[key]:
                    self.state[key].copy_(x)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            body()
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            body()

    def _step(self, s: dict, t: torch.Tensor, h, g: dict) -> None:
        c = self.c
        mask = c.depth - 1
        slot = t & mask
        early = (t - c.delay) & mask
        spike, kp, km = _neurons(s, slot, h, c)
        w = s['weights']
        e, valid, over = self.posts(s['spiked'].index_select(0, early)[0],
                                    g['col_ptr'])
        pos = torch.where(valid, g['col_pos'][e].long(), self.sink)
        x = w[pos]
        x = x + (c.lam * x.pow(c.mu)) * kp[g['col_src'][e].long()]
        w.index_put_((pos,), x)
        flat = s['ring'].view(-1)
        late = ((t + c.delay) & mask) * c.num
        ep, pvalid, pover = self.plastic(spike, self.pptr_all)
        tg = g['targets'][ep].long()
        kh = s['khist'].index_select(0, early)[0][tg % c.ne]
        x, units = _plastic(w[ep], kh, c)
        w.index_put_((torch.where(pvalid, ep, self.sink),), x)
        flat.index_add_(0, torch.where(pvalid, late + tg, self.spare[
            :PLASTIC]), torch.where(pvalid, units, 0))
        es, svalid, sover = self.static(spike, g['static_ptr'])
        units = torch.where(es < c.static_e_end, c.w_e, c.w_i)
        flat.index_add_(0, torch.where(svalid, late + g['targets'][es].long(),
                                       self.spare),
                        torch.where(svalid, units, 0).to(torch.int32))
        _traces(s, spike, slot, kp, km, c)
        self.over.copy_(self.over | over | pover | sover)

    def replay(self, s: dict, t: torch.Tensor, h: torch.Tensor) -> bool:
        """The chunk from *s* (not modified); whether a step overflowed."""
        for key, x in s.items():
            if key == 'weights':
                self.state[key][:-1].copy_(x)
            else:
                self.state[key].copy_(x)
        self.t.copy_(t)
        self.h.copy_(h)
        self.over.zero_()
        self.graph.replay()
        return bool(self.over)

    def result(self) -> dict:
        out = {key: x.clone() for key, x in self.state.items()}
        out['weights'] = out['weights'][:-1]
        return out


def simulate(cfg: dict, traffic: dict, inputs: dict, state: dict,
             n_steps: int, dtype=torch.float32) -> dict:
    """One trial of *n_steps* from *state* (not modified); returns the
    final state's arrays (:data:`FIELDS`)."""
    device = state['v'].device
    c = _Consts(cfg, inputs, dtype, device)
    net = inputs['net']
    if 'columns' not in inputs:
        inputs['columns'] = columns(net)
    g = dict(net, **inputs['columns'])
    g = {k: (x.long() if k.endswith('ptr') else x) for k, x in g.items()}
    s = {k: state[k].to(dtype if k in FLOATS else state[k].dtype, copy=True)
         for k in FIELDS}
    mask = c.depth - 1
    last = (state['step'] - 1) & mask
    s['km'] = torch.where(s['spiked'][last].bool(), s['khist'][last] + 1.0,
                          s['khist'][last])
    t = (state['step'] + torch.arange(n_steps, device=device)) & M32
    h = _mix(state['key'] ^ _mul(t, T_MUL))
    if device.type != 'cuda':
        for i, step in enumerate(t.tolist()):
            _eager_step(s, step, h[i], g, c)
    else:
        chunks = {}
        for pos in range(0, n_steps, CHUNK):
            k = min(CHUNK, n_steps - pos)
            if k not in chunks:
                chunks[k] = _Chunk(s, c, g, k)
            chunk = chunks[k]
            if chunk.replay(s, t[pos:pos + k], h[pos:pos + k]):
                for i, step in enumerate(t[pos:pos + k].tolist()):
                    _eager_step(s, step, h[pos + i], g, c)
            else:
                s = chunk.result()
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
