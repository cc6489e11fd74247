# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""NEST's HPC benchmark network with power-law STDP (Morrison, Aertsen &
Diesmann 2007, Neural Comput. 19:1437, doi 10.1162/neco.2007.19.6.1437),
at any scale: the setup of NEST's ``hpc_benchmark.py`` example
(``brunel_params``, ``model_params``, ``stdp_params``), which
:class:`HpcStdpParams` holds.

A balanced random network of ``NE = 9000 s`` excitatory and ``NI = 2250
s`` inhibitory ``iaf_psc_alpha`` neurons (C_m 250 pF, tau_m 10 ms,
tau_syn 0.3258 ms for both E and I, so one current channel, t_ref 0.5
ms, E_L = V_reset = 0, V_th 20 mV). At any scale each neuron has CE =
9000 excitatory and CI = 2250 inhibitory inputs, their sources drawn
uniformly with replacement within the source population (NEST's
``fixed_indegree`` defaults), every delay 1.5 ms (``d`` = 15 steps of
0.1 ms, a ring of ``D`` = 16 slots). JE = 0.14 mV of PSP peak is
``JE_pA`` = 45.61 pA (:meth:`HpcStdpParams.je_pa`); E -> I synapses weigh
JE_pA, I -> E and I -> I ``g JE_pA`` (g = -5), and each E -> E synapse is
plastic (``stdp_pl_synapse_hom``: lambda 0.1, alpha 0.0513, mu 0.4,
tau_plus 15 ms, tau_minus 30 ms), its weight starting at N(JE_pA, 3.47
pA). Every neuron gets its own Poisson train of ``eta nu_th CE`` = 20,856
Hz of weight JE_pA (lambda = 2.0856 a step).

The network (:func:`build_hpc_network`), drawn from a ``torch.Generator``
on the device, is two CSRs by source over one ``targets`` array (int32):
the plastic E -> E synapses at positions ``[0, P)`` (rows
``plastic_ptr``, float32 ``weights`` in pA), then the static ones at
``[P, P + S)`` (rows ``static_ptr``: E -> I, then I -> E and I -> I).
Weights enter the ring in int32 units of ``q = JE_pA / 4096``: 4096 for
E -> I and a Poisson event, -20480 for I, ``rint(w 4096 / JE_pA)`` for a
plastic weight as it is delivered; so a step's input is an exact sum,
whatever the order of the adds.

One step ``t`` of neuron ``j``, in NEST's order, every product and sum
rounded once to float32::

    s = ring[t mod D][j] + 4096 * k_poisson;  ring[t mod D][j] = 0
    if r == 0: V = ((P31 dI + P32 I) + expm1(-h/tau_m) V) + V  else r -= 1
    I = P21 dI + P11 I;  dI = P11 dI + (e / tau_syn) q s
    E: K+ = exp(-h/tau_plus) K+;  K- = exp(-h/tau_minus) K-;
       khist[t mod D][j] = K-
    if V >= V_th: V = V_reset, r = 5, count += 1

then, NEST's ``send()`` applied eagerly (the whole delay dendritic):

1. each E neuron j that spiked at step t - d, each E -> E synapse i -> j:
   ``w = w + (lambda w^mu) K+_i`` (K+_i not yet counting i's spike at t);
2. each E neuron i that spikes at t, each E -> E synapse i -> j:
   ``w = max(w - (lambda alpha w) khist[(t - d) mod D][j], 0)``, and every
   synapse of every spike at t adds its units into ``ring[(t + d) mod
   D][j]``;
3. the spikes of t add 1 to their neuron's K+ and K-.

:meth:`HpcStdpNet.run` runs a trial on a card as launches of kernel K24
(``csrc/stdp_sim.cu``) of at most LAUNCH_STEPS steps, and on the CPU
as :func:`stdp_loop`, plain PyTorch; they give the same bits. :func:`stdp_loop`
makes 1 as written, a pass over the columns of the step's post spikes
(:func:`stdp_columns`). K24 makes each synapse's facilitations where
NEST's ``send()`` does, at the next spike of its source, in the walk of
its row and before its depression, oldest first, with K+ of their steps
from a history of the launch; and the facilitations still owed at its
last step in one pass over the E rows (the flush). Between two spikes of
i nothing else writes a synapse i -> j and K+_i only decays, so these are
the eager rule's facilitations, in its order, on its operands. K24's
walk of a step's rows is split by target: each block of its grid owns
1/G of the E and 1/G of the I neurons and walks the segment of each row
whose targets it owns, from a split plan of the rows built with the
network (:func:`stdp_split`), so that it adds their inputs in shared
memory.
"""

import ctypes
import dataclasses
import functools
import math
from typing import NamedTuple, Optional

import torch

from .._error import KernelExecutionError
from ..ops import cuda_build, tracing
from ..ops.core import KernelOp, check_cuda_tensors, check_device, cuda_stream
from ..rng.light import M32, _mul32, light_rng_mix32
from .microcircuit import I_MUL, T_MUL, poisson_thresholds
from .neurons import f32

__all__ = ['HpcStdpNet', 'HpcStdpState', 'HpcStdpParams', 'StdpParams',
           'StdpPlan', 'build_hpc_network', 'stdp_columns',
           'stdp_plan', 'stdp_split', 'stdp_counts', 'spike_capacity',
           'stdp_sim', 'stdp_loop', 'stdp_sim_grid', 'stdp_pow_cuda',
           'propagator_31', 'propagator_32']

HPC_BLOCK = 256          # threads a block of K24 (SG_BLOCK in sim_grid.cuh)
HPC_NPT = 2              # neurons a thread of K24 owns at most (STDP_NPT)
HPC_KMAX = 16            # the Poisson draw's thresholds (SG_KMAX)
HPC_HTILE = 8            # steps of a tile of K24's K+ history (STDP_HTILE)
LAUNCH_STEPS = 10240     # the most steps of one K24 launch, by default
STATE_FIELDS = ('v', 'i_syn', 'di', 'ref', 'ring', 'spike_count', 'weights',
                'kplus', 'khist', 'spiked')
MAX_SYNAPSES = 2 ** 31 - 1  # the rows' positions are int32
SPLIT_CHUNK = 1 << 25    # positions of the rows stdp_split searches at a time
# the counters of a run, in the order of K24's (4,) buffer
COUNTERS = tuple(f'brainevent_torch.HpcStdpNet.{name}' for name in (
    'depressions', 'facilitations', 'flush_facilitations',
    'walk_busiest_block'))


def _lambert_wm1(x: float) -> float:
    """The lower branch W_-1 of Lambert's W at ``-1/e < x < 0`` (Halley's
    iteration in float64)."""
    lx = math.log(-x)
    w = lx - math.log(-lx)
    for _ in range(50):
        ew = math.exp(w)
        f = w * ew - x
        step = f / (ew * (w + 1) - (w + 2) * f / (2 * w + 2))
        w -= step
        if abs(step) <= 1e-15 * abs(w):
            break
    return w


def propagator_31(tau_syn: float, tau: float, c: float, h: float) -> float:
    """NEST's ``propagator_31``: dI's share in V after a step *h* of
    ``iaf_psc_alpha`` (float64)."""
    linear = (1.0 / (3.0 * c * tau * tau) * h ** 3 * (tau_syn - tau)
              * math.exp(-h / tau))
    exact = (1.0 / c * (math.exp(-h / tau_syn)
                        * math.expm1(-h / tau + h / tau_syn)
                        / (tau / tau_syn - 1.0) * tau
                        - h * math.exp(-h / tau_syn))
             / (-1.0 / tau - -1.0 / tau_syn))
    singular = h * h / 2.0 / c * math.exp(-h / tau)
    if tau == tau_syn or (abs(tau - tau_syn) < 0.1
                          and abs(exact - singular) > 2.0 * abs(linear)):
        return singular
    return exact


def propagator_32(tau_syn: float, tau: float, c: float, h: float) -> float:
    """NEST's ``propagator_32``: I's share in V after a step *h*."""
    linear = (1.0 / (2.0 * c * tau * tau) * h * h * (tau_syn - tau)
              * math.exp(-h / tau))
    singular = h / c * math.exp(-h / tau)
    exact = (-tau / (c * (1.0 - tau / tau_syn)) * math.exp(-h / tau_syn)
             * math.expm1(h * (1.0 / tau_syn - 1.0 / tau)))
    if tau == tau_syn or (abs(tau - tau_syn) < 0.1
                          and abs(exact - singular) > 2.0 * abs(linear)):
        return singular
    return exact


@dataclasses.dataclass(frozen=True)
class HpcStdpParams:
    """The published parameters (``hpc_benchmark.py``): sizes at scale 1
    (``ne``, ``ni``), in-degrees at every scale (``ce``, ``ci``), JE (mV),
    g, eta, the initial E -> E weights' SD (pA), the delay (ms), the
    neuron (pF, ms, mV), the STDP rule, the step (ms), the initial
    membrane ``N(v0_mean, v0_sd)`` and the ring's units of ``JE_pA``."""
    ne: int = 9000
    ni: int = 2250
    ce: int = 9000
    ci: int = 2250
    je: float = 0.14
    g: float = -5.0
    eta: float = 1.685
    sigma_w: float = 3.47
    delay: float = 1.5
    c_m: float = 250.0
    tau_m: float = 10.0
    tau_syn: float = 0.32582722403722841
    t_ref: float = 0.5
    e_l: float = 0.0
    v_th: float = 20.0
    v_reset: float = 0.0
    lam: float = 0.1
    alpha: float = 0.0513
    mu: float = 0.4
    tau_plus: float = 15.0
    tau_minus: float = 30.0
    dt: float = 0.1
    v0_mean: float = 5.7
    v0_sd: float = 7.2
    weight_units: int = 4096

    def sizes(self, scale: float = 1.0) -> tuple:
        """``(NE, NI)`` at *scale*, rounded."""
        return int(round(self.ne * scale)), int(round(self.ni * scale))

    def je_pa(self) -> float:
        """The current (pA) whose PSP peaks at ``je`` (NEST's
        ``convert_synapse_weight``): 45.61 pA."""
        tm, ts = self.tau_m, self.tau_syn
        a = tm / ts
        b = 1.0 / ts - 1.0 / tm
        t_rise = 1.0 / b * (-_lambert_wm1(-math.exp(-1.0 / a) / a) - 1.0 / a)
        v_max = (math.exp(1.0) / (ts * self.c_m * b)
                 * ((math.exp(-t_rise / tm) - math.exp(-t_rise / ts)) / b
                    - t_rise * math.exp(-t_rise / ts)))
        return self.je / v_max

    def poisson_rate(self) -> float:
        """Each neuron's Poisson drive (Hz): ``eta nu_th CE``, ``nu_th =
        V_th / (CE JE_pA e tau_syn tau_m / C_m)``: 20,856 Hz."""
        nu_th = self.v_th / (self.ce * self.tau_m / self.c_m * self.je_pa()
                             * math.e * self.tau_syn)
        return self.eta * nu_th * self.ce * 1000.0

    def delay_steps(self) -> int:
        return int(round(self.delay / self.dt))


def _by_source(src: torch.Tensor, n_src: int, per: int,
               first: int) -> tuple:
    """The synapses whose sources are *src*, of targets ``first + k //
    per`` (the k-th drawn), as CSR by source: ``(degree, targets)``, a
    stable sort."""
    order = torch.sort(src, stable=True).indices.to(torch.int32)
    degree = torch.bincount(src, minlength=n_src)
    order //= per
    if first:
        order += first
    return degree, order


def build_hpc_network(params: HpcStdpParams, scale: float,
                      generator: torch.Generator, device) -> dict:
    """The network at *scale*, drawn on *device* from *generator* (on that
    device): ``targets`` (int32), ``plastic_ptr`` (int32, NE + 1),
    ``static_ptr`` (int32, N + 1) and ``weights`` (float32, P).

    In turn: each E neuron's CE E sources, each I neuron's CE E sources,
    each neuron's CI I sources (uniform, with replacement, in target
    order), then the E -> E weights ``JE_pA + sigma_w N(0, 1)`` in the
    order of the plastic CSR; each group of synapses is put in the order
    of its source by a stable sort."""
    ne, ni = params.sizes(scale)
    n, ce, ci = ne + ni, params.ce, params.ci
    if n * (ce + ci) > MAX_SYNAPSES:
        raise ValueError(f'{n} neurons of {ce + ci} inputs are more synapses '
                         f'than the int32 positions hold ({MAX_SYNAPSES})')

    def draw(low, high, count):
        return torch.randint(low, high, (count,), generator=generator,
                             device=device, dtype=torch.int32)
    deg_ee, t_ee = _by_source(draw(0, ne, ne * ce), ne, ce, 0)
    deg_ei, t_ei = _by_source(draw(0, ne, ni * ce), ne, ce, ne)
    deg_ii, t_ii = _by_source(draw(0, ni, n * ci), ni, ci, 0)
    n_plastic = t_ee.numel()
    targets = torch.cat([t_ee, t_ei, t_ii])
    del t_ee, t_ei, t_ii
    plastic_ptr = torch.zeros(ne + 1, dtype=torch.int64, device=device)
    torch.cumsum(deg_ee, 0, out=plastic_ptr[1:])
    static_ptr = torch.full((n + 1,), n_plastic, dtype=torch.int64,
                            device=device)
    static_ptr[1:] += torch.cumsum(torch.cat([deg_ei, deg_ii]), 0)
    weights = f32(params.je_pa()) + f32(params.sigma_w) * torch.randn(
        n_plastic, generator=generator, device=device)
    return dict(targets=targets, plastic_ptr=plastic_ptr.to(torch.int32),
                static_ptr=static_ptr.to(torch.int32), weights=weights)


class HpcStdpState(NamedTuple):
    v: torch.Tensor            # membrane relative to E_L (mV), float32 (n,)
    i_syn: torch.Tensor        # synaptic current I (pA), float32 (n,)
    di: torch.Tensor           # its derivative dI (pA/ms), float32 (n,)
    ref: torch.Tensor          # refractory steps left, int32 (n,)
    ring: torch.Tensor         # pending input in units of q, int32 (D, n)
    spike_count: torch.Tensor  # per-neuron cumulative spikes, int32 (n,)
    weights: torch.Tensor      # the E -> E weights (pA), float32 (P,)
    kplus: torch.Tensor        # each E neuron's K+, float32 (NE,)
    khist: torch.Tensor        # K- of step t before t's spike, at t mod D,
    #                            float32 (D, NE)
    spiked: torch.Tensor       # each E neuron's spike at step t, at t mod D,
    #                            uint8 (D, NE)
    key: int                   # the Poisson stream, a uint32
    step: int                  # the next step's index


class StdpParams(ctypes.Structure):
    """The scalars of one network and trial, rounded to float32; the same
    layout as ``struct StdpParams`` in ``csrc/stdp_sim.cu``."""
    _fields_ = [(name, ctypes.c_float) for name in (
        'p11', 'p21', 'em1', 'p31', 'p32', 'pa', 'v_th', 'v_reset',
        'kp_decay', 'km_decay', 'lam', 'lam_alpha', 'mu', 'units')] + [
        (name, ctypes.c_int) for name in (
            'num', 'n_exc', 'n_plastic', 'static_e_end', 'depth', 'delay',
            'ref_steps', 'w_ext', 'w_e', 'w_i')] + [
        ('key', ctypes.c_uint32), ('step0', ctypes.c_uint32),
        ('thr', ctypes.c_uint32 * HPC_KMAX)]


# -- the twin ---------------------------------------------------------------------

def _segments(ptr: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The positions of rows *ids* of the CSR *ptr*, row after row."""
    beg = ptr[ids].long()
    lens = ptr[ids + 1].long() - beg
    first = beg - (torch.cumsum(lens, 0) - lens)
    return (torch.repeat_interleave(first, lens)
            + torch.arange(int(lens.sum()), device=ptr.device))


def stdp_columns(targets, plastic_ptr) -> tuple:
    """The plastic synapses by target, which :func:`stdp_loop` reads, on
    the network's device: each E neuron's column ``col_ptr`` (int32 ``(NE
    + 1,)``), and each entry's position ``col_pos`` and source ``col_src``
    (int32 ``(P,)``), a column's entries in the order of their position (a
    stable sort)."""
    ne = plastic_ptr.numel() - 1
    tp = targets[:int(plastic_ptr[-1])]
    order = torch.sort(tp, stable=True).indices.to(torch.int32)
    col_ptr = torch.zeros(ne + 1, dtype=torch.int64, device=targets.device)
    torch.cumsum(torch.bincount(tp, minlength=ne), 0, out=col_ptr[1:])
    rows = torch.repeat_interleave(
        torch.arange(ne, dtype=torch.int32, device=targets.device),
        (plastic_ptr[1:] - plastic_ptr[:-1]).long())
    return (col_ptr.to(torch.int32), order,
            torch.index_select(rows, 0, order))


def stdp_loop(v, i_syn, di, ref, ring, spike_count, weights, kplus, khist,
              spiked, targets, plastic_ptr, static_ptr, n_steps: int,
              p: StdpParams, counters: Optional[torch.Tensor] = None) -> None:
    """Plain PyTorch twin of K24, in place: *n_steps* steps from
    ``p.step0`` (see the module's docstring), each facilitation in the
    step d after its post spike, over the columns (:func:`stdp_columns`).
    *counters* (int64, (4,)), where given, is set to the depressions and
    facilitations made, and 0 twice: nothing is left to a flush, and the
    loop has no blocks."""
    col_ptr, col_pos, col_src = stdp_columns(targets, plastic_ptr)
    num, ne, d = p.num, p.n_exc, p.delay
    dmask = p.depth - 1
    device = v.device
    thr = torch.tensor(list(p.thr), dtype=torch.int64, device=device)
    neuron_hash = _mul32(torch.arange(num, device=device), I_MUL)
    last = (p.step0 - 1) & dmask
    km = torch.where(spiked[last].bool(), khist[last] + 1.0, khist[last])
    flat = ring.view(-1)
    if counters is not None:
        counters.zero_()
    for k in range(n_steps):
        t = (p.step0 + k) & M32
        slot = t & dmask
        now = ring[slot]
        s = now.clone()
        now.zero_()
        h = int(light_rng_mix32(p.key ^ ((t * T_MUL) & M32)))
        u = light_rng_mix32(h ^ neuron_hash)
        s += ((u[:, None] >= thr).sum(1) * p.w_ext).to(torch.int32)
        live = ref == 0
        vn = ((p.p31 * di + p.p32 * i_syn) + p.em1 * v) + v
        v.copy_(torch.where(live, vn, v))
        ref.sub_((~live).to(torch.int32))
        i_new = p.p21 * di + p.p11 * i_syn
        di.copy_(p.p11 * di + p.pa * s.to(torch.float32))
        i_syn.copy_(i_new)
        spike = v >= p.v_th
        v.masked_fill_(spike, p.v_reset)
        ref.masked_fill_(spike, p.ref_steps)
        spike_count.add_(spike.to(torch.int32))
        kp = p.kp_decay * kplus
        kmd = p.km_decay * km
        khist[slot] = kmd
        # 1. the E -> E synapses onto the E neurons that spiked at t - d
        posts = torch.nonzero(spiked[(t - d) & dmask]).flatten()
        e = _segments(col_ptr, posts)
        if e.numel():
            pos = col_pos[e].long()
            w = weights[pos]
            # torch.pow: K24's powf equals it on every float32 in (0, 4096)
            weights[pos] = w + (p.lam * torch.pow(w, p.mu)) * kp[
                col_src[e].long()]
        # 2. the rows of the spikes of t: depression, then delivery
        ids = torch.nonzero(spike).flatten()
        ep = _segments(plastic_ptr, ids[ids < ne])
        es = _segments(static_ptr, ids)
        if ep.numel():
            tg = targets[ep].long()
            w = weights[ep]
            w = w - (p.lam_alpha * w) * khist[(t - d) & dmask][tg]
            w = torch.where(w > 0, w, 0.0)
            weights[ep] = w
            late = ((t + d) & dmask) * num
            flat.index_add_(0, late + tg,
                            torch.round(w * p.units).to(torch.int32))
        if es.numel():
            units = torch.where(es < p.static_e_end, p.w_e,
                                p.w_i).to(torch.int32)
            flat.index_add_(0, ((t + d) & dmask) * num + targets[es].long(),
                            units)
        if counters is not None:
            counters += torch.tensor([ep.numel(), e.numel(), 0, 0],
                                     device=counters.device)
        # 3. the spikes of t into the traces
        se = spike[:ne]
        kplus.copy_(torch.where(se, kp + 1.0, kp))
        km = torch.where(se, kmd + 1.0, kmd)
        spiked[slot] = se.to(torch.uint8)


# -- K24: the whole trial in one launch ------------------------------------------------

def spike_capacity(launch_steps: int, delay: int, ref_steps: int,
                   resets_below_threshold: bool = True) -> int:
    """Entries of an E neuron's spike list in a K24 launch of at most
    *launch_steps* steps: its spikes of the *delay* steps before the
    launch, which a state may hold in any of them, and those of the
    launch, one every ``ref_steps + 1`` steps at the fastest (a neuron
    spikes again only once the membrane is integrated again), or every
    step where the reset is not below the threshold."""
    period = ref_steps + 1 if resets_below_threshold else 1
    return delay + -(-launch_steps // period)


class StdpPlan(NamedTuple):
    """K24's scratch for launches of at most ``steps`` steps: the lists of
    a step's spiking rows (``dlists`` int32 ``(2, 2 num, 4)``, by parity:
    each row's line of the split plan, its source and the source's walk
    before; the plastic rows from the front, the static ones from the
    back), their counters, the busiest block's work by parity and the
    flush's ranges' counters (``counts`` int32, see :func:`stdp_counts`);
    the K+ history of a launch (``kph`` float32 ``(steps / HPC_HTILE, NE,
    HPC_HTILE)``: K+ of each E neuron in each step before its spike, in
    tiles of HPC_HTILE steps); each E neuron's spike steps (``spikes``
    int32 ``(NE, cap)``, cap from :func:`spike_capacity`), its record
    (``recent`` int32 ``(NE, 16)``: the count and the 15 newest, newest
    first) and its row's last walk (``last_walk`` int32 ``(NE,)``); and
    the split plan of the network for K24's grid (``split``, from
    :func:`stdp_split`). One launch at a time uses a plan's scratch
    (launches on one stream)."""
    steps: int
    dlists: torch.Tensor
    counts: torch.Tensor
    kph: torch.Tensor
    spikes: torch.Tensor
    recent: torch.Tensor
    last_walk: torch.Tensor
    split: torch.Tensor


def stdp_counts(n_exc: int) -> int:
    """The counters of K24's scratch, by parity: the rows' lists' fronts
    (their plastic rows), the largest work of a block in a step's walk, the
    lists' backs (their static rows); then the flush's ranges', one a
    chunk of HPC_BLOCK E rows."""
    return 6 + -(-n_exc // HPC_BLOCK)


def stdp_plan(num: int, n_exc: int, steps: int, cap: int,
              split: torch.Tensor) -> StdpPlan:
    """K24's :class:`StdpPlan` for *num* neurons, *n_exc* of them E, on
    the device of *split* (:func:`stdp_split`, kept as it is): launches of
    at most *steps* steps (the history rounded up to whole tiles), spike
    lists of *cap* entries."""
    steps = -(-steps // HPC_HTILE) * HPC_HTILE

    def scratch(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=split.device)
    return StdpPlan(steps=steps, dlists=scratch(2, 2 * num, 4),
                    counts=scratch(stdp_counts(n_exc)),
                    kph=scratch(steps // HPC_HTILE, n_exc, HPC_HTILE,
                                dtype=torch.float32),
                    spikes=scratch(n_exc, cap), recent=scratch(n_exc, 16),
                    last_walk=scratch(n_exc), split=split)


def _owned(n_exc: int, num: int, blocks: int, device) -> tuple:
    """The targets that each block of K24's grid of *blocks* owns: block
    ``b`` the E neurons ``[e[b], e[b + 1])`` and the I neurons ``[i[b],
    i[b + 1])``, ``e`` and ``i`` int64 ``(blocks + 1,)``."""
    b = torch.arange(blocks + 1, dtype=torch.int64, device=device)
    return b * n_exc // blocks, n_exc + b * (num - n_exc) // blocks


def stdp_split(targets, plastic_ptr, static_ptr, n_exc: int,
               blocks: int) -> torch.Tensor:
    """K24's split plan of the network's rows for a grid of *blocks*, on
    the network's device: int32 ``(2 num, blocks + 1)``, a line of bounds
    for each part of a row that K24 walks, ``line[b]`` the first position
    of the part whose target block ``b`` owns or a later block (so block
    ``b`` walks ``[line[b], line[b + 1])``; the owners as ``_owned`` gives
    them). The lines: ``[0, NE)`` the plastic rows (E targets), ``[NE,
    2 NE)`` the static rows of the E neurons (I targets), ``[2 NE, NE +
    num)`` the static rows of the I neurons by their E targets, ``[NE +
    num, 2 num)`` the same rows by their I targets. Lower bounds of the
    keys ``row * num + target`` by ``torch.searchsorted``, over at most
    SPLIT_CHUNK positions at a time (or one row). Raises ``ValueError``
    where a row's targets do not ascend, as K24 needs them
    (``build_hpc_network``'s rows ascend)."""
    num = static_ptr.numel() - 1
    ne, device = n_exc, targets.device
    bounds = _owned(ne, num, blocks, device)
    # each row's first position: the plastic rows, then the static ones
    ptr = torch.cat([plastic_ptr[:-1], static_ptr]).long()
    host = ptr.cpu()
    out = torch.empty(2 * num, blocks + 1, dtype=torch.int32, device=device)
    unsorted = torch.zeros((), dtype=torch.bool, device=device)
    # (first line, first row, rows, the owners' bounds): see above
    for line0, row0, rows, bnd in ((0, 0, ne, bounds[0]),
                                   (ne, ne, ne, bounds[1]),
                                   (2 * ne, 2 * ne, num - ne, bounds[0]),
                                   (ne + num, 2 * ne, num - ne, bounds[1])):
        r, stop = row0, row0 + rows
        while r < stop:
            # rows [r, s): at most SPLIT_CHUNK positions, or one row
            s = int(torch.searchsorted(host, host[r] + SPLIT_CHUNK,
                                       right=True)) - 1
            s = min(max(s, r + 1), stop)
            lo, hi = int(host[r]), int(host[s])
            local = torch.arange(s - r, dtype=torch.int64, device=device)
            keys = torch.repeat_interleave(local * num, ptr[r + 1:s + 1]
                                           - ptr[r:s], output_size=hi - lo)
            keys += targets[lo:hi]
            unsorted |= (keys[1:] < keys[:-1]).any()
            out[line0 + r - row0:line0 + s - row0] = torch.searchsorted(
                keys, local[:, None] * num + bnd) + lo
            r = s
    if bool(unsorted):
        raise ValueError('K24 walks each row by target: the targets of a '
                         'row must ascend')
    return out


@functools.lru_cache(maxsize=None)
def _max_blocks(device_index: int) -> int:
    fn = cuda_build.function('stdp_sim_max_blocks', [
        ctypes.c_int, ctypes.POINTER(ctypes.c_int)])
    out = ctypes.c_int(0)
    err = fn(device_index, ctypes.byref(out))
    if err:
        raise KernelExecutionError(
            f'stdp_sim: occupancy failed with CUDA error {err} '
            f'({cuda_build.error_string(err)})')
    return out.value


def stdp_sim_grid(num: int, device: torch.device) -> int:
    """The blocks of K24's grid for *num* neurons: one a thread where the
    grid can be co-resident on *device*, else the co-resident grid with
    two a thread (HPC_NPT). Raises ``ValueError`` where even that is too
    small."""
    most = _max_blocks(device.index or 0)
    blocks = min(-(-num // HPC_BLOCK), most)
    if blocks * HPC_BLOCK * HPC_NPT < num:
        raise ValueError(f'stdp_sim: {num} neurons need more than the {most} '
                         f'blocks of {HPC_BLOCK} threads that can be '
                         f'co-resident on {device} at {HPC_NPT} neurons a '
                         f'thread')
    return blocks


def _stdp_sim_cuda(op, v, i_syn, di, ref, ring, spike_count, weights, kplus,
                   khist, spiked, targets, plastic_ptr, static_ptr, n_steps,
                   p, scratch: StdpPlan,
                   counters: Optional[torch.Tensor] = None):
    """K24's launch of *n_steps*, at most ``scratch.steps``; *scratch* is a
    :func:`stdp_plan` of the network, its split plan for K24's grid on the
    device (:func:`stdp_sim_grid`)."""
    f, i = torch.float32, torch.int32
    tensors = [(v, f), (i_syn, f), (di, f), (ref, i), (ring, i),
               (spike_count, i), (weights, f), (kplus, f), (khist, f),
               (spiked, torch.uint8), (targets, i), (plastic_ptr, i),
               (static_ptr, i), (scratch.split, i), (scratch.dlists, i),
               (scratch.counts, i), (scratch.kph, f), (scratch.spikes, i),
               (scratch.recent, i), (scratch.last_walk, i)]
    if counters is not None:
        tensors.append((counters, torch.int64))
    device = check_cuda_tensors(op.name, *tensors)
    num, ne, depth = p.num, p.n_exc, p.depth
    n_plastic = p.n_plastic
    cap = scratch.spikes.shape[-1]
    blocks = stdp_sim_grid(num, device)
    if (any(x.shape != (num,) for x in (v, i_syn, di, ref, spike_count))
            or ring.shape != (depth, num) or kplus.shape != (ne,)
            or khist.shape != (depth, ne) or spiked.shape != (depth, ne)
            or weights.shape != (n_plastic,)
            or plastic_ptr.shape != (ne + 1,)
            or static_ptr.shape != (num + 1,)
            or scratch.dlists.shape != (2, 2 * num, 4)
            or scratch.counts.shape != (stdp_counts(ne),)
            or scratch.steps % HPC_HTILE
            or scratch.kph.shape != (scratch.steps // HPC_HTILE, ne,
                                     HPC_HTILE)
            or scratch.spikes.shape != (ne, cap)
            or cap < spike_capacity(n_steps, p.delay, p.ref_steps,
                                    p.v_reset < p.v_th)
            or scratch.recent.shape != (ne, 16)
            or scratch.last_walk.shape != (ne,)
            or scratch.split.shape != (2 * num, blocks + 1)
            or (counters is not None and counters.shape != (4,))):
        raise ValueError(f'{op.name}: state, rows and scratch do not match '
                         f'num={num}, NE={ne}, P={n_plastic}, D={depth}, '
                         f'a launch of {n_steps} steps and a grid of '
                         f'{blocks} blocks')
    if not 0 <= n_steps <= scratch.steps:
        raise ValueError(f'{op.name}: {n_steps} steps, and the scratch holds '
                         f'launches of at most {scratch.steps}')
    fn = cuda_build.function('stdp_sim_launch', [ctypes.c_void_p] * 21 + [
        ctypes.c_int] * 3 + [ctypes.POINTER(StdpParams)] + [
        ctypes.c_int] * 2 + [ctypes.c_void_p])
    op.launch(fn, v.data_ptr(), i_syn.data_ptr(), di.data_ptr(),
              ref.data_ptr(), ring.data_ptr(), spike_count.data_ptr(),
              weights.data_ptr(), kplus.data_ptr(), khist.data_ptr(),
              spiked.data_ptr(), targets.data_ptr(), plastic_ptr.data_ptr(),
              static_ptr.data_ptr(), scratch.split.data_ptr(),
              scratch.dlists.data_ptr(),
              scratch.counts.data_ptr(), scratch.kph.data_ptr(),
              scratch.spikes.data_ptr(), scratch.recent.data_ptr(),
              scratch.last_walk.data_ptr(),
              None if counters is None else counters.data_ptr(),
              int(n_steps), scratch.steps, cap, ctypes.byref(p), blocks,
              device.index or 0, cuda_stream(device))


stdp_sim = KernelOp('stdp_sim', twin=stdp_loop, cuda=_stdp_sim_cuda,
                    source='brainevent_torch/csrc/stdp_sim.cu', replaces=None)


def stdp_pow_cuda(x: torch.Tensor, mu: float) -> torch.Tensor:
    """``w^mu`` of every entry of the float32 CUDA tensor *x*, as K24
    computes it (its ``powf``, built with the library's flags)."""
    check_cuda_tensors('stdp_pow', (x, torch.float32))
    x = x.contiguous()
    y = torch.empty_like(x)
    fn = cuda_build.function('stdp_pow_launch', [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float,
        ctypes.c_int, ctypes.c_void_p])
    err = fn(x.data_ptr(), y.data_ptr(), x.numel(), mu, x.device.index or 0,
             cuda_stream(x.device))
    if err:
        raise KernelExecutionError(
            f'stdp_pow: launch failed with CUDA error {err} '
            f'({cuda_build.error_string(err)})')
    return y


# -- the network ------------------------------------------------------------------

@dataclasses.dataclass
class HpcStdpNet:
    """The HPC benchmark network at *scale* (10: 112,500 neurons and
    1,265,625,000 synapses, 810,000,000 of them plastic).

    Parameters
    ----------
    scale : float
        ``NE = ne scale`` and ``NI = ni scale``, rounded; the in-degrees
        stay ``ce`` and ``ci``.
    params : :class:`HpcStdpParams`
        The published parameters by default.
    seed : int
        Seeds the generator the network is drawn from on *device*
        (:func:`build_hpc_network`) when the arrays are not given, and
        (plus 1) :meth:`init_state`'s default generator.
    targets, plastic_ptr, static_ptr, weights : optional tensors
        The network as :func:`build_hpc_network` returns it, to share one
        network with another program. ``weights`` are the initial E -> E
        weights, which :meth:`init_state` hands to every state.
    device : torch device, default the card (``'cuda'``)
        CUDA tensors run K24; ``device='cpu'`` runs :func:`stdp_loop`.
    The net keeps the given arrays as they are, and beside them, on a card,
    ``plan`` (:func:`stdp_plan`: K24's scratch for launches of at most
    ``launch_steps``, LAUNCH_STEPS: :meth:`run` makes a longer run in
    launches of at most as many steps; the scratch's K+ history holds 4 B
    an E neuron a step, 3.7 GB at scale 10; and the split plan of the rows
    for K24's grid on the device, :func:`stdp_split`, 0.36 GB at scale
    10), None on the CPU. On a card each row's targets must ascend, as
    :func:`build_hpc_network` draws them.
    """
    scale: float = 1.0
    params: HpcStdpParams = HpcStdpParams()
    seed: int = 42
    targets: Optional[torch.Tensor] = dataclasses.field(default=None,
                                                        repr=False)
    plastic_ptr: Optional[torch.Tensor] = dataclasses.field(default=None,
                                                            repr=False)
    static_ptr: Optional[torch.Tensor] = dataclasses.field(default=None,
                                                           repr=False)
    weights: Optional[torch.Tensor] = dataclasses.field(default=None,
                                                        repr=False)
    device: Optional[torch.device] = None

    def __post_init__(self):
        self.device = check_device(self.device or 'cuda')
        prm = self.params
        self.n_exc, n_inh = prm.sizes(self.scale)
        self.num = self.n_exc + n_inh
        arrays = (self.targets, self.plastic_ptr, self.static_ptr,
                  self.weights)
        if all(a is None for a in arrays):
            gen = torch.Generator(device=self.device).manual_seed(self.seed)
            arrays = build_hpc_network(prm, self.scale, gen,
                                       self.device).values()
        elif any(a is None for a in arrays):
            raise ValueError('give all of targets, plastic_ptr, static_ptr '
                             'and weights, or none')
        dtypes = (torch.int32, torch.int32, torch.int32, torch.float32)
        self.targets, self.plastic_ptr, self.static_ptr, self.weights = (
            torch.as_tensor(a).to(device=self.device, dtype=dt).contiguous()
            for a, dt in zip(arrays, dtypes))
        self.n_plastic = self.weights.numel()
        if (self.plastic_ptr.shape != (self.n_exc + 1,)
                or self.static_ptr.shape != (self.num + 1,)
                or int(self.plastic_ptr[0]) != 0
                or int(self.plastic_ptr[-1]) != self.n_plastic
                or int(self.static_ptr[0]) != self.n_plastic
                or int(self.static_ptr[-1]) != self.targets.numel()):
            raise ValueError(f'the rows do not match {self.n_exc} + '
                             f'{n_inh} neurons, {self.n_plastic} plastic and '
                             f'{self.targets.numel()} synapses in all')
        self.delay = prm.delay_steps()
        if self.delay < 1:
            raise ValueError('the delay must be at least one step')
        # the next power of two above the delay
        self.depth = 1 << self.delay.bit_length()
        self.thresholds = poisson_thresholds(
            prm.poisson_rate() * prm.dt * 1e-3, HPC_KMAX)
        self.launch_steps = LAUNCH_STEPS
        self.plan = None
        if self.device.type == 'cuda':
            q = self.step_params(0, 0)
            cap = spike_capacity(self.launch_steps, q.delay, q.ref_steps,
                                 q.v_reset < q.v_th)
            split = stdp_split(self.targets, self.plastic_ptr,
                               self.static_ptr, self.n_exc,
                               stdp_sim_grid(self.num, self.device))
            self.plan = stdp_plan(self.num, self.n_exc, self.launch_steps,
                                  cap, split)

    # -- state -------------------------------------------------------------------

    def init_state(self, generator: Optional[torch.Generator] = None
                   ) -> HpcStdpState:
        """A state drawn from *generator* (default: a CPU generator seeded
        with ``seed + 1``): ``V ~ N(v0_mean, v0_sd) - E_L``, the Poisson
        key a uniform uint32, the weights the network's initial ones (the
        same tensor, not a copy), the rest 0."""
        if generator is None:
            generator = torch.Generator().manual_seed(self.seed + 1)
        prm, dev = self.params, generator.device
        z = torch.randn(self.num, generator=generator, device=dev)
        key = int(torch.randint(0, 2 ** 32, (1,), generator=generator,
                                device=dev))
        v = f32(prm.v0_mean - prm.e_l) + f32(prm.v0_sd) * z

        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=self.device)
        return HpcStdpState(
            v=v.to(self.device), i_syn=zeros(self.num), di=zeros(self.num),
            ref=zeros(self.num, dtype=torch.int32),
            ring=zeros(self.depth, self.num, dtype=torch.int32),
            spike_count=zeros(self.num, dtype=torch.int32),
            weights=self.weights, kplus=zeros(self.n_exc),
            khist=zeros(self.depth, self.n_exc),
            spiked=zeros(self.depth, self.n_exc, dtype=torch.uint8),
            key=key, step=0)

    def step_params(self, key: int, step: int) -> StdpParams:
        """The scalars K24 and :func:`stdp_loop` read for a trial from
        *step* of the Poisson stream *key*."""
        prm = self.params
        h, ts, tm = prm.dt, prm.tau_syn, prm.tau_m
        je = prm.je_pa()
        units = prm.weight_units
        thr = list(self.thresholds) + [M32] * (HPC_KMAX
                                               - len(self.thresholds))
        return StdpParams(
            p11=f32(math.exp(-h / ts)), p21=f32(h * math.exp(-h / ts)),
            em1=f32(math.expm1(-h / tm)),
            p31=f32(propagator_31(ts, tm, prm.c_m, h)),
            p32=f32(propagator_32(ts, tm, prm.c_m, h)),
            pa=f32(math.e / ts * je / units),
            v_th=f32(prm.v_th - prm.e_l), v_reset=f32(prm.v_reset - prm.e_l),
            kp_decay=f32(math.exp(-h / prm.tau_plus)),
            km_decay=f32(math.exp(-h / prm.tau_minus)),
            lam=f32(prm.lam), lam_alpha=f32(prm.lam * prm.alpha),
            mu=f32(prm.mu), units=f32(units / je),
            num=self.num, n_exc=self.n_exc, n_plastic=self.n_plastic,
            static_e_end=int(self.static_ptr[self.n_exc]), depth=self.depth,
            delay=self.delay, ref_steps=int(round(prm.t_ref / h)),
            w_ext=units, w_e=units, w_i=int(round(prm.g * units)),
            key=key & M32, step0=step & M32,
            thr=(ctypes.c_uint32 * HPC_KMAX)(*thr))

    # -- dynamics ----------------------------------------------------------------

    def run(self, n_steps: int, state: Optional[HpcStdpState] = None
            ) -> HpcStdpState:
        """Run *n_steps* from *state* (default :meth:`init_state`) through
        K24, or :func:`stdp_loop` on the CPU, in launches of at most
        ``launch_steps`` steps (one where it is 0), chained through the
        state; returns the new state, its ``step`` *n_steps* on. *state*
        is not modified: its arrays, the weights among them, are copied
        first.

        With tracing on (:mod:`~brainevent_torch.ops.tracing`), a call
        records the span ``brainevent_torch.HpcStdpNet.run`` (attributes
        ``num``, ``n_plastic``, ``n_steps``, ``route``: ``sim`` on a card,
        ``loop`` on the CPU, and ``npt``: the most neurons a thread of K24
        owns, 0 on the loop) around ``.copies`` and ``.launch``, and adds
        each launch's depressions, facilitations and facilitations made by
        its flush to the counters ``brainevent_torch.HpcStdpNet.depressions``,
        ``.facilitations`` and ``.flush_facilitations`` (0 on the loop,
        which leaves none to a flush), and the sum over its steps of the
        most work a block of K24's grid did in the step's walk (plastic
        entries and the facilitations it made) to
        ``.walk_busiest_block`` (0 on the loop, which has no blocks; its
        ratio to the blocks' mean, ``busiest * blocks / (depressions +
        facilitations - flush_facilitations)``, is the walk's balance).
        On the card the counters are read back only when they are
        drained."""
        if state is None:
            state = self.init_state()
        n_steps = int(n_steps)
        route = 'sim' if state.v.device.type == 'cuda' else 'loop'
        npt = (-(-self.num // (stdp_sim_grid(self.num, state.v.device)
                               * HPC_BLOCK)) if route == 'sim' else 0)
        sizes = [min(self.launch_steps, n_steps - k)
                 for k in range(0, n_steps, self.launch_steps)] or [0]
        counting = tracing.enabled()
        with tracing.span('brainevent_torch.HpcStdpNet.run', num=self.num,
                          n_plastic=self.n_plastic, n_steps=n_steps,
                          route=route, npt=npt):
            p = self.step_params(state.key, state.step)
            with tracing.span('brainevent_torch.HpcStdpNet.copies'):
                out = [getattr(state, k).clone() for k in STATE_FIELDS]
            counters = (torch.empty(len(sizes), 4, dtype=torch.int64,
                                    device=state.v.device)
                        if counting else None)
            extra = dict(scratch=self.plan) if route == 'sim' else {}
            with tracing.span('brainevent_torch.HpcStdpNet.launch'):
                step = state.step
                for c, size in enumerate(sizes):
                    q = StdpParams.from_buffer_copy(p)
                    q.step0 = step & M32
                    stdp_sim(*out, self.targets, self.plastic_ptr,
                             self.static_ptr, size, q,
                             counters=None if counters is None
                             else counters[c], **extra)
                    step += size
            if counting:
                for row in counters:
                    for k, name in enumerate(COUNTERS):
                        tracing.count(name, row[k])
        return HpcStdpState(*out, key=state.key, step=state.step + n_steps)
