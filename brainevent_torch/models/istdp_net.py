# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""Vogels, Sprekeler, Zenke, Clopath & Gerstner 2011 (Science 334:1569, doi
10.1126/science.1211095): a recurrent EI network of conductance-based LIF
neurons whose inhibitory synapses onto the excitatory neurons learn
(inhibitory STDP), set up as Brian 2's
``examples/frompapers/Vogels_et_al_2011.py``, at any scale; the
published parameters are :class:`IstdpParams`.

``NE = 8000 s`` excitatory and ``NI = 2000 s`` inhibitory neurons; every
ordered pair is a synapse with probability ``epsilon / s`` (0.02 at scale
1), so a neuron has on average 160 E and 40 I inputs at every scale. E ->
any neuron: static, ``g_ampa += 0.3 nS``; I -> I: static, ``g_gaba += 3
nS``; I -> E: plastic, ``g_gaba += w nS``, w starting at 1e-10.

One step ``t`` of neuron ``j`` (dt 0.1 ms, Euler as Brian's
``method='euler'``), every product and sum rounded once to float32::

    ga = ga + float(ring[t mod D][AMPA][j]) q;  gg likewise;  slots = 0
    if ref > 0: ref -= 1
    if ref == 0: v = v + (dt / C) (((I_bg - g_L (v - E_L)) - ga v)
                                   - gg (v - E_r))
    ga = (1 - dt / tau_ampa) ga;  gg = (1 - dt / tau_gaba) gg
    if ref == 0 and v > V_t: v = E_L, ref = t_ref / dt, count += 1
    E: A_post = exp(-dt / tau_stdp) A_post;  I: A_pre likewise, + 1 at a
    spike

then the step's synapses, Brian's pre pathway before its post pathway:

1. each I neuron i that spikes at t, each I -> E synapse i -> j:
   ``w = clip(w + eta (A_post_j - alpha), 0, g_max)`` (A_post_j not yet
   counting j's spike at t), then ``rint(w U)`` units into
   ``ring[(t + 1) mod D][GABA][j]``; every static synapse of a spike adds
   its units (0.3 U into AMPA, 3 U into GABA) into its target's slot;
2. each E neuron j that spikes at t, each I -> E synapse i -> j:
   ``w = clip(w + eta A_pre_i, 0, g_max)`` (A_pre_i counting i's spike);
3. the E spikes of t add 1 to A_post.

A conductance enters the ring in int32 units of ``q = 1 / U`` nS (U =
``weight_units``, 10,000 a nS), so a step's input is an exact integer sum
whatever the order of the adds. The refractory rule is Brian's
``timestep(t - lastspike) >= timestep(refractory)``: a neuron that
spikes at step s integrates again at step ``s + t_ref / dt``.

The network (:func:`build_istdp_network`), drawn from a
``torch.Generator`` on the device, has ``build_hpc_network``'s layout: two
CSRs by source over one ``targets`` array (int32), the plastic I -> E
synapses first (positions ``[0, P)``, rows ``plastic_ptr`` of the I
neurons, float32 ``weights`` in nS), then the static ones (``[P, P +
S)``, rows ``static_ptr``: the E neurons' onto E and I targets, then the I
neurons' onto I targets). A row's targets ascend.

:meth:`IstdpNet.run` runs a trial on a card as launches of K24's iSTDP
instance (``istdp_sim`` in ``csrc/stdp_sim.cu``: the HPC network's grid
and rows' lists; the static rows scattered whole with global atomics, the
plastic rows walked by target over a split plan, as the HPC network's,
and each block's spiking E targets' columns after them; every update
eager) of at most LAUNCH_STEPS steps, and on the CPU as
:func:`istdp_loop`, plain PyTorch; they give the same bits.
"""

import ctypes
import dataclasses
import functools
import math
from typing import NamedTuple, Optional

import torch

from ..ops import cuda_build, tracing
from ..ops.core import KernelOp, check_cuda_tensors, check_device, cuda_stream
from .hpc_stdp import (HPC_BLOCK, LAUNCH_STEPS, MAX_SYNAPSES, _owned,
                       _segments, coresident_blocks, grid_blocks, split_lines,
                       stdp_columns)
from .neurons import f32

__all__ = ['IstdpNet', 'IstdpState', 'IstdpParams', 'IstdpSimParams',
           'IstdpPlan', 'build_istdp_network', 'istdp_split', 'istdp_plan',
           'istdp_sim', 'istdp_loop', 'istdp_sim_grid']

STATE_FIELDS = ('v', 'g_ampa', 'g_gaba', 'ref', 'ring', 'spike_count',
                'weights', 'apre', 'apost')
DEPTH = 2                # the ring's slots: every delay is one step
# the counters of a run, in the order of the iSTDP instance's buffer, then
# the phases of its clocked instance (IstdpPhase in csrc/stdp_sim.cu)
COUNTERS = tuple(f'brainevent_torch.IstdpNet.{name}' for name in (
    'pre_updates', 'post_updates'))
PHASES = ('update', 'scatter', 'walk', 'post', 'barrier')
ISTDP_COUNTS = len(COUNTERS) + len(PHASES)
DRAW_ROWS = 4096         # rows of the network whose gaps are drawn at a time
GAP_SDS = 10.0           # a row's gaps: its mean degree plus this many SD


@dataclasses.dataclass(frozen=True)
class IstdpParams:
    """The published parameters (Brian 2's ``Vogels_et_al_2011.py``): sizes
    at scale 1 (``ne``, ``ni``), the connection probability at scale 1,
    the static conductances (nS: ``w_e`` of an E synapse, ``w_ii`` of an
    I -> I one) and the plastic weights' start, the neuron (pF, nS, mV, pA,
    ms), the rule (``tau_stdp`` ms, ``eta``, the target rate ``rho0`` Hz
    and ``alpha = 2 rho0 tau_stdp``, the ceiling ``g_max``), the step
    (ms), the initial membrane (uniform in ``[v0_low, v0_high]`` mV) and
    the ring's units of a nS."""
    ne: int = 8000
    ni: int = 2000
    epsilon: float = 0.02
    w_e: float = 0.3
    w_ii: float = 3.0
    w0: float = 1e-10
    c_m: float = 200.0
    g_l: float = 10.0
    e_l: float = -60.0
    e_r: float = -80.0
    v_t: float = -50.0
    i_bg: float = 200.0
    tau_ampa: float = 5.0
    tau_gaba: float = 10.0
    t_ref: float = 5.0
    tau_stdp: float = 20.0
    eta: float = 1e-2
    rho0: float = 3.0
    alpha: float = 0.12
    g_max: float = 100.0
    dt: float = 0.1
    v0_low: float = -60.0
    v0_high: float = -50.0
    weight_units: int = 10000

    def sizes(self, scale: float = 1.0) -> tuple:
        """``(NE, NI)`` at *scale*, rounded."""
        return int(round(self.ne * scale)), int(round(self.ni * scale))

    def probability(self, scale: float = 1.0) -> float:
        """A pair's connection probability at *scale*: ``epsilon / scale``,
        so the in-degrees stay the published ones."""
        return self.epsilon / scale


class IstdpState(NamedTuple):
    v: torch.Tensor            # membrane (mV), float32 (n,)
    g_ampa: torch.Tensor       # AMPA conductance (nS), float32 (n,)
    g_gaba: torch.Tensor       # GABA conductance (nS), float32 (n,)
    ref: torch.Tensor          # refractory steps left, int32 (n,)
    ring: torch.Tensor         # pending input in units of q, int32 (D, 2, n):
    #                            slot t mod D, channel AMPA then GABA
    spike_count: torch.Tensor  # per-neuron cumulative spikes, int32 (n,)
    weights: torch.Tensor      # the I -> E weights (nS), float32 (P,)
    apre: torch.Tensor         # each I neuron's trace A_pre, float32 (NI,)
    apost: torch.Tensor        # each E neuron's trace A_post, float32 (NE,)
    step: int                  # the next step's index


class IstdpSimParams(ctypes.Structure):
    """The scalars of one network and trial, rounded to float32; the same
    layout as ``struct IstdpParams`` in ``csrc/stdp_sim.cu``."""
    _fields_ = [(name, ctypes.c_float) for name in (
        'dt_c', 'g_l', 'e_l', 'e_r', 'i_bg', 'v_t', 'da', 'dg', 'q', 'kd',
        'eta', 'alpha', 'g_max', 'units')] + [
        (name, ctypes.c_int) for name in (
            'num', 'n_exc', 'n_plastic', 'static_e_end', 'depth', 'ref_steps',
            'w_e', 'w_ii')] + [('step0', ctypes.c_uint32)]


# -- the network ------------------------------------------------------------------

def _bernoulli_rows(rows: int, n_targets: int, p: float, first: int,
                    generator: torch.Generator, device) -> tuple:
    """Each of *rows* sources' synapses onto ``first + [0, n_targets)``,
    every pair one with probability *p*: ``(degree int64 (rows,), targets
    int32, row after row, ascending)``. The gaps between a row's targets
    are geometric, ``floor(log1p(-u) / log1p(-p)) + 1`` of a float64 u
    uniform in [0, 1), drawn ``DRAW_ROWS`` rows at a time, enough of them
    that every row passes its last target (``GAP_SDS`` SD above the mean
    degree); a draw that does not raises ``RuntimeError``."""
    if not 0.0 < p <= 1.0:
        raise ValueError(f'a connection probability of {p} is not one')
    mean = n_targets * p
    budget = int(math.ceil(mean + GAP_SDS * math.sqrt(mean * (1 - p)) + 10))
    budget = max(budget, 1)
    scale = 1.0 / math.log1p(-p) if p < 1.0 else 0.0
    degrees, targets = [], []
    for r0 in range(0, rows, DRAW_ROWS):
        r = min(DRAW_ROWS, rows - r0)
        u = torch.rand((r, budget), generator=generator, device=device,
                       dtype=torch.float64)
        gaps = torch.floor(torch.log1p(-u) * scale).to(torch.int64) + 1
        pos = torch.cumsum(gaps, 1) - 1
        if bool((pos[:, -1] < n_targets).any()):
            raise RuntimeError('a row of the network drew fewer gaps than it '
                               'needs; raise GAP_SDS')
        keep = pos < n_targets
        degrees.append(keep.sum(1))
        targets.append((pos[keep] + first).to(torch.int32))
    if not degrees:
        return (torch.zeros(0, dtype=torch.int64, device=device),
                torch.zeros(0, dtype=torch.int32, device=device))
    return torch.cat(degrees), torch.cat(targets)


def build_istdp_network(params: IstdpParams, scale: float,
                        generator: torch.Generator, device) -> dict:
    """The network at *scale*, drawn on *device* from *generator* (on that
    device): ``targets`` (int32), ``plastic_ptr`` (int32, NI + 1),
    ``static_ptr`` (int32, N + 1) and ``weights`` (float32, P, every one
    ``w0``).

    In turn: each E neuron's targets among all neurons, each I neuron's
    among the E neurons (the plastic rows), each I neuron's among the I
    neurons; every ordered pair (a neuron and itself too, as Brian's
    ``connect(p=)``) independently with probability ``epsilon / scale``
    (:func:`_bernoulli_rows`)."""
    ne, ni = params.sizes(scale)
    n = ne + ni
    p = params.probability(scale)
    if n * n * p > MAX_SYNAPSES / 2:
        raise ValueError(f'{n} neurons at p = {p} are more synapses than '
                         f'the int32 positions hold ({MAX_SYNAPSES})')

    def rows(count, n_targets, first):
        return _bernoulli_rows(count, n_targets, p, first, generator, device)
    deg_e, t_e = rows(ne, n, 0)
    deg_ie, t_ie = rows(ni, ne, 0)
    deg_ii, t_ii = rows(ni, ni, ne)
    n_plastic = t_ie.numel()
    if n_plastic + t_e.numel() + t_ii.numel() > MAX_SYNAPSES:
        raise ValueError(f'the network drew more synapses than the int32 '
                         f'positions hold ({MAX_SYNAPSES})')
    plastic_ptr = torch.zeros(ni + 1, dtype=torch.int64, device=device)
    torch.cumsum(deg_ie, 0, out=plastic_ptr[1:])
    static_ptr = torch.full((n + 1,), n_plastic, dtype=torch.int64,
                            device=device)
    static_ptr[1:] += torch.cumsum(torch.cat([deg_e, deg_ii]), 0)
    weights = torch.full((n_plastic,), f32(params.w0), device=device)
    return dict(targets=torch.cat([t_ie, t_e, t_ii]),
                plastic_ptr=plastic_ptr.to(torch.int32),
                static_ptr=static_ptr.to(torch.int32), weights=weights)


def istdp_split(targets, plastic_ptr, n_exc: int, num: int,
                blocks: int) -> torch.Tensor:
    """The iSTDP instance's split plan of the network's plastic rows for a
    grid of *blocks* (``hpc_stdp.split_lines``, as the HPC network's
    ``stdp_split``): int32 ``(NI, blocks + 1)``, the line of each I
    neuron's plastic row by its E targets, block ``b`` owning the E
    neurons ``[b NE / G, (b + 1) NE / G)``. The static rows are scattered
    whole and have no line."""
    e, _ = _owned(n_exc, num, blocks, targets.device)
    ni = plastic_ptr.numel() - 1
    return split_lines(targets, plastic_ptr.long(), ((0, 0, ni, e),), num,
                       blocks)


# -- the twin ---------------------------------------------------------------------

def _clip(w: torch.Tensor, p: IstdpSimParams) -> torch.Tensor:
    """``min(max(w, 0), g_max)``, as the kernel makes it."""
    w = torch.where(w > 0, w, 0.0)
    return torch.where(w < p.g_max, w, p.g_max)


def istdp_loop(v, g_ampa, g_gaba, ref, ring, spike_count, weights, apre,
               apost, targets, plastic_ptr, static_ptr, n_steps: int,
               p: IstdpSimParams, counters: Optional[torch.Tensor] = None
               ) -> None:
    """Plain PyTorch twin of K24's iSTDP instance, in place: *n_steps* steps
    from ``p.step0`` (see the module's docstring), the post updates over
    the columns (``stdp_columns``). *counters* (int64,
    ``(ISTDP_COUNTS,)``), where given, is set to the pre and post updates
    made, and 0 in the rest: the loop has no phases."""
    col_ptr, col_pos, col_src = stdp_columns(targets, plastic_ptr, p.n_exc)
    num, ne = p.num, p.n_exc
    dmask = p.depth - 1
    flat = ring.view(-1)
    if counters is not None:
        counters.zero_()
    for k in range(n_steps):
        t = (p.step0 + k) & 0xFFFFFFFF
        now = ring[t & dmask]
        sa, sg = now[0].clone(), now[1].clone()
        now.zero_()
        ga = g_ampa + sa.to(torch.float32) * p.q
        gg = g_gaba + sg.to(torch.float32) * p.q
        ref.sub_((ref > 0).to(torch.int32))
        live = ref == 0
        cur = ((p.i_bg - p.g_l * (v - p.e_l)) - ga * v) - gg * (v - p.e_r)
        v.copy_(torch.where(live, v + p.dt_c * cur, v))
        g_ampa.copy_(p.da * ga)
        g_gaba.copy_(p.dg * gg)
        spike = live & (v > p.v_t)
        v.masked_fill_(spike, p.e_l)
        ref.masked_fill_(spike, p.ref_steps)
        spike_count.add_(spike.to(torch.int32))
        before = p.kd * apost
        apre.copy_(p.kd * apre)
        apre.add_(spike[ne:].to(torch.float32))
        late = ((t + 1) & dmask) * 2 * num
        # 1. the rows of the spikes of t: pre updates, then deliveries
        ids = torch.nonzero(spike).flatten()
        ep = _segments(plastic_ptr, ids[ids >= ne] - ne)
        if ep.numel():
            tg = targets[ep].long()
            w = _clip(weights[ep] + p.eta * (before[tg] - p.alpha), p)
            weights[ep] = w
            flat.index_add_(0, late + num + tg,
                            torch.round(w * p.units).to(torch.int32))
        es = _segments(static_ptr, ids)
        if es.numel():
            from_e = es < p.static_e_end
            flat.index_add_(0, late + torch.where(from_e, 0, num)
                            + targets[es].long(),
                            torch.where(from_e, p.w_e, p.w_ii).to(
                                torch.int32))
        # 2. the columns of the E spikes of t: post updates
        e = _segments(col_ptr, torch.nonzero(spike[:ne]).flatten())
        if e.numel():
            pos = col_pos[e].long()
            weights[pos] = _clip(weights[pos] + p.eta * apre[
                col_src[e].long()], p)
        if counters is not None:
            counters[:2] += torch.tensor([ep.numel(), e.numel()],
                                         device=counters.device)
        # 3. the E spikes of t into A_post
        apost.copy_(before + spike[:ne].to(torch.float32))


# -- K24's iSTDP instance: the whole trial in one launch ------------------------------

class IstdpPlan(NamedTuple):
    """The iSTDP instance's scratch and read-only plan: the lists of a
    step's spiking rows (``lists`` int32 ``(2, NI + num)``, by parity: the
    plastic rows' I neurons less NE, then the static rows' neurons) and
    their counters (``counts`` int32 ``(4,)``, by parity: plastic, static),
    each E neuron's spike of the step (``fired`` uint8 ``(NE,)``), the
    plastic synapses by target (``col_ptr`` int32 ``(NE + 1,)``,
    ``col_pos`` and ``col_src`` int32 ``(P,)``, ``stdp_columns``) and the
    split plan of the plastic rows for the instance's grid (``split``,
    :func:`istdp_split`). One launch at a time uses a plan's scratch
    (launches on one stream)."""
    lists: torch.Tensor
    counts: torch.Tensor
    fired: torch.Tensor
    col_ptr: torch.Tensor
    col_pos: torch.Tensor
    col_src: torch.Tensor
    split: torch.Tensor


def istdp_plan(targets, plastic_ptr, n_exc: int, num: int,
               split: torch.Tensor) -> IstdpPlan:
    """The :class:`IstdpPlan` of a network of *num* neurons, *n_exc* of
    them E, on the device of *split* (:func:`istdp_split`, kept as it
    is)."""
    def scratch(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=split.device)
    col_ptr, col_pos, col_src = stdp_columns(targets, plastic_ptr, n_exc)
    return IstdpPlan(lists=scratch(2, 2 * num - n_exc), counts=scratch(4),
                     fired=scratch(n_exc, dtype=torch.uint8),
                     col_ptr=col_ptr, col_pos=col_pos, col_src=col_src,
                     split=split)


@functools.lru_cache(maxsize=None)
def _max_blocks(device_index: int) -> int:
    return coresident_blocks('istdp_sim_max_blocks', device_index)


def istdp_sim_grid(num: int, device: torch.device) -> int:
    """The blocks of the iSTDP instance's grid for *num* neurons on
    *device* (``hpc_stdp.grid_blocks``: two neurons a thread where one
    would need more blocks than can be co-resident, else ``ValueError``)."""
    return grid_blocks('istdp_sim', num, _max_blocks(device.index or 0),
                       device)


def _istdp_sim_cuda(op, v, g_ampa, g_gaba, ref, ring, spike_count, weights,
                    apre, apost, targets, plastic_ptr, static_ptr, n_steps,
                    p, scratch: IstdpPlan,
                    counters: Optional[torch.Tensor] = None):
    """The iSTDP instance's launch of *n_steps*; *scratch* is an
    :func:`istdp_plan` of the network, its split plan for the instance's
    grid on the device (:func:`istdp_sim_grid`). Given *counters* (int64
    ``(ISTDP_COUNTS,)``, zeroed), the launch takes the clocked instance,
    which adds the launch's pre and post updates (:data:`COUNTERS`) and the
    grid's warps' ns in each of :data:`PHASES` to it; without, the plain
    one, which counts nothing."""
    f, i = torch.float32, torch.int32
    tensors = [(v, f), (g_ampa, f), (g_gaba, f), (ref, i), (ring, i),
               (spike_count, i), (weights, f), (apre, f), (apost, f),
               (targets, i), (plastic_ptr, i), (static_ptr, i),
               (scratch.col_ptr, i), (scratch.col_pos, i),
               (scratch.col_src, i), (scratch.split, i), (scratch.lists, i),
               (scratch.counts, i), (scratch.fired, torch.uint8)]
    if counters is not None:
        tensors.append((counters, torch.int64))
    device = check_cuda_tensors(op.name, *tensors)
    num, ne, depth, n_plastic = p.num, p.n_exc, p.depth, p.n_plastic
    blocks = istdp_sim_grid(num, device)
    if (any(x.shape != (num,) for x in (v, g_ampa, g_gaba, ref, spike_count))
            or ring.shape != (depth, 2, num) or apre.shape != (num - ne,)
            or apost.shape != (ne,) or weights.shape != (n_plastic,)
            or plastic_ptr.shape != (num - ne + 1,)
            or static_ptr.shape != (num + 1,)
            or scratch.lists.shape != (2, 2 * num - ne)
            or scratch.counts.shape != (4,)
            or scratch.fired.shape != (ne,)
            or scratch.col_ptr.shape != (ne + 1,)
            or scratch.col_pos.shape != (n_plastic,)
            or scratch.col_src.shape != (n_plastic,)
            or scratch.split.shape != (num - ne, blocks + 1)
            or (counters is not None
                and counters.shape != (ISTDP_COUNTS,))):
        raise ValueError(f'{op.name}: state, rows and scratch do not match '
                         f'num={num}, NE={ne}, P={n_plastic}, D={depth} '
                         f'and a grid of {blocks} blocks')
    if n_steps < 0:
        raise ValueError(f'{op.name}: {n_steps} steps')
    fn = cuda_build.function('istdp_sim_launch', [ctypes.c_void_p] * 20 + [
        ctypes.c_int, ctypes.POINTER(IstdpSimParams)] + [
        ctypes.c_int] * 2 + [ctypes.c_void_p])
    op.launch(fn, v.data_ptr(), g_ampa.data_ptr(), g_gaba.data_ptr(),
              ref.data_ptr(), ring.data_ptr(), spike_count.data_ptr(),
              weights.data_ptr(), apre.data_ptr(), apost.data_ptr(),
              targets.data_ptr(), plastic_ptr.data_ptr(),
              static_ptr.data_ptr(), scratch.col_ptr.data_ptr(),
              scratch.col_pos.data_ptr(), scratch.col_src.data_ptr(),
              scratch.split.data_ptr(), scratch.lists.data_ptr(),
              scratch.counts.data_ptr(), scratch.fired.data_ptr(),
              None if counters is None else counters.data_ptr(),
              int(n_steps), ctypes.byref(p), blocks, device.index or 0,
              cuda_stream(device))


istdp_sim = KernelOp('istdp_sim', twin=istdp_loop, cuda=_istdp_sim_cuda,
                     source='brainevent_torch/csrc/stdp_sim.cu',
                     replaces=None)


# -- the network ------------------------------------------------------------------

@dataclasses.dataclass
class IstdpNet:
    """Vogels et al. 2011's network at *scale* (20: 200,000 neurons and
    about 40 M synapses, 6.4 M of them plastic).

    Parameters
    ----------
    scale : float
        ``NE = ne scale`` and ``NI = ni scale``, rounded; each pair a
        synapse with probability ``epsilon / scale`` (at most 1).
    params : :class:`IstdpParams`
        The published parameters by default.
    seed : int
        Seeds the generator the network is drawn from on *device*
        (:func:`build_istdp_network`) when the arrays are not given, and
        (plus 1) :meth:`init_state`'s default generator.
    targets, plastic_ptr, static_ptr, weights : optional tensors
        The network as :func:`build_istdp_network` returns it, to share one
        network with another program. ``weights`` are the initial I -> E
        weights, which :meth:`init_state` hands to every state.
    device : torch device, default the card (``'cuda'``)
        CUDA tensors run K24's iSTDP instance; ``device='cpu'`` runs
        :func:`istdp_loop`.
    The net keeps the given arrays as they are, and beside them, on a card,
    ``plan`` (:func:`istdp_plan`: the instance's scratch, the plastic
    synapses by target and the split plan of the plastic rows for its grid
    on the device, 64 MB at scale 20), None on the CPU; :meth:`run` makes a
    longer run than ``launch_steps`` (LAUNCH_STEPS) in launches of at most
    as many steps. On a card each row's targets must ascend, as
    :func:`build_istdp_network` draws them.
    """
    scale: float = 1.0
    params: IstdpParams = IstdpParams()
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
            arrays = build_istdp_network(prm, self.scale, gen,
                                         self.device).values()
        elif any(a is None for a in arrays):
            raise ValueError('give all of targets, plastic_ptr, static_ptr '
                             'and weights, or none')
        dtypes = (torch.int32, torch.int32, torch.int32, torch.float32)
        self.targets, self.plastic_ptr, self.static_ptr, self.weights = (
            torch.as_tensor(a).to(device=self.device, dtype=dt).contiguous()
            for a, dt in zip(arrays, dtypes))
        self.n_plastic = self.weights.numel()
        if (self.plastic_ptr.shape != (n_inh + 1,)
                or self.static_ptr.shape != (self.num + 1,)
                or int(self.plastic_ptr[0]) != 0
                or int(self.plastic_ptr[-1]) != self.n_plastic
                or int(self.static_ptr[0]) != self.n_plastic
                or int(self.static_ptr[-1]) != self.targets.numel()):
            raise ValueError(f'the rows do not match {self.n_exc} + '
                             f'{n_inh} neurons, {self.n_plastic} plastic and '
                             f'{self.targets.numel()} synapses in all')
        self.depth = DEPTH
        self.launch_steps = LAUNCH_STEPS
        self.plan = None
        if self.device.type == 'cuda':
            split = istdp_split(self.targets, self.plastic_ptr, self.n_exc,
                                self.num,
                                istdp_sim_grid(self.num, self.device))
            self.plan = istdp_plan(self.targets, self.plastic_ptr,
                                   self.n_exc, self.num, split)

    # -- state -------------------------------------------------------------------

    def init_state(self, generator: Optional[torch.Generator] = None
                   ) -> IstdpState:
        """A state drawn from *generator* (default: a CPU generator seeded
        with ``seed + 1``): v uniform in ``[v0_low, v0_high]`` (float32 of
        ``v0_low + (v0_high - v0_low) u``), the weights the network's
        initial ones (the same tensor, not a copy), the rest 0."""
        if generator is None:
            generator = torch.Generator().manual_seed(self.seed + 1)
        prm = self.params
        u = torch.rand(self.num, generator=generator, device=generator.device)
        v = f32(prm.v0_low) + f32(prm.v0_high - prm.v0_low) * u

        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=self.device)
        return IstdpState(
            v=v.to(self.device), g_ampa=zeros(self.num),
            g_gaba=zeros(self.num), ref=zeros(self.num, dtype=torch.int32),
            ring=zeros(self.depth, 2, self.num, dtype=torch.int32),
            spike_count=zeros(self.num, dtype=torch.int32),
            weights=self.weights, apre=zeros(self.num - self.n_exc),
            apost=zeros(self.n_exc), step=0)

    def step_params(self, step: int) -> IstdpSimParams:
        """The scalars the iSTDP instance and :func:`istdp_loop` read for a
        trial from *step*."""
        prm = self.params
        units = prm.weight_units
        return IstdpSimParams(
            dt_c=f32(prm.dt / prm.c_m), g_l=f32(prm.g_l), e_l=f32(prm.e_l),
            e_r=f32(prm.e_r), i_bg=f32(prm.i_bg), v_t=f32(prm.v_t),
            da=f32(1.0 - prm.dt / prm.tau_ampa),
            dg=f32(1.0 - prm.dt / prm.tau_gaba), q=f32(1.0 / units),
            kd=f32(math.exp(-prm.dt / prm.tau_stdp)), eta=f32(prm.eta),
            alpha=f32(prm.alpha), g_max=f32(prm.g_max), units=f32(units),
            num=self.num, n_exc=self.n_exc, n_plastic=self.n_plastic,
            static_e_end=int(self.static_ptr[self.n_exc]), depth=self.depth,
            ref_steps=int(round(prm.t_ref / prm.dt)),
            w_e=int(round(prm.w_e * units)),
            w_ii=int(round(prm.w_ii * units)), step0=step & 0xFFFFFFFF)

    # -- dynamics ----------------------------------------------------------------

    def run(self, n_steps: int, state: Optional[IstdpState] = None
            ) -> IstdpState:
        """Run *n_steps* from *state* (default :meth:`init_state`) through
        K24's iSTDP instance, or :func:`istdp_loop` on the CPU, in launches
        of at most ``launch_steps`` steps, chained through the state;
        returns the new state, its ``step`` *n_steps* on. *state* is not
        modified: its arrays, the weights among them, are copied first.

        With tracing on (:mod:`~brainevent_torch.ops.tracing`), a call
        records the span ``brainevent_torch.IstdpNet.run`` (attributes
        ``num``, ``n_plastic``, ``n_steps``, ``route``: ``sim`` on a card,
        ``loop`` on the CPU, and ``npt``: the most neurons a thread of the
        instance owns, 0 on the loop) around ``.copies`` and ``.launch``,
        and adds each launch's pre and post updates to the counters
        ``brainevent_torch.IstdpNet.pre_updates`` and ``.post_updates``. On
        the card the launches then take the clocked instance, and each adds
        its warps' ns in each phase of the step (update, scatter, walk,
        post, barrier) and its warps times its steps
        (:func:`~brainevent_torch.ops.tracing.count_phases`); the loop
        counts no phase. The counters are read back from the card only when
        they are drained."""
        if state is None:
            state = self.init_state()
        n_steps = int(n_steps)
        route = 'sim' if state.v.device.type == 'cuda' else 'loop'
        threads = (istdp_sim_grid(self.num, state.v.device) * HPC_BLOCK
                   if route == 'sim' else 0)
        npt = -(-self.num // threads) if threads else 0
        sizes = [min(self.launch_steps, n_steps - k)
                 for k in range(0, n_steps, self.launch_steps)] or [0]
        counting = tracing.enabled()
        with tracing.span('brainevent_torch.IstdpNet.run', num=self.num,
                          n_plastic=self.n_plastic, n_steps=n_steps,
                          route=route, npt=npt):
            with tracing.span('brainevent_torch.IstdpNet.copies'):
                out = [getattr(state, k).clone() for k in STATE_FIELDS]
            counters = (torch.zeros(len(sizes), ISTDP_COUNTS,
                                    dtype=torch.int64, device=state.v.device)
                        if counting else None)
            extra = dict(scratch=self.plan) if route == 'sim' else {}
            with tracing.span('brainevent_torch.IstdpNet.launch'):
                step = state.step
                for c, n in enumerate(sizes):
                    istdp_sim(*out, self.targets, self.plastic_ptr,
                              self.static_ptr, n, self.step_params(step),
                              counters=None if counters is None
                              else counters[c], **extra)
                    step += n
            if counting:
                for row, n in zip(counters, sizes):
                    for k, name in enumerate(COUNTERS):
                        tracing.count(name, row[k])
                    if route == 'sim':
                        tracing.count_phases(
                            'IstdpNet', row[len(COUNTERS):], PHASES,
                            threads // 32 * n)
        return IstdpState(*out, step=state.step + n_steps)
