# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""The Potjans-Diesmann cortical microcircuit (Potjans & Diesmann 2014,
Cereb. Cortex 24:785, doi 10.1093/cercor/bhs358), at any scale.

Eight populations (L2/3, L4, L5 and L6, each excitatory and inhibitory) of
``iaf_psc_exp`` neurons, 77,169 at full scale, joined by the published
8 x 8 table of connection probabilities into 298,880,968 synapses with
per-synapse weights and delays, and driven by a Poisson background on
every neuron. The parameters are the defaults of the NEST example of the
model (``network_params`` and ``neuron_params``); :class:`MicrocircuitParams`
holds them.

The network (:func:`build_microcircuit`), drawn from a
``torch.Generator`` on the device, is CSR by source: ``row_ptr`` (int32),
``targets`` (int32), ``weights`` (int16, in units of ``q = PSC_mean /
4096`` pA) and ``delays`` (uint8, in steps, ``1 <= d < D``, ``D`` the ring's
depth: the next power of two above the largest delay drawn).

One step ``t`` of neuron ``j``, in NEST's ``iaf_psc_exp`` order, with ``V``
held relative to ``E_L``::

    s = ring[t mod D][j];  ring[t mod D][j] = 0
    u = mix(mix(key ^ t * 0x9E3779B9) ^ j * 0x85EBCA6B)     (light_rng_mix32)
    s += 4096 * #{m < 16 : u >= thr[pop(j)][m]}               (Poisson(lambda))
    if ref == 0: V = fma(I, P21, V * P22)  else: ref -= 1
    I = fma(I, P11, q * float(s))
    if V >= V_th: V = V_reset, ref = t_ref / dt, count += 1, and each
        synapse (target, w, d) of row j adds w to ring[(t + d) mod D][target]

The input of a step is an exact int32 sum whatever the order of its adds
(count first, scale after, as :class:`~brainevent_torch.EINet` does), and
every multiply-add is one FMA, so :meth:`MicrocircuitNet.run` on a card
(kernel K23, ``csrc/mc_sim.cu``, a whole trial in one launch) and on the
CPU (:func:`mc_loop`, plain PyTorch) give the same bits.
"""

import ctypes
import dataclasses
import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from .._error import KernelExecutionError
from ..ops import cuda_build, tracing
from ..ops.core import KernelOp, check_cuda_tensors, check_device, cuda_stream
from ..rng.light import M32, _mul32, light_rng_mix32
from .neurons import f32

__all__ = ['MicrocircuitNet', 'MicrocircuitState', 'MicrocircuitParams',
           'McParams', 'build_microcircuit', 'synapse_counts',
           'poisson_thresholds', 'McPlan', 'mc_plan', 'mc_sim', 'mc_loop',
           'mc_sim_grid']

# rows: the target population, columns: the source, both in the order
# L2/3E, L2/3I, L4E, L4I, L5E, L5I, L6E, L6I
CONN_PROBS = (
    (0.1009, 0.1689, 0.0437, 0.0818, 0.0323, 0.0, 0.0076, 0.0),
    (0.1346, 0.1371, 0.0316, 0.0515, 0.0755, 0.0, 0.0042, 0.0),
    (0.0077, 0.0059, 0.0497, 0.135, 0.0067, 0.0003, 0.0453, 0.0),
    (0.0691, 0.0029, 0.0794, 0.1597, 0.0033, 0.0, 0.1057, 0.0),
    (0.1004, 0.0622, 0.0505, 0.0057, 0.0831, 0.3726, 0.0204, 0.0),
    (0.0548, 0.0269, 0.0257, 0.0022, 0.06, 0.3158, 0.0086, 0.0),
    (0.0156, 0.0066, 0.0211, 0.0166, 0.0572, 0.0197, 0.0396, 0.2252),
    (0.0364, 0.001, 0.0034, 0.0005, 0.0277, 0.008, 0.0658, 0.1443))

MC_MAX_POPS = 8          # populations K23 takes (MC_MAX_POPS in mc_sim.cu)
MC_KMAX = 16             # Poisson thresholds a population (MC_KMAX)
MC_BLOCK = 256           # threads a block of K23, one neuron each (MC_BLOCK)
MC_LISTS = 3             # K23's lists of spiking rows, by step mod 3 (MC_LISTS)
# the phases of K23's clocked instance (McPhase in csrc/mc_sim.cu)
PHASES = ('update', 'scatter', 'barrier')
T_MUL = 0x9E3779B9       # the hash's step and neuron multipliers
I_MUL = 0x85EBCA6B


@dataclasses.dataclass(frozen=True)
class MicrocircuitParams:
    """The published parameters (the NEST example's defaults): sizes at
    full scale, connection probabilities (target x source), external
    in-degrees ``k_ext``, background rate (Hz), mean PSP (mV), the
    inhibitory factor ``g``, relative SDs of weights and delays, mean
    delays (ms) of excitatory and inhibitory sources, the neuron (pF, ms,
    mV), the step (ms) and the initial membrane ``N(v0_mean, v0_sd)``.
    The L4E -> L2/3E weight is ``l4e_to_l23e`` times the excitatory one."""
    full_sizes: tuple = (20683, 5834, 21915, 5479, 4850, 1065, 14395, 2948)
    conn_probs: tuple = CONN_PROBS
    k_ext: tuple = (1600, 1500, 2100, 1900, 2000, 1900, 2900, 2100)
    excitatory: tuple = (True, False) * 4
    bg_rate: float = 8.0
    psp_mean: float = 0.15
    g: float = -4.0
    w_rel_sd: float = 0.1
    l4e_to_l23e: float = 2.0
    d_mean_e: float = 1.5
    d_mean_i: float = 0.75
    d_rel_sd: float = 0.5
    c_m: float = 250.0
    tau_m: float = 10.0
    tau_syn: float = 0.5
    t_ref: float = 2.0
    e_l: float = -65.0
    v_th: float = -50.0
    v_reset: float = -65.0
    dt: float = 0.1
    v0_mean: float = -58.0
    v0_sd: float = 10.0
    weight_units: int = 4096

    def sizes(self, scale: float = 1.0) -> tuple:
        """The populations' sizes at *scale*, rounded."""
        return tuple(int(round(n * scale)) for n in self.full_sizes)

    def psc_mean(self) -> float:
        """The PSC (pA) whose PSP peaks at ``psp_mean``: 87.81 pA."""
        tm, ts = self.tau_m, self.tau_syn
        sub = 1.0 / (ts - tm)
        pre = tm * ts * sub / self.c_m
        frac = (tm / ts) ** sub
        return self.psp_mean / (pre * (frac ** tm - frac ** ts))

    def weight_means(self) -> np.ndarray:
        """The mean weight of each projection (target x source), in units
        of ``q = psc_mean / weight_units``."""
        w = np.array([[1.0 if e else self.g for e in self.excitatory]
                      for _ in self.excitatory]) * self.weight_units
        w[0, 2] *= self.l4e_to_l23e
        return w


def synapse_counts(params: MicrocircuitParams, sizes) -> np.ndarray:
    """Synapses of each projection (target x source) between populations
    of *sizes*: ``K = log(1 - C) / log(1 - 1 / (N_pre N_post))``, rounded
    (0 where either population is empty)."""
    n = np.asarray(sizes, dtype=np.float64)
    c = np.asarray(params.conn_probs, dtype=np.float64)
    pairs = np.outer(n, n)
    with np.errstate(divide='ignore', invalid='ignore'):
        k = np.log(1.0 - c) / np.log(1.0 - 1.0 / pairs)
    return np.where(pairs > 0, np.round(np.nan_to_num(k)), 0).astype(np.int64)


def poisson_thresholds(lam: float, kmax: int = MC_KMAX) -> list:
    """The uint32 thresholds of a Poisson(*lam*) draw from a uniform uint32
    ``u``: ``thr[m] = floor(2^32 P(k <= m))`` in float64, truncated (at most
    ``2^32 - 1``); the draw is the number of thresholds ``u`` reaches."""
    out, term, cdf = [], math.exp(-lam), 0.0
    for m in range(kmax):
        cdf += term
        term *= lam / (m + 1)
        out.append(min(int(math.floor(cdf * 2.0 ** 32)), M32))
    return out


def _redrawn(draw, bad, n: int) -> torch.Tensor:
    """*n* values of ``draw(k)``, those where ``bad`` holds drawn again."""
    x = draw(n)
    idx = torch.nonzero(bad(x)).flatten()
    while idx.numel():
        x[idx] = draw(idx.numel())
        idx = idx[bad(x[idx])]
    return x


def build_microcircuit(params: MicrocircuitParams, scale: float,
                       generator: torch.Generator, device) -> dict:
    """The network at *scale*, CSR by source, drawn on *device* from
    *generator* (on that device): ``row_ptr``, ``targets``, ``weights``
    and ``delays``.

    For each source population, then each target population, its
    projection's synapses (:func:`synapse_counts`) are drawn in turn: the
    presynaptic and the postsynaptic neuron uniformly within their
    populations (multapses and autapses allowed), the weight ``N(mean,
    w_rel_sd |mean|)`` drawn again where its sign flips, then rounded to
    int16 units of ``q``, and the delay ``N(mean, d_rel_sd mean)`` drawn
    again below ``dt`` (NEST 2's ``normal_clipped``), then rounded to
    steps. Each source population's synapses are then put in the order of
    their source (a stable sort)."""
    sizes = params.sizes(scale)
    counts = synapse_counts(params, sizes)
    w_mean = params.weight_means()
    starts = np.concatenate([[0], np.cumsum(sizes)])

    def normal(mean, sd):
        return lambda k: mean + sd * torch.randn(
            k, generator=generator, device=device)

    degree, targets, weights, delays = [], [], [], []
    for p, n_pre in enumerate(sizes):
        d_mean = (params.d_mean_e if params.excitatory[p]
                  else params.d_mean_i) / params.dt
        pre, parts = [], ([], [], [])
        for q, n_post in enumerate(sizes):
            k = int(counts[q, p])
            if k == 0:
                continue
            pre.append(torch.randint(0, n_pre, (k,), generator=generator,
                                     device=device, dtype=torch.int32))
            parts[0].append(torch.randint(
                0, n_post, (k,), generator=generator, device=device,
                dtype=torch.int32) + int(starts[q]))
            mean = float(w_mean[q, p])
            w = _redrawn(normal(mean, params.w_rel_sd * abs(mean)),
                         lambda x, m=mean: x * m <= 0, k)
            parts[1].append(torch.round(w).to(torch.int16))
            d = _redrawn(normal(d_mean, params.d_rel_sd * d_mean),
                         lambda x: x < 1.0, k)
            parts[2].append(torch.round(d).to(torch.uint8))
        if not pre:
            degree.append(torch.zeros(n_pre, dtype=torch.int64,
                                      device=device))
            continue
        pre = torch.cat(pre)
        order = torch.sort(pre, stable=True).indices
        degree.append(torch.bincount(pre, minlength=n_pre))
        del pre
        for out, part in zip((targets, weights, delays), parts):
            out.append(torch.cat(part)[order])
        del order, parts
    row_ptr = torch.zeros(starts[-1] + 1, dtype=torch.int64, device=device)
    torch.cumsum(torch.cat(degree), 0, out=row_ptr[1:])

    def joined(parts, dtype):
        return (torch.cat(parts) if parts
                else torch.zeros(0, dtype=dtype, device=device))
    return dict(row_ptr=row_ptr.to(torch.int32),
                targets=joined(targets, torch.int32),
                weights=joined(weights, torch.int16),
                delays=joined(delays, torch.uint8))


class MicrocircuitState(NamedTuple):
    v: torch.Tensor            # membrane relative to E_L (mV), float32 (n,)
    i_syn: torch.Tensor        # synaptic current (pA), float32 (n,)
    ref: torch.Tensor          # refractory steps left, int32 (n,)
    ring: torch.Tensor         # pending input in weight units, int32 (D, n)
    spike_count: torch.Tensor  # per-neuron cumulative spikes, int32 (n,)
    key: int                   # the Poisson stream, a uint32
    step: int                  # the next step's index


class McParams(ctypes.Structure):
    """The scalars of one network and trial, rounded to float32; the same
    layout as ``struct McParams`` in ``csrc/mc_sim.cu``."""
    _fields_ = [(name, ctypes.c_float) for name in (
        'p11', 'p21', 'p22', 'q', 'v_th', 'v_reset')] + [
        (name, ctypes.c_int) for name in (
            'num', 'depth', 'ref_steps', 'w_ext')] + [
        ('key', ctypes.c_uint32), ('step0', ctypes.c_uint32),
        ('n_pops', ctypes.c_int), ('pop_start', ctypes.c_int * (
            MC_MAX_POPS + 1)),
        ('thr', ctypes.c_uint32 * (MC_MAX_POPS * MC_KMAX))]


# -- the twin ---------------------------------------------------------------------

def mc_loop(v, i_syn, ref, ring, spike_count, row_ptr, targets, weights,
            delays, n_steps: int, p: McParams) -> None:
    """Plain PyTorch twin of K23, in place: *n_steps* steps from
    ``p.step0`` (see the module's docstring), each spike's row added into
    the ring with ``index_add_`` on int32."""
    num, depth = p.num, p.depth
    device = v.device
    sizes = [p.pop_start[k + 1] - p.pop_start[k] for k in range(p.n_pops)]
    pop = torch.repeat_interleave(torch.arange(p.n_pops, device=device),
                                  torch.tensor(sizes, device=device))
    thr = torch.tensor(list(p.thr), dtype=torch.int64, device=device).view(
        MC_MAX_POPS, MC_KMAX)[pop]
    neuron_hash = _mul32(torch.arange(num, device=device), I_MUL)
    degree = (row_ptr[1:] - row_ptr[:-1]).long()
    p11 = torch.tensor(p.p11, dtype=torch.float32, device=device)
    p21 = torch.tensor(p.p21, dtype=torch.float32, device=device)
    flat = ring.view(-1)
    for k in range(n_steps):
        t = (p.step0 + k) & M32
        now = ring[t & (depth - 1)]
        s = now.clone()
        now.zero_()
        h = int(light_rng_mix32(p.key ^ ((t * T_MUL) & M32)))
        u = light_rng_mix32(h ^ neuron_hash)
        s += ((u[:, None] >= thr).sum(1) * p.w_ext).to(torch.int32)
        live = ref == 0
        v.copy_(torch.where(live, torch.addcmul(v * p.p22, i_syn, p21), v))
        ref.sub_((~live).to(torch.int32))
        i_syn.copy_(torch.addcmul(p.q * s.to(torch.float32), i_syn, p11))
        spike = v >= p.v_th
        v.masked_fill_(spike, p.v_reset)
        ref.masked_fill_(spike, p.ref_steps)
        spike_count.add_(spike.to(torch.int32))
        ids = torch.nonzero(spike).flatten()
        if ids.numel():
            lens = degree[ids]
            first = row_ptr[ids].long() - (torch.cumsum(lens, 0) - lens)
            e = (torch.repeat_interleave(first, lens)
                 + torch.arange(int(lens.sum()), device=device))
            slot = (t + delays[e].long()) & (depth - 1)
            flat.index_add_(0, slot * num + targets[e].long(),
                            weights[e].to(torch.int32))


# -- K23: the whole trial in one launch ------------------------------------------------

class McPlan(NamedTuple):
    """What K23 reads besides the network: the rows' synapses of delay 1
    as a CSR of their own (``near_ptr`` int32 ``(num + 1,)``,
    ``near_targets`` int32, ``near_weights`` int16, in the rows' order),
    which the spiking neuron's block adds in the step of the spike, and
    the scratch of the grid's lists of spiking rows (``lists`` int32
    ``(MC_LISTS, num, 2)``, ``counts`` int32 ``(MC_LISTS,)``), whose
    synapses of delay >= 2 every block adds a share of one step later.
    One launch at a time uses a plan's scratch (launches on one stream)."""
    near_ptr: torch.Tensor
    near_targets: torch.Tensor
    near_weights: torch.Tensor
    lists: torch.Tensor
    counts: torch.Tensor


def mc_plan(row_ptr, targets, weights, delays) -> McPlan:
    """The :class:`McPlan` of a network, CSR by source (int32 targets,
    int16 weights, uint8 delays), on its device: the delay-1 synapses'
    positions (``nonzero``), each row's first of them counted at
    ``row_ptr`` (``searchsorted``); the arrays are not copied or
    changed."""
    near = torch.nonzero(delays == 1).flatten()
    near_ptr = torch.searchsorted(near, row_ptr.to(near.dtype))
    num = row_ptr.numel() - 1

    def scratch(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=row_ptr.device)
    return McPlan(near_ptr=near_ptr.to(torch.int32),
                  near_targets=targets[near], near_weights=weights[near],
                  lists=scratch(MC_LISTS, num, 2), counts=scratch(MC_LISTS))


@functools.lru_cache(maxsize=None)
def _max_blocks(device_index: int) -> int:
    fn = cuda_build.function('mc_sim_max_blocks', [
        ctypes.c_int, ctypes.POINTER(ctypes.c_int)])
    out = ctypes.c_int(0)
    err = fn(device_index, ctypes.byref(out))
    if err:
        raise KernelExecutionError(
            f'mc_sim: occupancy failed with CUDA error {err} '
            f'({cuda_build.error_string(err)})')
    return out.value


def mc_sim_grid(num: int, device: torch.device) -> int:
    """The blocks of K23's grid for *num* neurons, one a thread (302 at
    full scale). Raises ``ValueError`` where that grid cannot be
    co-resident on *device*."""
    blocks = -(-num // MC_BLOCK)
    most = _max_blocks(device.index or 0)
    if blocks > most:
        raise ValueError(f'mc_sim: {num} neurons need {blocks} blocks of '
                         f'{MC_BLOCK}, more than the {most} that can be '
                         f'co-resident on {device}')
    return blocks


def _mc_sim_cuda(op, v, i_syn, ref, ring, spike_count, row_ptr, targets,
                 weights, delays, n_steps, p, plan: McPlan, phases=None):
    """K23's launch; *plan* is :func:`mc_plan` of the rows. Given *phases*
    (int64 ``(3,)``, zeroed), its clocked instance, which adds the grid's
    warps' ns in each of :data:`PHASES` to it."""
    f, i = torch.float32, torch.int32
    tensors = [(v, f), (i_syn, f), (ref, i), (ring, i), (spike_count, i),
               (row_ptr, i), (targets, i), (weights, torch.int16),
               (delays, torch.uint8), (plan.near_ptr, i),
               (plan.near_targets, i), (plan.near_weights, torch.int16),
               (plan.lists, i), (plan.counts, i)]
    if phases is not None:
        tensors.append((phases, torch.int64))
    device = check_cuda_tensors(op.name, *tensors)
    num = p.num
    n_syn = targets.numel()
    n_near = plan.near_targets.numel()
    if (any(x.shape != (num,) for x in (v, i_syn, ref, spike_count))
            or ring.shape != (p.depth, num) or row_ptr.shape != (num + 1,)
            or weights.numel() != n_syn or delays.numel() != n_syn
            or plan.near_ptr.shape != (num + 1,)
            or plan.near_weights.numel() != n_near
            or plan.lists.shape != (MC_LISTS, num, 2)
            or plan.counts.shape != (MC_LISTS,)
            or (phases is not None and phases.shape != (len(PHASES),))):
        raise ValueError(f'{op.name}: state, ring {tuple(ring.shape)}, rows '
                         f'and plan do not match num={num}, D={p.depth}')
    blocks = mc_sim_grid(num, device)
    fn = cuda_build.function('mc_sim_launch', [ctypes.c_void_p] * 15 + [
        ctypes.c_int, ctypes.POINTER(McParams)] + [ctypes.c_int] * 2 + [
        ctypes.c_void_p])
    op.launch(fn, v.data_ptr(), i_syn.data_ptr(), ref.data_ptr(),
              ring.data_ptr(), spike_count.data_ptr(), row_ptr.data_ptr(),
              targets.data_ptr(), weights.data_ptr(), delays.data_ptr(),
              plan.near_ptr.data_ptr(), plan.near_targets.data_ptr(),
              plan.near_weights.data_ptr(), plan.lists.data_ptr(),
              plan.counts.data_ptr(),
              None if phases is None else phases.data_ptr(), int(n_steps),
              ctypes.byref(p), blocks, device.index or 0, cuda_stream(device))


mc_sim = KernelOp('mc_sim', twin=mc_loop, cuda=_mc_sim_cuda,
                  source='brainevent_torch/csrc/mc_sim.cu', replaces=None)


# -- the network ------------------------------------------------------------------

@dataclasses.dataclass
class MicrocircuitNet:
    """The microcircuit at *scale* (1.0: 77,169 neurons).

    Parameters
    ----------
    scale : float
        The populations' sizes times *scale*, rounded; the synapse counts
        follow from the sizes (:func:`synapse_counts`).
    params : :class:`MicrocircuitParams`
        The published parameters by default.
    seed : int
        Seeds the generator the network is drawn from on *device*
        (:func:`build_microcircuit`) when the arrays are not given, and
        (plus 1) :meth:`init_state`'s default generator.
    row_ptr, targets, weights, delays : optional tensors
        The network, CSR by source, as :func:`build_microcircuit` returns
        it, to share one network with another program.
    device : torch device, default the card (``'cuda'``)
        CUDA tensors run K23; ``device='cpu'`` runs :func:`mc_loop`.

    The net keeps the given arrays as they are, and beside them ``plan``
    (:func:`mc_plan`: the delay-1 synapses as a CSR of their own and K23's
    scratch) and ``grid_share``, the share of the synapses of delay >= 2,
    which K23's grid pass adds.
    """
    scale: float = 1.0
    params: MicrocircuitParams = MicrocircuitParams()
    seed: int = 42
    row_ptr: Optional[torch.Tensor] = dataclasses.field(default=None,
                                                        repr=False)
    targets: Optional[torch.Tensor] = dataclasses.field(default=None,
                                                        repr=False)
    weights: Optional[torch.Tensor] = dataclasses.field(default=None,
                                                        repr=False)
    delays: Optional[torch.Tensor] = dataclasses.field(default=None,
                                                       repr=False)
    device: Optional[torch.device] = None

    def __post_init__(self):
        self.device = check_device(self.device or 'cuda')
        prm = self.params
        self.sizes = prm.sizes(self.scale)
        if not 1 <= len(self.sizes) <= MC_MAX_POPS:
            raise ValueError(f'MicrocircuitNet takes 1 to {MC_MAX_POPS} '
                             f'populations, got {len(self.sizes)}')
        self.num = sum(self.sizes)
        self.pop_start = [0] + np.cumsum(self.sizes).tolist()
        arrays = (self.row_ptr, self.targets, self.weights, self.delays)
        if all(a is None for a in arrays):
            gen = torch.Generator(device=self.device).manual_seed(self.seed)
            arrays = build_microcircuit(prm, self.scale, gen,
                                        self.device).values()
        elif any(a is None for a in arrays):
            raise ValueError('give all of row_ptr, targets, weights and '
                             'delays, or none')
        dtypes = (torch.int32, torch.int32, torch.int16, torch.uint8)
        self.row_ptr, self.targets, self.weights, self.delays = (
            torch.as_tensor(a).to(device=self.device, dtype=d).contiguous()
            for a, d in zip(arrays, dtypes))
        n_syn = self.targets.numel()
        if (self.row_ptr.shape != (self.num + 1,)
                or self.weights.numel() != n_syn
                or self.delays.numel() != n_syn
                or int(self.row_ptr[-1]) != n_syn):
            raise ValueError(f'the rows do not match {self.num} neurons and '
                             f'{n_syn} synapses')
        max_delay = int(self.delays.max()) if n_syn else 1
        if n_syn and int(self.delays.min()) < 1:
            raise ValueError('every delay must be at least one step')
        # the next power of two above the largest delay
        self.depth = 1 << max_delay.bit_length()
        self.plan = mc_plan(self.row_ptr, self.targets, self.weights,
                            self.delays)
        # the share of the synapses K23's grid pass adds (delay >= 2)
        n_near = self.plan.near_targets.numel()
        self.grid_share = (n_syn - n_near) / n_syn if n_syn else 0.0
        lam = [k * prm.bg_rate * prm.dt * 1e-3 for k in prm.k_ext]
        self.thresholds = [poisson_thresholds(x) for x in lam]

    # -- state -------------------------------------------------------------------

    def init_state(self, generator: Optional[torch.Generator] = None
                   ) -> MicrocircuitState:
        """A state drawn from *generator* (default: a CPU generator seeded
        with ``seed + 1``): ``V ~ N(v0_mean, v0_sd) - E_L``, the Poisson
        key a uniform uint32, the rest 0."""
        if generator is None:
            generator = torch.Generator().manual_seed(self.seed + 1)
        prm, dev = self.params, generator.device
        z = torch.randn(self.num, generator=generator, device=dev)
        key = int(torch.randint(0, 2 ** 32, (1,), generator=generator,
                                device=dev))
        v = f32(prm.v0_mean - prm.e_l) + f32(prm.v0_sd) * z

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.int32, device=self.device)
        return MicrocircuitState(
            v=v.to(self.device),
            i_syn=torch.zeros(self.num, dtype=torch.float32,
                              device=self.device),
            ref=zeros(self.num), ring=zeros(self.depth, self.num),
            spike_count=zeros(self.num), key=key, step=0)

    def step_params(self, key: int, step: int) -> McParams:
        """The scalars K23 and :func:`mc_loop` read for a trial from
        *step* of the Poisson stream *key*."""
        prm = self.params
        p11 = math.exp(-prm.dt / prm.tau_syn)
        p22 = math.exp(-prm.dt / prm.tau_m)
        p21 = (prm.tau_m * prm.tau_syn
               / (prm.c_m * (prm.tau_syn - prm.tau_m)) * (p11 - p22))
        thr = [x for row in self.thresholds for x in row]
        thr += [M32] * (MC_MAX_POPS * MC_KMAX - len(thr))
        starts = self.pop_start + [self.num] * (MC_MAX_POPS + 1
                                                - len(self.pop_start))
        return McParams(
            p11=f32(p11), p21=f32(p21), p22=f32(p22),
            q=f32(prm.psc_mean() / prm.weight_units),
            v_th=f32(prm.v_th - prm.e_l), v_reset=f32(prm.v_reset - prm.e_l),
            num=self.num, depth=self.depth,
            ref_steps=int(round(prm.t_ref / prm.dt)),
            w_ext=prm.weight_units, key=key & M32, step0=step & M32,
            n_pops=len(self.sizes),
            pop_start=(ctypes.c_int * (MC_MAX_POPS + 1))(*starts),
            thr=(ctypes.c_uint32 * (MC_MAX_POPS * MC_KMAX))(*thr))

    # -- dynamics ----------------------------------------------------------------

    def run(self, n_steps: int, state: Optional[MicrocircuitState] = None
            ) -> MicrocircuitState:
        """Run *n_steps* from *state* (default :meth:`init_state`) through
        K23 in one launch, or :func:`mc_loop` on the CPU; returns the new
        state, its ``step`` *n_steps* on. *state* is not modified.

        With tracing on (:mod:`~brainevent_torch.ops.tracing`), a call
        records the span ``brainevent_torch.MicrocircuitNet.run``
        (attributes ``num``, ``n_steps``, ``route``: ``sim`` on a card,
        ``loop`` on the CPU, and ``grid_share``: the share of the synapses
        that K23's grid pass adds, those of delay >= 2) around ``.copies``
        and ``.launch``. On the card the launch then takes K23's clocked
        instance, and adds its warps' ns in each phase of the step (update,
        scatter, barrier) and its warps times its steps
        (:func:`~brainevent_torch.ops.tracing.count_phases`); the loop
        counts no phase."""
        if state is None:
            state = self.init_state()
        route = 'sim' if state.v.device.type == 'cuda' else 'loop'
        # the twin reads the rows alone
        extra = dict(plan=self.plan) if route == 'sim' else {}
        clocked = route == 'sim' and tracing.enabled()
        if clocked:
            extra['phases'] = torch.zeros(len(PHASES), dtype=torch.int64,
                                          device=state.v.device)
        with tracing.span('brainevent_torch.MicrocircuitNet.run',
                          num=self.num, n_steps=int(n_steps), route=route,
                          grid_share=self.grid_share):
            p = self.step_params(state.key, state.step)
            with tracing.span('brainevent_torch.MicrocircuitNet.copies'):
                out = [x.to(dtype, copy=True) for x, dtype in (
                    (state.v, torch.float32), (state.i_syn, torch.float32),
                    (state.ref, torch.int32), (state.ring, torch.int32),
                    (state.spike_count, torch.int32))]
            with tracing.span('brainevent_torch.MicrocircuitNet.launch'):
                mc_sim(*out, self.row_ptr, self.targets, self.weights,
                       self.delays, int(n_steps), p, **extra)
            if clocked:
                warps = mc_sim_grid(self.num, state.v.device) * MC_BLOCK // 32
                tracing.count_phases('MicrocircuitNet', extra['phases'],
                                     PHASES, warps * int(n_steps))
        return MicrocircuitState(*out, key=state.key,
                                 step=state.step + int(n_steps))
