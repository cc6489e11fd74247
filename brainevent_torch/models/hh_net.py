# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""Brette et al. 2007's Benchmark 3 (COBAHH, J Comput Neurosci 23:349,
doi 10.1007/s10827-007-0038-6): a Hodgkin-Huxley EI network with
exponential conductances, as Brian 2's ``examples/COBAHH.py`` sets it up,
at any scale.

80% excitatory and 20% inhibitory neurons of Traub and Miles's sodium and
potassium channels, each with ``n_conn`` random targets (the table
:class:`~brainevent_torch.EINet` draws), stepped at dt = 0.1 ms by
exponential Euler. :class:`HHParams` holds the published parameters
(v in mV, rates in 1/ms, conductances in nS, C_m in pF).

One step of neuron ``j``, every variable from the step's old state (see
``csrc/hh_neuron.cuh`` for the order of the roundings, which
:func:`hh_loop` repeats op for op)::

    d = v - V_T;  each rate from its argument (o - d) * s:
        alpha_m, beta_m, alpha_n = c / exprel(.)     (exprel(0) = 1)
        alpha_h, beta_n = c * exp(.);  beta_h = c / (1 + exp(.))
    x' = x_inf + (x - x_inf) exp(-(alpha + beta) dt),
        x_inf = alpha / (alpha + beta)
    v' = v_inf + (v - v_inf) exp(-den dt / C_m),  v_inf = num / den
    g' = g * float32(exp(-dt / tau_syn))
    spike: v' > v_spike while armed; the spike disarms, a step that ends
        at v' <= v_spike arms (Brian's refractory='v > -20*mV'); no reset
    then each spike's row adds 1 to its targets' int32 E or I hit count,
    and g = g' + w * hits

with no FMA, so that :meth:`HHNet.run` on a card (K21's HH instance,
``einet_sim_hh_kernel`` in ``csrc/einet_sim.cu``, a whole trial in one
launch on K21's grid, scatter and barrier) and on the CPU
(:func:`hh_loop`, plain PyTorch) give the same bits.
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
from .networks import SIM_BLOCK
from .neurons import f32

__all__ = ['HHNet', 'HHNetState', 'HHParams', 'HHSimParams', 'hh_loop',
           'hh_rates', 'einet_sim_hh', 'hh_sim_grid', 'hh_sim_capacity',
           'hh_math_cuda']

# the rates in the order of HHParams.rates, and the form of each
RATES = ('alpha_m', 'beta_m', 'alpha_h', 'beta_h', 'alpha_n', 'beta_n')
FORMS = ('exprel', 'exprel', 'exp', 'sigmoid', 'exprel', 'exp')
HH_NPT = (1, 2, 4, 8)    # K21's HH instances: neurons a thread keeps
NEURON_UPDATES = 'brainevent_torch.HHNet.neuron_updates'
# the phases of K21's clocked HH instance (BeSimPhase in csrc/einet_sim.cu)
PHASES = ('update', 'scatter', 'barrier')


@dataclasses.dataclass(frozen=True)
class HHParams:
    """The published parameters (Brian 2's ``examples/COBAHH.py``): the
    membrane of ``area`` um^2 (``c_m`` pF, the leak ``g_l`` nS to ``e_l``
    mV), the channels (``g_na``, ``g_kd`` nS to ``e_na``, ``e_k`` mV; the
    rates' ``v_t`` mV), the spike's threshold ``v_spike`` mV, the step
    ``dt`` ms, the synapses (``tau_e``, ``tau_i`` ms to ``e_e``, ``e_i``
    mV, weights ``w_e``, ``w_i`` nS, ``n_conn`` targets a neuron) and the
    rates ``(c, o, s)`` of :data:`RATES`, the argument ``(o - (v - v_t))
    * s``. The initial state: ``v = e_l + (v_sd z + v_shift)``, ``g_e =
    g_e_scale (g_e_sd z + g_e_mean)``, ``g_i`` alike, z standard
    normal."""
    area: float = 20000.0
    c_m: float = 200.0
    g_l: float = 10.0
    e_l: float = -60.0
    g_na: float = 20000.0
    e_na: float = 50.0
    g_kd: float = 6000.0
    e_k: float = -90.0
    v_t: float = -63.0
    v_spike: float = -20.0
    dt: float = 0.1
    n_conn: int = 80
    tau_e: float = 5.0
    tau_i: float = 10.0
    e_e: float = 0.0
    e_i: float = -80.0
    w_e: float = 6.0
    w_i: float = 67.0
    rates: tuple = ((1.28, 13.0, 0.25), (1.4, 40.0, -0.2),
                    (0.128, 17.0, 1 / 18), (4.0, 40.0, 0.2),
                    (0.16, 15.0, 0.2), (0.5, 10.0, 0.025))
    v_sd: float = 5.0
    v_shift: float = -5.0
    g_e_scale: float = 10.0
    g_e_sd: float = 1.5
    g_e_mean: float = 4.0
    g_i_scale: float = 10.0
    g_i_sd: float = 12.0
    g_i_mean: float = 20.0


class HHNetState(NamedTuple):
    v: torch.Tensor            # membrane (mV), float32 (n,)
    m: torch.Tensor            # sodium activation, float32 (n,)
    h: torch.Tensor            # sodium inactivation, float32 (n,)
    n: torch.Tensor            # potassium activation, float32 (n,)
    g_e: torch.Tensor          # excitatory conductance (nS), float32 (n,)
    g_i: torch.Tensor          # inhibitory conductance (nS), float32 (n,)
    armed: torch.Tensor        # may spike at v > v_spike, bool (n,)
    spike_count: torch.Tensor  # per-neuron cumulative spikes, int32 (n,)


class HHSimParams(ctypes.Structure):
    """The scalars of one network, rounded to float32; the same layout as
    ``struct HHParams`` in ``csrc/hh_neuron.cuh``."""
    _fields_ = [(name, ctypes.c_float) for name in (
        'v_t', 'g_l', 'gl_el', 'e_e', 'e_i', 'e_na', 'e_k', 'g_na', 'g_k',
        'neg_dt', 'neg_dt_c', 'decay_e', 'decay_i', 'w_e', 'w_i',
        'v_spike')] + [(name, ctypes.c_float * len(RATES)) for name in (
            'rate_c', 'rate_o', 'rate_s')] + [('num', ctypes.c_int)]


# -- the twin ---------------------------------------------------------------------

def hh_rates(v: torch.Tensor, p: HHSimParams) -> list:
    """The six rates of :data:`RATES` at membrane *v* (1/ms), as K21's HH
    instance computes them; a constant that divides is a tensor, so that
    ``c / x`` is one rounded quotient (``torch`` makes ``c / x`` of a
    Python number a product with the reciprocal)."""
    d = v - p.v_t
    out = []
    for r, form in enumerate(FORMS):
        c = torch.tensor(p.rate_c[r], dtype=v.dtype, device=v.device)
        a = (p.rate_o[r] - d) * p.rate_s[r]
        if form == 'exprel':
            exprel = torch.where(a == 0, 1.0, torch.expm1(a) / a)
            out.append(torch.div(c, exprel))
        elif form == 'exp':
            out.append(c * torch.exp(a))
        else:
            out.append(torch.div(c, 1.0 + torch.exp(a)))
    return out


def _gate(x, alpha, beta, neg_dt):
    s = alpha + beta
    x_inf = alpha / s
    return x_inf + (x - x_inf) * torch.exp(s * neg_dt)


def hh_loop(v, m, h, n, g_e, g_i, armed, spike_count, conn, n_steps: int,
            p: HHSimParams, n_exc: int) -> None:
    """Plain PyTorch twin of K21's HH instance, in place: *n_steps* steps
    (see the module's docstring), each step's hits counted in int32 over
    the rows of *conn* of its spiking neurons (targets outside ``[0,
    num)`` dropped) and folded into the conductances."""
    num = p.num
    for _ in range(int(n_steps)):
        am, bm, ah, bh, an, bn = hh_rates(v, p)
        gna = p.g_na * (m * m * m * h)
        n2 = n * n
        gk = p.g_k * (n2 * n2)
        den = p.g_l + g_e + g_i + gna + gk
        drive = (p.gl_el + g_e * p.e_e + g_i * p.e_i + gna * p.e_na
                 + gk * p.e_k)
        v_inf = drive / den
        vn = v_inf + (v - v_inf) * torch.exp(den * p.neg_dt_c)
        m.copy_(_gate(m, am, bm, p.neg_dt))
        h.copy_(_gate(h, ah, bh, p.neg_dt))
        n.copy_(_gate(n, an, bn, p.neg_dt))
        v.copy_(vn)
        spike = armed & (vn > p.v_spike)
        armed.copy_((armed & ~spike) | (vn <= p.v_spike))
        spike_count.add_(spike.to(torch.int32))
        ids = torch.nonzero(spike).flatten()
        targets = conn[ids].long()
        ok = (targets >= 0) & (targets < num)
        targets = (targets + ((ids >= n_exc).long() * num)[:, None])[ok]
        hits = torch.bincount(targets, minlength=2 * num).to(torch.int32)
        g_e.copy_(g_e * p.decay_e + p.w_e * hits[:num].float())
        g_i.copy_(g_i * p.decay_i + p.w_i * hits[num:].float())


# -- K21's HH instance: the whole trial in one launch --------------------------------

@functools.lru_cache(maxsize=None)
def _max_blocks(device_index: int, npt: int) -> int:
    fn = cuda_build.function('einet_sim_hh_max_blocks', [
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)])
    out = ctypes.c_int(0)
    err = fn(npt, device_index, ctypes.byref(out))
    if err:
        raise KernelExecutionError(
            f'einet_sim_hh: occupancy of npt={npt} failed with CUDA error '
            f'{err} ({cuda_build.error_string(err)})')
    return out.value


def hh_sim_capacity(device: torch.device) -> int:
    """The most neurons K21's HH instance runs on *device*: its largest
    NPT instance at its own occupancy, every co-resident thread holding
    NPT neurons."""
    npt = HH_NPT[-1]
    return _max_blocks(device.index or 0, npt) * SIM_BLOCK * npt


def hh_sim_grid(num: int, device: torch.device):
    """``(npt, blocks)`` of K21's HH instance for *num* neurons: the
    fewest neurons a thread that a co-resident grid covers, and as many
    blocks as that takes. Raises ``ValueError`` above
    :func:`hh_sim_capacity`: the HH network has no other route on a
    card."""
    for npt in HH_NPT:
        blocks = -(-num // (npt * SIM_BLOCK))
        if blocks <= _max_blocks(device.index or 0, npt):
            return npt, blocks
    raise ValueError(f'einet_sim_hh: {num} neurons exceed what K21\'s HH '
                     f'instance holds on {device} '
                     f'({hh_sim_capacity(device)})')


def _einet_sim_hh_cuda(op, v, m, h, n, g_e, g_i, armed, spike_count, conn,
                       n_steps, p, n_exc, *, npt=0, blocks=0, phases=None):
    """Launch K21's HH instance once for *n_steps* steps over the rows of
    *conn*: the instance :func:`hh_sim_grid` picks, or *npt* on *blocks*
    (so that tests can run another; no public entry sets them). Given
    *phases* (int64 ``(3,)``, zeroed), its clocked instance, which adds
    the grid's warps' ns in each of :data:`PHASES` to it."""
    f, i = torch.float32, torch.int32
    tensors = [(v, f), (m, f), (h, f), (n, f), (g_e, f), (g_i, f),
               (armed, torch.bool), (spike_count, i), (conn, i)]
    if phases is not None:
        tensors.append((phases, torch.int64))
    device = check_cuda_tensors(op.name, *tensors)
    num = p.num
    if (conn.dim() != 2 or conn.shape[0] != num
            or any(x.shape != (num,) for x in (v, m, h, n, g_e, g_i, armed,
                                                 spike_count))
            or (phases is not None and phases.shape != (len(PHASES),))):
        raise ValueError(f'{op.name}: state and conn {tuple(conn.shape)} do '
                         f'not match num={num}')
    if not npt:
        npt, fewest = hh_sim_grid(num, device)
    elif npt in HH_NPT:
        fewest = -(-num // (npt * SIM_BLOCK))
    else:
        raise ValueError(f'{op.name}: npt must be one of {HH_NPT}, got '
                         f'{npt}')
    blocks = blocks or fewest
    if blocks * SIM_BLOCK * npt < num:
        raise ValueError(f'{op.name}: {blocks} blocks of {SIM_BLOCK} threads '
                         f'x {npt} neurons do not cover {num} neurons')
    counts = torch.zeros(2, 2, num, dtype=i, device=device)
    fn = cuda_build.function('einet_sim_hh_launch', [ctypes.c_void_p] * 9 + [
        ctypes.c_int] * 3 + [ctypes.c_void_p] * 2 + [
        ctypes.POINTER(HHSimParams)] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    op.launch(fn, v.data_ptr(), m.data_ptr(), h.data_ptr(), n.data_ptr(),
              g_e.data_ptr(), g_i.data_ptr(), armed.data_ptr(),
              spike_count.data_ptr(), conn.data_ptr(), int(n_steps),
              conn.shape[1], int(n_exc), counts.data_ptr(),
              None if phases is None else phases.data_ptr(), ctypes.byref(p),
              npt, blocks, device.index or 0, cuda_stream(device))


einet_sim_hh = KernelOp(
    'einet_sim_hh', twin=hh_loop, cuda=_einet_sim_hh_cuda,
    source='brainevent_torch/csrc/einet_sim.cu', replaces=None)


def hh_math_cuda(x: torch.Tensor, fn: str) -> torch.Tensor:
    """``exp`` or ``expm1`` (*fn*) of every entry of the float32 CUDA
    tensor *x*, as K21's HH instance computes them (the library's
    ``expf`` and ``expm1f``)."""
    check_cuda_tensors('einet_sim_hh_math', (x, torch.float32))
    y = torch.empty_like(x)
    launch = cuda_build.function('einet_sim_hh_math_launch', [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p])
    err = launch(x.data_ptr(), y.data_ptr(), x.numel(),
                 ('exp', 'expm1').index(fn), x.device.index or 0,
                 cuda_stream(x.device))
    if err:
        raise KernelExecutionError(
            f'einet_sim_hh_math: launch failed with CUDA error {err} '
            f'({cuda_build.error_string(err)})')
    return y


# -- the network ------------------------------------------------------------------

@dataclasses.dataclass
class HHNet:
    """The COBAHH network at *scale* (1.0: Brette's 4,000 neurons).

    Parameters
    ----------
    scale : float
        ``n = 4000 * scale`` neurons (``3200 * scale`` excitatory, ``800 *
        scale`` inhibitory), ``params.n_conn`` targets each.
    params : :class:`HHParams`
        The published parameters by default.
    seed : int
        Seeds the table's draw when ``conn_all`` is not given (as
        :class:`~brainevent_torch.EINet` draws it), and (plus 1)
        :meth:`init_state`'s default generator.
    conn_all : optional ``(num, n_conn)`` int array
        The target table, excitatory rows first.
    device : torch device, default the card (``'cuda'``)
        CUDA tensors run K21's HH instance; ``device='cpu'`` runs
        :func:`hh_loop`.
    """
    scale: float = 1.0
    params: HHParams = HHParams()
    seed: int = 42
    conn_all: Optional[torch.Tensor] = dataclasses.field(default=None,
                                                         repr=False)
    device: Optional[torch.device] = None

    def __post_init__(self):
        self.n_exc = int(3200 * self.scale)
        self.n_inh = int(800 * self.scale)
        self.num = self.n_exc + self.n_inh
        self.device = check_device(self.device or 'cuda')
        if self.conn_all is None:
            gen = torch.Generator().manual_seed(self.seed)
            conn = torch.randint(0, self.num, (self.num, min(
                self.params.n_conn, self.num)), generator=gen,
                dtype=torch.int32)
        else:
            conn = torch.as_tensor(self.conn_all)
            if conn.dim() != 2 or conn.shape[0] != self.num:
                raise ValueError(f'conn_all must be (num={self.num}, n_conn), '
                                 f'got {tuple(conn.shape)}')
        self.conn_all = conn.to(device=self.device,
                                dtype=torch.int32).contiguous()

    # -- state -------------------------------------------------------------------

    def init_state(self, generator: Optional[torch.Generator] = None
                   ) -> HHNetState:
        """A state drawn from *generator* (default: a CPU generator seeded
        with ``seed + 1``) as Brian's example draws it (three standard
        normal rows, float32 arithmetic; a negative ``g_i`` is kept): the
        gates 0, armed where ``v <= v_spike``, no spikes."""
        if generator is None:
            generator = torch.Generator().manual_seed(self.seed + 1)
        prm = self.params
        z = torch.randn((3, self.num), generator=generator,
                        device=generator.device).to(self.device)
        v = prm.e_l + (prm.v_sd * z[0] + prm.v_shift)
        zeros = torch.zeros(self.num, device=self.device)
        return HHNetState(
            v=v, m=zeros, h=zeros.clone(), n=zeros.clone(),
            g_e=prm.g_e_scale * (prm.g_e_sd * z[1] + prm.g_e_mean),
            g_i=prm.g_i_scale * (prm.g_i_sd * z[2] + prm.g_i_mean),
            armed=v <= prm.v_spike,
            spike_count=torch.zeros(self.num, dtype=torch.int32,
                                    device=self.device))

    def step_params(self) -> HHSimParams:
        """The float32 scalars K21's HH instance and :func:`hh_loop`
        read."""
        prm = self.params
        floats = len(RATES) * ctypes.c_float
        return HHSimParams(
            v_t=f32(prm.v_t), g_l=f32(prm.g_l), gl_el=f32(prm.g_l * prm.e_l),
            e_e=f32(prm.e_e), e_i=f32(prm.e_i), e_na=f32(prm.e_na),
            e_k=f32(prm.e_k), g_na=f32(prm.g_na), g_k=f32(prm.g_kd),
            neg_dt=f32(-prm.dt), neg_dt_c=f32(-prm.dt / prm.c_m),
            decay_e=f32(math.exp(-prm.dt / prm.tau_e)),
            decay_i=f32(math.exp(-prm.dt / prm.tau_i)),
            w_e=f32(prm.w_e), w_i=f32(prm.w_i), v_spike=f32(prm.v_spike),
            rate_c=floats(*(f32(c) for c, _, _ in prm.rates)),
            rate_o=floats(*(f32(o) for _, o, _ in prm.rates)),
            rate_s=floats(*(f32(s) for _, _, s in prm.rates)),
            num=self.num)

    # -- dynamics ----------------------------------------------------------------

    def run(self, n_steps: int, state: Optional[HHNetState] = None
            ) -> HHNetState:
        """Run *n_steps* from *state* (default :meth:`init_state`) through
        K21's HH instance in one launch, or :func:`hh_loop` on the CPU;
        returns the new state, which chains into the next run. *state* is
        not modified. A network above :func:`hh_sim_capacity` raises
        ``ValueError`` on a card.

        With tracing on (:mod:`~brainevent_torch.ops.tracing`), a call
        records the span ``brainevent_torch.HHNet.run`` (attributes
        ``num``, ``n_steps``, ``route``: ``sim`` on a card, ``loop`` on
        the CPU, and ``npt``: the neurons a thread of K21 keeps, 0 on the
        loop) around ``.copies`` and ``.launch``, and adds ``num *
        n_steps`` to the counter ``brainevent_torch.HHNet.neuron_updates``.
        On the card the launch then takes K21's clocked HH instance, and
        adds its warps' ns in each phase of the step (update, scatter,
        barrier) and its warps times its steps
        (:func:`~brainevent_torch.ops.tracing.count_phases`); the loop
        counts no phase."""
        if state is None:
            state = self.init_state()
        n_steps = int(n_steps)
        device = state.v.device
        route = 'sim' if device.type == 'cuda' else 'loop'
        npt, blocks = (hh_sim_grid(self.num, device) if route == 'sim'
                       else (0, 0))
        clocked = route == 'sim' and tracing.enabled()
        with tracing.span('brainevent_torch.HHNet.run', num=self.num,
                          n_steps=n_steps, route=route, npt=npt):
            p = self.step_params()
            with tracing.span('brainevent_torch.HHNet.copies'):
                out = [x.to(dtype, copy=True) for x, dtype in zip(
                    state, (torch.float32,) * 6 + (torch.bool, torch.int32))]
            extra = (dict(phases=torch.zeros(len(PHASES), dtype=torch.int64,
                                             device=device))
                     if clocked else {})
            with tracing.span('brainevent_torch.HHNet.launch'):
                einet_sim_hh(*out, self.conn_all, n_steps, p, self.n_exc,
                             **extra)
            tracing.count(NEURON_UPDATES, self.num * n_steps)
            if clocked:
                tracing.count_phases('HHNet', extra['phases'], PHASES,
                                     blocks * SIM_BLOCK // 32 * n_steps)
        return HHNetState(*out)
