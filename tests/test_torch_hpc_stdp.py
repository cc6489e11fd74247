# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""NEST's HPC benchmark network with power-law STDP (``HpcStdpNet``): its
constants, its network and K24's twin (``stdp_loop``) against the
benchmark's plain reference (``benchmark_torch/reference/hpc_stdp.py``),
bit for bit, and the eager STDP against a synapse-by-synapse replay of
NEST's ``send()``, on the CPU; and K24 against the twin on a card.

This file imports no JAX. The card tests (marker ``cuda``) skip without a
CUDA device; on a card run them with::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_hpc_stdp.py
"""

import copy
import ctypes
import json
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import brainevent_torch as bt
from brainevent_torch.models import hpc_stdp as hs
from brainevent_torch.ops import core, cuda_build, tracing
from benchmark_torch.reference import hpc_stdp as ref

from _torch_one_thread import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
CFG = json.loads((ROOT / 'benchmark_torch' / 'configs'
                  / 'hpc_stdp.json').read_text())
CPU = torch.device('cpu')
SEED = 2 ** 31 + 12345
PARAMS = bt.HpcStdpParams()
# tiny presets of the CPU tests: (scale, CE, CI)
SMALL = (0.02, 90, 22)
FULL_DEGREE = (0.01, 9000, 2250)
_CACHE = {}


def config(ce: int, ci: int) -> dict:
    cfg = copy.deepcopy(CFG)
    cfg['network'].update(ce=ce, ci=ci)
    return cfg


def setup(scale=SMALL[0], ce=SMALL[1], ci=SMALL[2], device=CPU, seed=SEED):
    """The reference's inputs (two initial states) and the program's
    network over the same arrays."""
    key = (scale, ce, ci, str(device), seed)
    if key not in _CACHE:
        cfg = config(ce, ci)
        inputs = ref.make_inputs(cfg, dict(scale=scale, initial_states=2),
                                 seed, device)
        net = bt.HpcStdpNet(scale=scale, device=device,
                            params=bt.HpcStdpParams(ce=ce, ci=ci),
                            **inputs['program'])
        _CACHE[key] = net, inputs, cfg
    return _CACHE[key]


def program_state(fields: dict) -> bt.HpcStdpState:
    return bt.HpcStdpState(**{k: fields[k] for k in bt.HpcStdpState._fields})


def mismatches(got: bt.HpcStdpState, want: dict) -> dict:
    return ref.compare(CFG, {}, got._asdict(), want)


ZERO = {f'{k}_mismatch': 0 for k in ref.FIELDS}


# -- the constants ------------------------------------------------------------------

def test_the_published_parameters_are_the_defaults_and_the_config():
    names = {'lambda': 'lam'}
    for part in ('network', 'neuron', 'initial_state'):
        for key, value in CFG[part].items():
            name = names.get(key, key)
            if hasattr(PARAMS, name):
                assert getattr(PARAMS, name) == value, key
    assert PARAMS.sizes(10.0) == (90_000, 22_500)
    assert PARAMS.sizes(1.0) == (9000, 2250)
    assert PARAMS.delay_steps() == 15


def test_je_pa_and_the_drive_are_the_scripts():
    """``convert_synapse_weight`` (t_rise 1.700759 ms) gives JE_pA =
    45.6096 pA, and the drive ``eta nu_th CE`` 20,856 Hz."""
    assert abs(PARAMS.je_pa() - 45.6096) < 1e-4
    assert PARAMS.je_pa() == pytest.approx(ref.je_pa(CFG), rel=1e-13)
    assert abs(PARAMS.poisson_rate() - 20856.04) < 0.01
    lam = PARAMS.poisson_rate() * 1e-4
    assert lam == pytest.approx(ref.poisson_lambda(CFG), rel=1e-13)
    thr = hs.poisson_thresholds(lam, 16)
    assert thr == ref.thresholds(CFG)
    # P(k > 15) at lambda 2.0856
    tail = 1 - sum(math.exp(-lam) * lam ** k / math.factorial(k)
                   for k in range(16))
    assert 5e-10 < tail < 1.2e-9


def _expm(a: np.ndarray) -> np.ndarray:
    """The matrix exponential by its Taylor series (|a| is small)."""
    out, term = np.eye(len(a)), np.eye(len(a))
    for k in range(1, 40):
        term = term @ a / k
        out = out + term
    return out


def test_the_propagators_are_the_exact_integration():
    """P11, P21, P31 and P32 are the step's propagator of ``d(dI)/dt =
    -dI / tau_s``, ``dI/dt = dI - I / tau_s``, ``dV/dt = -V / tau_m + I /
    C``, rounded to float32 once."""
    ts, tm, c, h = PARAMS.tau_syn, PARAMS.tau_m, PARAMS.c_m, PARAMS.dt
    a = np.array([[-1 / ts, 0, 0], [1, -1 / ts, 0], [0, 1 / c, -1 / tm]])
    e = _expm(a * h)
    p = bt.HpcStdpNet(scale=SMALL[0], device='cpu',
                      params=bt.HpcStdpParams(ce=SMALL[1], ci=SMALL[2])
                      ).step_params(1, 0)
    assert abs(hs.propagator_31(ts, tm, c, h) / e[2, 0] - 1) < 1e-12
    assert abs(hs.propagator_32(ts, tm, c, h) / e[2, 1] - 1) < 1e-12
    assert (hs.propagator_31(ts, tm, c, h),
            hs.propagator_32(ts, tm, c, h)) == pytest.approx(
        ref.propagators(CFG), rel=1e-14)
    for got, want in ((p.p31, e[2, 0]), (p.p32, e[2, 1]), (p.p21, e[1, 0]),
                      (p.p11, e[0, 0]), (p.em1, e[2, 2] - 1)):
        assert got == float(np.float32(want))
    assert p.units == np.float32(4096 / PARAMS.je_pa())
    assert (p.w_ext, p.w_e, p.w_i, p.ref_steps, p.delay, p.depth) == (
        4096, 4096, -20480, 5, 15, 16)
    assert (p.v_th, p.v_reset) == (20.0, 0.0)


def test_one_excitatory_input_peaks_at_je():
    """4096 units into a neuron at rest with no drive: a PSP of 0.14 mV
    that peaks ~1.7 ms later."""
    prm = bt.HpcStdpParams(ce=2, ci=1, eta=0.0)
    net = bt.HpcStdpNet(scale=0.001, params=prm, device='cpu')
    s = net.init_state()
    ring = s.ring.clone()
    ring[0, 0] = 4096
    s = s._replace(v=torch.zeros(net.num), ring=ring)
    vs = []
    for _ in range(60):
        s = net.run(1, state=s)
        vs.append(float(s.v[0]))
    assert abs(max(vs) - 0.14) < 1e-6
    assert vs.index(max(vs)) in (16, 17)


# -- the network ------------------------------------------------------------------

@pytest.mark.parametrize('preset', [SMALL, FULL_DEGREE],
                         ids=['reduced', 'full-degree'])
def test_each_neuron_has_its_in_degrees(preset):
    scale, ce, ci = preset
    net, inputs, _ = setup(*preset)
    ne, num, n_plastic = net.n_exc, net.num, net.n_plastic
    assert n_plastic == ne * ce
    assert net.targets.numel() == n_plastic + net.num * ci + (num - ne) * ce
    rows = torch.repeat_interleave(
        torch.arange(num), torch.cat([
            (net.plastic_ptr[1:] - net.plastic_ptr[:-1]).long(),
            torch.zeros(num - ne, dtype=torch.long)]))
    assert bool((net.targets[:n_plastic] < ne).all())
    indeg = torch.bincount(net.targets[:n_plastic].long(), minlength=ne)
    assert bool((indeg == ce).all())
    srows = torch.repeat_interleave(
        torch.arange(num), (net.static_ptr[1:] - net.static_ptr[:-1]).long())
    tg = net.targets[n_plastic:].long()
    from_e = srows < ne
    assert bool((tg[from_e] >= ne).all())
    assert int(net.static_ptr[ne]) == n_plastic + int(from_e.sum())
    assert bool((torch.bincount(tg[from_e], minlength=num)[ne:] == ce).all())
    assert bool((torch.bincount(tg[~from_e], minlength=num) == ci).all())
    assert rows.numel() == n_plastic
    w = net.weights.double()
    assert abs(float(w.mean()) - PARAMS.je_pa()) < 0.05 * 3.47 + 0.05
    assert abs(float(w.std()) / 3.47 - 1) < 0.1
    assert net.depth == inputs['depth'] == 16


def test_build_hpc_network_draws_the_reference_network():
    scale, ce, ci = SMALL
    gen = torch.Generator().manual_seed(CFG['network_seed'])
    got = bt.build_hpc_network(bt.HpcStdpParams(ce=ce, ci=ci), scale, gen,
                               CPU)
    want = ref.network(config(ce, ci), scale, CPU)
    for k, x in got.items():
        assert x.dtype == want[k].dtype and torch.equal(x, want[k]), k


def test_a_default_network_is_drawn_from_its_seed():
    prm = bt.HpcStdpParams(ce=SMALL[1], ci=SMALL[2])
    a = bt.HpcStdpNet(scale=SMALL[0], params=prm, device='cpu', seed=7)
    b = bt.HpcStdpNet(scale=SMALL[0], params=prm, device='cpu', seed=7)
    c = bt.HpcStdpNet(scale=SMALL[0], params=prm, device='cpu', seed=8)
    assert torch.equal(a.targets, b.targets) and torch.equal(a.weights,
                                                             b.weights)
    assert not torch.equal(a.targets, c.targets)
    with pytest.raises(ValueError, match='all of'):
        bt.HpcStdpNet(scale=SMALL[0], params=prm, device='cpu',
                      targets=a.targets)
    with pytest.raises(ValueError, match='do not match'):
        bt.HpcStdpNet(scale=SMALL[0] * 2, params=prm, device='cpu',
                      targets=a.targets, plastic_ptr=a.plastic_ptr,
                      static_ptr=a.static_ptr, weights=a.weights)


def test_a_network_past_int32_positions_is_refused():
    """Scale 16.9 holds 2,138,906,250 synapses; 17 would pass 2^31 - 1,
    which the rows' int32 positions cannot address."""
    assert sum(PARAMS.sizes(16.9)) * 11250 <= hs.MAX_SYNAPSES
    with pytest.raises(ValueError, match='int32 positions'):
        bt.build_hpc_network(PARAMS, 17.0, None, CPU)


def test_the_plan_holds_each_columns_synapses_in_order():
    """The twin's CSC (:func:`stdp_columns`): each E neuron's incoming
    plastic synapses, in the order of their positions, with their
    sources. A net on the CPU keeps no K24 scratch."""
    net, _, _ = setup()
    col_ptr, col_pos, col_src = hs.stdp_columns(net.targets, net.plastic_ptr)
    assert net.plan is None
    assert col_ptr.dtype == col_pos.dtype == col_src.dtype == torch.int32
    ne, n_plastic = net.n_exc, net.n_plastic
    src = torch.repeat_interleave(
        torch.arange(ne), (net.plastic_ptr[1:] - net.plastic_ptr[:-1]).long())
    cp = col_ptr.tolist()
    assert cp[0] == 0 and cp[-1] == n_plastic
    for j in range(ne):
        pos = col_pos[cp[j]:cp[j + 1]].long()
        want = torch.nonzero(net.targets[:n_plastic] == j).flatten()
        assert torch.equal(pos, want), j
        assert torch.equal(col_src[cp[j]:cp[j + 1]].long(), src[pos])


def test_the_plan_is_k24s_scratch():
    """:func:`stdp_plan`: the rows' lists (line, source, walk before) by
    parity, their fronts' and backs' counters, the busiest block's work by
    parity and the flush's counters, the K+ history in whole tiles, the
    spike lists, records and last walks, and the split plan it is given."""
    split = torch.zeros(100, 4, dtype=torch.int32)
    plan = hs.stdp_plan(50, 40, 100, 37, split)
    assert plan.steps == 104
    assert plan.dlists.shape == (2, 100, 4)
    assert plan.counts.shape == (2 + 2 + 2 + 1,)
    assert hs.stdp_counts(90_000) == 2 + 2 + 2 + 352
    assert plan.split is split
    assert plan.kph.shape == (13, 40, hs.HPC_HTILE)
    assert plan.kph.dtype == torch.float32
    assert plan.spikes.shape == (40, 37) and plan.recent.shape == (40, 16)
    assert plan.last_walk.shape == (40,)
    for x in (plan.dlists, plan.counts, plan.spikes, plan.recent,
              plan.last_walk):
        assert x.dtype == torch.int32


def _hand_made():
    """Six E and three I neurons: empty rows, multapses and rows with no
    target in some blocks' ranges, each row's targets ascending."""
    plastic = [[], [0, 0, 5], [3], [1, 2, 2, 4, 5], [], [5]]
    static = [[6, 8], [], [7, 7], [6], [8], [], [0, 5, 6, 6], [], [2, 8]]

    def ptr(rows, first):
        return torch.tensor([first] + [first + sum(map(len, rows[:k + 1]))
                                       for k in range(len(rows))],
                            dtype=torch.int32)
    n_plastic = sum(map(len, plastic))
    return dict(targets=torch.tensor(sum(plastic + static, []),
                                     dtype=torch.int32),
                plastic_ptr=ptr(plastic, 0),
                static_ptr=ptr(static, n_plastic)), 6


def _drawn(scale, ce, ci):
    """A network drawn as :func:`build_hpc_network` draws it, and its NE."""
    prm = bt.HpcStdpParams(ce=ce, ci=ci)
    net = bt.build_hpc_network(prm, scale, torch.Generator().manual_seed(5),
                               CPU)
    return net, prm.sizes(scale)[0]


def _split_by_hand(net, ne, blocks):
    """Each line's bounds by brute force: for block b, its row's first
    position plus the targets of the row's part below b's first owned
    target (the E owners ``floor(b NE / G)``, the I owners ``NE + floor(b
    NI / G)``)."""
    tg, pp, sp = (net[k].tolist() for k in ('targets', 'plastic_ptr',
                                           'static_ptr'))
    num = len(sp) - 1
    first_e = [b * ne // blocks for b in range(blocks + 1)]
    first_i = [ne + b * (num - ne) // blocks for b in range(blocks + 1)]
    # each line: its row's positions, whether it is the row's part of I
    # targets, and the owners' first targets
    lines = ([(pp[i], pp[i + 1], False, first_e) for i in range(ne)]
             + [(sp[i], sp[i + 1], True, first_i) for i in range(ne)]
             + [(sp[i], sp[i + 1], False, first_e) for i in range(ne, num)]
             + [(sp[i], sp[i + 1], True, first_i) for i in range(ne, num)])
    out = []
    for beg, end, inh, first in lines:
        row = tg[beg:end]
        # the part's first position, and its targets
        beg += sum(t < ne for t in row) if inh else 0
        part = [t for t in row if (t >= ne) == inh]
        out.append([beg + sum(t < f for t in part) for f in first])
    return torch.tensor(out, dtype=torch.int32)


SPLIT_CASES = {
    # G divides neither NE = 180 nor NI = 45
    'drawn, 7 blocks': (lambda: _drawn(0.02, 90, 22), 7, hs.SPLIT_CHUNK),
    'one block': (lambda: _drawn(0.02, 90, 22), 1, hs.SPLIT_CHUNK),
    # CE 40 sources of 18 E neurons: every row holds multapses
    'multapses': (lambda: _drawn(0.002, 40, 10), 3, hs.SPLIT_CHUNK),
    # 5 blocks over NI = 4: a block owns no I neuron
    'more blocks than I neurons': (lambda: _drawn(0.002, 40, 10), 5,
                                   hs.SPLIT_CHUNK),
    'hand-made, empty rows and ranges': (_hand_made, 4, hs.SPLIT_CHUNK),
    'hand-made, a chunk a row': (_hand_made, 3, 2),
    'drawn, chunks of 100 positions': (lambda: _drawn(0.02, 90, 22), 11,
                                       100),
}


@pytest.mark.parametrize('case', list(SPLIT_CASES))
def test_the_split_plan_is_each_rows_lower_bound_by_block(monkeypatch, case):
    """:func:`stdp_split`: each line's bound for block b is the first
    position of the row's part whose target b or a later block owns,
    against a count by hand: on drawn networks, with multapses, with
    empty rows, rows with no target in a block's range, G dividing
    neither NE nor NI and G above NI, one block, and chunks of a row or
    less."""
    make, blocks, chunk = SPLIT_CASES[case]
    monkeypatch.setattr(hs, 'SPLIT_CHUNK', chunk)
    net, ne = make()
    num = net['static_ptr'].numel() - 1
    got = hs.stdp_split(net['targets'], net['plastic_ptr'],
                        net['static_ptr'], ne, blocks)
    assert got.dtype == torch.int32 and got.shape == (2 * num, blocks + 1)
    assert torch.equal(got, _split_by_hand(net, ne, blocks))
    # block b's parts of the rows are its own targets, and the lines tile
    # the rows
    e, i = hs._owned(ne, num, blocks, CPU)
    tg = net['targets'].long()
    for line in range(2 * num):
        bounds = got[line].tolist()
        assert bounds == sorted(bounds)
        # the lines by E targets: the plastic rows and the I rows' E parts
        owners = e if line < ne or 2 * ne <= line < ne + num else i
        for b in range(blocks):
            part = tg[bounds[b]:bounds[b + 1]]
            ok = (part >= owners[b]) & (part < owners[b + 1])
            assert bool(ok.all()), (line, b)
    pp, sp = net['plastic_ptr'], net['static_ptr']
    assert torch.equal(got[:ne, 0], pp[:-1]) and torch.equal(
        got[:ne, -1], pp[1:])
    assert torch.equal(got[ne:2 * ne, 0], sp[:ne]) and torch.equal(
        got[ne:2 * ne, -1], sp[1:ne + 1])
    assert torch.equal(got[2 * ne:ne + num, 0], sp[ne:-1])
    assert torch.equal(got[2 * ne:ne + num, -1], got[ne + num:, 0])
    assert torch.equal(got[ne + num:, -1], sp[ne + 1:])


def test_the_split_plan_refuses_rows_whose_targets_do_not_ascend():
    net, ne = _hand_made()
    targets = net['targets'].clone()
    # plastic row 3, [1, 2, 2, 4, 5], as [4, 2, 2, 4, 5]
    targets[4] = 4
    with pytest.raises(ValueError, match='must ascend'):
        hs.stdp_split(targets, net['plastic_ptr'], net['static_ptr'], ne, 2)


@pytest.mark.parametrize('steps, delay, ref_steps', [
    (1, 15, 5), (14, 15, 5), (15, 15, 5), (10240, 15, 5), (97, 3, 0),
    (50, 1, 2)])
def test_the_spike_lists_hold_the_fastest_firing(steps, delay, ref_steps):
    """A launch's spike list holds an E neuron's spikes of the d steps
    before it, any of them (a state may be made by hand), and one every
    ``ref_steps + 1`` steps of the launch from its first, the fastest the
    refractory period allows; every step where the reset is not below the
    threshold."""
    cap = hs.spike_capacity(steps, delay, ref_steps)
    fastest = delay + len(range(0, steps, ref_steps + 1))
    assert cap == fastest
    assert hs.spike_capacity(steps, delay, ref_steps, False) == delay + steps
    assert hs.spike_capacity(10240, 15, 5) >= math.ceil(
        (10240 + 15) / 6) + 1


def test_a_neuron_driven_hard_fires_once_a_refractory_period():
    """The twin with a drive far past threshold (JE 1000 mV at the same
    Poisson rate, no inhibition): every neuron spikes at the launch's first
    step and then every ``ref_steps + 1`` steps, no faster, so its spikes
    fill the list's rule exactly."""
    prm = bt.HpcStdpParams(ce=2, ci=1, je=1000.0, eta=12036.0, g=0.0)
    net = bt.HpcStdpNet(scale=0.002, params=prm, device='cpu')
    p = net.step_params(0, 0)
    s = net.init_state()
    s = s._replace(v=torch.full((net.num,), 30.0))
    for steps in (1, 6, 7, 40, 100):
        out = net.run(steps, state=s)
        spikes = out.spike_count - s.spike_count
        assert bool((spikes == len(range(0, steps, p.ref_steps + 1))).all())
        assert int(spikes.max()) + p.delay <= hs.spike_capacity(
            steps, p.delay, p.ref_steps)


# -- the run ------------------------------------------------------------------------

@pytest.mark.parametrize('seed', [SEED, 3, 2 ** 40 + 7])
def test_the_twin_is_the_reference_bit_for_bit(seed):
    """300 steps from a drawn state (every spike's synapses delivered and
    depressed, every post spike's column facilitated after 15 steps):
    each state array bit for bit the reference's, on three seeds."""
    net, inputs, cfg = setup(seed=seed)
    state = inputs['states'][0]
    got = net.run(300, state=program_state(state))
    want = ref.simulate(cfg, {}, inputs, state, 300)
    assert mismatches(got, want) == ZERO
    assert got.step == 300 and got.key == state['key']
    assert int(got.spike_count.sum()) > net.num
    assert int((got.weights != state['weights']).sum()) > net.n_plastic // 2
    assert bool(got.ring.any()) and bool(got.spiked.any())
    other = ref.simulate(cfg, {}, inputs, inputs['states'][1], 300)
    assert mismatches(got, other) != ZERO


def test_the_twin_is_the_reference_at_the_full_in_degree():
    net, inputs, cfg = setup(*FULL_DEGREE)
    state = inputs['states'][1]
    got = net.run(200, state=program_state(state))
    want = ref.simulate(cfg, {}, inputs, state, 200)
    assert mismatches(got, want) == ZERO
    assert int(got.spike_count.sum()) > 0


def test_chained_runs_continue_the_step_the_stream_and_the_traces():
    net, inputs, _ = setup()
    state = program_state(inputs['states'][1])
    whole = net.run(130, state=state)
    half = net.run(70, state=net.run(60, state=state))
    assert half.step == whole.step == 130
    for k in hs.STATE_FIELDS:
        assert torch.equal(getattr(half, k), getattr(whole, k)), k


@pytest.mark.parametrize('launch_steps, n_steps, sizes', [
    (7, 30, [7, 7, 7, 7, 2]), (10, 30, [10, 10, 10]), (30, 30, [30]),
    (64, 30, [30]), (8, 0, [0])])
def test_run_splits_a_trial_into_launches_of_at_most_launch_steps(
        monkeypatch, launch_steps, n_steps, sizes):
    """``run`` makes a trial in launches of at most LAUNCH_STEPS steps,
    each from the step the one before ended at, chained through the
    state: bit for bit one twin run of the whole trial, and the counters
    the launches'."""
    net0, inputs, _ = setup()
    monkeypatch.setattr(hs, 'LAUNCH_STEPS', launch_steps)
    net = bt.HpcStdpNet(scale=SMALL[0], params=net0.params, device='cpu',
                        **inputs['program'])
    assert net.launch_steps == launch_steps
    state = program_state(inputs['states'][1])._replace(step=2 ** 32 - 12)
    seen = []
    twin = hs.stdp_sim.twin

    def spy(*args, **kwargs):
        seen.append((args[13], args[14].step0))
        return twin(*args, **kwargs)
    monkeypatch.setattr(hs.stdp_sim, 'twin', spy)
    tracing.drain()
    tracing.drain_counts()
    tracing.enable()
    try:
        got = net.run(n_steps, state=state)
    finally:
        tracing.disable()
    tracing.drain()
    counts = tracing.drain_counts()
    assert [n for n, _ in seen] == sizes
    assert [s for _, s in seen] == [(state.step + sum(sizes[:k])) % 2 ** 32
                                    for k in range(len(sizes))]
    assert got.step == state.step + n_steps
    want = [getattr(state, k).clone() for k in hs.STATE_FIELDS]
    counters = torch.zeros(4, dtype=torch.int64)
    twin(*want, net.targets, net.plastic_ptr, net.static_ptr, n_steps,
         net.step_params(state.key, state.step), counters=counters)
    for k, x in zip(hs.STATE_FIELDS, want):
        assert torch.equal(getattr(got, k), x), k
    assert counts == dict(zip(hs.COUNTERS, counters.tolist()))


def test_run_leaves_its_state_untouched_and_states_share_the_weights():
    net, inputs, _ = setup()
    state = program_state(inputs['states'][0])
    before = {k: getattr(state, k).clone() for k in hs.STATE_FIELDS}
    out = net.run(40, state=state)
    for k in hs.STATE_FIELDS:
        assert torch.equal(getattr(state, k), before[k]), k
    assert out.weights.data_ptr() != state.weights.data_ptr()
    a, b = net.init_state(), net.init_state(torch.Generator().manual_seed(3))
    assert a.weights is b.weights is net.weights
    assert a.key != b.key and a.step == 0
    assert abs(float(a.v.mean()) - 5.7) < 1.0
    assert not a.khist.any() and not a.spiked.any() and not a.kplus.any()


def _spike_steps(net, state, n_steps):
    """The twin one step a launch: each step's spiking neurons, and the
    final state."""
    steps = []
    for _ in range(n_steps):
        out = net.run(1, state=state)
        steps.append(torch.nonzero(out.spike_count
                                   - state.spike_count).flatten().tolist())
        state = out
    return steps, state


def _send(w0, pre_spikes, post_spikes, n_steps, d, p):
    """NEST's ``stdp_pl_synapse_hom::send()``, synapse by synapse, in
    float64 with ``exp()`` of the time since an event: facilitation for
    the post spikes in ``(t_last - d, t - d]`` with the synapse's K+, then
    depression with the post neuron's K- at ``t - d`` (its spikes strictly
    before), at each pre spike ``t``. Returns the weight and whether a
    facilitation that the eager rule applied by the end is still pending
    (a post spike in ``(t_last - d, n_steps - 1 - d]``)."""
    h, tp, tm = p.dt, p.tau_plus, p.tau_minus
    w, kplus, t_last = float(w0), 0.0, 0

    def k_minus(t):
        return sum(math.exp(-(t - s) * h / tm) for s in post_spikes if s < t)
    for t in pre_spikes:
        for s in post_spikes:
            if t_last - d < s <= t - d:
                kp = kplus * math.exp((t_last - (s + d)) * h / tp)
                w = w + p.lam * w ** p.mu * kp
        w = max(w - p.lam * p.alpha * w * k_minus(t - d), 0.0)
        kplus = kplus * math.exp((t_last - t) * h / tp) + 1.0
        t_last = t
    first = t_last - d if pre_spikes else -math.inf
    pending = any(first < s <= n_steps - 1 - d for s in post_spikes)
    return w, pending


def test_the_eager_rule_is_nests_send():
    """Over 400 steps of the twin, each E -> E weight that NEST's send()
    has settled by the end (no facilitation still pending) equals the
    eager rule's, within the traces' float32 step-by-step decay (1e-4 pA);
    thousands of synapses changed."""
    net, inputs, _ = setup()
    state = program_state(inputs['states'][0])
    n_steps, d = 400, net.delay
    steps, out = _spike_steps(net, state, n_steps)
    by_neuron = {}
    for t, ids in enumerate(steps):
        for i in ids:
            by_neuron.setdefault(i, []).append(t)
    src = torch.repeat_interleave(
        torch.arange(net.n_exc),
        (net.plastic_ptr[1:] - net.plastic_ptr[:-1]).long()).tolist()
    tg = net.targets[:net.n_plastic].tolist()
    w0, w1 = state.weights.tolist(), out.weights.tolist()
    settled = changed = 0
    for c in range(net.n_plastic):
        w, pending = _send(w0[c], by_neuron.get(src[c], []),
                           by_neuron.get(tg[c], []), n_steps, d, PARAMS)
        if pending:
            continue
        settled += 1
        changed += w != w0[c]
        assert abs(w1[c] - w) < 1e-4, (c, w0[c], w1[c], w)
    assert settled > net.n_plastic // 4 and changed > 2000


def test_the_run_records_its_spans_and_counts():
    net, inputs, _ = setup()
    state = program_state(inputs['states'][0])
    tracing.drain()
    tracing.drain_counts()
    tracing.enable()
    try:
        out = net.run(60, state=state)
    finally:
        tracing.disable()
    spans = tracing.drain()
    root = spans[0]
    assert root.name == 'brainevent_torch.HpcStdpNet.run'
    assert root.parent_id is None
    assert root.attrs == dict(num=net.num, n_plastic=net.n_plastic,
                              n_steps=60, route='loop', npt=0)
    assert [s.name for s in spans[1:]] == [
        'brainevent_torch.HpcStdpNet.copies',
        'brainevent_torch.HpcStdpNet.launch']
    # the counts by hand, from the spikes of the same 60 steps
    steps, _ = _spike_steps(net, state, 60)
    prow = (net.plastic_ptr[1:] - net.plastic_ptr[:-1]).tolist()
    col_ptr = hs.stdp_columns(net.targets, net.plastic_ptr)[0]
    col = (col_ptr[1:] - col_ptr[:-1]).tolist()
    dep = sum(prow[i] for ids in steps for i in ids if i < net.n_exc)
    fac = sum(col[i] for ids in steps[:60 - net.delay] for i in ids
              if i < net.n_exc)
    assert tracing.drain_counts() == {
        'brainevent_torch.HpcStdpNet.depressions': dep,
        'brainevent_torch.HpcStdpNet.facilitations': fac,
        'brainevent_torch.HpcStdpNet.flush_facilitations': 0,
        'brainevent_torch.HpcStdpNet.walk_busiest_block': 0}
    assert dep > 0 and fac > 0
    net.run(5, state=out)
    assert tracing.drain() == [] and tracing.drain_counts() == {}


# -- the kernel's interface, without a card ---------------------------------------

def test_the_ctypes_struct_is_the_c_struct():
    text = (ROOT / 'brainevent_torch' / 'csrc' / 'stdp_sim.cu').read_text()
    body = text[text.index('struct StdpParams {'):]
    body = body[:body.index('};')]
    names = re.findall(r'^\s+\w+ (\w+)(?:\[[^\]]+\])?;', body, re.M)
    assert names == [name for name, _ in hs.StdpParams._fields_]
    assert ctypes.sizeof(hs.StdpParams) == 4 * (14 + 10 + 2 + 16)


def test_the_wrapper_passes_what_the_c_entry_point_takes(monkeypatch):
    """Each C entry point gets the arguments it declares, K24's the split
    plan after the rows and the grid's blocks; the C signature's parameter
    names are the wrapper's pointers in order."""
    text = (ROOT / 'brainevent_torch' / 'csrc' / 'stdp_sim.cu').read_text()
    seen = {}

    def function(name, argtypes, restype=ctypes.c_int):
        sig = text[text.index(f' {name}(') + len(name) + 2:]
        assert sig[:sig.index(')')].count(',') + 1 == len(argtypes), name

        def fn(*cargs):
            assert len(cargs) == len(argtypes), name
            seen[name] = cargs
            if name == 'stdp_sim_max_blocks':
                cargs[-1]._obj.value = 1000
            return 0
        return fn
    monkeypatch.setattr(cuda_build, 'function', function)
    monkeypatch.setattr(hs, 'cuda_stream', lambda device: None)
    hs._max_blocks.cache_clear()
    try:
        net, inputs, _ = setup()
        s = program_state(inputs['states'][0])
        out = [getattr(s, k).clone() for k in hs.STATE_FIELDS]
        assert hs.stdp_sim_grid(net.num, CPU) == 1
        before = hs.stdp_sim.launches
        plan = _plan(net)
        hs._stdp_sim_cuda(hs.stdp_sim, *out, net.targets, net.plastic_ptr,
                          net.static_ptr, 10, net.step_params(1, 0),
                          scratch=plan,
                          counters=torch.zeros(4, dtype=torch.int64))
        assert hs.stdp_sim.launches == before + 1
        x = hs.stdp_pow_cuda(torch.ones(5), 0.4)
        assert x.shape == (5,)
    finally:
        hs._max_blocks.cache_clear()
    assert {k: len(v) for k, v in seen.items()} == {
        'stdp_sim_max_blocks': 2, 'stdp_sim_launch': 28,
        'stdp_pow_launch': 6}
    sig = text[text.index('BE_EXPORT int stdp_sim_launch('):]
    names = re.findall(r'(\w+),', sig[:sig.index('{')])
    cargs = seen['stdp_sim_launch']
    assert names[names.index('split')] == 'split'
    assert cargs[names.index('split')] == plan.split.data_ptr()
    assert cargs[names.index('dlists')] == plan.dlists.data_ptr()
    assert cargs[names.index('targets')] == net.targets.data_ptr()
    assert cargs[names.index('blocks')] == 1


def _plan(net, steps=16, blocks=1):
    p = net.step_params(1, 0)
    split = hs.stdp_split(net.targets, net.plastic_ptr, net.static_ptr,
                          net.n_exc, blocks)
    return hs.stdp_plan(net.num, net.n_exc, steps,
                        hs.spike_capacity(steps, p.delay, p.ref_steps), split)


def _other_network():
    """A smaller network than :func:`setup`'s."""
    prm = bt.HpcStdpParams(ce=SMALL[1], ci=SMALL[2])
    return bt.build_hpc_network(prm, SMALL[0] / 2,
                                torch.Generator().manual_seed(1), CPU), prm


def _bad(field, make):
    return lambda net, plan: plan._replace(**{field: make(net, plan)})


BAD_SCRATCH = {
    'dlists of two ints': _bad('dlists', lambda net, plan: torch.zeros(
        2, 2 * net.num, 2, dtype=torch.int32)),
    'counts without the ranges': _bad('counts', lambda net, plan: torch.zeros(
        2, dtype=torch.int32)),
    'a history too short': _bad('kph', lambda net, plan: plan.kph[1:]),
    'a history not in tiles': _bad('kph', lambda net, plan: plan.kph.view(
        plan.steps, net.n_exc)),
    'steps not whole tiles': _bad('steps', lambda net, plan: plan.steps - 1),
    'spike lists too short': _bad('spikes', lambda net, plan: plan.spikes[
        :, :-1].contiguous()),
    'records of four': _bad('recent', lambda net, plan: plan.recent[
        :, :4].contiguous()),
    'a last walk short': _bad('last_walk', lambda net, plan: plan.last_walk[
        1:]),
    'a split plan for another grid': _bad('split', lambda net, plan: _plan(
        net, blocks=2).split),
    'a split plan of another network': _bad('split', lambda net, plan: (
        lambda other, prm: hs.stdp_split(
            other['targets'], other['plastic_ptr'], other['static_ptr'],
            prm.sizes(SMALL[0] / 2)[0], 1))(*_other_network())),
}


@pytest.mark.parametrize('case', [*BAD_SCRATCH, 'counters of two',
                                  'more steps than a launch holds'])
def test_the_wrapper_refuses_scratch_that_does_not_fit(monkeypatch, case):
    """Each scratch array, the split plan (for K24's grid and the
    network's rows), the counters and the launch's steps are checked
    against the network and the launch before K24 is called."""
    monkeypatch.setattr(cuda_build, 'function', lambda *a, **k: pytest.fail(
        'K24 was called'))
    monkeypatch.setattr(hs, 'stdp_sim_grid', lambda num, device: 1)
    net, inputs, _ = setup()
    s = program_state(inputs['states'][0])
    out = [getattr(s, k).clone() for k in hs.STATE_FIELDS]
    plan, n_steps = _plan(net), 16
    counters = torch.zeros(4, dtype=torch.int64)
    if case in BAD_SCRATCH:
        plan = BAD_SCRATCH[case](net, plan)
    elif case == 'counters of two':
        counters = counters[:2]
    else:
        n_steps = plan.steps + 1
    with pytest.raises(ValueError, match='do not match|at most'):
        hs._stdp_sim_cuda(hs.stdp_sim, *out, net.targets, net.plastic_ptr,
                          net.static_ptr, n_steps, net.step_params(1, 0),
                          scratch=plan, counters=counters)


def test_a_launch_holds_the_cells_trials():
    """A net's default launch holds a 1 s trial (10,000 steps), so the
    benchmark's trials run as one launch each, in whole tiles of the K+
    history, whose tile is the kernel's."""
    text = (ROOT / 'brainevent_torch' / 'csrc' / 'stdp_sim.cu').read_text()
    assert re.search(r'constexpr int STDP_HTILE = (\d+);', text).group(
        1) == str(hs.HPC_HTILE)
    assert hs.LAUNCH_STEPS >= 10_000 and hs.LAUNCH_STEPS % hs.HPC_HTILE == 0
    net, _, _ = setup()
    assert net.launch_steps == hs.LAUNCH_STEPS


def test_the_grid_takes_two_neurons_a_thread_before_it_refuses(monkeypatch):
    monkeypatch.setattr(hs, '_max_blocks', lambda device_index: 1000)
    assert hs.stdp_sim_grid(112_500, CPU) == 440
    monkeypatch.setattr(hs, '_max_blocks', lambda device_index: 396)
    assert hs.stdp_sim_grid(112_500, CPU) == 396
    monkeypatch.setattr(hs, '_max_blocks', lambda device_index: 219)
    with pytest.raises(ValueError, match='112500 neurons need more than'):
        hs.stdp_sim_grid(112_500, CPU)
    monkeypatch.setattr(hs, '_max_blocks', lambda device_index: 220)
    assert hs.stdp_sim_grid(112_500, CPU) == 220


def test_k24_replaces_no_tpu_kernel():
    assert core.REGISTRY['stdp_sim'].replaces is None
    assert core.REGISTRY['stdp_sim'].twin is hs.stdp_loop


# -- K24 on a card ----------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the CUDA kernels have no CPU form')
    return torch.device('cuda')


def twin_run(net, state, n_steps, counters=None):
    """The twin over the net's arrays, on their device: the state arrays
    after *n_steps* from *state*."""
    out = [getattr(state, k).clone() for k in hs.STATE_FIELDS]
    hs.stdp_loop(*out, net.targets, net.plastic_ptr, net.static_ptr,
                 n_steps, net.step_params(state.key, state.step),
                 counters=counters)
    return out


def full_setup(scale, device):
    return setup(scale, PARAMS.ce, PARAMS.ci, device)


def traced_run(net, state, n_steps):
    """``run`` with tracing on: the state and the counters' sums."""
    tracing.drain()
    tracing.drain_counts()
    tracing.enable()
    try:
        out = net.run(n_steps, state=state)
        root = tracing.drain()[0]
    finally:
        tracing.disable()
    return out, root, tracing.drain_counts()


def check_counts(counts, counters, net):
    """K24's counters against the twin's: the same depressions and
    facilitations, a share of the latter made by the flush, and the
    busiest block's work of the walks (its plastic entries and
    facilitations, a step's largest, summed over the steps) between the
    blocks' mean and the grid's whole work."""
    dep, fac, none, no_blocks = counters.tolist()
    assert none == 0 and no_blocks == 0 and dep > 0 and fac > 0
    flush = counts.pop('brainevent_torch.HpcStdpNet.flush_facilitations')
    assert 0 < flush < fac
    busiest = counts.pop('brainevent_torch.HpcStdpNet.walk_busiest_block')
    work = dep + fac - flush
    blocks = hs.stdp_sim_grid(net.num, net.device)
    assert work <= busiest * blocks and busiest <= work, (busiest, work)
    assert counts == {'brainevent_torch.HpcStdpNet.depressions': dep,
                      'brainevent_torch.HpcStdpNet.facilitations': fac}


@pytest.mark.cuda
@pytest.mark.parametrize('scale, warm, n_steps', [(0.1, 0, 1000),
                                                  (10.0, 0, 1000),
                                                  (10.0, 1000, 200)],
                         ids=['0.1', '10', '10-after-1000'])
def test_k24_is_the_twin_bit_for_bit(cuda_device, scale, warm, n_steps):
    """``run`` from a drawn state (the start-up bursts of its first ~900
    steps), or *warm* steps on, is one K24 launch and no other kernel, bit
    for bit the twin (every state array) and a second launch from the same
    state; its counters are the twin's."""
    net, inputs, _ = full_setup(scale, cuda_device)
    state = program_state(inputs['states'][0])
    if warm:
        state = net.run(warm, state=state)
    core.reset_launch_counts()
    got, _, counts = traced_run(net, state, n_steps)
    torch.cuda.synchronize()
    launches = core.launch_counts()
    assert launches['stdp_sim'] == 1 and sum(launches.values()) == 1, launches
    again = net.run(n_steps, state=state)
    counters = torch.zeros(4, dtype=torch.int64, device=cuda_device)
    want = twin_run(net, state, n_steps, counters)
    for k, x in zip(hs.STATE_FIELDS, want):
        assert torch.equal(getattr(got, k), x), k
        assert torch.equal(getattr(again, k), x), k
    assert int((got.spike_count - state.spike_count).sum()) > 0
    assert not torch.equal(got.weights, state.weights)
    check_counts(counts, counters, net)


@pytest.mark.cuda
def test_k24_takes_two_neurons_a_thread(cuda_device, monkeypatch):
    """A grid of fewer blocks than one neuron a thread needs (the
    co-resident limit patched lower, the net and its split plan built
    for it): threads own two neurons, bit for bit the twin over 500
    steps, and the counts are the twin's."""
    net0, inputs, _ = full_setup(0.1, cuda_device)
    blocks = -(-net0.num // (2 * hs.HPC_BLOCK)) + 1
    assert blocks * hs.HPC_BLOCK < net0.num
    monkeypatch.setattr(hs, '_max_blocks', lambda device_index: blocks)
    net = bt.HpcStdpNet(scale=0.1, params=net0.params, device=cuda_device,
                        **inputs['program'])
    state = program_state(inputs['states'][1])
    assert hs.stdp_sim_grid(net.num, cuda_device) == blocks
    assert net.plan.split.shape == (2 * net.num, blocks + 1)
    got, root, counts = traced_run(net, state, 500)
    assert root.attrs['npt'] == 2 and root.attrs['route'] == 'sim'
    counters = torch.zeros(4, dtype=torch.int64, device=cuda_device)
    want = twin_run(net, state, 500, counters)
    for k, x in zip(hs.STATE_FIELDS, want):
        assert torch.equal(getattr(got, k), x), k
    check_counts(counts, counters, net)


@pytest.mark.cuda
def test_k24_walks_a_grid_of_more_blocks_than_i_neurons(cuda_device,
                                                        monkeypatch):
    """A grid forced to 250 blocks over 900 E and 225 I neurons: each
    block owns 3 or 4 E neurons and 0 or 1 I neuron, so the walk's
    ranges are unequal and some empty; bit for bit the twin over 500
    steps, the counts the twin's, and the net refused at launch where its
    split plan is for another grid."""
    net0, inputs, _ = full_setup(0.1, cuda_device)
    monkeypatch.setattr(hs, 'stdp_sim_grid', lambda num, device: 250)
    net = bt.HpcStdpNet(scale=0.1, params=net0.params, device=cuda_device,
                        **inputs['program'])
    e, i = (x.diff() for x in hs._owned(net.n_exc, net.num, 250, 'cpu'))
    assert set(e.tolist()) == {3, 4} and set(i.tolist()) == {0, 1}
    state = program_state(inputs['states'][0])
    got, root, counts = traced_run(net, state, 500)
    assert root.attrs['npt'] == 1
    counters = torch.zeros(4, dtype=torch.int64, device=cuda_device)
    want = twin_run(net, state, 500, counters)
    for k, x in zip(hs.STATE_FIELDS, want):
        assert torch.equal(getattr(got, k), x), k
    check_counts(counts, counters, net)
    with pytest.raises(ValueError, match='grid of 250 blocks'):
        net0.run(10, state=state)


@pytest.mark.cuda
@pytest.mark.parametrize('n_steps', [1, 2, 14, 16, 17, 150])
def test_k24_chains_and_leaves_its_state(cuda_device, n_steps):
    """Runs of 1-150 steps chained into one of 300, a boundary inside the
    facilitations owed for the E spikes of the d steps before it (the
    lists seeded from ``spiked`` at every launch, and all but those owed
    made by the flush), and the state given unchanged."""
    net, inputs, _ = full_setup(0.1, cuda_device)
    state = program_state(inputs['states'][1])
    before = {k: getattr(state, k).clone() for k in hs.STATE_FIELDS}
    whole = net.run(300, state=state)
    part = net.run(n_steps, state=state)
    owed = part.spiked.sum() - part.spiked[part.step % net.depth].sum()
    assert int(owed) > 0
    part = net.run(300 - n_steps, state=part)
    for k in hs.STATE_FIELDS:
        assert torch.equal(getattr(part, k), getattr(whole, k)), k
        assert torch.equal(getattr(state, k), before[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize('scale', [0.1, 10.0])
def test_k24_splits_a_trial_longer_than_a_launch(cuda_device, monkeypatch,
                                                 scale):
    """A net whose launches hold 96 steps makes 300 in four launches, bit
    for bit the twin's one run and the counters its."""
    net0, inputs, _ = full_setup(scale, cuda_device)
    monkeypatch.setattr(hs, 'LAUNCH_STEPS', 96)
    net = bt.HpcStdpNet(scale=scale, params=net0.params, device=cuda_device,
                        **inputs['program'])
    state = program_state(inputs['states'][0])
    core.reset_launch_counts()
    got, _, counts = traced_run(net, state, 300)
    torch.cuda.synchronize()
    assert core.launch_counts()['stdp_sim'] == 4
    counters = torch.zeros(4, dtype=torch.int64, device=cuda_device)
    want = twin_run(net0, state, 300, counters)
    for k, x in zip(hs.STATE_FIELDS, want):
        assert torch.equal(getattr(got, k), x), k
    check_counts(counts, counters, net)


@pytest.mark.cuda
@pytest.mark.parametrize('launch_steps', [hs.LAUNCH_STEPS, 256])
def test_k24_catches_up_rows_silent_for_long(cuda_device, monkeypatch,
                                            launch_steps):
    """E neurons held refractory (600 steps, or past the run) while the
    rest fire every ~11 steps (eta 13, no inhibition): their rows' first
    walks and the flush owe a synapse dozens of facilitations, more than a
    record holds, from the spike lists; in one launch and in four, bit for
    bit the twin, and its counts."""
    prm = bt.HpcStdpParams(ce=90, ci=22, eta=13.0, g=0.0)
    monkeypatch.setattr(hs, 'LAUNCH_STEPS', launch_steps)
    net = bt.HpcStdpNet(scale=0.02, params=prm, device=cuda_device)
    state = net.init_state()
    ref = state.ref.clone()
    ref[:net.n_exc // 2] = 600
    ref[:net.n_exc // 8] = 10 ** 6
    state = state._replace(ref=ref, v=torch.where(ref > 0, 0.0, state.v))
    got, _, counts = traced_run(net, state, 900)
    counters = torch.zeros(4, dtype=torch.int64, device=cuda_device)
    want = twin_run(net, state, 900, counters)
    for k, x in zip(hs.STATE_FIELDS, want):
        assert torch.equal(getattr(got, k), x), k
    assert int((got.spike_count - state.spike_count)[:net.n_exc // 8].sum(
    )) == 0
    assert int(got.spike_count.sum()) > 20 * net.num
    check_counts(counts, counters, net)


@pytest.mark.cuda
def test_k24_pow_is_torch_pow_on_every_weight(cuda_device):
    """K24's ``powf`` (built with the library's flags) and ``torch.pow``
    on the card agree bit for bit on every float32 in (0, 4096) pA, the
    weights the facilitation can raise to mu."""
    mu = float(np.float32(PARAMS.mu))
    top = int(np.float32(4096.0).view(np.int32))
    chunk = 2 ** 27
    differ = 0
    for lo in range(1, top, chunk):
        bits = torch.arange(lo, min(lo + chunk, top), dtype=torch.int32,
                            device=cuda_device)
        x = bits.view(torch.float32)
        differ += int((hs.stdp_pow_cuda(x, mu).view(torch.int32)
                       != torch.pow(x, mu).view(torch.int32)).sum())
    assert differ == 0
