# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""Vogels et al. 2011's network with inhibitory plasticity (``IstdpNet``):
its constants, its network and the twin of K24's iSTDP instance
(``istdp_loop``) against the benchmark's plain reference
(``benchmark_torch/reference/vogels_istdp.py``), bit for bit, and the rule
against a replay of Brian's ``on_pre`` and ``on_post`` code, on the CPU;
and the instance against the twin on a card.

This file imports no JAX. The card tests (marker ``cuda``) skip without a
CUDA device; on a card run them with::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_vogels_istdp.py
"""

import ctypes
import json
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import brainevent_torch as bt
from brainevent_torch.models import istdp_net as isn
from brainevent_torch.ops import core, cuda_build, tracing
from benchmark_torch.reference import vogels_istdp as ref

from _torch_one_thread import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
CFG = json.loads((ROOT / 'benchmark_torch' / 'configs'
                  / 'vogels_istdp.json').read_text())
CPU = torch.device('cpu')
SEED = 2 ** 31 + 12345
PARAMS = bt.IstdpParams()
SMALL = 0.1          # 1,000 neurons at the published in-degrees
_CACHE = {}


def setup(scale=SMALL, device=CPU, seed=SEED):
    """The reference's inputs (two initial states) and the program's
    network over the same arrays."""
    key = (scale, str(device), seed)
    if key not in _CACHE:
        inputs = ref.make_inputs(CFG, dict(scale=scale, initial_states=2),
                                 seed, device)
        net = bt.IstdpNet(scale=scale, device=device, **inputs['program'])
        _CACHE[key] = net, inputs
    return _CACHE[key]


def program_state(fields: dict) -> bt.IstdpState:
    return bt.IstdpState(**{k: fields[k] for k in bt.IstdpState._fields})


def mismatches(got: bt.IstdpState, want: dict) -> dict:
    return ref.compare(CFG, {}, got._asdict(), want)


ZERO = {f'{k}_mismatch': 0 for k in ref.FIELDS}


# -- the constants ------------------------------------------------------------------

def test_the_published_parameters_are_the_defaults_and_the_config():
    stated = {k: v for part in ('network', 'neuron', 'initial_state')
              for k, v in CFG[part].items()}
    assert set(stated) == set(PARAMS.__dataclass_fields__)
    for key, value in stated.items():
        assert getattr(PARAMS, key) == value, key
    assert PARAMS.alpha == pytest.approx(2 * PARAMS.rho0 * PARAMS.tau_stdp
                                         * 1e-3, rel=1e-15)
    assert PARAMS.sizes(20.0) == (160_000, 40_000)
    assert PARAMS.probability(20.0) == pytest.approx(0.001)
    # the untrained network drives itself: E_L + I_bg / g_L is above V_t
    assert PARAMS.e_l + PARAMS.i_bg / PARAMS.g_l > PARAMS.v_t


def test_the_step_params_are_the_published_constants_in_float32():
    net, _ = setup()
    p = net.step_params(7)
    f = np.float32
    assert (p.dt_c, p.g_l, p.e_l, p.e_r, p.i_bg, p.v_t) == (
        f(0.1 / 200), 10.0, -60.0, -80.0, 200.0, -50.0)
    assert (p.da, p.dg) == (f(1 - 0.1 / 5), f(1 - 0.1 / 10))
    assert p.kd == f(math.exp(-0.1 / 20)) and p.q == f(1e-4)
    assert (p.eta, p.alpha, p.g_max, p.units) == (f(0.01), f(0.12), 100.0,
                                                  10000.0)
    # 0.3 nS and 3 nS are whole numbers of units
    assert (p.w_e, p.w_ii, p.ref_steps, p.depth, p.step0) == (
        3000, 30000, 50, 2, 7)
    assert p.static_e_end == int(net.static_ptr[net.n_exc])


# -- the network ------------------------------------------------------------------

def test_build_istdp_network_draws_the_reference_network():
    gen = torch.Generator().manual_seed(CFG['network_seed'])
    got = bt.build_istdp_network(PARAMS, SMALL, gen, CPU)
    want = ref.network(CFG, SMALL, CPU)
    for k, x in got.items():
        assert x.dtype == want[k].dtype and torch.equal(x, want[k]), k


@pytest.mark.parametrize('scale', [SMALL, 1.0])
def test_each_pair_is_a_synapse_at_epsilon_over_the_scale(scale):
    """The rows' targets ascend without repeats, the plastic rows hold E
    targets, the E rows E and I, the I rows I; the mean in-degrees are
    160 E and 40 I within a few SD, and every weight starts at 1e-10."""
    net, _ = setup(scale)
    ne, num, p = net.n_exc, net.num, PARAMS.probability(scale)
    pp, sp = net.plastic_ptr.long(), net.static_ptr.long()
    tg = net.targets.long()
    for ptr, lo, hi in ((pp, 0, ne), (sp[:ne + 1], 0, num),
                        (sp[ne:], ne, num)):
        rows = torch.repeat_interleave(torch.arange(ptr.numel() - 1),
                                       ptr[1:] - ptr[:-1])
        t = tg[int(ptr[0]):int(ptr[-1])]
        assert bool(((t >= lo) & (t < hi)).all())
        same = rows[1:] == rows[:-1]
        assert bool((t[1:][same] > t[:-1][same]).all())
    from_e = torch.bincount(tg[int(sp[0]):int(sp[ne])], minlength=num)
    from_i = torch.bincount(torch.cat([tg[:int(pp[-1])],
                                       tg[int(sp[ne]):]]), minlength=num)
    for deg, mean in ((from_e, ne * p), (from_i, (num - ne) * p)):
        sd = math.sqrt(mean * (1 - p) / num)
        assert abs(float(deg.double().mean()) - mean) < 6 * sd + 1e-9
    assert abs(float(from_e.double().mean()) - 160) < 2
    assert bool((net.weights == np.float32(1e-10)).all())


def test_a_default_network_is_drawn_from_its_seed():
    a = bt.IstdpNet(scale=SMALL, device='cpu', seed=7)
    b = bt.IstdpNet(scale=SMALL, device='cpu', seed=7)
    c = bt.IstdpNet(scale=SMALL, device='cpu', seed=8)
    assert torch.equal(a.targets, b.targets)
    assert not torch.equal(a.targets, c.targets)
    with pytest.raises(ValueError, match='all of'):
        bt.IstdpNet(scale=SMALL, device='cpu', targets=a.targets)
    with pytest.raises(ValueError, match='do not match'):
        bt.IstdpNet(scale=SMALL * 2, device='cpu', targets=a.targets,
                    plastic_ptr=a.plastic_ptr, static_ptr=a.static_ptr,
                    weights=a.weights)
    with pytest.raises(ValueError, match='probability'):
        bt.IstdpNet(scale=0.01, device='cpu')


def _hand_made():
    """Four E and three I neurons: empty rows and rows with no target in
    some blocks' ranges, each row's targets ascending."""
    plastic = [[0, 2, 3], [], [1]]
    static = [[0, 4, 6], [], [3, 5], [1, 2, 4, 5, 6], [4, 6], [], [5]]

    def ptr(rows, first):
        return torch.tensor([first] + [first + sum(map(len, rows[:k + 1]))
                                       for k in range(len(rows))],
                            dtype=torch.int32)
    n_plastic = sum(map(len, plastic))
    return dict(targets=torch.tensor(sum(plastic + static, []),
                                     dtype=torch.int32),
                plastic_ptr=ptr(plastic, 0),
                static_ptr=ptr(static, n_plastic)), 4


def _split_by_hand(net, ne, blocks):
    """Each plastic row's bounds by brute force: for block b, the row's
    first position plus its targets below b's first owned E target."""
    tg, pp = net['targets'].tolist(), net['plastic_ptr'].tolist()
    first = [b * ne // blocks for b in range(blocks + 1)]
    return torch.tensor([[pp[i] + sum(t < f for t in tg[pp[i]:pp[i + 1]])
                          for f in first] for i in range(len(pp) - 1)],
                        dtype=torch.int32)


@pytest.mark.parametrize('case, blocks', [('hand-made', 3), ('hand-made', 5),
                                          ('drawn', 7), ('drawn', 1)])
def test_the_split_plan_is_each_plastic_rows_lower_bound_by_block(case,
                                                                  blocks):
    """The iSTDP instance's split plan (``split_lines`` of the HPC
    network's, over the plastic rows alone): block ``b`` walks ``[line[b],
    line[b + 1])`` of each I neuron's plastic row, the part whose E
    targets it owns; a row whose targets do not ascend is refused."""
    if case == 'drawn':
        net = bt.build_istdp_network(PARAMS, SMALL,
                                     torch.Generator().manual_seed(3), CPU)
        ne, num = PARAMS.sizes(SMALL)[0], sum(PARAMS.sizes(SMALL))
    else:
        (net, ne), num = _hand_made(), 7
    got = isn.istdp_split(net['targets'], net['plastic_ptr'], ne, num,
                          blocks)
    assert got.shape == (num - ne, blocks + 1)
    assert torch.equal(got, _split_by_hand(net, ne, blocks))
    targets = net['targets'].clone()
    targets[:2] = net['targets'][:2].flip(0)
    with pytest.raises(ValueError, match='must ascend'):
        isn.istdp_split(targets, net['plastic_ptr'], ne, num, blocks)


def test_the_plan_holds_each_columns_synapses_and_the_scratch():
    """:func:`istdp_plan`: the plastic synapses by E target, in the order
    of their positions with their I sources, the plastic and static rows'
    lists and counters by parity and the E neurons' spike flags, and the
    split plan it is given."""
    net, ne = _hand_made()
    split = isn.istdp_split(net['targets'], net['plastic_ptr'], ne, 7, 2)
    plan = isn.istdp_plan(net['targets'], net['plastic_ptr'], ne, 7, split)
    assert plan.col_ptr.tolist() == [0, 1, 2, 3, 4]
    assert plan.col_pos.tolist() == [0, 3, 1, 2]
    assert plan.col_src.tolist() == [0, 2, 0, 0]
    assert plan.lists.shape == (2, 3 + 7) and plan.counts.shape == (4,)
    assert plan.fired.shape == (4,) and plan.fired.dtype == torch.uint8
    assert plan.split is split


# -- the rule and the neuron --------------------------------------------------------

def _pair(w0=0.5, **changes):
    """One E neuron (0) and one I neuron (1), one plastic synapse 1 -> 0."""
    prm = bt.IstdpParams(ne=1, ni=1, **changes)
    return bt.IstdpNet(scale=1.0, params=prm, device='cpu',
                       targets=torch.tensor([0], dtype=torch.int32),
                       plastic_ptr=torch.tensor([0, 1], dtype=torch.int32),
                       static_ptr=torch.tensor([1, 1, 1], dtype=torch.int32),
                       weights=torch.tensor([w0]))


def _drive(net, e_steps, i_steps, n_steps):
    """The twin one step a run, each neuron's v set above the threshold in
    the steps it should spike and far below in the others: the weight
    after each step, and the spikes."""
    state = net.init_state()._replace(v=torch.full((2,), -70.0))
    ws, spikes = [], []
    for t in range(n_steps):
        v = torch.tensor([-40.0 if t in e_steps else -70.0,
                          -40.0 if t in i_steps else -70.0])
        out = net.run(1, state=state._replace(
            v=v, ref=torch.zeros(2, dtype=torch.int32)))
        spikes.append((out.spike_count - state.spike_count).tolist())
        ws.append(float(out.weights[0]))
        state = out
    return ws, spikes


def _brian(w0, e_steps, i_steps, n_steps, prm, float64=False):
    """Brian's ``on_pre`` (``Apre += 1; w = clip(w + (Apost - alpha) eta,
    0, g_max)``) and ``on_post`` (``Apost += 1; w = clip(w + Apre eta, 0,
    g_max)``), the pre pathway first, with the traces decayed step by step
    by float32 exp(-dt / tau) (as the model), or by float64 exp over the
    interval since the trace's last event (as Brian, *float64*)."""
    dt = np.float64 if float64 else np.float32
    kd = dt(math.exp(-prm.dt / prm.tau_stdp))
    eta, alpha, g_max = dt(prm.eta), dt(prm.alpha), dt(prm.g_max)
    w, apre, apost, ws = dt(w0), dt(0), dt(0), []
    last_pre = last_post = 0
    for t in range(n_steps):
        if float64:
            apre_t = apre * math.exp(-(t - last_pre) * prm.dt / prm.tau_stdp)
            apost_t = apost * math.exp(-(t - last_post) * prm.dt
                                       / prm.tau_stdp)
        else:
            apre = apre_t = dt(kd * apre)
            apost = apost_t = dt(kd * apost)
        if t in i_steps:
            apre, last_pre = dt(apre_t + 1), t
            w = dt(min(max(dt(w + dt(eta * dt(apost_t - alpha))), 0), g_max))
        if t in e_steps:
            apre_now = apre if last_pre == t else apre_t
            apost, last_post = dt(apost_t + 1), t
            w = dt(min(max(dt(w + dt(eta * apre_now)), 0), g_max))
        ws.append(float(w))
    return ws


PAIR_CASES = {
    # pre and post in one step: the pre update sees A_post before the
    # post spike, the post update A_pre after the pre spike
    'pre then post in one step': (0.5, {}, [3, 20, 21], [3, 20, 40]),
    # post, then pre three steps on, and back
    'post then pre': (0.5, {}, [5, 30, 31], [8, 29, 60]),
    # pre spikes alone pull w down by eta alpha each, to the clip at 0
    'the clip at 0': (0.003, {}, [], [2, 4, 6, 8, 10]),
    # a low ceiling: the post updates after pre spikes reach it
    'the clip at g_max': (0.5, dict(g_max=0.52), [3, 4, 5, 6, 7, 8],
                          [1, 2, 3]),
}


@pytest.mark.parametrize('case', list(PAIR_CASES))
def test_a_pair_driven_by_hand_follows_brians_rule(case):
    """One I -> E synapse, its neurons driven to spike at chosen steps: the
    weight after every step is a float32 replay of Brian's on_pre and
    on_post code (the pre pathway first), and within 1e-6 of the same
    code with Brian's float64 event-driven traces."""
    w0, changes, e_steps, i_steps = PAIR_CASES[case]
    net = _pair(w0, **changes)
    n = 70
    ws, spikes = _drive(net, e_steps, i_steps, n)
    assert [t for t in range(n) if spikes[t][0]] == e_steps
    assert [t for t in range(n) if spikes[t][1]] == i_steps
    assert ws == _brian(w0, e_steps, i_steps, n, net.params)
    exact = _brian(w0, e_steps, i_steps, n, net.params, float64=True)
    assert max(abs(a - b) for a, b in zip(ws, exact)) < 1e-6
    if case == 'the clip at 0':
        assert ws[-1] == 0.0 and min(ws) == 0.0
    if case == 'the clip at g_max':
        assert max(ws) == np.float32(0.52) and ws[-1] == np.float32(0.52)


def test_a_neuron_driven_past_threshold_fires_once_a_refractory_period():
    """A drive that crosses the threshold in one step from E_L: each
    neuron spikes at steps 0, 50, 100, ... (Brian's ``timestep(t -
    lastspike) >= timestep(refractory)``), v held at E_L for the 49 steps
    between and integrated in the 50th."""
    prm = bt.IstdpParams(ne=2, ni=1, i_bg=1e5)
    net = bt.IstdpNet(scale=1.0, params=prm, device='cpu',
                      targets=torch.zeros(0, dtype=torch.int32),
                      plastic_ptr=torch.zeros(2, dtype=torch.int32),
                      static_ptr=torch.zeros(4, dtype=torch.int32),
                      weights=torch.zeros(0))
    state = net.init_state()
    fired, held = [], []
    for t in range(260):
        out = net.run(1, state=state)
        if bool((out.spike_count > state.spike_count).all()):
            fired.append(t)
        elif not bool((out.spike_count == state.spike_count).all()):
            raise AssertionError(t)
        held.append(bool((out.v == -60.0).all()))
        state = out
    assert fired == [0, 50, 100, 150, 200, 250]
    assert all(held)  # every step a spike, or held at E_L
    out = net.run(49, state=net.run(1, state=net.init_state()))
    assert int(out.ref[0]) == 1 and bool((out.v == -60.0).all())
    out = net.run(1, state=out)
    assert int(out.spike_count[0]) == 2


# -- the run ------------------------------------------------------------------------

@pytest.mark.parametrize('scale', [SMALL, 1.0], ids=['0.1', '1'])
@pytest.mark.parametrize('seed', [SEED, 3, 2 ** 40 + 7])
def test_the_twin_is_the_reference_bit_for_bit(scale, seed):
    """2,000 steps from a drawn state (the start's bursts near the
    refractory limit, thousands of pre and post updates): each state array
    bit for bit the reference's, on three seeds, at 1,000 and 10,000
    neurons."""
    net, inputs = setup(scale, seed=seed)
    state = inputs['states'][0]
    got = net.run(2000, state=program_state(state))
    want = ref.simulate(CFG, {}, inputs, state, 2000)
    assert mismatches(got, want) == ZERO
    assert got.step == 2000
    assert int(got.spike_count.sum()) > 10 * net.num
    assert int((got.weights != state['weights']).sum()) > net.n_plastic // 2
    assert bool(got.ring.any()) and bool(got.apre.any())
    other = ref.simulate(CFG, {}, inputs, inputs['states'][1], 2000)
    assert mismatches(got, other) != ZERO


def test_chained_runs_are_one_run():
    net, inputs = setup()
    state = program_state(inputs['states'][1])
    whole = net.run(300, state=state)
    part = net.run(17, state=state)
    part = net.run(1, state=part)
    part = net.run(282, state=part)
    assert part.step == whole.step == 300
    for k in isn.STATE_FIELDS:
        assert torch.equal(getattr(part, k), getattr(whole, k)), k


@pytest.mark.parametrize('launch_steps, n_steps, sizes', [
    (7, 30, [7, 7, 7, 7, 2]), (30, 30, [30]), (64, 30, [30]), (8, 0, [0])])
def test_run_splits_a_trial_into_launches_of_at_most_launch_steps(
        monkeypatch, launch_steps, n_steps, sizes):
    """``run`` makes a trial in launches of at most LAUNCH_STEPS steps, each
    from the step the one before ended at: bit for bit one twin run, and
    the counters the launches'."""
    _, inputs = setup()
    monkeypatch.setattr(isn, 'LAUNCH_STEPS', launch_steps)
    net = bt.IstdpNet(scale=SMALL, device='cpu', **inputs['program'])
    state = program_state(inputs['states'][1])._replace(step=2 ** 32 - 12)
    seen = []
    twin = isn.istdp_sim.twin

    def spy(*args, **kwargs):
        seen.append((args[12], args[13].step0))
        return twin(*args, **kwargs)
    monkeypatch.setattr(isn.istdp_sim, 'twin', spy)
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
    want = [getattr(state, k).clone() for k in isn.STATE_FIELDS]
    counters = torch.zeros(isn.ISTDP_COUNTS, dtype=torch.int64)
    twin(*want, net.targets, net.plastic_ptr, net.static_ptr, n_steps,
         net.step_params(state.step), counters=counters)
    for k, x in zip(isn.STATE_FIELDS, want):
        assert torch.equal(getattr(got, k), x), k
    assert counts == dict(zip(isn.COUNTERS, counters.tolist()))


def test_run_leaves_its_state_untouched_and_states_share_the_weights():
    net, inputs = setup()
    state = program_state(inputs['states'][0])
    before = {k: getattr(state, k).clone() for k in isn.STATE_FIELDS}
    out = net.run(40, state=state)
    for k in isn.STATE_FIELDS:
        assert torch.equal(getattr(state, k), before[k]), k
    assert out.weights.data_ptr() != state.weights.data_ptr()
    a, b = net.init_state(), net.init_state(torch.Generator().manual_seed(3))
    assert a.weights is b.weights is net.weights
    assert not torch.equal(a.v, b.v) and a.step == 0
    assert float(a.v.min()) >= -60.0 and float(a.v.max()) <= -50.0
    assert not a.apre.any() and not a.apost.any() and not a.ring.any()


def _spike_steps(net, state, n_steps):
    steps = []
    for _ in range(n_steps):
        out = net.run(1, state=state)
        steps.append(torch.nonzero(out.spike_count
                                   - state.spike_count).flatten().tolist())
        state = out
    return steps


def test_the_run_records_its_spans_and_counts():
    net, inputs = setup()
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
    assert root.name == 'brainevent_torch.IstdpNet.run'
    assert root.parent_id is None
    assert root.attrs == dict(num=net.num, n_plastic=net.n_plastic,
                              n_steps=60, route='loop', npt=0)
    assert [s.name for s in spans[1:]] == [
        'brainevent_torch.IstdpNet.copies',
        'brainevent_torch.IstdpNet.launch']
    # the counts by hand, from the spikes of the same 60 steps
    steps = _spike_steps(net, state, 60)
    prow = (net.plastic_ptr[1:] - net.plastic_ptr[:-1]).tolist()
    col = torch.bincount(net.targets[:net.n_plastic].long(),
                         minlength=net.n_exc).tolist()
    pre = sum(prow[i - net.n_exc] for ids in steps for i in ids
              if i >= net.n_exc)
    post = sum(col[i] for ids in steps for i in ids if i < net.n_exc)
    assert tracing.drain_counts() == {
        'brainevent_torch.IstdpNet.pre_updates': pre,
        'brainevent_torch.IstdpNet.post_updates': post}
    assert pre > 0 and post > 0
    net.run(5, state=out)
    assert tracing.drain() == [] and tracing.drain_counts() == {}


def test_the_entry_without_a_card_takes_the_twin(monkeypatch):
    """On the CPU ``run`` calls the twin, never a CUDA entry point, and
    keeps no plan; with no device it asks for the card."""
    monkeypatch.setattr(cuda_build, 'function', lambda *a, **k: pytest.fail(
        'a CUDA entry point was called'))
    net, inputs = setup()
    assert net.plan is None
    calls = []
    twin = isn.istdp_sim.twin
    monkeypatch.setattr(isn.istdp_sim, 'twin', lambda *a, **k: (
        calls.append(a[12]), twin(*a, **k)))
    before = isn.istdp_sim.launches
    net.run(12, state=program_state(inputs['states'][0]))
    assert calls == [12] and isn.istdp_sim.launches == before
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(bt.CUDANotInstalledError):
        bt.IstdpNet(scale=SMALL)


# -- the kernel's interface, without a card ---------------------------------------

def test_the_ctypes_struct_is_the_c_struct():
    text = (ROOT / 'brainevent_torch' / 'csrc' / 'stdp_sim.cu').read_text()
    body = text[text.index('struct IstdpParams {'):]
    body = body[:body.index('};')]
    names = re.findall(r'^\s+\w+ (\w+);', body, re.M)
    assert names == [name for name, _ in isn.IstdpSimParams._fields_]
    assert ctypes.sizeof(isn.IstdpSimParams) == 4 * (14 + 8 + 1)


def _plan(net, blocks=1):
    split = isn.istdp_split(net.targets, net.plastic_ptr, net.n_exc, net.num,
                            blocks)
    return isn.istdp_plan(net.targets, net.plastic_ptr, net.n_exc, net.num,
                          split)


def test_the_wrapper_passes_what_the_c_entry_point_takes(monkeypatch):
    """The C entry point gets the arguments it declares, the columns and
    the split plan after the rows and the grid's blocks after the
    params."""
    text = (ROOT / 'brainevent_torch' / 'csrc' / 'stdp_sim.cu').read_text()
    seen = {}

    def function(name, argtypes, restype=ctypes.c_int):
        sig = text[text.index(f' {name}(') + len(name) + 2:]
        assert sig[:sig.index(')')].count(',') + 1 == len(argtypes), name

        def fn(*cargs):
            assert len(cargs) == len(argtypes), name
            seen[name] = cargs
            if name == 'istdp_sim_max_blocks':
                cargs[-1]._obj.value = 1000
            return 0
        return fn
    monkeypatch.setattr(cuda_build, 'function', function)
    monkeypatch.setattr(isn, 'cuda_stream', lambda device: None)
    isn._max_blocks.cache_clear()
    try:
        net, inputs = setup()
        s = program_state(inputs['states'][0])
        out = [getattr(s, k).clone() for k in isn.STATE_FIELDS]
        assert isn.istdp_sim_grid(net.num, CPU) == 4
        before = isn.istdp_sim.launches
        plan = _plan(net, 4)
        isn._istdp_sim_cuda(isn.istdp_sim, *out, net.targets,
                            net.plastic_ptr, net.static_ptr, 10,
                            net.step_params(0), scratch=plan,
                            counters=torch.zeros(isn.ISTDP_COUNTS,
                                                 dtype=torch.int64))
        assert isn.istdp_sim.launches == before + 1
    finally:
        isn._max_blocks.cache_clear()
    assert {k: len(v) for k, v in seen.items()} == {
        'istdp_sim_max_blocks': 2, 'istdp_sim_launch': 25}
    sig = text[text.index('BE_EXPORT int istdp_sim_launch('):]
    names = re.findall(r'(\w+)[,)]', sig[:sig.index('{')])
    cargs = seen['istdp_sim_launch']
    assert len(names) == len(cargs)
    for name, x in (('split', plan.split), ('col_ptr', plan.col_ptr),
                    ('col_pos', plan.col_pos), ('col_src', plan.col_src),
                    ('lists', plan.lists), ('fired', plan.fired),
                    ('targets', net.targets), ('apre', out[7]),
                    ('apost', out[8])):
        assert cargs[names.index(name)] == x.data_ptr(), name
    assert cargs[names.index('blocks')] == 4
    assert cargs[names.index('n_steps')] == 10


BAD_SCRATCH = {
    'lists of one parity': lambda net, plan: plan._replace(
        lists=plan.lists[:1]),
    'two counters': lambda net, plan: plan._replace(counts=plan.counts[:2]),
    'flags of the I neurons too': lambda net, plan: plan._replace(
        fired=torch.zeros(net.num, dtype=torch.uint8)),
    'columns of another length': lambda net, plan: plan._replace(
        col_pos=plan.col_pos[1:]),
    'a split plan for another grid': lambda net, plan: _plan(net, 2),
}


@pytest.mark.parametrize('case', [*BAD_SCRATCH, 'counters of two',
                                  'a ring of one channel'])
def test_the_wrapper_refuses_scratch_that_does_not_fit(monkeypatch, case):
    monkeypatch.setattr(cuda_build, 'function', lambda *a, **k: pytest.fail(
        'the kernel was called'))
    monkeypatch.setattr(isn, 'istdp_sim_grid', lambda num, device: 1)
    net, inputs = setup()
    s = program_state(inputs['states'][0])
    out = [getattr(s, k).clone() for k in isn.STATE_FIELDS]
    plan = _plan(net)
    counters = torch.zeros(isn.ISTDP_COUNTS, dtype=torch.int64)
    if case in BAD_SCRATCH:
        plan = BAD_SCRATCH[case](net, plan)
    elif case == 'counters of two':
        counters = counters[:2]
    else:
        out[4] = out[4][:, :1].contiguous()
    with pytest.raises(ValueError, match='do not match'):
        isn._istdp_sim_cuda(isn.istdp_sim, *out, net.targets,
                            net.plastic_ptr, net.static_ptr, 16,
                            net.step_params(0), scratch=plan,
                            counters=counters)


def test_the_grid_takes_two_neurons_a_thread_before_it_refuses(monkeypatch):
    """At the cell's scale, 200,000 neurons: 396 co-resident blocks (three
    an SM of an H100) hold them at two a thread; 390 do not."""
    monkeypatch.setattr(isn, '_max_blocks', lambda device_index: 1000)
    assert isn.istdp_sim_grid(200_000, CPU) == 782
    monkeypatch.setattr(isn, '_max_blocks', lambda device_index: 396)
    assert isn.istdp_sim_grid(200_000, CPU) == 396
    assert 396 * 256 * 2 >= 200_000 > 390 * 256 * 2
    monkeypatch.setattr(isn, '_max_blocks', lambda device_index: 390)
    with pytest.raises(ValueError, match='200000 neurons need more than'):
        isn.istdp_sim_grid(200_000, CPU)


def test_the_istdp_instance_replaces_no_tpu_kernel():
    assert core.REGISTRY['istdp_sim'].replaces is None
    assert core.REGISTRY['istdp_sim'].twin is isn.istdp_loop
    assert core.REGISTRY['istdp_sim'].source.endswith('csrc/stdp_sim.cu')


# -- K24's iSTDP instance on a card ------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the CUDA kernels have no CPU form')
    return torch.device('cuda')


def twin_run(net, state, n_steps, counters=None):
    """The twin over the net's arrays, on their device."""
    out = [getattr(state, k).clone() for k in isn.STATE_FIELDS]
    isn.istdp_loop(*out, net.targets, net.plastic_ptr, net.static_ptr,
                   n_steps, net.step_params(state.step), counters=counters)
    return out


def traced_run(net, state, n_steps):
    """``run`` with tracing on: the state, its root span and the counts."""
    tracing.drain()
    tracing.drain_counts()
    tracing.enable()
    try:
        out = net.run(n_steps, state=state)
        root = tracing.drain()[0]
    finally:
        tracing.disable()
    return out, root, tracing.drain_counts()


def check_counts(counts, counters):
    """The instance's counters against the twin's, and each phase of the
    clocked launches a positive time."""
    pre, post, *rest = counters.tolist()
    assert rest == [0] * len(rest) and pre > 0 and post > 0
    prefix = 'brainevent_torch.IstdpNet.phase_'
    phases = {k: counts.pop(k) for k in list(counts) if k.startswith(prefix)}
    assert set(phases) == {prefix + 'warp_steps'} | {
        f'{prefix}ns.{name}' for name in isn.PHASES}
    assert all(v > 0 for v in phases.values()), phases
    assert counts == {'brainevent_torch.IstdpNet.pre_updates': pre,
                      'brainevent_torch.IstdpNet.post_updates': post}


@pytest.mark.cuda
@pytest.mark.parametrize('scale', [1.0, 20.0], ids=['1', '20'])
def test_istdp_instance_is_the_twin_bit_for_bit(cuda_device, scale):
    """``run`` from a drawn state over 2,000 steps is one launch of K24's
    iSTDP instance and no other kernel, bit for bit the twin (every state
    array) and a second launch from the same state; its counters are the
    twin's."""
    net, inputs = setup(scale, cuda_device)
    state = program_state(inputs['states'][0])
    core.reset_launch_counts()
    got, root, counts = traced_run(net, state, 2000)
    torch.cuda.synchronize()
    launches = core.launch_counts()
    assert launches['istdp_sim'] == 1 and sum(launches.values()) == 1, (
        launches)
    assert root.attrs['route'] == 'sim'
    assert root.attrs['npt'] == (2 if scale == 20.0 else 1)
    again = net.run(2000, state=state)
    counters = torch.zeros(isn.ISTDP_COUNTS, dtype=torch.int64,
                           device=cuda_device)
    want = twin_run(net, state, 2000, counters)
    for k, x in zip(isn.STATE_FIELDS, want):
        assert torch.equal(getattr(got, k), x), k
        assert torch.equal(getattr(again, k), x), k
    assert int((got.spike_count - state.spike_count).sum()) > 10 * net.num
    check_counts(counts, counters)


@pytest.mark.cuda
@pytest.mark.parametrize('scale', [1.0, 20.0], ids=['1', '20'])
@pytest.mark.parametrize('n_steps', [1, 17, 1000])
def test_istdp_instance_chains_and_leaves_its_state(cuda_device, scale,
                                                    n_steps):
    """Launches of 1, 17 and 1,000 steps chained into one run of 2,000, bit
    for bit the twin's, and the state given unchanged."""
    net, inputs = setup(scale, cuda_device)
    state = program_state(inputs['states'][1])
    before = {k: getattr(state, k).clone() for k in isn.STATE_FIELDS}
    part = state
    for size in (n_steps, 2000 - n_steps):
        part = net.run(size, state=part)
    want = twin_run(net, state, 2000)
    for k, x in zip(isn.STATE_FIELDS, want):
        assert torch.equal(getattr(part, k), x), k
        assert torch.equal(getattr(state, k), before[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize('scale', [1.0, 20.0], ids=['1', '20'])
def test_istdp_clocked_instance_is_the_plain_one_and_tiles_its_time(
        cuda_device, scale):
    """With tracing on, ``run`` takes the clocked instance on the same
    grid: bit for bit the plain instance's state over 1,000 steps, and its
    warps' phases a step (update, scatter, walk, post, barrier) within 3%
    of the instance's device time a step in the profiler's trace."""
    from _torch_card import check_phases, clocked_run
    net, inputs = setup(scale, cuda_device)
    state = program_state(inputs['states'][1])
    plain = net.run(1000, state=state)
    got, counts, seconds = clocked_run(lambda: net.run(1000, state=state),
                                       cuda_device, 'istdp_sim_kernel')
    for k in isn.STATE_FIELDS:
        assert torch.equal(getattr(got, k), getattr(plain, k)), k
    warps = isn.istdp_sim_grid(net.num, cuda_device) * isn.HPC_BLOCK // 32
    check_phases(counts, 'IstdpNet', isn.PHASES, warps * 1000, seconds,
                 1000)


@pytest.mark.cuda
def test_istdp_instance_takes_two_neurons_a_thread(cuda_device, monkeypatch):
    """A grid of fewer blocks than one neuron a thread needs at scale 1
    (the co-resident limit patched lower, the net built for it): bit for
    bit the twin over 1,000 steps, and the twin's counts."""
    net0, inputs = setup(1.0, cuda_device)
    blocks = -(-net0.num // (2 * isn.HPC_BLOCK)) + 1
    monkeypatch.setattr(isn, '_max_blocks', lambda device_index: blocks)
    net = bt.IstdpNet(scale=1.0, device=cuda_device, **inputs['program'])
    assert net.plan.split.shape == (net.num - net.n_exc, blocks + 1)
    state = program_state(inputs['states'][0])
    got, root, counts = traced_run(net, state, 1000)
    assert root.attrs['npt'] == 2
    counters = torch.zeros(isn.ISTDP_COUNTS, dtype=torch.int64,
                           device=cuda_device)
    want = twin_run(net, state, 1000, counters)
    for k, x in zip(isn.STATE_FIELDS, want):
        assert torch.equal(getattr(got, k), x), k
    check_counts(counts, counters)
    with pytest.raises(ValueError, match=f'grid of {blocks} blocks'):
        isn._istdp_sim_cuda(isn.istdp_sim, *twin_run(net, state, 0),
                            net.targets, net.plastic_ptr, net.static_ptr, 5,
                            net.step_params(0), scratch=net0.plan)


@pytest.mark.cuda
def test_istdp_instance_splits_a_trial_longer_than_a_launch(cuda_device,
                                                            monkeypatch):
    """A net whose launches hold 96 steps makes 300 in four launches at
    the cell's scale, bit for bit the twin's one run."""
    _, inputs = setup(20.0, cuda_device)
    monkeypatch.setattr(isn, 'LAUNCH_STEPS', 96)
    net = bt.IstdpNet(scale=20.0, device=cuda_device, **inputs['program'])
    state = program_state(inputs['states'][0])
    core.reset_launch_counts()
    got = net.run(300, state=state)
    torch.cuda.synchronize()
    assert core.launch_counts()['istdp_sim'] == 4
    for k, x in zip(isn.STATE_FIELDS, twin_run(net, state, 300)):
        assert torch.equal(getattr(got, k), x), k
