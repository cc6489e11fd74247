# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""Brette et al. 2007's Hodgkin-Huxley network (COBAHH, ``HHNet``): its
constants, its rates at exprel's zeros, its arming rule and K21's HH twin
(``hh_loop``) against the benchmark's plain reference
(``benchmark_torch/reference/coba_hh.py``), bit for bit, on the CPU; and
K21's HH instance against the twin on a card.

This file imports no JAX. The card tests (marker ``cuda``) skip without a
CUDA device; on a card run them with::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_coba_hh.py
"""

import ctypes
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import brainevent_torch as bt
from brainevent_torch.models import hh_net as hn
from brainevent_torch.ops import core, cuda_build, tracing
from benchmark_torch.reference import coba_ei as ref_ei
from benchmark_torch.reference import coba_hh as ref

from _torch_one_thread import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
CFG = json.loads((ROOT / 'benchmark_torch' / 'configs'
                  / 'coba_hh.json').read_text())
CPU = torch.device('cpu')
SEED = 2 ** 31 + 12345
PARAMS = bt.HHParams()
HEADER = (ROOT / 'brainevent_torch' / 'csrc' / 'hh_neuron.cuh').read_text()
SIM = (ROOT / 'brainevent_torch' / 'csrc' / 'einet_sim.cu').read_text()
_CACHE = {}


def setup(scale, device=CPU, seed=SEED):
    """The reference's inputs at *scale* (two initial states) and the
    program's network over the same table."""
    key = (scale, str(device), seed)
    if key not in _CACHE:
        inputs = ref.make_inputs(CFG, dict(scale=scale, initial_states=2),
                                 seed, device)
        net = bt.HHNet(scale=scale, device=device, **inputs['program'])
        _CACHE[key] = net, inputs
    return _CACHE[key]


def program_state(fields: dict) -> bt.HHNetState:
    return bt.HHNetState(**{k: fields[k] for k in bt.HHNetState._fields})


def mismatches(got: bt.HHNetState, want: dict) -> dict:
    return ref.compare(CFG, {}, got._asdict(), want)


ZERO = {f'{k}_mismatch': 0 for k in ref.FIELDS}


# -- the constants ------------------------------------------------------------------

def test_the_published_parameters_are_the_defaults_and_the_config():
    for part in ('network', 'neuron', 'initial_state'):
        for key, value in CFG[part].items():
            assert getattr(PARAMS, key) == value, key
    assert [[CFG['gates'][r][k] for k in 'cos'] for r in ref.RATES] == [
        list(x) for x in PARAMS.rates]
    assert tuple(CFG['gates'][r]['form'] for r in ref.RATES) == hn.FORMS
    assert ref.RATES == hn.RATES and ref.FORMS == hn.FORMS
    # Brian's COBAHH.py: an area of 20,000 um^2 at 1 uF/cm^2, 5e-5 S/cm^2,
    # 100 and 30 mS/cm^2
    cm2 = PARAMS.area * 1e-8
    assert PARAMS.c_m == pytest.approx(1e-6 * cm2 * 1e12)
    assert PARAMS.g_l == pytest.approx(5e-5 * cm2 * 1e9)
    assert PARAMS.g_na == pytest.approx(100e-3 * cm2 * 1e9)
    assert PARAMS.g_kd == pytest.approx(30e-3 * cm2 * 1e9)
    net = bt.HHNet(scale=100.0, device=CPU,
                   conn_all=torch.zeros(400_000, 1, dtype=torch.int32))
    assert (net.num, net.n_exc) == (400_000, 320_000)


def test_the_step_params_are_the_references():
    p, want = bt.HHNet(scale=0.05, device=CPU).step_params(), ref.params(CFG)
    for name in ('v_t', 'g_l', 'gl_el', 'e_e', 'e_i', 'e_na', 'e_k', 'g_na',
                 'g_k', 'neg_dt', 'neg_dt_c', 'decay_e', 'decay_i', 'w_e',
                 'w_i', 'v_spike'):
        assert getattr(p, name) == getattr(want, name), name
    for k, field in enumerate(('rate_c', 'rate_o', 'rate_s')):
        assert list(getattr(p, field)) == [r[k] for r in want.rates]
    assert p.num == 200


def test_the_reference_draws_coba_eis_table():
    traffic = dict(scale=0.25, initial_states=2)
    hh = ref.make_inputs(CFG, traffic, SEED, CPU)
    ei_cfg = json.loads((ROOT / 'benchmark_torch' / 'configs'
                         / 'coba_ei.json').read_text())
    ei = ref_ei.make_inputs(ei_cfg, traffic, SEED, CPU)
    assert torch.equal(hh['conn'], ei['conn'])
    assert (hh['num'], hh['n_exc']) == (ei['num'], ei['n_exc'])


def test_init_state_is_the_published_draw():
    """``init_state`` draws as the reference's states do, from the same
    generator: v, g_e and g_i from three normal rows, a few g_i
    negative, the gates 0, all armed."""
    net = bt.HHNet(scale=1.0, device=CPU)
    got = net.init_state(torch.Generator().manual_seed(5))
    want = ref.initial_states(CFG, net.num, 1, torch.Generator().manual_seed(
        5), CPU)[0]
    assert mismatches(got, want) == ZERO
    assert 0 < int((got.g_i < 0).sum()) < net.num // 10
    assert bool(got.armed.all()) and float(got.m.abs().max()) == 0.0


# -- the twin against the reference ---------------------------------------------

def _reference_run(inputs, state, n_steps):
    return ref.simulate(CFG, {}, inputs, state, n_steps)


@pytest.mark.parametrize('seed', [SEED, 3, 2 ** 40 + 7])
def test_the_twin_is_the_reference_bit_for_bit(seed):
    """Brette's 4,000 neurons over 2,000 steps (200 ms) from two drawn
    states of a seed: every state array bit for bit, and the network
    fires."""
    net, inputs = setup(1.0, seed=seed)
    for fields in inputs['states']:
        state = program_state(fields)
        got = net.run(2000, state=state)
        assert mismatches(got, _reference_run(inputs, fields, 2000)) == ZERO
        assert int(got.spike_count.sum()) > net.num


def test_the_twin_is_the_reference_at_a_tenth_of_the_size():
    net, inputs = setup(0.1)
    fields = inputs['states'][1]
    got = net.run(2000, state=program_state(fields))
    assert mismatches(got, _reference_run(inputs, fields, 2000)) == ZERO
    assert int(got.spike_count.sum()) > 0


@pytest.mark.parametrize('first', [1, 17, 150])
def test_chained_runs_are_one_run(first):
    net, inputs = setup(0.25)
    state = program_state(inputs['states'][0])
    before = [x.clone() for x in state]
    whole = net.run(300, state=state)
    part = net.run(300 - first, state=net.run(first, state=state))
    for k in bt.HHNetState._fields:
        assert torch.equal(getattr(part, k), getattr(whole, k)), k
    for x, y in zip(state, before):
        assert torch.equal(x, y)


# v such that d = v - V_T puts a rate's exprel argument at 0 exactly
ZEROS = {'alpha_m': 13.0, 'beta_m': 40.0, 'alpha_n': 15.0}


@pytest.mark.parametrize('rate', sorted(ZEROS))
def test_the_rates_at_exprels_zero_are_the_references(rate):
    """At ``v = V_T + o`` a rate's exprel argument is exactly 0: the twin
    takes exprel(0) = 1, as the reference does, so the rate is ``c``; one
    step from there is the reference's, beside voltages an ulp either
    side."""
    k = ref.RATES.index(rate)
    p = bt.HHNet(scale=0.05, device=CPU).step_params()
    v0 = np.float32(PARAMS.v_t + ZEROS[rate])
    v = torch.tensor([np.nextafter(v0, np.float32(-np.inf)), v0,
                      np.nextafter(v0, np.float32(np.inf))])
    got = hn.hh_rates(v, p)
    want = ref.rates(v, ref._Consts(ref.params(CFG), torch.float32, CPU))
    for x, y in zip(got, want):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))
    assert float(got[k][1]) == np.float32(PARAMS.rates[k][0])
    p_ref = ref.params(CFG)
    _, o, s = p_ref.rates[k]
    a = (o - (v - p_ref.v_t)) * s
    assert a[1] == 0
    # one step of 200 neurons at these voltages
    net, inputs = setup(0.05)
    fields = dict(inputs['states'][0])
    fields['v'] = v.repeat(67)[:net.num].clone()
    out = net.run(1, state=program_state(fields))
    assert mismatches(out, _reference_run(inputs, fields, 1)) == ZERO


def test_a_neuron_held_above_threshold_spikes_once_until_it_falls():
    """Three unconnected neurons: 0 and 1 held near 0 mV by a vast g_e
    (1 armed, 2 not), 2 at rest. Held, 0 spikes once and 1 never; at
    -70 mV for a step both arm, and held again both spike once more. The
    reference counts the same."""
    net = bt.HHNet(scale=0.001, device=CPU,
                   conn_all=torch.zeros(3, 0, dtype=torch.int32))
    assert net.num == 3
    zeros = torch.zeros(3)
    state = bt.HHNetState(
        v=torch.tensor([-10.0, -10.0, -70.0]), m=zeros, h=zeros, n=zeros,
        g_e=torch.tensor([1e7, 1e7, 0.0]), g_i=zeros,
        armed=torch.tensor([True, False, True]),
        spike_count=torch.zeros(3, dtype=torch.int32))
    inputs = dict(conn=net.conn_all, n_exc=net.n_exc, num=3)
    held = net.run(120, state=state)
    assert held.spike_count.tolist() == [1, 0, 0]
    assert held.armed.tolist() == [False, False, True]
    assert bool((held.v[:2] > -20).all())
    assert mismatches(held, _reference_run(inputs, state._asdict(),
                                           120)) == ZERO
    fallen = net.run(1, state=held._replace(
        v=torch.tensor([-70.0, -70.0, -70.0]), g_e=zeros))
    assert fallen.armed.tolist() == [True, True, True]
    assert fallen.spike_count.tolist() == [1, 0, 0]
    again = net.run(50, state=fallen._replace(
        v=torch.tensor([-10.0, -10.0, -70.0]),
        g_e=torch.tensor([1e7, 1e7, 0.0])))
    assert again.spike_count.tolist() == [2, 1, 0]


# -- the entry ----------------------------------------------------------------------

def test_the_run_records_its_spans_and_counter():
    net, inputs = setup(0.05)
    state = program_state(inputs['states'][0])
    tracing.drain()
    tracing.drain_counts()
    tracing.enable()
    try:
        out = net.run(30, state=state)
    finally:
        tracing.disable()
    spans = tracing.drain()
    root = spans[0]
    assert root.name == 'brainevent_torch.HHNet.run'
    assert root.parent_id is None
    assert root.attrs == dict(num=net.num, n_steps=30, route='loop', npt=0)
    assert [s.name for s in spans[1:]] == ['brainevent_torch.HHNet.copies',
                                           'brainevent_torch.HHNet.launch']
    assert tracing.drain_counts() == {
        'brainevent_torch.HHNet.neuron_updates': 30 * net.num}
    net.run(5, state=out)
    assert tracing.drain() == [] and tracing.drain_counts() == {}


def test_the_entry_without_a_card_takes_the_twin(monkeypatch):
    """On CPU tensors ``run`` calls ``hh_loop`` once, whatever the steps,
    and builds no kernel; with no ``device`` it asks for the card."""
    calls = []
    twin = hn.einet_sim_hh.twin
    monkeypatch.setattr(hn.einet_sim_hh, 'twin',
                        lambda *a, **k: calls.append(a[9]) or twin(*a, **k))
    monkeypatch.setattr(cuda_build, 'function', lambda *a, **k: pytest.fail(
        'a kernel was asked for'))
    net, inputs = setup(0.05)
    launches = hn.einet_sim_hh.launches
    net.run(40, state=program_state(inputs['states'][0]))
    assert calls == [40] and hn.einet_sim_hh.launches == launches
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(bt.CUDANotInstalledError):
        bt.HHNet(scale=0.05)


def test_k21_hh_replaces_no_tpu_kernel():
    op = core.REGISTRY['einet_sim_hh']
    assert op.replaces is None and op.twin is hn.hh_loop
    assert op.source == 'brainevent_torch/csrc/einet_sim.cu'


# -- the kernel's interface, without a card ---------------------------------------

def test_the_ctypes_struct_is_the_c_struct():
    body = HEADER[HEADER.index('struct HHParams {'):]
    body = body[:body.index('};')]
    names = re.findall(r'^\s+\w+ (\w+)(?:\[[^\]]+\])?;', body, re.M)
    assert names == [name for name, _ in hn.HHSimParams._fields_]
    assert re.search(r'constexpr int HH_RATES = (\d+);', HEADER).group(
        1) == str(len(hn.RATES))
    assert ctypes.sizeof(hn.HHSimParams) == 4 * (16 + 3 * 6 + 1)


def test_the_wrappers_pass_what_the_c_entry_points_take(monkeypatch):
    seen = {}

    def function(name, argtypes, restype=ctypes.c_int):
        sig = SIM[SIM.index(f' {name}(') + len(name) + 2:]
        assert sig[:sig.index(')')].count(',') + 1 == len(argtypes), name

        def fn(*cargs):
            assert len(cargs) == len(argtypes), name
            seen[name] = len(cargs)
            if name == 'einet_sim_hh_max_blocks':
                cargs[-1]._obj.value = 1000
            return 0
        return fn
    monkeypatch.setattr(cuda_build, 'function', function)
    monkeypatch.setattr(hn, 'cuda_stream', lambda device: None)
    hn._max_blocks.cache_clear()
    try:
        net, inputs = setup(0.05)
        out = [x.clone() for x in program_state(inputs['states'][0])]
        assert hn.hh_sim_grid(net.num, CPU) == (1, 1)
        before = hn.einet_sim_hh.launches
        hn._einet_sim_hh_cuda(hn.einet_sim_hh, *out, net.conn_all, 10,
                              net.step_params(), net.n_exc)
        assert hn.einet_sim_hh.launches == before + 1
        assert hn.hh_math_cuda(torch.ones(5), 'expm1').shape == (5,)
    finally:
        hn._max_blocks.cache_clear()
    assert seen == {'einet_sim_hh_max_blocks': 3, 'einet_sim_hh_launch': 19,
                    'einet_sim_hh_math_launch': 6}


@pytest.mark.parametrize('phases', [None, 3, 2])
def test_the_wrapper_takes_the_clocked_instance_with_phases(monkeypatch,
                                                            phases):
    """Given a buffer of the three phases, the wrapper passes it as the C
    entry's ``phases`` (the clocked instance); without, null (the plain
    one); a buffer of another size is refused before K21 is called."""
    sig = SIM[SIM.index('BE_EXPORT int einet_sim_hh_launch('):]
    names = re.findall(r'(\w+)[,)]', sig[:sig.index('{')])
    seen = []

    def function(name, argtypes, restype=ctypes.c_int):
        def fn(*cargs):
            seen.append(cargs)
            return 0
        return fn
    monkeypatch.setattr(cuda_build, 'function', function)
    monkeypatch.setattr(hn, 'cuda_stream', lambda device: None)
    net, inputs = setup(0.05)
    out = [x.clone() for x in program_state(inputs['states'][0])]
    buf = (None if phases is None
           else torch.zeros(phases, dtype=torch.int64))
    call = lambda: hn._einet_sim_hh_cuda(  # noqa: E731
        hn.einet_sim_hh, *out, net.conn_all, 10, net.step_params(),
        net.n_exc, npt=1, blocks=1, phases=buf)
    if phases == 2:
        with pytest.raises(ValueError, match='do not match'):
            call()
        assert seen == []
        return
    call()
    assert len(hn.PHASES) == 3
    assert seen[0][names.index('phases')] == (
        None if buf is None else buf.data_ptr())


@pytest.mark.parametrize('case', ['npt', 'blocks', 'conn', 'armed'])
def test_the_wrapper_refuses_what_does_not_fit(monkeypatch, case):
    """An instance not built, a grid that does not cover the net, a table
    of another size and flags of another dtype are refused before K21 is
    called."""
    monkeypatch.setattr(cuda_build, 'function', lambda *a, **k: pytest.fail(
        'K21 was called'))
    net, inputs = setup(0.25)
    out = [x.clone() for x in program_state(inputs['states'][0])]
    conn, kw = net.conn_all, {}
    if case == 'npt':
        kw = dict(npt=3)
    elif case == 'blocks':
        kw = dict(npt=1, blocks=-(-net.num // 256) - 1)
    elif case == 'conn':
        conn = conn[1:].contiguous()
    else:
        out[6] = out[6].to(torch.uint8)
    with pytest.raises((ValueError, TypeError)):
        hn._einet_sim_hh_cuda(hn.einet_sim_hh, *out, conn, 10,
                              net.step_params(), net.n_exc, **kw)


def test_the_grid_takes_the_fewest_neurons_a_thread_then_refuses(
        monkeypatch):
    """400k neurons: 1,563 blocks at one a thread, 782 at two, 391 at
    four, 196 at eight; the first that the co-resident grid holds, else
    ``ValueError``, as ``run`` raises on a card."""
    most = {1: 1056, 2: 792, 4: 396, 8: 264}
    monkeypatch.setattr(hn, '_max_blocks', lambda index, npt: most[npt])
    assert hn.hh_sim_grid(400_000, CPU) == (2, 782)
    most[2] = 528
    assert hn.hh_sim_grid(400_000, CPU) == (4, 391)
    most[4] = 390
    assert hn.hh_sim_grid(400_000, CPU) == (8, 196)
    assert hn.hh_sim_capacity(CPU) == 264 * 256 * 8
    with pytest.raises(ValueError, match='540673 neurons exceed'):
        hn.hh_sim_grid(540_673, CPU)


def test_the_header_states_the_arithmetic_once_a_rounding():
    """No FMA and no fast-math function in the HH neuron: the sums,
    products and quotients are the round-to-nearest intrinsics, and the
    library is built without contraction."""
    code = re.sub(r'//[^\n]*', '', HEADER)
    assert '__fmaf' not in code and '__expf' not in code
    assert 'expm1f(' in code and 'expf(' in code
    assert '-fmad=false' in cuda_build.NVCC_FLAGS
    body = code[code.index('bool update('):]
    # no bare float operator left in the update
    assert not re.search(r'[\w)\]] [*/+-] [\w(]', body), body


# -- K21's HH instance on a card ------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the CUDA kernels have no CPU form')
    return torch.device('cuda')


def twin_run(net, state, n_steps):
    out = [x.clone() for x in state]
    hn.hh_loop(*out, net.conn_all, n_steps, net.step_params(), net.n_exc)
    return bt.HHNetState(*out)


def assert_same(got, want):
    for k in bt.HHNetState._fields:
        assert torch.equal(getattr(got, k), getattr(want, k)), k


@pytest.mark.cuda
@pytest.mark.parametrize('scale', [1.0, 100.0], ids=['4k', '400k'])
def test_k21_hh_clocked_instance_is_the_plain_one_and_tiles_its_time(
        cuda_device, scale):
    """With tracing on, ``run`` takes K21's clocked HH instance on the same
    grid: bit for bit the plain instance's state from the same state over
    2,000 steps, and its warps' phases a step (update, scatter, barrier)
    within 3% of the kernel's device time a step in the profiler's trace
    of the same launch."""
    from _torch_card import check_phases, clocked_run
    net, inputs = setup(scale, cuda_device)
    state = program_state(inputs['states'][1])
    plain = net.run(2000, state=state)
    got, counts, seconds = clocked_run(lambda: net.run(2000, state=state),
                                       cuda_device, 'einet_sim_hh_kernel')
    assert_same(got, plain)
    npt, blocks = hn.hh_sim_grid(net.num, cuda_device)
    check_phases(counts, 'HHNet', hn.PHASES, blocks * hn.SIM_BLOCK // 32
                 * 2000, seconds, 2000)


@pytest.mark.cuda
@pytest.mark.parametrize('scale', [1.0, 100.0], ids=['4k', '400k'])
def test_k21_hh_is_the_twin_bit_for_bit(cuda_device, scale):
    """From a drawn state, 2,000 steps in one K21 launch (and no other
    kernel of the port), and in chained launches of 1, 17, 1,000 and 982
    steps: every state array bit for bit the twin's on the card."""
    net, inputs = setup(scale, cuda_device)
    state = program_state(inputs['states'][0])
    core.reset_launch_counts()
    got = net.run(2000, state=state)
    torch.cuda.synchronize()
    launches = core.launch_counts()
    assert launches['einet_sim_hh'] == 1 and sum(launches.values()) == 1
    want = twin_run(net, state, 2000)
    assert_same(got, want)
    chained = state
    for n_steps in (1, 17, 1000, 982):
        chained = net.run(n_steps, state=chained)
    assert_same(chained, want)
    assert int(got.spike_count.sum()) > net.num


@pytest.mark.cuda
@pytest.mark.parametrize('npt', hn.HH_NPT)
def test_k21_hh_each_instance_is_the_twin(cuda_device, npt):
    """Every NPT instance, forced on the fewest blocks that cover 40k
    neurons, over 500 steps: the twin's bits."""
    net, inputs = setup(10.0, cuda_device)
    state = program_state(inputs['states'][1])
    out = [x.clone() for x in state]
    hn.einet_sim_hh(*out, net.conn_all, 500, net.step_params(), net.n_exc,
                    npt=npt)
    assert_same(bt.HHNetState(*out), twin_run(net, state, 500))


@pytest.mark.cuda
def test_k21_hh_runs_its_grid_and_refuses_above_it(cuda_device):
    """The cell's 400k neurons take NPT 4 on 391 co-resident blocks; a net
    above the capacity is refused before a launch."""
    assert hn.hh_sim_grid(400_000, cuda_device) == (4, 391)
    cap = hn.hh_sim_capacity(cuda_device)
    assert cap >= 400_000
    with pytest.raises(ValueError, match='exceed'):
        hn.hh_sim_grid(cap + 1, cuda_device)
    net, inputs = setup(1.0, cuda_device)
    tracing.drain()
    tracing.enable()
    try:
        net.run(3, state=program_state(inputs['states'][0]))
    finally:
        tracing.disable()
    root = tracing.drain()[0]
    assert root.attrs['route'] == 'sim' and root.attrs['npt'] == 1
    tracing.drain_counts()


@pytest.mark.cuda
@pytest.mark.parametrize('fn', ['exp', 'expm1'])
def test_k21_hh_exp_is_torchs_on_every_float(cuda_device, fn):
    """The kernel's ``expf`` and ``expm1f`` (built with the library's
    flags) and ``torch.exp`` and ``torch.expm1`` on the card agree bit for
    bit on every float32 in [-104, 89], past where each is 0, -1 or
    infinite."""
    torch_fn = getattr(torch, fn)
    top = int(np.float32(89.0).view(np.int32))
    bottom = int(np.float32(-104.0).view(np.int32))
    differ = total = 0
    chunk = 2 ** 27
    for lo, hi in ((0, top + 1), (-2 ** 31, bottom + 1)):
        for a in range(lo, hi, chunk):
            bits = torch.arange(a, min(a + chunk, hi), dtype=torch.int64,
                                device=cuda_device).to(torch.int32)
            x = bits.view(torch.float32)
            total += x.numel()
            differ += int((hn.hh_math_cuda(x, fn).view(torch.int32)
                           != torch_fn(x).view(torch.int32)).sum())
    assert differ == 0 and total > 2 * 10 ** 9
