# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""The Potjans-Diesmann microcircuit (``MicrocircuitNet``): its network,
its constants, its Poisson draw and K23's twin (``mc_loop``) against the
benchmark's plain reference (``benchmark_torch/reference/pd_microcircuit.py``),
bit for bit, on the CPU; and K23 against the twin on a card.

This file imports no JAX. The card tests (marker ``cuda``) skip without a
CUDA device; on a card run them with::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_microcircuit.py
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
from brainevent_torch.models import microcircuit as mc
from brainevent_torch.ops import core, cuda_build, tracing
from benchmark_torch.reference import pd_microcircuit as ref

from _torch_one_thread import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
CFG = json.loads((ROOT / 'benchmark_torch' / 'configs'
                  / 'pd_microcircuit.json').read_text())
CPU = torch.device('cpu')
SEED = 2 ** 31 + 12345
PARAMS = bt.MicrocircuitParams()
_CACHE = {}


def setup(scale, device=CPU):
    """The reference's inputs at *scale* (two initial states) and the
    program's network over the same arrays."""
    key = (scale, str(device))
    if key not in _CACHE:
        inputs = ref.make_inputs(CFG, dict(scale=scale, initial_states=2),
                                 SEED, device)
        net = bt.MicrocircuitNet(scale=scale, device=device,
                                 **inputs['program'])
        _CACHE[key] = net, inputs
    return _CACHE[key]


def program_state(fields: dict) -> bt.MicrocircuitState:
    return bt.MicrocircuitState(**{k: fields[k] for k in (
        'v', 'i_syn', 'ref', 'ring', 'spike_count', 'key', 'step')})


def mismatches(got: bt.MicrocircuitState, want: dict) -> dict:
    return ref.compare(CFG, {}, got._asdict(), want)


ZERO = {f'{k}_mismatch': 0 for k in ref.FIELDS}


# -- the network ------------------------------------------------------------------

def test_the_published_parameters_are_the_defaults_and_the_configs():
    net, neuron = CFG['network'], CFG['neuron']
    for key, value in {**net, **neuron, **CFG['initial_state']}.items():
        if hasattr(PARAMS, key):
            got = getattr(PARAMS, key)
            want = (tuple(tuple(r) if isinstance(r, list) else r
                          for r in value)
                    if isinstance(value, list) else value)
            assert got == want, key
    assert PARAMS.sizes() == tuple(net['full_sizes'])
    assert sum(PARAMS.sizes()) == 77169
    assert PARAMS.sizes(0.02) == (414, 117, 438, 110, 97, 21, 288, 59)


@pytest.mark.parametrize('scale, total', [(1.0, 298_880_968),
                                          (0.05, 747_065),
                                          (0.02, 119_729)])
def test_projection_counts_follow_the_formula(scale, total):
    n = PARAMS.sizes(scale)
    counts = mc.synapse_counts(PARAMS, n)
    for q in range(8):
        for p in range(8):
            c = PARAMS.conn_probs[q][p]
            want = (0 if c == 0 else round(
                math.log(1 - c) / math.log(1 - 1 / (n[q] * n[p]))))
            assert counts[q, p] == want, (q, p)
    assert counts.sum() == total
    assert np.array_equal(counts, ref.synapse_counts(CFG, n))


def _pop(ids: torch.Tensor, starts) -> torch.Tensor:
    return torch.bucketize(ids.long(), torch.tensor(starts[1:]), right=True)


@pytest.mark.parametrize('scale', [0.02, 0.05])
def test_the_network_holds_its_projections(scale):
    net, inputs = setup(scale)
    starts = net.pop_start
    rows = torch.repeat_interleave(
        torch.arange(net.num), (net.row_ptr[1:] - net.row_ptr[:-1]).long())
    src, dst = _pop(rows, starts), _pop(net.targets, starts)
    # each projection's synapses, by the populations of their two ends
    got = torch.zeros(8, 8, dtype=torch.int64)
    got.index_put_((dst, src), torch.ones_like(dst), accumulate=True)
    assert np.array_equal(got.numpy(), mc.synapse_counts(PARAMS, net.sizes))
    assert int(net.row_ptr[0]) == 0
    assert bool((net.row_ptr[1:] >= net.row_ptr[:-1]).all())
    assert 0 <= int(net.targets.min()) and int(net.targets.max()) < net.num
    w = net.weights.long()
    exc = torch.tensor(PARAMS.excitatory)[src]
    assert bool((w[exc] > 0).all()) and bool((w[~exc] < 0).all())
    doubled = (src == 2) & (dst == 0)
    assert abs(float(w[doubled].float().mean()) / 8192 - 1) < 0.01
    assert abs(float(w[exc & ~doubled].float().mean()) / 4096 - 1) < 0.01
    assert abs(float(w[~exc].float().mean()) / -16384 - 1) < 0.01
    d = net.delays.long()
    assert int(d.min()) >= 1 and int(d.max()) < net.depth
    assert net.depth == 1 << int(d.max()).bit_length() == inputs['depth']
    # N(15, 7.5) steps from excitatory sources, N(7.5, 3.75) from
    # inhibitory ones, both drawn again below one step: truncated normals
    for sel, mean in ((exc, 15.0), (~exc, 7.5)):
        sd, a = mean / 2, (1 - mean) / (mean / 2)
        phi = math.exp(-a * a / 2) / math.sqrt(2 * math.pi)
        tail = 0.5 * math.erfc(a / math.sqrt(2))
        want = mean + sd * phi / tail
        assert abs(float(d[sel].float().mean()) - want) < 0.3


def test_the_builder_draws_the_reference_network():
    gen = torch.Generator().manual_seed(CFG['network_seed'])
    got = mc.build_microcircuit(PARAMS, 0.02, gen, CPU)
    want = ref.network(CFG, 0.02, CPU)
    for k, x in got.items():
        assert x.dtype == want[k].dtype and torch.equal(x, want[k]), k


def test_a_default_network_is_drawn_from_its_seed():
    a = bt.MicrocircuitNet(scale=0.02, device='cpu', seed=7)
    b = bt.MicrocircuitNet(scale=0.02, device='cpu', seed=7)
    c = bt.MicrocircuitNet(scale=0.02, device='cpu', seed=8)
    assert torch.equal(a.targets, b.targets)
    assert not torch.equal(a.targets, c.targets)
    with pytest.raises(ValueError, match='all of'):
        bt.MicrocircuitNet(scale=0.02, device='cpu', row_ptr=a.row_ptr)
    with pytest.raises(ValueError, match='at least one step'):
        bt.MicrocircuitNet(scale=0.02, device='cpu', row_ptr=a.row_ptr,
                           targets=a.targets, weights=a.weights,
                           delays=torch.zeros_like(a.delays))


# -- constants and the draw -------------------------------------------------------

def test_weights_are_quantized_to_units_of_q():
    psc = PARAMS.psc_mean()
    assert abs(psc - 87.81) < 0.005
    p = bt.MicrocircuitNet(scale=0.02, device='cpu').step_params(1, 0)
    assert p.q == np.float32(psc / 4096)
    assert p.w_ext == 4096
    assert PARAMS.weight_means()[0, 2] == 8192
    assert set(PARAMS.weight_means()[:, 1]) == {-16384}


def test_the_float32_constants_round_the_float64_ones_once():
    p = bt.MicrocircuitNet(scale=0.02, device='cpu').step_params(1, 0)
    p11 = math.exp(-0.1 / 0.5)
    p22 = math.exp(-0.1 / 10.0)
    p21 = 10.0 * 0.5 / (250.0 * (0.5 - 10.0)) * (p11 - p22)
    for got, want in ((p.p11, p11), (p.p22, p22), (p.p21, p21)):
        assert got == float(np.float32(want))
        assert abs(got - want) <= np.spacing(np.float32(want)) / 2
    assert (p.v_th, p.v_reset, p.ref_steps) == (15.0, 0.0, 20)


def test_poisson_thresholds_are_monotone_and_draw_their_rate():
    net = bt.MicrocircuitNet(scale=0.02, device='cpu')
    u = mc.light_rng_mix32(12345 ^ mc._mul32(torch.arange(10 ** 6),
                                             mc.I_MUL))
    for k_ext, thr in zip(PARAMS.k_ext, net.thresholds):
        lam = k_ext * 8.0 * 1e-4
        assert thr == sorted(thr) and len(thr) == 16
        assert thr[-1] < 2 ** 32
        k = (u[:, None] >= torch.tensor(thr)).sum(1).double()
        assert abs(float(k.mean()) / lam - 1) < 0.005, k_ext
    assert min(min(t) for t in net.thresholds) > 0


# -- the run ------------------------------------------------------------------------

@pytest.mark.parametrize('scale', [0.02, 0.05])
def test_the_twin_is_the_reference_bit_for_bit(scale):
    net, inputs = setup(scale)
    n_steps = 300
    # 300 steps wrap the ring of 64 slots more than twice
    assert n_steps >= 2 * net.depth
    state = inputs['states'][0]
    got = net.run(n_steps, state=program_state(state))
    want = ref.simulate(CFG, {}, inputs, state, n_steps)
    assert mismatches(got, want) == ZERO
    assert got.step == n_steps and got.key == state['key']
    assert int(got.spike_count.sum()) > net.num // 4
    assert bool(got.ring.any())
    other = ref.simulate(CFG, {}, inputs, inputs['states'][1], n_steps)
    assert mismatches(got, other) != ZERO


def test_chained_runs_continue_the_step_and_the_stream():
    net, inputs = setup(0.02)
    state = program_state(inputs['states'][1])
    whole = net.run(130, state=state)
    half = net.run(70, state=net.run(60, state=state))
    assert half.step == whole.step == 130
    for k in ref.FIELDS:
        assert torch.equal(getattr(half, k), getattr(whole, k)), k


def test_run_leaves_its_state_untouched():
    net, inputs = setup(0.02)
    state = program_state(inputs['states'][0])
    before = {k: getattr(state, k).clone() for k in ref.FIELDS}
    net.run(40, state=state)
    for k in ref.FIELDS:
        assert torch.equal(getattr(state, k), before[k]), k


def test_init_state_draws_v0_and_a_key():
    net = bt.MicrocircuitNet(scale=0.05, device='cpu')
    a, b = net.init_state(), net.init_state()
    assert torch.equal(a.v, b.v) and a.key == b.key
    c = net.init_state(torch.Generator().manual_seed(3))
    assert c.key != a.key
    assert abs(float(a.v.mean()) - 7.0) < 0.5
    assert abs(float(a.v.std()) - 10.0) < 0.5
    assert a.ring.shape == (net.depth, net.num) and a.step == 0
    assert not a.ref.any() and not a.i_syn.any()
    out = net.run(20)
    assert out.key == a.key and int(out.spike_count.sum()) > 0


def test_the_run_records_its_spans():
    net, inputs = setup(0.02)
    tracing.drain()
    tracing.enable()
    try:
        net.run(5, state=program_state(inputs['states'][0]))
    finally:
        tracing.disable()
    spans = tracing.drain()
    root = spans[0]
    assert root.name == 'brainevent_torch.MicrocircuitNet.run'
    assert root.parent_id is None
    share = float((net.delays >= 2).double().mean())
    assert root.attrs == dict(num=net.num, n_steps=5, route='loop',
                              grid_share=pytest.approx(share, abs=1e-12))
    assert 0.98 < share < 1
    assert [s.name for s in spans[1:]] == [
        'brainevent_torch.MicrocircuitNet.copies',
        'brainevent_torch.MicrocircuitNet.launch']
    assert all(s.parent_id == root.span_id for s in spans[1:])
    net.run(5, state=program_state(inputs['states'][0]))
    assert tracing.drain() == []


# -- the plan: the delay-1 CSR and the grid's scratch ------------------------------

def hand_made_rows(num: int) -> dict:
    """A network of *num* neurons whose every third row is empty, the
    others of 1 + (i mod 7) synapses, of delays 1, 2, 3, 1, ... in turn."""
    degree = torch.tensor([0 if i % 3 == 0 else 1 + i % 7
                           for i in range(num)])
    row_ptr = torch.zeros(num + 1, dtype=torch.int32)
    torch.cumsum(degree, 0, out=row_ptr[1:])
    n_syn = int(row_ptr[-1])
    j = torch.arange(n_syn)
    return dict(row_ptr=row_ptr,
                targets=((j * 7919) % num).to(torch.int32),
                weights=(j % 101 - 50).to(torch.int16),
                delays=(1 + j % 3).to(torch.uint8))


def network_arrays(kind: str) -> dict:
    if kind == 'drawn':
        return {k: x.clone() for k, x in setup(0.02)[1]['program'].items()}
    return hand_made_rows(sum(PARAMS.sizes(0.02)))


@pytest.mark.parametrize('kind', ['drawn', 'hand-made'])
def test_the_plan_holds_each_rows_delay_1_synapses_in_order(kind):
    arrays = network_arrays(kind)
    given = {k: x.clone() for k, x in arrays.items()}
    net = bt.MicrocircuitNet(scale=0.02, device='cpu', **arrays)
    plan = net.plan
    assert plan.near_ptr.dtype == plan.near_targets.dtype == torch.int32
    assert plan.near_weights.dtype == torch.int16
    rp = net.row_ptr.tolist()
    near = plan.near_ptr.tolist()
    d, tg, w = net.delays, net.targets, net.weights
    for i in range(net.num):
        one = torch.nonzero(d[rp[i]:rp[i + 1]] == 1).flatten() + rp[i]
        assert near[i + 1] - near[i] == one.numel(), i
        assert torch.equal(plan.near_targets[near[i]:near[i + 1]], tg[one])
        assert torch.equal(plan.near_weights[near[i]:near[i + 1]], w[one])
    assert near[0] == 0 and near[-1] == int((d == 1).sum()) > 0
    if kind == 'hand-made':
        assert (net.row_ptr[1:] == net.row_ptr[:-1]).sum() > net.num // 4
    # the given arrays are the net's, unchanged and not copied
    for k, x in given.items():
        assert torch.equal(arrays[k], x), k
        assert getattr(net, k).data_ptr() == arrays[k].data_ptr(), k
    assert plan.lists.shape == (mc.MC_LISTS, net.num, 2)
    assert plan.counts.shape == (mc.MC_LISTS,)
    assert plan.lists.dtype == plan.counts.dtype == torch.int32


@pytest.mark.parametrize('kind', ['drawn', 'hand-made'])
def test_grid_share_is_the_share_of_delays_of_two_or_more(kind):
    arrays = network_arrays(kind)
    n_syn = arrays['delays'].numel()
    want = int((arrays['delays'] >= 2).sum()) / n_syn
    net = bt.MicrocircuitNet(scale=0.02, device='cpu', **arrays)
    assert net.grid_share == want
    tracing.drain()
    tracing.enable()
    try:
        net.run(3, state=net.init_state())
    finally:
        tracing.disable()
    root = tracing.drain()[0]
    assert root.name == 'brainevent_torch.MicrocircuitNet.run'
    assert root.attrs['grid_share'] == want


@pytest.mark.parametrize('delay', [1, 2])
def test_grid_share_of_one_delay_everywhere(delay):
    arrays = network_arrays('hand-made')
    arrays['delays'] = torch.full_like(arrays['delays'], delay)
    net = bt.MicrocircuitNet(scale=0.02, device='cpu', **arrays)
    assert net.grid_share == (0.0 if delay == 1 else 1.0)
    n_near = net.plan.near_targets.numel()
    assert n_near == (arrays['delays'].numel() if delay == 1 else 0)
    assert net.depth == 1 << delay.bit_length()


def test_an_empty_network_has_an_empty_plan():
    num = sum(PARAMS.sizes(0.02))
    net = bt.MicrocircuitNet(
        scale=0.02, device='cpu',
        row_ptr=torch.zeros(num + 1, dtype=torch.int32),
        targets=torch.zeros(0, dtype=torch.int32),
        weights=torch.zeros(0, dtype=torch.int16),
        delays=torch.zeros(0, dtype=torch.uint8))
    assert net.grid_share == 0.0
    assert not net.plan.near_ptr.any() and net.plan.near_targets.numel() == 0


# -- the kernel's interface, without a card ---------------------------------------

def test_the_ctypes_struct_is_the_c_struct():
    text = (ROOT / 'brainevent_torch' / 'csrc' / 'mc_sim.cu').read_text()
    body = text[text.index('struct McParams {'):]
    body = body[:body.index('};')]
    names = re.findall(r'^\s+\w+ (\w+)(?:\[[^\]]+\])?;', body, re.M)
    assert names == [name for name, _ in mc.McParams._fields_]
    assert ctypes.sizeof(mc.McParams) == 4 * (13 + 9 + 8 * 16)


def test_the_wrapper_passes_what_the_c_entry_point_takes(monkeypatch):
    text = (ROOT / 'brainevent_torch' / 'csrc' / 'mc_sim.cu').read_text()
    seen = {}

    def function(name, argtypes, restype=ctypes.c_int):
        sig = text[text.index(f' {name}(') + len(name) + 2:]
        assert sig[:sig.index(')')].count(',') + 1 == len(argtypes), name

        def fn(*cargs):
            assert len(cargs) == len(argtypes), name
            seen[name] = len(cargs)
            if name == 'mc_sim_max_blocks':
                cargs[-1]._obj.value = 1000
            return 0
        return fn
    monkeypatch.setattr(cuda_build, 'function', function)
    monkeypatch.setattr(mc, 'cuda_stream', lambda device: None)
    mc._max_blocks.cache_clear()
    try:
        net, inputs = setup(0.02)
        s = program_state(inputs['states'][0])
        out = [x.clone() for x in (s.v, s.i_syn, s.ref, s.ring,
                                   s.spike_count)]
        assert mc.mc_sim_grid(net.num, CPU) == 7
        before = mc.mc_sim.launches
        mc._mc_sim_cuda(mc.mc_sim, *out, net.row_ptr, net.targets,
                        net.weights, net.delays, 10, net.step_params(1, 0),
                        plan=net.plan)
        assert mc.mc_sim.launches == before + 1
    finally:
        mc._max_blocks.cache_clear()
    assert seen == {'mc_sim_max_blocks': 2, 'mc_sim_launch': 20}


@pytest.mark.parametrize('phases', [None, 3, 4])
def test_the_wrapper_takes_the_clocked_instance_with_phases(monkeypatch,
                                                            phases):
    """Given a buffer of the three phases, the wrapper passes it as the C
    entry's ``phases`` (the clocked instance); without, null (the plain
    one); a buffer of another size is refused before K23 is called."""
    text = (ROOT / 'brainevent_torch' / 'csrc' / 'mc_sim.cu').read_text()
    sig = text[text.index('BE_EXPORT int mc_sim_launch('):]
    names = re.findall(r'(\w+)[,)]', sig[:sig.index('{')])
    seen = []

    def function(name, argtypes, restype=ctypes.c_int):
        def fn(*cargs):
            seen.append(cargs)
            return 0
        return fn
    monkeypatch.setattr(cuda_build, 'function', function)
    monkeypatch.setattr(mc, 'cuda_stream', lambda device: None)
    monkeypatch.setattr(mc, 'mc_sim_grid', lambda num, device: 7)
    net, inputs = setup(0.02)
    s = program_state(inputs['states'][0])
    out = [x.clone() for x in (s.v, s.i_syn, s.ref, s.ring, s.spike_count)]
    buf = (None if phases is None
           else torch.zeros(phases, dtype=torch.int64))
    call = lambda: mc._mc_sim_cuda(  # noqa: E731
        mc.mc_sim, *out, net.row_ptr, net.targets, net.weights, net.delays,
        10, net.step_params(1, 0), plan=net.plan, phases=buf)
    if phases == 4:
        with pytest.raises(ValueError, match='do not match'):
            call()
        assert seen == []
        return
    call()
    assert len(mc.PHASES) == 3
    assert seen[0][names.index('phases')] == (
        None if buf is None else buf.data_ptr())


def test_a_grid_that_cannot_be_co_resident_is_refused(monkeypatch):
    net, inputs = setup(0.02)
    monkeypatch.setattr(mc, '_max_blocks', lambda device_index: 6)
    with pytest.raises(ValueError, match='1544 neurons need 7 blocks'):
        mc.mc_sim_grid(net.num, CPU)
    monkeypatch.setattr(mc, '_max_blocks', lambda device_index: 7)
    assert mc.mc_sim_grid(net.num, CPU) == 7


def test_k23_replaces_no_tpu_kernel():
    assert core.REGISTRY['mc_sim'].replaces is None
    assert core.REGISTRY['mc_sim'].twin is mc.mc_loop


# -- K23 on a card ----------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the CUDA kernels have no CPU form')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('scale, warm', [(0.02, 0), (1.0, 0), (1.0, 1000)],
                         ids=['0.02', '1.0', '1.0-after-1000'])
def test_k23_is_the_twin_bit_for_bit(cuda_device, scale, warm):
    """``run`` of 2,000 steps, from a drawn state or *warm* steps on from
    it, is one K23 launch and no other kernel, bit for bit the twin and a
    second launch from the same state."""
    net, inputs = setup(scale, cuda_device)
    state = program_state(inputs['states'][0])
    if warm:
        state = net.run(warm, state=state)
    core.reset_launch_counts()
    got = net.run(2000, state=state)
    torch.cuda.synchronize()
    counts = core.launch_counts()
    assert counts['mc_sim'] == 1 and sum(counts.values()) == 1, counts
    again = net.run(2000, state=state)
    out = [getattr(state, k).clone() for k in ref.FIELDS]
    mc.mc_loop(*out, net.row_ptr, net.targets, net.weights, net.delays, 2000,
               net.step_params(state.key, state.step))
    for k, want in zip(ref.FIELDS, out):
        assert torch.equal(getattr(got, k), want), k
        assert torch.equal(getattr(again, k), want), k
    assert int((got.spike_count - state.spike_count).sum()) > 0


@pytest.mark.cuda
def test_k23_clocked_instance_is_the_plain_one_and_tiles_its_time(
        cuda_device):
    """With tracing on, ``run`` takes K23's clocked instance on the same
    grid, at full scale: bit for bit the plain instance's state from the
    same state over 2,000 steps, and its warps' phases a step (update,
    scatter, barrier) within 3% of K23's device time a step in the
    profiler's trace of the same launch."""
    from _torch_card import check_phases, clocked_run
    net, inputs = setup(1.0, cuda_device)
    state = program_state(inputs['states'][1])
    plain = net.run(2000, state=state)
    got, counts, seconds = clocked_run(lambda: net.run(2000, state=state),
                                       cuda_device, 'mc_sim_kernel')
    for k in ref.FIELDS:
        assert torch.equal(getattr(got, k), getattr(plain, k)), k
    warps = mc.mc_sim_grid(net.num, cuda_device) * mc.MC_BLOCK // 32
    check_phases(counts, 'MicrocircuitNet', mc.PHASES, warps * 2000,
                 seconds, 2000)


@pytest.mark.cuda
def test_k23_chains_and_leaves_its_state(cuda_device):
    net, inputs = setup(0.02, cuda_device)
    state = program_state(inputs['states'][1])
    before = {k: getattr(state, k).clone() for k in ref.FIELDS}
    whole = net.run(700, state=state)
    half = net.run(400, state=net.run(300, state=state))
    for k in ref.FIELDS:
        assert torch.equal(getattr(half, k), getattr(whole, k)), k
        assert torch.equal(getattr(state, k), before[k]), k
    assert mc.mc_sim_grid(net.num, cuda_device) == -(-net.num // mc.MC_BLOCK)


@pytest.mark.cuda
@pytest.mark.parametrize('empty_rows', [False, True])
def test_k23_walks_a_full_list_bit_for_bit(cuda_device, empty_rows):
    """The first three blocks' 3 MC_BLOCK neurons all spike at the first
    step, so their blocks' lists of delay-1 rows are full and the grid's
    list of the step holds more than one chunk of MC_BLOCK rows; with
    *empty_rows*, every third row of the network holds no synapse, some of
    those blocks' among them."""
    net, inputs = setup(0.02, cuda_device)
    if empty_rows:
        degree = (net.row_ptr[1:] - net.row_ptr[:-1]).long()
        kept = torch.arange(net.num, device=cuda_device) % 3 != 0
        keep = torch.repeat_interleave(kept, degree)
        row_ptr = torch.zeros(net.num + 1, dtype=torch.int64,
                              device=cuda_device)
        torch.cumsum(degree * kept, 0, out=row_ptr[1:])
        net = bt.MicrocircuitNet(
            scale=0.02, device=cuda_device, row_ptr=row_ptr,
            targets=net.targets[keep], weights=net.weights[keep],
            delays=net.delays[keep])
        assert net.depth == inputs['depth']
    state = program_state(inputs['states'][0])
    block = slice(0, 3 * mc.MC_BLOCK)
    v, i_syn, refr = state.v.clone(), state.i_syn.clone(), state.ref.clone()
    v[block], i_syn[block], refr[block] = 2 * (PARAMS.v_th - PARAMS.e_l), 0, 0
    state = state._replace(v=v, i_syn=i_syn, ref=refr)
    first = [getattr(state, k).clone() for k in ref.FIELDS]
    rows = (net.row_ptr, net.targets, net.weights, net.delays)
    mc.mc_loop(*first, *rows, 1, net.step_params(state.key, state.step))
    assert bool((first[-1] - state.spike_count)[block].eq(1).all())
    got = net.run(50, state=state)
    want = [getattr(state, k).clone() for k in ref.FIELDS]
    mc.mc_loop(*want, *rows, 50, net.step_params(state.key, state.step))
    for k, x in zip(ref.FIELDS, want):
        assert torch.equal(getattr(got, k), x), k


def twin_run(net, state, n_steps):
    out = [getattr(state, k).clone() for k in ref.FIELDS]
    mc.mc_loop(*out, net.row_ptr, net.targets, net.weights, net.delays,
               n_steps, net.step_params(state.key, state.step))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize('scale', [0.02, 1.0])
@pytest.mark.parametrize('n_steps', [1, 2])
def test_k23_adds_its_last_steps_spikes_before_it_returns(cuda_device, scale,
                                                         n_steps):
    """A run of one or two steps from a drawn state (a fifth of the
    neurons above threshold at once) leaves in the ring every synapse its
    spikes sent, the last step's too, as the twin does; and a run chained
    on from it goes on as one run."""
    net, inputs = setup(scale, cuda_device)
    state = program_state(inputs['states'][0])
    got = net.run(n_steps, state=state)
    want = twin_run(net, state, n_steps)
    for k, x in zip(ref.FIELDS, want):
        assert torch.equal(getattr(got, k), x), k
    assert int((got.spike_count - state.spike_count).sum()) > net.num // 10
    on = net.run(3, state=got)
    whole = net.run(n_steps + 3, state=state)
    for k in ref.FIELDS:
        assert torch.equal(getattr(on, k), getattr(whole, k)), k


@pytest.mark.cuda
@pytest.mark.parametrize('delays', ['all 1', 'none 1'])
def test_k23_takes_networks_of_one_kind_of_delay(cuda_device, delays):
    """Every delay 1 (D = 2: the grid pass adds nothing), or none (the
    owner's walk adds nothing): bit for bit the twin over 200 steps."""
    base, inputs = setup(0.02, cuda_device)
    d = (torch.ones_like(base.delays) if delays == 'all 1'
         else base.delays.clamp(min=2))
    net = bt.MicrocircuitNet(scale=0.02, device=cuda_device,
                             row_ptr=base.row_ptr, targets=base.targets,
                             weights=base.weights, delays=d)
    assert net.grid_share == (0.0 if delays == 'all 1' else 1.0)
    assert net.depth == (2 if delays == 'all 1' else base.depth)
    state = program_state(inputs['states'][1])
    state = state._replace(ring=torch.zeros(net.depth, net.num,
                                            dtype=torch.int32,
                                            device=cuda_device))
    got = net.run(200, state=state)
    want = twin_run(net, state, 200)
    for k, x in zip(ref.FIELDS, want):
        assert torch.equal(getattr(got, k), x), k
    assert int((got.spike_count - state.spike_count).sum()) > 0
