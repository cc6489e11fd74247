# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""brainevent_torch.models.networks against brainevent_tpu.models.networks.

Both packages simulate the same network: the connectivity and the initial
state are the JAX ``EINet``'s, carried across as numpy arrays
(``brainevent_torch.interop``). On the CPU the port's step and loop must
equal ``jax.jit``'s bit for bit at 4,000 neurons for 2,000 steps. That
holds only with the FMAs XLA forms written out in the port:

- ``g' = fma(g, decay, w * count)``: XLA folds the decay multiply into the
  add of the scaled counts (settled by this test; plain evaluation and
  ``fma(w, count, g * decay)`` both differ within a few steps);
- COBA ``current = fma(g_e*d_e, e_e - v, (g_i*d_i)*(e_i - v)) + inp``;
- CUBA ``current = fma(g_e, d_e, -(g_i*d_i)) + inp``;
- ``v' = fma((v_rest - v) + current, dt/tau, v)``;

and with time as ``float32(i) * float32(0.1)``. The bar is the JAX
package's own: its count-then-scale engines agree for about 2,000 steps,
after which chaos amplifies any rounding difference.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brainevent_tpu.models import EINet as JEINet
from brainevent_torch import CUDANotInstalledError
from brainevent_torch.interop import einet_from_arrays
from brainevent_torch.models import EINet
from brainevent_torch.models import networks as tnet
from brainevent_torch.ops import scatter as ts

from _torch_one_thread import one_torch_thread  # noqa: F401

N_STEPS = 2000
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _pair(scale, coba, seed=42):
    jnet = JEINet(scale=scale, coba=coba, seed=seed)
    s = jnet.init_state()
    net, state = einet_from_arrays(
        np.asarray(jnet.conn_all), jnet.n_exc, s.neurons.v, s.neurons.t_last,
        s.g_e, s.g_i, s.spike_count, scale=scale, coba=coba, device='cpu')
    return jnet, s, net, state


def _fields(s):
    return {'v': s.neurons.v, 't_last': s.neurons.t_last, 'g_e': s.g_e,
            'g_i': s.g_i, 'spike_count': s.spike_count}


@pytest.mark.parametrize('coba', [True, False], ids=['coba', 'cuba'])
def test_step_bitwise_vs_jax_every_step(coba):
    jnet, js, net, ts_ = _pair(1.0, coba)
    assert net.num == 4000
    jstep = jax.jit(lambda s, t: jnet.step(s, t))
    n_spikes = 0
    for i in range(N_STEPS):
        t = np.float32(i) * np.float32(0.1)
        prev_count = ts_.spike_count
        js = jstep(js, jnp.float32(t))
        ts_ = net.step(ts_, float(t))
        n_spikes += int((ts_.spike_count - prev_count).sum())
        want, got = _fields(js), _fields(ts_)
        for name in want:
            w = np.asarray(want[name])
            g = got[name].numpy()
            if not np.array_equal(g, w):
                raise AssertionError(
                    f'step {i}: {name} differs at {int((g != w).sum())} of '
                    f'{w.size} neurons')
    assert n_spikes > 1000                   # the network is active


@pytest.mark.parametrize('coba', [True, False], ids=['coba', 'cuba'])
def test_run_spike_counts_vs_jax_run(coba):
    jnet, js, net, state = _pair(1.0, coba)
    ref = jax.jit(lambda s: jnet.run(N_STEPS, state=s))(js)
    out = net.run(N_STEPS, state=state)
    np.testing.assert_array_equal(out.spike_count.numpy(),
                                  np.asarray(ref.spike_count))
    # the K1/K2 twins reach the same state as the JAX loop, not just counts
    np.testing.assert_array_equal(out.neurons.v.numpy(),
                                  np.asarray(ref.neurons.v))
    np.testing.assert_array_equal(out.g_e.numpy(), np.asarray(ref.g_e))
    np.testing.assert_array_equal(out.g_i.numpy(), np.asarray(ref.g_i))
    # the input state is left as it was
    np.testing.assert_array_equal(state.neurons.v.numpy(),
                                  np.asarray(js.neurons.v))
    assert out.spike_count.dtype == torch.int32


def test_run_launches_twins_not_kernels_on_cpu():
    net = EINet(scale=0.05, device='cpu')
    before = (tnet.einet_step.launches, ts.event_count_scatter.launches,
              tnet.einet_sim.launches)
    net.run(20)
    net.step(net.init_state(), 0.0)
    assert (tnet.einet_step.launches, ts.event_count_scatter.launches,
            tnet.einet_sim.launches) == before


def _burst(net):
    """The net's initial state with every neuron above threshold and none
    refractory: at inp 500 every neuron fires at the first step."""
    s = net.init_state()
    v = net.params.v_th + torch.rand(net.num, generator=torch.Generator()
                                     .manual_seed(3))
    return s._replace(neurons=s.neurons._replace(
        v=v, t_last=torch.full_like(s.neurons.t_last, -1e7)))


def _twin_loop(net, state, n, inp):
    return tnet.einet_loop(
        state.neurons.v, state.neurons.t_last, state.g_e, state.g_i,
        state.spike_count, net.times(n), net.step_params(inp),
        lambda ids, n_ids, counts: ts.event_count_scatter_twin(
            ids, n_ids, net.conn_all, net.n_exc, counts),
        step_op=tnet.einet_step_twin)


@pytest.mark.parametrize('n', [0, 1, 2, 300])
@pytest.mark.parametrize('coba', [True, False], ids=['coba', 'cuba'])
def test_einet_sim_twin_bitwise_the_twin_loop_on_a_burst(coba, n):
    net = EINet(scale=0.1, coba=coba, seed=7, device='cpu')
    state = _burst(net)
    want = _twin_loop(net, state, n, 500.0)
    got = [x.clone() for x in (state.neurons.v, state.neurons.t_last,
                               state.g_e, state.g_i, state.spike_count)]
    before = tnet.einet_sim.launches
    tnet.einet_sim(*got, net.conn_all,
                   torch.tensor(net.times(n), dtype=torch.float32),
                   net.step_params(500.0), net.n_exc)
    assert tnet.einet_sim.launches == before
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and torch.equal(x, y)
    if n:
        assert int(got[4].min()) >= 1              # every neuron fired
    out = net.run(n, 500.0, state)                 # EINet.run: the same
    for x, y in zip((out.neurons.v, out.neurons.t_last, out.g_e, out.g_i,
                     out.spike_count), want):
        assert torch.equal(x, y)


def test_run_and_step_go_through_einet_sim_once(monkeypatch):
    calls = []
    twin = tnet.einet_sim.twin

    def spy(*args, **kwargs):
        calls.append(args[6].numel())              # the step times
        return twin(*args, **kwargs)
    monkeypatch.setattr(tnet.einet_sim, 'twin', spy)
    net = EINet(scale=0.05, device='cpu')
    state = net.run(30)
    assert calls == [30]
    net._simulate(state, [3.0], 20.0)        # EINet.step on a CUDA tensor
    assert calls == [30, 1]
    # an explicit step or scatter op runs the loop of two ops a step
    net._simulate(state, net.times(5), 20.0,
                  scatter_op=ts.event_count_scatter_twin)
    net._simulate(state, net.times(5), 20.0, step_op=tnet.einet_step_twin)
    assert calls == [30, 1]


def _recording_launches(monkeypatch):
    """Replace the C entry points by recorders of their arguments, each
    call checked against its declared argument count, keyed by name."""
    from brainevent_torch.ops import cuda_build
    seen = {}

    def function(name, argtypes, restype=None):
        def fn(*cargs):
            assert len(cargs) == len(argtypes), name
            seen[name] = cargs
            return 0
        return fn
    monkeypatch.setattr(cuda_build, 'function', function)
    monkeypatch.setattr(tnet, 'cuda_stream', lambda device: None)
    return seen


def test_einet_sim_wrapper_passes_what_the_c_entry_point_takes(monkeypatch):
    """K21's wrapper declares and passes as many ctypes arguments as
    ``einet_sim_launch`` has parameters (checked without a card: the entry
    point is replaced by a recorder), and checks its shapes."""
    seen = _recording_launches(monkeypatch)
    net = EINet(scale=0.1, device='cpu')
    s = net.init_state()
    bufs = [x.clone() for x in (s.neurons.v, s.neurons.t_last, s.g_e,
                                s.g_i, s.spike_count)]
    times = torch.zeros(7)
    op = tnet.einet_sim
    op.cuda(op, *bufs, net.conn_all, times, net.step_params(), net.n_exc,
            npt=2)
    cargs = seen['einet_sim_launch']
    text = (ROOT / 'brainevent_torch' / 'csrc' / 'einet_sim.cu').read_text()
    sig = text[text.index(' einet_sim_launch(') + 18:]
    assert sig[:sig.index(')')].count(',') + 1 == len(cargs)
    # n_steps, npt, blocks: 400 neurons, 2 a thread
    assert (cargs[7], cargs[12], cargs[13]) == (7, 2, 1)
    with pytest.raises(ValueError, match='cover'):
        op.cuda(op, *bufs, net.conn_all, times, net.step_params(),
                net.n_exc, npt=1, blocks=1)
    with pytest.raises(ValueError, match='npt'):
        op.cuda(op, *bufs, net.conn_all, times, net.step_params(),
                net.n_exc, npt=3)
    with pytest.raises(ValueError, match='num'):
        op.cuda(op, *bufs, net.conn_all[:-1], times, net.step_params(),
                net.n_exc, npt=2)


@pytest.mark.parametrize('scale, dtype, vec', [
    (0.1, torch.uint8, 16), (0.25, torch.uint8, 4), (0.2525, torch.uint8, 1),
    (0.1, torch.int32, 16), (0.2525, torch.int32, 4)])
def test_einet_sim_table_wrapper_passes_source_and_piece(monkeypatch, scale,
                                                         dtype, vec):
    """With a table K21's wrapper passes the table as the targets, its
    source (1 uint8, 2 int32) and the bytes of its pieces (16 where a
    row's bytes are a multiple of 16, else 4 or one entry); it refuses a
    table of another dtype or shape (checked without a card)."""
    seen = _recording_launches(monkeypatch)
    monkeypatch.setattr(tnet, '_max_blocks', lambda index, npt, src: 1000)
    net = EINet(scale=scale, device='cpu')
    s = net.init_state()
    bufs = [x.clone() for x in (s.neurons.v, s.neurons.t_last, s.g_e,
                                s.g_i, s.spike_count)]
    table = torch.zeros(net.num, net.num, dtype=dtype)
    assert tnet.table_piece_bytes(table) == vec
    op = tnet.einet_sim
    op.cuda(op, *bufs, net.conn_all, torch.zeros(3), net.step_params(),
            net.n_exc, table=table)
    cargs = seen['einet_sim_launch']
    assert cargs[5] == table.data_ptr()
    # rows of at most 8 KB: each block walks its own rows
    assert cargs[14:18] == (tnet.SIM_SOURCES[dtype], vec, None, 0)
    op.cuda(op, *bufs, net.conn_all, torch.zeros(3), net.step_params(),
            net.n_exc, table=table, grid_walk=True)
    cargs = seen['einet_sim_launch']
    assert cargs[16] is not None and cargs[17] == 1
    # the walk by the bytes of a row (views of one entry, no memory)
    item = table.element_size()
    longest = tnet.TABLE_BLOCK_WALK_ROW_BYTES // item
    assert not tnet.table_grid_walk(table)
    assert not tnet.table_grid_walk(
        table[:1, :1].expand(longest, longest))
    assert tnet.table_grid_walk(table[:1, :1].expand(longest + 1,
                                                      longest + 1))
    op.cuda(op, *bufs, net.conn_all, torch.zeros(3), net.step_params(),
            net.n_exc)
    cargs = seen['einet_sim_launch']
    assert cargs[5] == net.conn_all.data_ptr()
    assert cargs[14:18] == (0, 0, None, 0)
    with pytest.raises(TypeError, match='uint8 or int32'):
        op.cuda(op, *bufs, net.conn_all, torch.zeros(3), net.step_params(),
                net.n_exc, table=table.to(torch.int16))
    with pytest.raises(ValueError, match='table'):
        op.cuda(op, *bufs, net.conn_all, torch.zeros(3), net.step_params(),
                net.n_exc, table=table[:-1])


@pytest.mark.parametrize('dtype, largest', [(None, 8), (torch.uint8, 4),
                                            (torch.int32, 2)])
def test_einet_sim_instances_by_source(monkeypatch, dtype, largest):
    """Each source builds the NPT instances up to its largest (8 over conn,
    4 over a uint8 table, 2 over an int32 one, as einet_sim.cu's
    be_sim_max_npt): the capacity is the largest one's, the grid is
    chosen among them, and the wrapper refuses any other NPT (checked
    without a card)."""
    from brainevent_torch.models import sim
    from brainevent_torch.ops import cuda_build
    assert tnet.SIM_SOURCE_NPT[dtype] == tuple(
        k for k in tnet.SIM_NPT if k <= largest)
    text = (ROOT / 'brainevent_torch' / 'csrc' / 'einet_sim.cu').read_text()
    assert 'be_sim_max_npt = SRC == 0 ? 8 : (SRC == 1 ? 4 : 2);' in text
    seen = []
    monkeypatch.setattr(tnet, '_max_blocks',
                        lambda index, npt, src: seen.append(npt) or 3)
    cpu = torch.device('cpu')
    assert tnet.einet_sim_capacity(cpu, dtype) == 3 * 256 * largest
    assert seen == [largest]
    assert tnet.einet_sim_grid(3 * 256 * largest, cpu, dtype) == (largest, 3)
    with pytest.raises(ValueError, match='exceed'):
        tnet.einet_sim_grid(3 * 256 * largest + 1, cpu, dtype)
    monkeypatch.setattr(cuda_build, 'function',
                        lambda name, argtypes, restype=None: lambda *a: 0)
    monkeypatch.setattr(tnet, 'cuda_stream', lambda device: None)
    net = EINet(scale=0.1, device='cpu')
    s = net.init_state()
    bufs = [x.clone() for x in (s.neurons.v, s.neurons.t_last, s.g_e,
                                s.g_i, s.spike_count)]
    table = None if dtype is None else sim.dense_count_table(net).to(dtype)
    op = tnet.einet_sim
    for npt in tnet.SIM_NPT:
        if npt <= largest:
            op.cuda(op, *bufs, net.conn_all, torch.zeros(3),
                    net.step_params(), net.n_exc, table=table, npt=npt,
                    grid_walk=False)
        else:
            with pytest.raises(ValueError, match='npt'):
                op.cuda(op, *bufs, net.conn_all, torch.zeros(3),
                        net.step_params(), net.n_exc, table=table, npt=npt,
                        grid_walk=False)


def test_einet_sim_holds_by_size_with_a_patched_capacity(monkeypatch):
    """The route rule: a run takes K21 up to the capacity of its source
    (conn, or the table's dtype) and the loop of two ops a step above it,
    on a card; always K21's twin on the CPU."""
    caps = {None: 1000, torch.uint8: 500, torch.int32: 200}
    monkeypatch.setattr(tnet, 'einet_sim_capacity',
                        lambda device, table_dtype=None: caps[table_dtype])
    card, cpu = torch.device('cuda', 0), torch.device('cpu')
    for dtype, cap in caps.items():
        assert tnet.einet_sim_holds(cap, card, dtype)
        assert not tnet.einet_sim_holds(cap + 1, card, dtype)
        assert tnet.einet_sim_holds(10 * cap, cpu, dtype)


H100 = (16, 232448)      # the largest cluster an H100 grants, its block's bytes


@pytest.mark.parametrize('limits, num, n_conn, want', [
    (H100, 4000, 80, (8, 500, 1)),            # Brette's size
    (H100, 11056, 80, (16, 691, 1)),          # the capacity's edge at 80
    (H100, 11057, 80, None),
    ((8, 232448), 5528, 80, (8, 691, 1)),     # a device of 8 CTAs: half
    ((8, 232448), 5529, 80, None),
    ((0, 232448), 4000, 80, None),            # a device that grants none
    (H100, 1, 80, (1, 1, 1)),
    (H100, 33, 80, (1, 33, 1)),
    (H100, 2000, 8, (1, 2000, 2)),            # few targets: more a thread
    (H100, 8000, 8, (2, 4000, 4)),
    (H100, 16 * 4096 + 1, 0, None),           # past 1,024 threads x NPT 4
], ids=str)
def test_einet_sim_cluster_rule(monkeypatch, limits, num, n_conn, want):
    """The cluster instance's route by size (the device's largest cluster
    and a block's shared memory patched, checked without a card): the
    fewest blocks C whose share = ceil(num / C) of rows and counts,
    share * (n_conn + 4) * 4 bytes, fit a block and whose share a block's
    1,024 threads hold at the least NPT; else the grid (None)."""
    monkeypatch.setattr(tnet, '_cluster_limits', lambda index: limits)
    card = torch.device('cuda', 0)
    assert tnet.einet_sim_cluster(num, n_conn, card) == want
    if want is not None:
        blocks, share, npt = want
        assert share * (n_conn + 4) * 4 <= limits[1] and blocks * share >= num
        # never a table, never the CPU
        for dtype in (torch.uint8, torch.int32):
            assert tnet.einet_sim_cluster(num, n_conn, card, dtype) is None
        assert tnet.einet_sim_cluster(num, n_conn, torch.device('cpu')) is None


def test_einet_sim_cluster_instances_match_the_source():
    """The cluster instances the rule picks among are those einet_sim.cu
    builds, and a block's most threads is its launch bound."""
    text = (ROOT / 'brainevent_torch' / 'csrc' / 'einet_sim.cu').read_text()
    for npt in tnet.SIM_CLUSTER_NPT:
        assert (f'case {npt}: return reinterpret_cast<const void*>('
                f'einet_sim_cluster_kernel<{npt}>);') in text
    assert text.count('einet_sim_cluster_kernel<') == len(tnet.SIM_CLUSTER_NPT)
    assert (f'BE_CLUSTER_THREADS = {tnet.SIM_CLUSTER_THREADS};') in text
    assert 'for (int npt : {1, 2, 4})' in text


def _rule_on_a_card(monkeypatch, limits):
    """The cluster rule of a device of *limits*, asked for a card whatever
    the tensors' device (so the CPU's twin, or a recorder, runs)."""
    monkeypatch.setattr(tnet, '_cluster_limits', lambda index: limits)
    rule = tnet.einet_sim_cluster
    asked = []

    def on_a_card(num, n_conn, device, table_dtype=None):
        asked.append((num, n_conn))
        return rule(num, n_conn, torch.device('cuda', 0), table_dtype)
    monkeypatch.setattr(tnet, 'einet_sim_cluster', on_a_card)
    return asked


def test_einet_sim_wrapper_takes_the_cluster_by_default(monkeypatch):
    """K21's wrapper launches the cluster instance where the rule finds
    one (as many ctypes arguments as ``einet_sim_cluster_launch`` has
    parameters; blocks, share and NPT the rule's), and the grid instance
    where a test forces one with ``npt``/``blocks``, or the rule finds
    none (checked without a card: the entry points are recorders)."""
    seen = _recording_launches(monkeypatch)
    asked = _rule_on_a_card(monkeypatch, H100)
    monkeypatch.setattr(tnet, '_max_blocks', lambda index, npt, src: 1000)
    net = EINet(scale=1.0, device='cpu')
    s = net.init_state()
    bufs = [x.clone() for x in (s.neurons.v, s.neurons.t_last, s.g_e,
                                s.g_i, s.spike_count)]
    op = tnet.einet_sim
    op.cuda(op, *bufs, net.conn_all, torch.zeros(7), net.step_params(),
            net.n_exc)
    cargs = seen.pop('einet_sim_cluster_launch')
    assert not seen
    text = (ROOT / 'brainevent_torch' / 'csrc' / 'einet_sim.cu').read_text()
    sig = text[text.index(' einet_sim_cluster_launch(') + 26:]
    assert sig[:sig.index(')')].count(',') + 1 == len(cargs)
    assert cargs[5] == net.conn_all.data_ptr()
    # n_steps, n_conn, n_exc; npt, blocks, share
    assert cargs[7:10] == (7, 80, net.n_exc)
    assert cargs[11:14] == (1, 8, 500)
    op.cuda(op, *bufs, net.conn_all, torch.zeros(7), net.step_params(),
            net.n_exc, npt=1, blocks=16)
    assert list(seen) == ['einet_sim_launch']
    assert seen.pop('einet_sim_launch')[12:14] == (1, 16)
    assert asked == [(4000, 80)]              # a forced grid asks nothing
    monkeypatch.setattr(tnet, '_cluster_limits', lambda index: (0, 232448))
    op.cuda(op, *bufs, net.conn_all, torch.zeros(7), net.step_params(),
            net.n_exc)
    assert seen.pop('einet_sim_launch')[12:14] == (1, 16)


@pytest.mark.parametrize('dense, limits, route', [
    (False, H100, 'sim_cluster'), (False, (0, 232448), 'sim'),
    (True, H100, 'sim_table')], ids=['conn', 'no_cluster', 'table'])
def test_run_span_route_sim_cluster(monkeypatch, dense, limits, route):
    """The ``run`` span's route is ``sim_cluster`` where the rule gives
    the cluster (here the rule of a device of *limits* asked for a card,
    its twin run on the CPU), ``sim`` on a device that grants no
    cluster, ``sim_table`` for a table whatever the size; the state is
    the twin's, bitwise."""
    from brainevent_torch.models import sim
    from brainevent_torch.ops import tracing
    asked = _rule_on_a_card(monkeypatch, limits)
    net = EINet(scale=0.1, device='cpu')
    table = sim.dense_count_table(net) if dense else None
    state = net.init_state()
    want = _fields(net._simulate(state, net.times(30), 20.0, table=table))
    tracing.disable()
    tracing.drain()
    tracing.enable()
    try:
        got = net._simulate(state, 30, 20.0, table=table)
    finally:
        tracing.disable()
    root = tracing.drain()[0]
    assert root.name == 'brainevent_torch.EINet.run'
    assert root.attrs == dict(num=net.num, n_steps=30, route=route)
    assert asked == ([] if dense else [(400, 80)] * 2)
    for name, x in _fields(got).items():
        assert torch.equal(x, want[name]), name


@pytest.mark.parametrize('dense', [False, True], ids=['conn', 'table'])
def test_simulate_above_capacity_runs_the_loop(monkeypatch, dense):
    """Where the rule says no, EINet._simulate runs einet_loop over K1 and
    K2, or K19 with a table (their twins on the CPU), never K21, with the
    same five outputs bitwise."""
    from brainevent_torch.models import sim
    net = EINet(scale=0.1, device='cpu')
    state = net.init_state()
    table = sim.dense_count_table(net) if dense else None
    want = net._simulate(state, net.times(40), 20.0, table=table)
    calls = {'einet_sim': 0, 'einet_step': 0, 'einet_dense_hits': 0,
             'event_count_scatter': 0}
    for name, mod in (('einet_sim', tnet), ('einet_step', tnet),
                      ('einet_dense_hits', tnet),
                      ('event_count_scatter', tnet)):
        op = getattr(mod, name)

        def spy(*args, _op=op, _name=name, **kwargs):
            calls[_name] += 1
            return _op(*args, **kwargs)
        monkeypatch.setattr(mod, name, spy)
    holds = []
    monkeypatch.setattr(tnet, 'einet_sim_holds',
                        lambda num, device, dtype: holds.append(
                            (num, dtype)) and False)
    got = net._simulate(state, net.times(40), 20.0, table=table)
    assert holds == [(net.num, None if table is None else table.dtype)]
    assert calls == {'einet_sim': 0, 'einet_step': 41,
                     'einet_dense_hits': 40 if dense else 0,
                     'event_count_scatter': 0 if dense else 40}
    want = _fields(want)
    for name, x in _fields(got).items():
        assert torch.equal(x, want[name]), name


@pytest.mark.parametrize('coba', [True, False], ids=['coba', 'cuba'])
def test_firing_rate_regime_own_draws(coba):
    # the port's own torch.Generator draws (not JAX's), same band as
    # tests/test_models.py::TestEINet::test_firing_rate_regime
    net = EINet(scale=0.25, coba=coba, device='cpu')
    state = net.run(3000)
    rate = float(net.firing_rate_hz(state, 3000))
    assert 5.0 < rate < 200.0, f'firing rate {rate} Hz out of regime'


def test_own_draws_are_seeded():
    a, b = (EINet(scale=0.1, seed=9, device='cpu'),
            EINet(scale=0.1, seed=9, device='cpu'))
    assert torch.equal(a.conn_all, b.conn_all)
    assert torch.equal(a.init_state().neurons.v, b.init_state().neurons.v)
    assert a.conn_all.dtype == torch.int32
    assert a.conn_all.shape == (400, 80)
    assert int(a.conn_all.min()) >= 0 and int(a.conn_all.max()) < 400
    c = EINet(scale=0.1, seed=10, device='cpu')
    assert not torch.equal(a.conn_all, c.conn_all)


def test_einet_from_arrays_checks_shapes():
    jnet, s, net, state = _pair(0.1, True)
    assert net.init_state() is net.initial_state
    np.testing.assert_array_equal(net.conn_all.numpy(),
                                  np.asarray(jnet.conn_all))
    with pytest.raises(ValueError):
        einet_from_arrays(np.asarray(jnet.conn_all), jnet.n_exc + 1,
                          s.neurons.v, s.neurons.t_last, s.g_e, s.g_i,
                          s.spike_count, scale=0.1, coba=True,
                          device='cpu')


def test_cuda_device_on_cpu_host_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(CUDANotInstalledError):
        EINet(scale=0.1, device='cuda')
