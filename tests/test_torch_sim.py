# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""brainevent_torch.models.sim.einet_pallas_sim, its K1/K2 strategies
and their knobs against the JAX package.

On the CPU the port runs the twins of kernels K1 and K2; the JAX package
runs its Pallas kernels in interpret mode, as ``tests/test_models.py``
does. The checks mirror that file: spike counts equal, ``v`` to atol 1e-4
(the Pallas kernels' own bar against the XLA loop; their layout is not
the XLA step's, so a few ulps may differ), and ``g_e`` equal through a
burst that overflows every capacity the TPU kernels have.
"""

import inspect

import jax
import numpy as np
import pytest
import torch

from brainevent_tpu.models import EINet as JEINet
from brainevent_tpu.models import pallas_sim as jps
from brainevent_tpu.models.pallas_sim import (
    einet_pallas_sim as j_sim, einet_pallas_sim_mxu3 as j_mxu3,
    einet_pallas_sim_mxu6 as j_mxu6)
from brainevent_torch.interop import einet_from_arrays
from brainevent_torch.models import EINet, einet_pallas_sim, mxu6_conn_table
from brainevent_torch.models import sim
from brainevent_torch.models.sim import STRATEGIES, _auto_strategy

from _torch_one_thread import one_torch_thread  # noqa: F401


def _pair(scale, coba=True, seed=42, key=None, **kw):
    jnet = JEINet(scale=scale, coba=coba, seed=seed, **kw)
    s = jnet.init_state(None if key is None else jax.random.PRNGKey(key))
    net, state = einet_from_arrays(
        np.asarray(jnet.conn_all), jnet.n_exc, s.neurons.v, s.neurons.t_last,
        s.g_e, s.g_i, s.spike_count, scale=scale, coba=coba, device='cpu')
    return jnet, s, net, state


def _check_returns(out, num):
    v, t_last, g_e, g_i, spike_count = out
    for x in (v, t_last, g_e, g_i):
        assert x.shape == (num,) and x.dtype == torch.float32
        assert torch.isfinite(x).all()
    assert spike_count.shape == (num,) and spike_count.dtype == torch.int32


def test_matches_jax_mxu3():
    # mirrors tests/test_models.py::test_mxu3_strategy_matches_xla_loop
    jnet, s, net, state = _pair(0.1, seed=1, key=2)
    want = j_sim(jnet, s, 30, strategy='mxu3')
    got = einet_pallas_sim(net, state, 30, strategy='mxu3')
    _check_returns(got, net.num)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-4)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
    assert int(got[4].sum()) > 0


def test_matches_jax_mxu6():
    # mirrors tests/test_models.py::test_mxu6_strategy_matches_xla_loop
    jnet, s, net, state = _pair(0.1, seed=1, key=2)
    want = j_mxu6(jnet, s, 30, rpb=3, group=2)
    got = einet_pallas_sim(net, state, 30, strategy='mxu6', rpb=3, group=2)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-4)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))


def test_burst_matches_jax_mxu3():
    # mirrors tests/test_models.py::test_mxu3_multi_round_burst_exact: a
    # saturating drive overflows the TPU kernel's event capacity
    jnet, s, net, state = _pair(0.064, seed=3, key=0)
    want = j_mxu3(jnet, s, 10, 500.0)
    got = einet_pallas_sim(net, state, 10, 500.0)
    assert int(got[4].sum()) > 100
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_matches_jax_run_at_4k():
    jnet, s, net, state = _pair(1.0)
    assert net.num == 4000
    ref = jax.jit(lambda st: jnet.run(2000, state=st))(s)
    got = einet_pallas_sim(net, state, 2000)
    _check_returns(got, 4000)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(ref.spike_count))
    rate = float(got[4].float().mean()) / (2000 * 0.1e-3)
    assert 5.0 < rate < 200.0


@pytest.mark.parametrize('num,want', [(4_000, 'mxu3'), (39_999, 'mxu3'),
                                      (40_000, 'mxu6'), (400_000, 'mxu6')])
def test_auto_strategy(num, want):
    from brainevent_tpu.models.pallas_sim import _auto_strategy as j_auto
    assert _auto_strategy(num) == want == j_auto(num)


# each strategy with knobs of its JAX function (none for four of them)
KNOBS = {
    'chain': {}, 'mxu': {}, 'mxu2': {}, 'dense': {},
    'mxu3': dict(mask_dtype=None, operands='scratch', pack=False,
                 two_stage=False, table_space='hbm', cap_divisor=224,
                 factors='fori'),
    'mxu4': dict(row_chunk=2, table_space='hbm'),
    'mxu5': dict(mask_dtype=None, table_space='hbm', cap_divisor=224,
                 factors='fori'),
    'mxu6': dict(rpb=3, group=2, radix=2, prefetch=False, dead_skip=True,
                 cap_divisor=448, conn_table=None, table_space='hbm',
                 gather='rows', fused_load=False, tier_w=4, _ablate=()),
}


@pytest.mark.parametrize('strategy', STRATEGIES)
def test_every_strategy_and_knob_runs_the_same_kernels(strategy):
    net = EINet(scale=0.1, seed=5, device='cpu')
    state = net.init_state()
    ref = einet_pallas_sim(net, state, 25)
    out = einet_pallas_sim(net, state, 25, 20.0, None, strategy,
                           **KNOBS[strategy])
    for a, b in zip(ref, out):
        assert torch.equal(a, b), strategy
    with pytest.raises(ValueError, match='strategy'):
        einet_pallas_sim(net, state, 1, strategy='mxu7')
    # a knob of another strategy is an unknown keyword, as in JAX
    with pytest.raises(TypeError):
        einet_pallas_sim(net, state, 1, strategy=strategy, rbp=3)


@pytest.mark.parametrize('strategy', STRATEGIES)
def test_knobs_are_the_jax_signature(strategy):
    j_fn = getattr(jps, f'einet_pallas_sim_{strategy}')
    t_fn = getattr(sim, f'einet_pallas_sim_{strategy}')
    j_sig, t_sig = inspect.signature(j_fn), inspect.signature(t_fn)
    assert list(t_sig.parameters) == list(j_sig.parameters)
    for name, p in j_sig.parameters.items():
        q = t_sig.parameters[name]
        assert q.kind == p.kind, name
        if p.default is not inspect.Parameter.empty and not callable(
                p.default):
            assert q.default == p.default, name
    bad = 'rpb' if strategy != 'mxu6' else 'row_chunk'
    jnet = JEINet(scale=0.05)
    for fn, net in ((j_fn, jnet), (t_fn, EINet(scale=0.05, device='cpu'))):
        with pytest.raises(TypeError):
            fn(net, net.init_state(), 1, **{bad: 3})
    assert list(inspect.signature(einet_pallas_sim).parameters) == list(
        inspect.signature(j_sim).parameters)


def test_mxu6_conn_table_is_the_plain_table():
    net = EINet(scale=0.1, device='cpu')
    assert mxu6_conn_table(net, rpb=3, group=2) is net.conn_all


def test_zero_steps_returns_the_state():
    net = EINet(scale=0.05, device='cpu')
    state = net.init_state()
    out = einet_pallas_sim(net, state, 0)
    assert torch.equal(out[0], state.neurons.v)
    assert torch.equal(out[2], state.g_e)
    assert out[0] is not state.neurons.v


def _equal(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


# -- the superseded strategies (B5) against their JAX functions ------------------------

def test_mxu2_matches_jax():
    # tests/test_models.py::test_mxu2_strategy_matches_xla_loop
    jnet, s, net, state = _pair(0.1, seed=1, key=2)
    want = jps.einet_pallas_sim_mxu2(jnet, s, 30)
    got = sim.einet_pallas_sim_mxu2(net, state, 30)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-4)


def test_mxu5_matches_jax():
    # tests/test_models.py::test_mxu5_strategy_matches_xla_loop
    jnet, s, net, state = _pair(0.1, seed=1, key=2)
    want = jps.einet_pallas_sim_mxu5(jnet, s, 30)
    got = sim.einet_pallas_sim_mxu5(net, state, 30)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-4)


def test_mxu_matches_jax():
    # tests/test_models.py::test_mxu_strategy_matches_xla_loop
    jnet, s, net, state = _pair(0.032)
    want = jps.einet_pallas_sim_mxu(jnet, s, 30)
    got = sim.einet_pallas_sim_mxu(net, state, 30)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-4)


def test_mxu4_matches_jax():
    # tests/test_models.py::TestMxu4::test_exact_multi_chunk
    jnet, s, net, state = _pair(0.1, seed=3, key=1, n_conn=16)
    ref = jax.jit(lambda st: jnet.run(40, 20.0, st))(s)
    want = jps.einet_pallas_sim_mxu4(jnet, s, 40, 20.0, row_chunk=2)
    got = sim.einet_pallas_sim_mxu4(net, state, 40, 20.0, row_chunk=2)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref.g_e))


def test_chain_matches_jax_run():
    # the JAX package has no test of chain; hold it to jax.jit's loop
    jnet, s, net, state = _pair(0.1, seed=1, key=2)
    ref = jax.jit(lambda st: jnet.run(200, state=st))(s)
    got = sim.einet_pallas_sim_chain(net, state, 200)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(ref.spike_count))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref.neurons.v))


def test_mxu4_takes_an_in_degree_above_255():
    # the JAX function refuses it (tests/test_models.py:639, its 8-bit
    # packed fields); K2's int32 counts do not need the refusal
    conn = np.zeros((200, 8), np.int32)
    net = EINet(scale=0.05, n_conn=8, conn_all=conn, device='cpu')
    state = net.init_state()
    out = sim.einet_pallas_sim_mxu4(net, state, 30, 500.0)
    assert int(out[4].sum()) > 0
    _equal(out, sim.einet_pallas_sim_mxu3(net, state, 30, 500.0))
    _equal(out, sim.einet_pallas_sim_dense(net, state, 30, 500.0))


# -- the strategies' route: K21 ``einet_sim`` (its twin on the CPU) ------------------

def _burst(net):
    """The net's initial state with every neuron above threshold and none
    refractory: at inp 500 every neuron fires at the first step."""
    s = net.init_state()
    v = net.params.v_th + torch.rand(net.num, generator=torch.Generator()
                                     .manual_seed(4))
    return s._replace(neurons=s.neurons._replace(
        v=v, t_last=torch.full_like(s.neurons.t_last, -1e7)))


@pytest.mark.parametrize('n', [0, 1, 2, 300])
@pytest.mark.parametrize('coba', [True, False], ids=['coba', 'cuba'])
def test_einet_sim_twin_bitwise_einet_loop_on_a_burst(coba, n):
    from brainevent_torch.models import networks as nw
    from brainevent_torch.ops import scatter as sc
    net = EINet(scale=0.1, coba=coba, seed=8, device='cpu')
    state = _burst(net)
    want = nw.einet_loop(
        state.neurons.v, state.neurons.t_last, state.g_e, state.g_i,
        state.spike_count, net.times(n), net.step_params(500.0),
        lambda ids, n_ids, counts: sc.event_count_scatter_twin(
            ids, n_ids, net.conn_all, net.n_exc, counts),
        step_op=nw.einet_step_twin)
    got = einet_pallas_sim(net, state, n, 500.0)
    _equal(got, want)
    if n:
        assert int(got[4].min()) >= 1              # every neuron fired


@pytest.mark.parametrize('strategy', ['mxu3', 'mxu6', 'mxu', 'chain', 'mxu2',
                                      'mxu4', 'mxu5'])
def test_strategies_run_einet_sim_once(monkeypatch, strategy):
    """Each K21 strategy is one ``einet_sim`` call per run (a spy on its
    twin); so is dense, through K21's table instance."""
    from brainevent_torch.models import networks as nw
    calls = []
    twin = nw.einet_sim.twin

    def spy(*args, **kwargs):
        calls.append(args[6].numel())
        return twin(*args, **kwargs)
    monkeypatch.setattr(nw.einet_sim, 'twin', spy)
    net = EINet(scale=0.05, device='cpu')
    state = net.init_state()
    einet_pallas_sim(net, state, 12, strategy=strategy)
    assert calls == [12]
    einet_pallas_sim(net, state, 12, strategy='dense')
    assert calls == [12, 12]
