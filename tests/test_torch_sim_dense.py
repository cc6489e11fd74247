# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""The dense strategy of ``brainevent_torch.models.sim`` (kernel K21's
table instance over the connection-count table, K19 above its capacity)
against the JAX package; the superseded strategies are held in
``test_torch_sim.py``.

On the CPU the port runs the twins of K21 (the loop of K1's and K19's
twins when given a table), K1, K2 and K19; the JAX package runs its
Pallas kernels in interpret mode, as ``tests/test_models.py`` does. The
bars are that file's: spike counts equal, ``v`` to atol 1e-4 (the Pallas
kernels' layout is not the XLA step's, so a few ulps may differ), and the
port's own routes bitwise equal to each other, since K2, K19 and K21
count the same integer hits.
"""

import jax
import numpy as np
import pytest
import torch

from brainevent_tpu.models import EINet as JEINet
from brainevent_tpu.models import pallas_sim as jps
from brainevent_torch.interop import einet_from_arrays
from brainevent_torch.models import EINet, sim
from brainevent_torch.models import networks as nw
from brainevent_torch.ops import scatter as ts

from _torch_one_thread import one_torch_thread  # noqa: F401


def _pair(scale, coba=True, seed=42, key=None):
    jnet = JEINet(scale=scale, coba=coba, seed=seed)
    s = jnet.init_state(None if key is None else jax.random.PRNGKey(key))
    net, state = einet_from_arrays(
        np.asarray(jnet.conn_all), jnet.n_exc, s.neurons.v, s.neurons.t_last,
        s.g_e, s.g_i, s.spike_count, scale=scale, coba=coba, device='cpu')
    return jnet, s, net, state


def _counts_equal(got, want):
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))


def _bitwise(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_dense_matches_jax_dense_interpret():
    # mirrors tests/test_models.py::test_dense_strategy_matches_xla_loop
    jnet, s, net, state = _pair(0.1, seed=1, key=2)
    want = jps.einet_pallas_sim(jnet, s, 30, strategy='dense')
    got = sim.einet_pallas_sim(net, state, 30, strategy='dense')
    _counts_equal(got, want)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-4)
    assert int(got[4].sum()) > 0


@pytest.mark.parametrize('coba', [True, False], ids=['coba', 'cuba'])
def test_dense_matches_jax_run_at_4k(coba):
    jnet, s, net, state = _pair(1.0, coba)
    ref = jax.jit(lambda st: jnet.run(2000, state=st))(s)
    got = sim.einet_pallas_sim_dense(net, state, 2000)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(ref.spike_count))
    # the K1/K2 twins equal jax.jit's loop bitwise, so the dense route does
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref.neurons.v))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref.g_e))
    rate = float(got[4].float().mean()) / (2000 * 0.1e-3)
    assert 5.0 < rate < 200.0


@pytest.mark.parametrize('coba', [True, False], ids=['coba', 'cuba'])
def test_dense_bitwise_the_k1_k2_twin_loop(coba):
    net = EINet(scale=0.5, coba=coba, seed=11, device='cpu')
    state = net.init_state()
    _bitwise(sim.einet_pallas_sim(net, state, 400, strategy='dense'),
             sim.einet_pallas_sim(net, state, 400, strategy='mxu3'))


def test_dense_burst_matches_jax():
    # mirrors tests/test_models.py::test_mxu3_multi_round_burst_exact: a
    # saturating drive, every neuron near threshold at once
    jnet, s, net, state = _pair(0.064, seed=3, key=0)
    ref = jax.jit(lambda st: jnet.run(10, 500.0, st))(s)
    want = jps.einet_pallas_sim_dense(jnet, s, 10, 500.0)
    got = sim.einet_pallas_sim_dense(net, state, 10, 500.0)
    assert int(got[4].sum()) > 100
    _counts_equal(got, want)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(ref.spike_count))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref.g_e))
    _bitwise(got, sim.einet_pallas_sim(net, state, 10, 500.0))


def _jax_count_table(conn):
    """The JAX package's construction (``pallas_sim.py:573-576``)."""
    num, n_conn = conn.shape
    w = np.zeros((num, num), np.float32)
    np.add.at(w, (np.repeat(np.arange(num), n_conn), conn.reshape(-1)), 1.0)
    return w


def test_dense_count_table_matches_the_jax_construction():
    jnet, _, net, _ = _pair(0.1, seed=4)
    table = sim.dense_count_table(net)
    assert table.dtype == torch.uint8 and table.shape == (net.num, net.num)
    np.testing.assert_array_equal(table.numpy(),
                                  _jax_count_table(np.asarray(jnet.conn_all)))


def test_dense_count_table_int32_above_255():
    rng = np.random.default_rng(5)
    num, n_conn = 400, 300
    conn = rng.integers(0, num, (num, n_conn)).astype(np.int32)
    conn[7, :280] = 3                      # the edge 7 -> 3, 280 times
    conn[9, ::2] = 12
    net = EINet(scale=0.1, n_conn=n_conn, conn_all=conn, device='cpu')
    table = sim.dense_count_table(net)
    assert table.dtype == torch.int32
    assert int(table[7, 3]) >= 280
    np.testing.assert_array_equal(table.numpy(), _jax_count_table(conn))
    # the counts are int32 end to end: K19's twin equals K2's on this table
    ids = torch.arange(num, dtype=torch.int32)
    n_ids = torch.tensor([num], dtype=torch.int32)
    got = sim.einet_dense_hits_twin(ids, n_ids, table, net.n_exc,
                                    torch.zeros(2, num, dtype=torch.int32))
    from brainevent_torch.ops import scatter as sc
    want = sc.event_count_scatter_twin(ids, n_ids, net.conn_all, net.n_exc,
                                       torch.zeros(2, num, dtype=torch.int32))
    assert torch.equal(got, want)


def test_dense_count_table_drops_targets_outside_the_net():
    conn = np.random.default_rng(7).integers(-3, 13, (10, 3)).astype(np.int32)
    conn[2] = 3
    net = EINet(scale=0.0025, n_conn=3, conn_all=conn, device='cpu')
    assert net.num == 10
    want = np.zeros((10, 10), np.uint8)
    for i, row in enumerate(conn):
        for j in row:
            if 0 <= j < 10:
                want[i, j] += 1
    assert want[2, 3] == 3 and (conn < 0).any() and (conn >= 10).any()
    np.testing.assert_array_equal(sim.dense_count_table(net).numpy(), want)


def test_memory_guard_raises_at_400k():
    net = EINet(scale=100.0, device='cpu')
    assert net.num == 400_000
    with pytest.raises(ValueError, match='160000000000 bytes'):
        sim.dense_count_table(net)
    with pytest.raises(ValueError, match='budget'):
        sim.einet_pallas_sim(net, net.init_state(), 1, strategy='dense')


def test_memory_guard_names_the_budget(monkeypatch):
    net = EINet(scale=0.1, device='cpu')
    monkeypatch.setattr(sim, 'CPU_TABLE_BUDGET', 400 * 400 - 1)
    with pytest.raises(ValueError, match=f'budget of {400 * 400 - 1} bytes'):
        sim.dense_count_table(net)


def _oracle(ids, n_ids, table, n_exc):
    """``masks(2, num) @ table``, the JAX kernel's product, in numpy."""
    num = table.shape[0]
    masks = np.zeros((2, num), np.int64)
    for i in ids[:max(0, min(n_ids, num))]:
        if 0 <= i < num:
            masks[int(i >= n_exc), i] += 1
    return masks @ table.astype(np.int64)


@pytest.mark.parametrize('case', ['empty', 'one', 'all', 'out_of_range',
                                  'long_count'])
def test_k19_twin_vs_the_mask_product(case):
    rng = np.random.default_rng(6)
    num, n_exc = 300, 240
    conn = rng.integers(0, num, (num, 40)).astype(np.int32)
    table = _jax_count_table(conn).astype(np.uint8)
    ids = rng.permutation(num).astype(np.int32)
    n = {'empty': 0, 'one': 1, 'all': num, 'out_of_range': 50,
         'long_count': 10 ** 6}[case]
    if case == 'out_of_range':
        ids[:50:3] = [-1, num, 10 ** 6, -7, num + 1, 2 ** 31 - 1, -2 ** 31,
                      num, -1, 5 * num, 3 * num, -4, num + 9, -8, 2 * num,
                      num, -3][:len(range(0, 50, 3))]
    counts = torch.from_numpy(rng.integers(0, 9, (2, num)).astype(np.int32))
    start = counts.clone()
    got = sim.einet_dense_hits(torch.from_numpy(ids),
                               torch.tensor([n], dtype=torch.int32),
                               torch.from_numpy(table), n_exc, counts)
    assert got is counts
    want = start.numpy() + _oracle(ids, n, table, n_exc)
    np.testing.assert_array_equal(counts.numpy(), want)


def test_dense_runs_the_twins_not_kernels_on_cpu():
    net = EINet(scale=0.05, device='cpu')
    ops = (nw.einet_step, sim.einet_dense_hits, nw.einet_sim)
    before = [op.launches for op in ops]
    sim.einet_pallas_sim_dense(net, net.init_state(), 20)
    assert [op.launches for op in ops] == before


# -- K21's table instance: its twin, einet_sim with a table --------------------------

def _fields(x):
    if isinstance(x, tuple) and len(x) == 5:
        return x
    return (x.neurons.v, x.neurons.t_last, x.g_e, x.g_i, x.spike_count)


def _k19_twin_loop(net, state, n, table, inp=20.0):
    """The loop of the K1 and K19 twins, the dense route K21's table
    instance replaced."""
    return nw.einet_loop(
        *_fields(state), net.times(n), net.step_params(inp),
        lambda ids, n_ids, counts: nw.einet_dense_hits_twin(
            ids, n_ids, table, net.n_exc, counts),
        step_op=nw.einet_step_twin)


def _k2_twin_loop(net, state, n, inp=20.0):
    return nw.einet_loop(
        *_fields(state), net.times(n), net.step_params(inp),
        lambda ids, n_ids, counts: ts.event_count_scatter_twin(
            ids, n_ids, net.conn_all, net.n_exc, counts),
        step_op=nw.einet_step_twin)


def _table_sim(net, state, n, table, inp=20.0):
    """One einet_sim call with the table (its twin here) on a copy."""
    got = [x.clone() for x in _fields(state)]
    nw.einet_sim(*got, net.conn_all,
                 torch.tensor(net.times(n), dtype=torch.float32),
                 net.step_params(inp), net.n_exc, table=table)
    return got


@pytest.mark.parametrize('coba', [True, False], ids=['coba', 'cuba'])
def test_einet_sim_table_twin_bitwise_k19_loop_and_jax_dense(coba):
    """einet_sim's twin over the table: bitwise the K1/K19 twin loop and
    the K1/K2 twin loop; against JAX's einet_pallas_sim_dense in
    interpret mode, this file's bar (spike counts equal, v to 1e-4)."""
    jnet, s, net, state = _pair(0.1, coba, seed=1, key=2)
    table = sim.dense_count_table(net)
    got = _table_sim(net, state, 30, table)
    _bitwise(got, _k19_twin_loop(net, state, 30, table))
    _bitwise(got, _k2_twin_loop(net, state, 30))
    want = jps.einet_pallas_sim_dense(jnet, s, 30)
    _counts_equal(got, want)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-4)
    assert int(got[4].sum()) > 0


@pytest.mark.parametrize('n', [1, 2, 40])
@pytest.mark.parametrize('coba', [True, False], ids=['coba', 'cuba'])
def test_einet_sim_table_twin_on_an_all_fire_burst(coba, n):
    """Every neuron above threshold and none refractory at inp 500: all
    fire at the first step; bitwise the K1/K19 and K1/K2 twin loops."""
    net = EINet(scale=0.1, coba=coba, seed=7, device='cpu')
    s = net.init_state()
    v = net.params.v_th + torch.rand(net.num, generator=torch.Generator()
                                     .manual_seed(3))
    state = s._replace(neurons=s.neurons._replace(
        v=v, t_last=torch.full_like(v, -1e7)))
    table = sim.dense_count_table(net)
    got = _table_sim(net, state, n, table, 500.0)
    assert int(got[4].min()) >= 1
    _bitwise(got, _k19_twin_loop(net, state, n, table, 500.0))
    _bitwise(got, _k2_twin_loop(net, state, n, 500.0))
    _bitwise(got, sim.einet_pallas_sim_dense(net, state, n, 500.0))


def test_einet_sim_int32_table_twin_bitwise_the_loops():
    """An int32 table (the edge 7 -> 3 280 times, a multiplicity above
    255): einet_sim's twin bitwise the K1/K19 and K1/K2 twin loops, and
    the dense strategy bitwise mxu3."""
    rng = np.random.default_rng(5)
    num, n_conn = 400, 300
    conn = rng.integers(0, num, (num, n_conn)).astype(np.int32)
    conn[7, :280] = 3
    net = EINet(scale=0.1, n_conn=n_conn, conn_all=conn, device='cpu')
    table = sim.dense_count_table(net)
    assert table.dtype == torch.int32 and int(table[7, 3]) >= 280
    state = net.init_state()
    got = _table_sim(net, state, 100, table)
    assert int(got[4].sum()) > 0
    _bitwise(got, _k19_twin_loop(net, state, 100, table))
    _bitwise(got, _k2_twin_loop(net, state, 100))
    _bitwise(sim.einet_pallas_sim_dense(net, state, 100),
             sim.einet_pallas_sim(net, state, 100, strategy='mxu3'))


def test_dense_calls_einet_sim_once_a_run(monkeypatch):
    """einet_pallas_sim_dense is one einet_sim call a run, with the table
    (a spy on its twin): K21's table instance on a card."""
    calls = []
    twin = nw.einet_sim.twin

    def spy(*args, **kwargs):
        table = kwargs.get('table')
        calls.append((args[6].numel(), None if table is None
                      else tuple(table.shape)))
        return twin(*args, **kwargs)
    monkeypatch.setattr(nw.einet_sim, 'twin', spy)
    net = EINet(scale=0.05, device='cpu')
    state = net.init_state()
    sim.einet_pallas_sim_dense(net, state, 12)
    assert calls == [(12, (net.num, net.num))]
    sim.einet_pallas_sim(net, state, 7, strategy='dense')
    assert calls[1:] == [(7, (net.num, net.num))]
