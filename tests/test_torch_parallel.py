# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""brainevent_torch.parallel's ShardedEINet (K22's twin on each rank),
mega_local_counts (K20's twin) and balance_csr_shards against
brainevent_tpu.parallel's; K22's twin against the parent's K1 + K20 twin
loop.

The JAX side runs on 4 devices of the 8-device virtual CPU mesh
(``tests/conftest.py``); its Pallas mega-kernel runs in interpret mode,
as the JAX package's own tests run it. The port's ShardedEINet runs on 4
gloo ranks (``tests/_torch_dist.py``, one spawn for the file) from the
JAX network's table and state, carried across as numpy arrays
(``interop.sharded_einet_from_arrays``). The bar is the JAX package's own
(``tests/test_parallel_ops.py:349-381``): all five state fields bitwise,
for the scatter route (COBA and CUBA, 1,000 neurons, 80 steps) and the
mxu6 route (512 neurons, 15 single steps and a 40-step run); each step
makes exactly one reduce-scatter, of ``2 * num * 4`` bytes, and no other
collective. Where the JAX route refuses (a shard width that is not a
multiple of 128, an in-degree above 255), the port's mxu6 route is held
bitwise to its scatter route.
"""

import jax
import numpy as np
import pytest
import torch

from brainevent_tpu.models import EINet as JEINet
from brainevent_tpu import parallel as jpar
from brainevent_tpu.parallel import mega as jmega
from brainevent_torch import parallel as par
from brainevent_torch.parallel import mega as tmega

import _torch_dist
from _torch_one_thread import one_torch_thread  # noqa: F401

FIELDS = ('v', 't_last', 'g_e', 'g_i', 'spike_count')
LABELS = ('coba', 'cuba', 'mxu6_step', 'mxu6_run')


def _jax_runs():
    """``(inputs, finals)`` of the JAX ShardedEINet runs, keyed
    ``'label:field'``."""
    mesh = jpar.neuron_mesh(4)
    nets = {}
    for coba in (True, False):
        einet = JEINet(scale=0.25, coba=coba, seed=7)
        snet = jpar.ShardedEINet.from_einet(einet, mesh)
        nets['coba' if coba else 'cuba'] = (snet, snet.init_state_from(
            einet.init_state()))
    for label, n_conn, seed in (('mxu6_step', 16, 3), ('mxu6_run', 24, 9)):
        snet = jpar.ShardedEINet(mesh=mesh, num=512, n_conn=n_conn,
                                 propagate='mxu6', seed=seed)
        nets[label] = (snet, snet.init_state())
    inputs, finals = {}, {}
    for label, (snet, s0) in nets.items():
        for k in FIELDS:
            inputs[f'{label}:{k}'] = np.asarray(getattr(s0, k))
        inputs[f'{label}:indices'] = np.asarray(snet.indices)
        inputs[f'{label}:n_exc'] = np.array(snet.n_exc)
        inputs[f'{label}:coba'] = np.array(snet.coba)
        if label == 'mxu6_step':
            step = jax.jit(snet.step_fn())
            s = s0
            for i in range(_torch_dist.MXU6_STEPS):
                s = step(s, i * 0.1)
        else:
            n = (_torch_dist.MXU6_RUN_STEPS if label == 'mxu6_run'
                 else _torch_dist.EINET_STEPS)
            s = jax.jit(lambda st, net=snet, n=n: net.run(n, state=st))(s0)
        for k in FIELDS:
            finals[f'{label}:{k}'] = np.asarray(getattr(s, k))
    return inputs, finals


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """``(want, got)``: the JAX runs' final states and the port's."""
    inputs, want = _jax_runs()
    tmp = tmp_path_factory.mktemp('einet')
    np.savez(tmp / 'jax_in.npz', **inputs)
    got = _torch_dist.spawn('einet', 4, tmp)
    return want, got, inputs


@pytest.mark.parametrize('label', LABELS)
@pytest.mark.parametrize('field', FIELDS)
def test_sharded_einet_bitwise_vs_jax(runs, label, field):
    want, got, _ = runs
    key = f'{label}:{field}'
    assert got[key].dtype == want[key].dtype
    np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize('label', LABELS)
def test_network_is_live(runs, label):
    want, _, _ = runs
    assert int(want[f'{label}:spike_count'].sum()) > 0


@pytest.mark.parametrize('label', LABELS)
def test_one_reduce_scatter_of_2_num_4_bytes_per_step(runs, label):
    _, got, inputs = runs
    num = inputs[f'{label}:v'].shape[0]
    n_steps = {'mxu6_step': _torch_dist.MXU6_STEPS,
               'mxu6_run': _torch_dist.MXU6_RUN_STEPS}.get(
                   label, _torch_dist.EINET_STEPS)
    calls = list(got[f'{label}:calls'])
    assert calls == ['reduce_scatter_tensor'] * n_steps
    assert set(got[f'{label}:bytes'].tolist()) == {2 * num * 4}


@pytest.mark.parametrize('label', ['unaligned', 'indegree300'])
@pytest.mark.parametrize('field', FIELDS)
def test_mxu6_where_jax_refuses_equals_scatter_route(runs, label, field):
    _, got, _ = runs
    np.testing.assert_array_equal(got[f'{label}:{field}:mxu6'],
                                  got[f'{label}:{field}:scatter'])
    assert int(got[f'{label}:spike_count:scatter'].sum()) > 0


def test_jax_refuses_what_the_port_takes():
    mesh = jpar.neuron_mesh(4)
    with pytest.raises(ValueError):
        jpar.ShardedEINet(mesh=mesh, num=4 * 64, n_conn=8, propagate='mxu6')
    conn, _ = _torch_dist.einet_inputs(11, 512, 409, 16, deg=300)
    with pytest.raises(ValueError, match='255'):
        jmega.MegaScatterLayout(conn, 409, 512)


# -- mega_local_counts on one shard ---------------------------------------------------

@pytest.mark.parametrize('shard', [0, 3])
def test_mega_local_counts_equal_jax(shard):
    num, n_conn, n_dev = 512, 16, 4
    n_exc, n_loc = int(num * 0.8), num // n_dev
    rng = np.random.default_rng(40 + shard)
    conn = rng.integers(0, num, (num, n_conn)).astype(np.int32)
    spike = rng.random(n_loc) < 0.2
    layout = jmega.MegaScatterLayout(conn, n_exc, num)
    lr = layout.lr
    conn_loc = layout.conn_flat[shard * n_loc * lr:(shard + 1) * n_loc * lr]
    want = jmega.mega_local_counts(spike, conn_loc, layout.pmap,
                                   layout=layout)
    tl = tmega.MegaScatterLayout(conn, n_exc, num)
    got = tmega.mega_local_counts(
        torch.from_numpy(spike),
        tl.conn_flat[shard * n_loc:(shard + 1) * n_loc], layout=tl,
        row0=shard * n_loc)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_mega_counts_twin_shard_major_sums_to_k2():
    # the four shards' (n_dev, 2, n_loc) partials, summed, are K2's counts
    from brainevent_torch.ops import scatter as ts
    num, n_conn, n_dev = 640, 12, 4
    n_exc, n_loc = int(num * 0.8), num // n_dev
    rng = np.random.default_rng(5)
    conn = torch.from_numpy(rng.integers(0, num, (num, n_conn)).astype(
        np.int32))
    ids = torch.from_numpy(rng.permutation(num).astype(np.int32))
    n_act = torch.tensor([200], dtype=torch.int32)
    want = ts.event_count_scatter_twin(ids, n_act, conn, n_exc,
                                       torch.zeros(2, num, dtype=torch.int32))
    total = torch.zeros(n_dev, 2, n_loc, dtype=torch.int32)
    sel = ids[:200]
    for r in range(n_dev):
        loc = sel[(sel >= r * n_loc) & (sel < (r + 1) * n_loc)] - r * n_loc
        ids_r = torch.zeros(n_loc, dtype=torch.int32)
        ids_r[:loc.numel()] = loc
        tmega.mega_counts_twin(ids_r, torch.tensor([loc.numel()],
                                                   dtype=torch.int32),
                               conn[r * n_loc:(r + 1) * n_loc], r * n_loc,
                               n_exc, total)
    assert torch.equal(total.transpose(0, 1).reshape(2, num), want)


# -- K22: the sharded step in one launch (its twin) --------------------------------------

def _shards_run(net, n_dev, n_steps, fused):
    """*n_steps* of *net* split over *n_dev* shards in one process, the
    reduce-scatter a sum over the shards: a step is K22's twin on each
    shard (*fused*), or the parent's K1 twin, a memset and K20's twin;
    a last fold. Returns the five global arrays."""
    from brainevent_torch.models import networks as nw
    num, n_loc = net.num, net.num // n_dev
    s = net.init_state()
    cut = [[x[r * n_loc:(r + 1) * n_loc].clone() for x in (
        s.neurons.v, s.neurons.t_last, s.g_e, s.g_i, s.spike_count)]
        for r in range(n_dev)]
    counts = [torch.zeros(2, n_loc, dtype=torch.int32) for _ in range(n_dev)]
    parts = [torch.zeros(2, n_dev, 2, n_loc, dtype=torch.int32)
             for _ in range(n_dev)]
    ids = [torch.zeros(n_loc, dtype=torch.int32) for _ in range(n_dev)]
    n_ids = [torch.zeros(2, dtype=torch.int32) for _ in range(n_dev)]
    p = net.step_params()
    p.num = n_loc

    def launch(r, t, parity, fold, step):
        v, t_last, g_e, g_i, spike_count = cut[r]
        conn = net.conn_all[r * n_loc:(r + 1) * n_loc]
        if fused:
            tmega.einet_shard_step_twin(v, t_last, g_e, g_i, counts[r],
                                        spike_count, parts[r], conn,
                                        r * n_loc, net.n_exc, p, t, parity,
                                        fold, step)
            return
        nw.einet_step_twin(v, t_last, g_e, g_i, counts[r], spike_count,
                           ids[r], n_ids[r], p, t, parity, fold, step)
        if step:
            parts[r][parity].zero_()
            tmega.mega_counts_twin(ids[r], n_ids[r][parity:parity + 1],
                                   conn, r * n_loc, net.n_exc,
                                   parts[r][parity])

    for k, t in enumerate(net.times(n_steps)):
        for r in range(n_dev):
            launch(r, t, k & 1, k > 0, True)
        total = sum(parts[r][k & 1] for r in range(n_dev))
        for r in range(n_dev):
            counts[r].copy_(total[r])
    for r in range(n_dev):
        launch(r, 0.0, 0, True, False)
    return [torch.cat([cut[r][i] for r in range(n_dev)]) for i in range(5)]


@pytest.mark.parametrize('coba', [True, False], ids=['coba', 'cuba'])
@pytest.mark.parametrize('n_dev', [1, 4])
def test_k22_twin_bitwise_k1_k20_twin_loop(n_dev, coba):
    """K22's twin on 1 and 4 shards in one process (the reduce-scatter a
    sum over the shards), 60 steps: all five arrays bitwise the parent's
    K1 + memset + K20 twin loop, and the single-device run."""
    from brainevent_torch.models import EINet
    net = EINet(scale=0.16, coba=coba, seed=21, device='cpu')
    got = _shards_run(net, n_dev, 60, fused=True)
    want = _shards_run(net, n_dev, 60, fused=False)
    ref = net.run(60)
    for x, y, z in zip(got, want, (ref.neurons.v, ref.neurons.t_last,
                                   ref.g_e, ref.g_i, ref.spike_count)):
        assert x.dtype == y.dtype == z.dtype
        assert torch.equal(x, y) and torch.equal(x, z)
    assert int(got[4].sum()) > 0


def test_k22_twin_leaves_counts_and_zeroes_the_other_parity():
    from brainevent_torch.models import EINet
    net = EINet(scale=0.1, seed=3, device='cpu')
    p = net.step_params(500.0)
    s = net.init_state()
    v = net.params.v_th + torch.rand(net.num, generator=torch.Generator()
                                     .manual_seed(3))
    bufs = [v, torch.full_like(v, -1e7), s.g_e.clone(), s.g_i.clone()]
    counts = torch.ones(2, net.num, dtype=torch.int32)
    spike_count = torch.zeros(net.num, dtype=torch.int32)
    parts = torch.full((2, 1, 2, net.num), 9, dtype=torch.int32)
    parts[1].zero_()                    # the previous step zeroed parity 1
    tmega.einet_shard_step_twin(*bufs, counts, spike_count, parts,
                                net.conn_all, 0, net.n_exc, p, 0.0, 1,
                                True, True)
    assert int(spike_count.min()) == 1              # every neuron fired
    assert bool((counts == 1).all())
    assert int(parts[0].abs().sum()) == 0
    want = tmega.mega_counts_twin(
        torch.arange(net.num, dtype=torch.int32),
        torch.tensor([net.num], dtype=torch.int32), net.conn_all, 0,
        net.n_exc, torch.zeros(1, 2, net.num, dtype=torch.int32))
    assert torch.equal(parts[1], want)
    tmega.einet_shard_step_twin(*bufs, counts, spike_count, parts,
                                net.conn_all, 0, net.n_exc, p, 0.0, 0,
                                True, False)               # a fold alone
    assert torch.equal(parts[1], want) and int(parts[0].abs().sum()) == 0


# -- balance_csr_shards ---------------------------------------------------------------

def _structure(kind, rng):
    m, k = 1000, 1000
    if kind == 'skewed':
        counts = np.concatenate([rng.integers(50, 100, 100),
                                 rng.integers(0, 2, m - 100)])
    else:
        counts = rng.integers(0, 10, m)
    nse = int(counts.sum())
    indices = rng.integers(0, k, nse).astype(np.int32)
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return indices, indptr, (m, k)


@pytest.mark.parametrize('kind', ['ragged', 'skewed'])
@pytest.mark.parametrize('n_dev', [4, 8])
def test_balance_csr_shards_equals_jax(kind, n_dev):
    indices, indptr, shape = _structure(kind, np.random.default_rng(n_dev))
    want = jpar.balance_csr_shards(indices, indptr, n_dev, shape=shape)
    got = par.balance_csr_shards(indices, indptr, n_dev, shape=shape)
    assert (got.n_dev, got.shape, got.rows_loc, got.nse_loc) == (
        want.n_dev, want.shape, want.rows_loc, want.nse_loc)
    for name in ('indices_pad', 'counts_pad', 'row_pos', 'nse_pos'):
        np.testing.assert_array_equal(getattr(got, name),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    w = np.random.default_rng(1).normal(size=indices.shape[0]).astype(
        np.float32)
    np.testing.assert_array_equal(
        got.pad_weights(torch.from_numpy(w)).numpy(),
        np.asarray(want.pad_weights(w)))
