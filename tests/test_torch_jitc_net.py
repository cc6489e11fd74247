# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""JITCNet of brainevent_torch against brainevent_tpu on the CPU.

From one state carried across (``jitc_net_from_arrays``), a port step
equals ``jax.jit(JITCNet.step)``: spikes bitwise and the synaptic drives
within 1e-5 relative (bitwise for the scalar law). Over 300 steps from
the JAX initial state, the scalar law gives the JAX spike counts exactly;
the normal and uniform laws (whose weights may differ in the last bit,
``brainevent_torch/rng/light.py``) a rate within 2% of the JAX rate and
in 1-200 Hz. The JAX package's own JITCNet tests (a dense-matrix oracle,
no weight storage) are mirrored on the port.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import brainevent_torch as bt
from brainevent_tpu.models import JITCNet as JNet

from _torch_one_thread import one_torch_thread  # noqa: F401

LAWS = ['scalar', 'normal', 'uniform']


def _kw(coba):
    return {} if coba else dict(w_e=0.3, w_i=1.0)


def _carry(jnet, s, law, scale, coba):
    a = np.asarray
    return bt.jitc_net_from_arrays(
        a(s.neurons.v), a(s.neurons.t_last), a(s.g_e), a(s.g_i),
        a(s.spike_count), scale=scale, weight_law=law, coba=coba,
        seed=jnet.seed, device='cpu', **_kw(coba))


@pytest.mark.parametrize('coba', [True, False], ids=['coba', 'cuba'])
@pytest.mark.parametrize('scale', [0.05, 0.1])
@pytest.mark.parametrize('law', LAWS)
def test_one_step_matches_jax(law, scale, coba):
    jnet = JNet(scale=scale, weight_law=law, coba=coba, **_kw(coba))
    rng = np.random.default_rng(int(scale * 100))
    n = jnet.num
    s = jnet.init_state()
    s = s._replace(
        neurons=s.neurons._replace(
            v=jnp.asarray(rng.uniform(-52.0, -49.5, n), jnp.float32)),
        g_e=jnp.asarray(rng.uniform(0.0, 1.0, n), jnp.float32),
        g_i=jnp.asarray(rng.uniform(0.0, 1.0, n), jnp.float32))
    net, state = _carry(jnet, s, law, scale, coba)
    want = jax.jit(lambda st: jnet.step(st, jnp.float32(0.0), 80.0))(s)
    got = net.step(state, 0.0, 80.0)
    spikes = np.asarray(want.spike_count)
    assert spikes.sum() >= 10
    np.testing.assert_array_equal(got.spike_count.numpy(), spikes)
    np.testing.assert_array_equal(got.neurons.v.numpy(),
                                  np.asarray(want.neurons.v))
    for g, w in ((got.g_e, want.g_e), (got.g_i, want.g_i)):
        if law == 'scalar':
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=0)


@pytest.mark.parametrize('coba', [True, False], ids=['coba', 'cuba'])
@pytest.mark.parametrize('law', LAWS)
def test_300_steps_from_the_jax_state(law, coba):
    scale, n_steps = 0.1, 300
    jnet = JNet(scale=scale, weight_law=law, coba=coba, **_kw(coba))
    s0 = jnet.init_state()
    want = jax.jit(lambda st: jnet.run(n_steps, state=st))(s0)
    net, state = _carry(jnet, s0, law, scale, coba)
    got = net.run(n_steps, state=state)
    rate = float(net.firing_rate_hz(got, n_steps))
    rate_jax = float(jnet.firing_rate_hz(want, n_steps))
    assert 1.0 < rate < 200.0, rate
    if law == 'scalar':
        np.testing.assert_array_equal(got.spike_count.numpy(),
                                      np.asarray(want.spike_count))
    else:
        assert abs(rate - rate_jax) <= 0.02 * rate_jax, (rate, rate_jax)


@pytest.mark.parametrize('law', LAWS)
def test_step_matches_dense_oracle(law):
    """One propagation step == spikes @ todense() of the same matrices
    (the JAX package's oracle test, on the port)."""
    net = bt.JITCNet(scale=0.05, weight_law=law, device='cpu')
    state = net.init_state()
    rng = np.random.default_rng(0)
    v0 = torch.from_numpy(rng.uniform(-52.0, -49.5, net.num).astype(
        np.float32))
    state = state._replace(neurons=state.neurons._replace(v=v0))
    s1 = net.step(state, 0.0, inp=80.0)
    De = net.conn_e.todense().numpy()
    Di = net.conn_i.todense().numpy()
    p = net.params
    g_e = state.g_e.numpy() * math.exp(-net.dt / net.tau_e)
    g_i = state.g_i.numpy() * math.exp(-net.dt / net.tau_i)
    v = state.neurons.v.numpy()
    cur = g_e * (net.e_e - v) + g_i * (net.e_i - v) + 80.0
    refr = (0.0 - state.neurons.t_last.numpy()) < p.tau_ref
    v2 = np.where(refr, v, v + (p.v_rest - v + p.r * cur) * (net.dt / p.tau))
    spk = v2 >= p.v_th
    assert spk.sum() >= 10
    inc_e = spk[:net.n_exc].astype(np.float32) @ De
    inc_i = spk[net.n_exc:].astype(np.float32) @ Di
    np.testing.assert_allclose(s1.g_e.numpy(), g_e + inc_e, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(s1.g_i.numpy(), g_i + inc_i, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(s1.spike_count.numpy(), spk)


def test_cuba_variant_runs():
    net = bt.JITCNet(scale=0.05, weight_law='scalar', coba=False, w_e=0.3,
                     w_i=1.0, device='cpu')
    final = net.run(100)
    assert int(final.spike_count.sum()) >= 0
    assert bool(torch.isfinite(final.neurons.v).all())


def test_no_weight_storage():
    """Model memory holds no O(n^2) or O(nnz) connectivity buffer; the
    plans' streams are O(n * 128)."""
    net = bt.JITCNet(scale=0.25, device='cpu')
    for p in (*net.conn_e.data, *net.conn_i.data):
        assert np.asarray(p).size <= 1
    words = sum(t.numel() for t in (*net.plan_e.setup[:2],
                                    *net.plan_i.setup[:2]))
    assert words < 4 * net.num * 128


def test_bad_weight_law():
    with pytest.raises(ValueError, match='weight_law'):
        bt.JITCNet(scale=0.05, weight_law='lognormal', device='cpu')


def test_carried_state_is_checked():
    with pytest.raises(ValueError, match='scale'):
        bt.jitc_net_from_arrays(*(np.zeros(7, np.float32),) * 4,
                                np.zeros(7, np.int32), scale=0.05,
                                weight_law='scalar', coba=True, device='cpu')
