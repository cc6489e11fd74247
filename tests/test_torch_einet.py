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

N_STEPS = 2000


def _pair(scale, coba, seed=42):
    jnet = JEINet(scale=scale, coba=coba, seed=seed)
    s = jnet.init_state()
    net, state = einet_from_arrays(
        np.asarray(jnet.conn_all), jnet.n_exc, s.neurons.v, s.neurons.t_last,
        s.g_e, s.g_i, s.spike_count, scale=scale, coba=coba)
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
    net = EINet(scale=0.05)
    before = (tnet.einet_step.launches, ts.event_count_scatter.launches)
    net.run(20)
    assert (tnet.einet_step.launches,
            ts.event_count_scatter.launches) == before


@pytest.mark.parametrize('coba', [True, False], ids=['coba', 'cuba'])
def test_firing_rate_regime_own_draws(coba):
    # the port's own torch.Generator draws (not JAX's), same band as
    # tests/test_models.py::TestEINet::test_firing_rate_regime
    net = EINet(scale=0.25, coba=coba)
    state = net.run(3000)
    rate = float(net.firing_rate_hz(state, 3000))
    assert 5.0 < rate < 200.0, f'firing rate {rate} Hz out of regime'


def test_own_draws_are_seeded():
    a, b = EINet(scale=0.1, seed=9), EINet(scale=0.1, seed=9)
    assert torch.equal(a.conn_all, b.conn_all)
    assert torch.equal(a.init_state().neurons.v, b.init_state().neurons.v)
    assert a.conn_all.dtype == torch.int32
    assert a.conn_all.shape == (400, 80)
    assert int(a.conn_all.min()) >= 0 and int(a.conn_all.max()) < 400
    c = EINet(scale=0.1, seed=10)
    assert not torch.equal(a.conn_all, c.conn_all)


def test_einet_from_arrays_checks_shapes():
    jnet, s, net, state = _pair(0.1, True)
    assert net.init_state() is net.initial_state
    np.testing.assert_array_equal(net.conn_all.numpy(),
                                  np.asarray(jnet.conn_all))
    with pytest.raises(ValueError):
        einet_from_arrays(np.asarray(jnet.conn_all), jnet.n_exc + 1,
                          s.neurons.v, s.neurons.t_last, s.g_e, s.g_i,
                          s.spike_count, scale=0.1, coba=True)


def test_cuda_device_on_cpu_host_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(CUDANotInstalledError):
        EINet(scale=0.1, device='cuda')
