# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""brainevent_torch.models.sim.einet_pallas_sim against the JAX package.

On the CPU the port runs the twins of kernels K1 and K2; the JAX package
runs its Pallas kernels in interpret mode, as ``tests/test_models.py``
does. The checks mirror that file: spike counts equal, ``v`` to atol 1e-4
(the Pallas kernels' own bar against the XLA loop; their layout is not
the XLA step's, so a few ulps may differ), and ``g_e`` equal through a
burst that overflows every capacity the TPU kernels have.
"""

import jax
import numpy as np
import pytest
import torch

from brainevent_tpu.models import EINet as JEINet
from brainevent_tpu.models.pallas_sim import (
    einet_pallas_sim as j_sim, einet_pallas_sim_mxu3 as j_mxu3,
    einet_pallas_sim_mxu6 as j_mxu6)
from brainevent_torch.interop import einet_from_arrays
from brainevent_torch.models import EINet, einet_pallas_sim, mxu6_conn_table
from brainevent_torch.models.sim import STRATEGIES, _auto_strategy

from _torch_one_thread import one_torch_thread  # noqa: F401


def _pair(scale, coba=True, seed=42, key=None):
    jnet = JEINet(scale=scale, coba=coba, seed=seed)
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


def test_every_strategy_and_knob_runs_the_same_kernels():
    net = EINet(scale=0.1, seed=5, device='cpu')
    state = net.init_state()
    ref = einet_pallas_sim(net, state, 25)
    knobs = dict(rpb=384, group=4, radix='auto', prefetch=True,
                 dead_skip=True, cap_divisor=448, conn_table=None,
                 table_space='hbm', factors='fori', row_chunk=2)
    for strategy in STRATEGIES:
        out = einet_pallas_sim(net, state, 25, 20.0, None, strategy, **knobs)
        for a, b in zip(ref, out):
            assert torch.equal(a, b), strategy
    with pytest.raises(ValueError, match='strategy'):
        einet_pallas_sim(net, state, 1, strategy='mxu7')
    with pytest.raises(TypeError, match='unknown knobs'):
        einet_pallas_sim(net, state, 1, rbp=3)


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
