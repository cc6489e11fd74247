# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""brainevent_torch.ops.scatter against brainevent_tpu.ops.scatter.

The port's scatters are ``index_add_`` twins on the CPU and kernel K2
(``csrc/event_scatter.cu``) on a CUDA device; the kernel is tested against
the twin in ``tests/test_torch_cuda.py``. With 0/1 values every sum is
an integer below 2^24, so the results are bitwise equal to the JAX
package's at any add order. With float values the two packages add in
different orders; the tolerance is rtol 1e-6 (a few float32 ulps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import brainevent_tpu.config as jconfig
from brainevent_tpu.fcn.binary import event_capacity as j_event_capacity
from brainevent_tpu.models import EINet as JEINet
from brainevent_tpu.ops import scatter as js

import brainevent_torch.config as tconfig
from brainevent_torch.fcn import event_capacity
from brainevent_torch.interop import einet_from_arrays
from brainevent_torch.ops import scatter as ts


def _events(rng, n_events, n_out, binary, n_chan=None):
    targets = rng.integers(0, n_out, n_events).astype(np.int32)
    shape = (n_events,) if n_chan is None else (n_chan, n_events)
    if binary:
        values = (rng.random(shape) < 0.5).astype(np.float32)
    else:
        values = rng.normal(size=shape).astype(np.float32)
    return targets, values


# n_out 4000 takes the JAX package's one-hot route, 50_000 its XLA scatter
@pytest.mark.parametrize('n_out', [4000, 50_000])
def test_event_scatter_add_binary_bitwise(rng, n_out):
    targets, values = _events(rng, 20_000, n_out, binary=True)
    want = js.event_scatter_add(jnp.asarray(targets), jnp.asarray(values),
                                n_out)
    got = ts.event_scatter_add(torch.from_numpy(targets),
                               torch.from_numpy(values), n_out)
    assert got.dtype == torch.float32 and got.shape == (n_out,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize('n_out', [4000, 50_000])
def test_event_scatter_add_float_close(rng, n_out):
    targets, values = _events(rng, 20_000, n_out, binary=False)
    want = js.event_scatter_add(jnp.asarray(targets), jnp.asarray(values),
                                n_out)
    got = ts.event_scatter_add(torch.from_numpy(targets),
                               torch.from_numpy(values), n_out)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)


def test_event_scatter_add_mask_and_out_of_range_dropped(rng):
    n_out = 1000
    targets = rng.integers(0, n_out + 50, (300, 8)).astype(np.int32)
    mask = rng.random((300, 1)) < 0.6
    values = rng.normal(size=(300, 8)).astype(np.float32)
    want = js.event_scatter_add(jnp.asarray(targets), jnp.asarray(values),
                                n_out, mask=jnp.asarray(mask))
    got = ts.event_scatter_add(torch.from_numpy(targets),
                               torch.from_numpy(values), n_out,
                               mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)
    # the plain definition, with the masked and out-of-range events dropped
    keep = np.broadcast_to(mask, targets.shape) & (targets < n_out)
    dense = np.zeros(n_out, np.float64)
    np.add.at(dense, targets[keep], values[keep])
    np.testing.assert_allclose(got.numpy(), dense, rtol=1e-5, atol=1e-5)


def test_event_scatter_add_scalar_value_and_dtype(rng):
    targets = rng.integers(0, 500, 4000).astype(np.int32)
    want = js.event_scatter_add(jnp.asarray(targets), 1.0, 500,
                                dtype=jnp.float32)
    got = ts.event_scatter_add(torch.from_numpy(targets), 1.0, 500,
                               dtype=torch.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    counts = ts.event_scatter_add(torch.from_numpy(targets),
                                  torch.ones(4000, dtype=torch.int32), 500)
    assert counts.dtype == torch.int32
    np.testing.assert_array_equal(counts.numpy(),
                                  np.bincount(targets, minlength=500))


@pytest.mark.parametrize('binary', [True, False])
@pytest.mark.parametrize('n_out', [4000, 50_000])
def test_event_scatter_add_multi_vs_jax(rng, binary, n_out):
    targets, values = _events(rng, 30_000, n_out, binary, n_chan=2)
    targets[::17] = n_out                    # sentinel: dropped by both
    want = np.asarray(js.event_scatter_add_multi(
        jnp.asarray(targets), jnp.asarray(values), n_out))
    got = ts.event_scatter_add_multi(torch.from_numpy(targets),
                                     torch.from_numpy(values), n_out)
    assert got.shape == (2, n_out) and got.dtype == torch.float32
    if binary:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize('divisor', [None, 1, 7])
def test_event_capacity_matches_jax(divisor):
    old_j = jconfig.get_event_capacity_divisor()
    old_t = tconfig.get_event_capacity_divisor()
    try:
        if divisor is not None:
            jconfig.set_event_capacity_divisor(divisor)
            tconfig.set_event_capacity_divisor(divisor)
        for n in (1, 50, 64, 400, 4000, 39_999, 400_000):
            assert event_capacity(n) == j_event_capacity(n), n
    finally:
        jconfig.set_event_capacity_divisor(old_j)
        tconfig.set_event_capacity_divisor(old_t)


def _nets(coba=True):
    jnet = JEINet(scale=0.1, coba=coba, seed=4)
    s = jnet.init_state()
    net, _ = einet_from_arrays(np.asarray(jnet.conn_all), jnet.n_exc,
                               s.neurons.v, s.neurons.t_last, s.g_e, s.g_i,
                               s.spike_count, scale=0.1, coba=coba)
    return jnet, net


@pytest.mark.parametrize('rate', [0.05, 0.5, 1.0])
def test_propagate_bitwise_including_burst(rate):
    # rate 1.0 fires all 400 neurons, far above event_capacity(400) = 64:
    # the JAX package's overflow branch (networks.py:138-149); the port's
    # scatter has no capacity and takes the same path at every rate
    jnet, net = _nets()
    rng = np.random.default_rng(int(rate * 100))
    spk = rng.random(jnet.num) < rate
    if rate == 1.0:
        assert spk.all() and spk.sum() > j_event_capacity(jnet.num)
    want_e, want_i = jax.jit(jnet._propagate)(jnp.asarray(spk))
    got_e, got_i = net._propagate(torch.from_numpy(spk))
    np.testing.assert_array_equal(got_e.numpy(), np.asarray(want_e))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


def test_event_count_scatter_twin_counts(rng):
    num, n_conn, n_exc = 1000, 16, 800
    conn = rng.integers(0, num, (num, n_conn)).astype(np.int32)
    conn[5, 3] = num                                 # out of range: dropped
    spiking = np.flatnonzero(rng.random(num) < 0.3).astype(np.int32)
    ids = np.zeros(num, np.int32)
    ids[:spiking.size] = rng.permutation(spiking)
    counts = torch.zeros(2, num, dtype=torch.int32)
    ts.event_count_scatter(torch.from_numpy(ids),
                           torch.tensor([spiking.size], dtype=torch.int32),
                           torch.from_numpy(conn), n_exc, counts)
    want = np.zeros((2, num), np.int64)
    for i in spiking:
        row = conn[i][conn[i] < num]
        np.add.at(want[int(i >= n_exc)], row, 1)
    np.testing.assert_array_equal(counts.numpy(), want)
